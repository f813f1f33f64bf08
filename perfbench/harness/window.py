"""The measured window: serving ticks dispatched back to back on staged
inputs, each tick's state carried into the next, harvests read back
without blocking, one tick in flight beyond the one being dispatched.

A tick's latency ends when its harvest copy completes on the device,
read from CUDA events after the window and mapped onto the host clock,
so that it holds none of the next tick's host work.

After ``epoch_ticks`` ticks every row is restored from the joined
snapshot by a device copy and the next input set begins. Every harvest
is held to the first harvest of the same tick of the same input set, and
every epoch's final sampled rows to the first epoch's of its set, on the
device; those firsts are what the plain reference judges."""

from __future__ import annotations

import numpy as np

from .cell import HARVEST, OVF_NONE, Staged, now


class Ticker:
    """Dispatches ticks and keeps what the checks and metrics read."""

    def __init__(self, staged: Staged, mark=None) -> None:
        import torch

        from fluidframework_tpu_torch.server import storm
        self.torch, self.storm, self.staged = torch, storm, staged
        self.mark = mark
        self.cuda = staged.device.type == "cuda"
        docs = staged.config["docs"]
        self.width = len(HARVEST) * docs + 5
        # Two pinned generations: one being filled, one being read.
        self.host = [torch.empty(self.width, dtype=torch.int32,
                                 pin_memory=self.cuda) for _ in range(2)]
        self.gen = 0
        self.set_index, self.tick = 0, 0
        self.states = staged.fresh()
        self.pending = None
        self.first_harvest: dict = {}
        self.first_capture: dict = {}
        self.repeat_diffs = torch.zeros((), dtype=torch.int64,
                                        device=staged.device)
        self.harvest_repeat_diffs = 0
        # Harvest columns of a family the cell does not serve.
        self.no_tree = torch.zeros(docs, dtype=torch.int32,
                                   device=staged.device)
        self.no_text = self.no_tree + OVF_NONE
        self.latency_s: list = []
        self.done: list = []
        self.anchors: list = []
        self.host_tick_s: list = []
        self.kstats: list = []
        self.harvested_at: list = []
        self.ops = 0
        self.attempted = 0
        self.ticks_run = 0
        self.epochs_done = 0

    def dispatch(self) -> None:
        """One tick of the current input set, its harvest copy started."""
        torch = self.torch
        args, steps = self.staged.ticks[self.set_index][self.tick]
        if self.mark is not None:
            self.mark.begin()
        t_call = now()
        out = self.storm._mixed_tick(*self.states, *args, tree_steps=steps,
                                     mark=self.mark)
        t_back = now()
        self.host_tick_s.append(t_back - t_call)
        self.states = list(out[:5])
        n_seq, first, last, msn, tovf, xovf, kstats = out[5:]
        flat = torch.cat([n_seq, first, last, msn,
                          self.no_tree if tovf is None else tovf,
                          self.no_text if xovf is None else xovf,
                          kstats]).to(torch.int32)
        buf = self.host[self.gen]
        self.gen ^= 1
        buf.copy_(flat, non_blocking=self.cuda)
        event = None
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
        key = (self.set_index, self.tick)
        self.attempted += self.staged.ops_per_tick
        self.ticks_run += 1
        self.tick += 1
        if self.tick == self.staged.config["epoch_ticks"]:
            self._close_epoch()
        self.harvest()
        self.pending = (key, buf, event, t_call)

    def _close_epoch(self) -> None:
        """The epoch's sampled rows against its set's first epoch, then the
        joined snapshot restored for the next set."""
        i = self.set_index
        got = self.staged.capture(self.states, i)
        if i in self.first_capture:
            self.repeat_diffs += (got != self.first_capture[i]).sum()
        else:
            self.first_capture[i] = got
        self.epochs_done += 1
        self.states = self.staged.fresh()
        self.tick = 0
        self.set_index = (i + 1) % len(self.staged.ticks)

    def harvest(self) -> None:
        """Read the pending tick's harvest (waiting for it) and check it
        against the first of its kind."""
        if self.pending is None:
            return
        key, buf, event, t_call = self.pending
        self.pending = None
        if event is not None:
            event.synchronize()
            self.done.append((t_call, event))
        self.latency_s.append(now() - t_call)
        got = buf.numpy().copy()
        docs = self.staged.config["docs"]
        kstats = got[len(HARVEST) * docs:].copy()
        self.kstats.append(kstats)
        self.harvested_at.append(now())
        self.ops += int(kstats[0])
        if key in self.first_harvest:
            self.harvest_repeat_diffs += int(
                np.count_nonzero(got != self.first_harvest[key]))
        else:
            self.first_harvest[key] = got

    def drain(self) -> None:
        self.harvest()
        if self.cuda:
            self.torch.cuda.synchronize()

    def anchor(self) -> None:
        """Tie the device's event clock to the host's: an event recorded on
        the idle stream and waited for, beside the host time it was seen."""
        if self.cuda:
            event = self.torch.cuda.Event(enable_timing=True)
            event.record()
            event.synchronize()
            self.anchors.append((now(), event))

    def ready_latency_s(self) -> tuple[list, float]:
        """(each harvested tick's latency in seconds, the clock scale). A
        latency runs from the host's call into the tick to the moment its
        harvest copy completed on the device, that moment mapped onto the
        host clock linearly between the first and the last anchor (the
        scale is host seconds per device second). Without a card: until
        the host read the harvest."""
        if not self.cuda:
            return list(self.latency_s), 1.0
        (h0, e0), (h1, e1) = self.anchors[0], self.anchors[-1]
        scale = (h1 - h0) / (e0.elapsed_time(e1) / 1e3)
        return [h0 + scale * e0.elapsed_time(ev) / 1e3 - t_call
                for t_call, ev in self.done], scale


def run_epochs(ticker: Ticker, epochs: int) -> None:
    """``epochs`` whole epochs (from an epoch boundary), drained."""
    for _ in range(epochs * ticker.staged.config["epoch_ticks"]):
        ticker.dispatch()
    ticker.drain()


def harvest_planes(first: np.ndarray, docs: int) -> dict:
    """A harvest's flat buffer as named [docs] planes and its kstats."""
    out = {name: first[i * docs:(i + 1) * docs]
           for i, name in enumerate(HARVEST)}
    out["kstats"] = first[len(HARVEST) * docs:]
    return out
