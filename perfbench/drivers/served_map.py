"""The served path: SharedMap storm frames through the program's front
door, ``StormController.submit_frame``, on the stack a deployment builds
(``KernelSequencerHost``, ``KernelMergeHost``, ``RouterliciousService``)
with the arguments its configuration names under ``stack``.

* Set-up joins ``clients`` clients to each of ``docs`` documents through
  ``service.connect``, keeps the joined sequencer and map state, draws
  ``input_sets`` input sets of ``epoch_rounds`` rounds (every document
  sends one batch of ``k`` words a round, from one of its clients) and
  encodes every frame's header and payload; then serves one epoch of
  every set, untimed.
* The window submits the frames back to back, a closed loop: the next
  frame as soon as ``submit_frame`` returns. A round's last frame crosses
  the controller's flush threshold and the controller runs the round
  itself. A round's latency runs from the call that submits its first
  frame to the push of its last ack.
* Between epochs, outside every round's latency, the controller settles
  what is in flight (``flush`` with no frame buffered), the sampled
  documents' map rows are read back, the sequencer and map state return
  to the joined snapshot with the controller's host bookkeeping of the
  closed epoch, and the closed epoch's tick blobs are trimmed with the
  controller's ``trim_tick_blobs``.
* The check holds each (input set, round)'s first acks in the window to
  the plain reference deli (``reference/deli.py``), each set's first
  sampled map rows to the plain replay (``reference/map.py``), and every
  later round and epoch to the first of its kind."""

from __future__ import annotations

import functools
import gc
import resource
import statistics

import numpy as np

from perfbench.harness import check
from perfbench.harness.bench import build_kernels, p95, read_metric
from perfbench.harness.cell import module, now, seed_words
from perfbench.harness.trace import TICK, WINDOW, reduce

#: The profiler range around each epoch's close in a traced run.
EPOCH_CLOSE = "perfbench.epoch_close"
#: The readers of the controller's stage records, also read untraced.
STAGE_METRICS = ("stage_ms.ingress", "stage_ms.scatter", "stage_ms.dispatch",
                 "stage_ms.readback", "stage_ms.harvest")


def generate(config: dict, work: dict, seed: int, index: int,
             device) -> dict:
    """Input set ``index``: [rounds, docs, 6] ``scalars`` (slot, cseq0,
    ref, ts, count, 0) of every document's batch, its [rounds, docs, k]
    ``words`` and the ``sample`` of documents whose map rows are judged."""
    docs, rounds, k = config["docs"], config["epoch_rounds"], config["k"]
    rng = np.random.default_rng([seed_words(seed), index])
    deli = module("traffic", "deli").generate(
        rng, np.full(docs, k, np.int64), config["clients"], rounds)
    scalars = np.zeros((rounds, docs, 6), np.int32)
    scalars[:, :, 0] = deli["slot"]
    scalars[:, :, 1] = deli["cseq0"]
    scalars[:, :, 2] = deli["ref"]
    scalars[:, :, 3] = deli["ts"][:, None]
    scalars[:, :, 4] = k
    params = {**work["traffic"]["map"], "slots": config["key_slots"]}
    words = module("traffic", "map_device").generate(
        int(rng.integers(0, 2**63)), rounds, docs, k, params, device)
    sample = np.sort(rng.choice(docs, min(work["sample"], docs),
                                replace=False))
    return {"scalars": scalars, "words": words, "sample": sample}


def _ignore(_messages) -> None:
    """A joined client's handler: the frames' acks come by their push."""


class Stack:
    """The served stack with every client joined, and the joined state."""

    def __init__(self, config: dict, device) -> None:
        from fluidframework_tpu_torch.server.kernel_host import \
            KernelSequencerHost
        from fluidframework_tpu_torch.server.merge_host import \
            KernelMergeHost
        from fluidframework_tpu_torch.server.routerlicious import \
            RouterliciousService
        from fluidframework_tpu_torch.server.storm import StormController
        spec = config["stack"]
        if spec["storm"]["flush_threshold_docs"] != config["docs"] \
                or config["docs"] % config["frames_per_round"] \
                or spec["sequencer"]["num_slots"] != config["clients"]:
            raise ValueError("a round has to be every document once, in "
                             "whole frames, from the joined clients")
        self.seq = KernelSequencerHost(device=device, **spec["sequencer"])
        self.merge = KernelMergeHost(device=device, **spec["merge_host"])
        self.service = RouterliciousService(
            merge_host=self.merge, batched_deli_host=self.seq,
            **spec["service"])
        self.storm = StormController(self.service, self.seq, self.merge,
                                     **spec["storm"])
        self.storm.depth_adapt_every = spec["depth_adapt_every"]
        self.names = [f"doc{d}" for d in range(config["docs"])]
        self.ids = [[self.service.connect(name, _ignore).client_id
                     for _ in range(config["clients"])]
                    for name in self.names]
        self.service.pump()
        self.joined = (clone(self.seq._state), clone(self.merge._xstate))

    def restore(self, tick0: int) -> None:
        """Every document back at the joined snapshot: the sequencer and
        map state, the sequencer's host mirror, each storm map row's last
        sequence number (0 when joined: the rows come with the first
        round), and the controller's catch-up index without the entries
        of ticks ``tick0`` on, whose history is rolled back."""
        self.seq._state = clone(self.joined[0])
        self.merge._xstate = clone(self.joined[1])
        self.seq._host_state = None
        for row in self.merge._map_rows.values():
            row.last_seq = 0
        for entries in self.storm._doc_ticks.values():
            keep = len(entries)
            while keep and entries[keep - 1][2] >= tick0:
                keep -= 1
            del entries[keep:]


def clone(state):
    return type(state)(*(x.clone() for x in state))


class Round:
    """One round as served: its frames' ack rows by frame as they come."""

    __slots__ = ("key", "timed", "profiled", "t_first", "rows")

    def __init__(self, key: tuple, timed: bool, profiled: bool) -> None:
        self.key, self.timed, self.profiled = key, timed, profiled
        self.t_first = 0.0
        self.rows: dict = {}


class Served:
    """Serves the cell's rounds and keeps what the check and the metrics
    read."""

    def __init__(self, config: dict, stack: Stack, sets: list) -> None:
        self.config, self.stack, self.sets = config, stack, sets
        self.storm = stack.storm
        self.frames = config["frames_per_round"]
        self.epoch_rounds = config["epoch_rounds"]
        self.ops_per_round = config["docs"] * config["k"]
        self.frames_of = [self.encode(s, i) for i, s in enumerate(sets)]
        self.sample_rows: list = [None] * len(sets)
        self.set_index, self.round = 0, 0
        self.measuring = self.profiling = False
        self.open: dict = {}
        self.first_acks: dict = {}
        self.first_planes: dict = {}
        self.repeat_diffs = 0
        self.ack_faults = 0
        self.latency_s: list = []
        self.ops = self.attempted = 0
        self.rounds_run = self.epochs_done = 0
        self.epoch_tick0 = self.storm._tick_counter
        self.restore_s: list = []
        self.trim_s: list = []
        self.trimmed = 0

    def encode(self, s: dict, index: int) -> list:
        """Every round's frames of input set ``s``: (header, payload,
        push) each, the payload a byte view of the set's words."""
        names, ids = self.stack.names, self.stack.ids
        k = self.config["k"]
        per = self.config["docs"] // self.frames
        out = []
        for r in range(self.epoch_rounds):
            slot, cseq0, ref = (s["scalars"][r, :, c].tolist()
                                for c in range(3))
            frames = []
            for f in range(self.frames):
                lo, hi = f * per, (f + 1) * per
                header = {"op": "storm", "rid": f"{index}.{r}.{f}",
                          "docs": [[names[d], ids[d][slot[d]], cseq0[d],
                                    ref[d], k] for d in range(lo, hi)]}
                payload = memoryview(
                    s["words"][r, lo:hi].reshape(-1)).cast("B")
                frames.append((header, payload,
                               functools.partial(self.on_ack, (index, r, f))))
            out.append(frames)
        return out

    def on_ack(self, key: tuple, payload: dict) -> None:
        """A frame's ack, pushed by the controller."""
        t = now()
        rnd = self.open.get(key[:2])
        if rnd is None or key[2] in rnd.rows or "error" in payload \
                or "quarantined" in payload:
            self.ack_faults += 1
            return
        rnd.rows[key[2]] = payload.rows
        if len(rnd.rows) == self.frames:
            self.finish(rnd, t)

    def finish(self, rnd: Round, t: float) -> None:
        """A round whose every frame is acked: its latency, its sequenced
        ops, and its acks against the first of its (input set, round)."""
        del self.open[rnd.key]
        if not rnd.timed:
            return
        acks = np.concatenate([rnd.rows[f] for f in range(self.frames)])
        if not rnd.profiled:
            self.latency_s.append(t - rnd.t_first)
        self.ops += int(acks[:, 0].sum())
        first = self.first_acks.get(rnd.key)
        if first is None:
            self.first_acks[rnd.key] = acks.copy()
        else:
            self.repeat_diffs += int(np.count_nonzero(acks != first))

    def step(self) -> None:
        """One round, and the epoch's close after its last."""
        self.serve_round()
        if self.round == self.epoch_rounds:
            self.close_epoch()

    def serve_round(self) -> None:
        key = (self.set_index, self.round)
        rnd = Round(key, self.measuring, self.profiling)
        self.open[key] = rnd
        submit = self.storm.submit_frame
        rnd.t_first = now()
        for header, payload, push in self.frames_of[key[0]][key[1]]:
            submit(push, header, payload)
        if rnd.timed:
            self.rounds_run += 1
            self.attempted += self.ops_per_round
        self.round += 1

    def settle(self) -> None:
        """Everything in flight harvested and acked; a round that is
        still missing acks then counts each missing one."""
        self.storm.flush()
        for rnd in list(self.open.values()):
            del self.open[rnd.key]
            self.ack_faults += self.frames - len(rnd.rows)

    def close_epoch(self) -> None:
        """The epoch's sampled map rows read back (the set's first in the
        window kept, a later one held to it), then every document restored
        to the joined snapshot and the epoch's tick blobs trimmed."""
        storm, i = self.storm, self.set_index
        self.settle()
        rows = self.sample_rows[i]
        if rows is None:
            rows = self.sample_rows[i] = [
                storm._storm_map_row(self.stack.names[d])
                for d in self.sets[i]["sample"].tolist()]
        planes = self.stack.merge.read_map_rows(rows)
        if self.measuring:
            first = self.first_planes.get(i)
            if first is None:
                self.first_planes[i] = planes
            else:
                self.repeat_diffs += sum(
                    int(np.count_nonzero(planes[f] != first[f]))
                    for f in planes)
            self.epochs_done += 1
        t0 = now()
        self.stack.restore(self.epoch_tick0)
        t1 = now()
        self.trimmed += storm.trim_tick_blobs(
            set(range(self.epoch_tick0, storm._tick_counter)))
        t2 = now()
        if self.measuring:
            self.restore_s.append(t1 - t0)
            self.trim_s.append(t2 - t1)
        self.epoch_tick0 = storm._tick_counter
        self.round = 0
        self.set_index = (i + 1) % len(self.sets)

    def profiled_epochs(self, epochs: int, cuda: bool) -> tuple:
        """``epochs`` whole epochs under ``torch.profiler``, from an epoch
        boundary: (the trace's reduction, the profiled (set, round) keys,
        the profiled tick ids)."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        keys = []
        tick0 = self.storm._tick_counter
        self.profiling = True
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                for _ in range(epochs * self.epoch_rounds):
                    keys.append((self.set_index, self.round))
                    with record_function(TICK):
                        self.serve_round()
                    if self.round == self.epoch_rounds:
                        with record_function(EPOCH_CLOSE):
                            self.close_epoch()
        self.profiling = False
        if cuda:
            torch.cuda.synchronize()
        return reduce(prof), keys, range(tick0, self.storm._tick_counter)


def rss_bytes() -> dict:
    """This process's resident set now and at its peak."""
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return {"now": pages * resource.getpagesize(),
            "peak": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            * 1024}


def run(work: dict, config: dict, seed: int, seconds: float, trace: bool,
        device, t_start: float, metrics: dict,
        control: bool = False) -> dict:
    """``bench.run_cell`` for a cell this driver serves: the same fields,
    and the same four checks."""
    import torch

    from fluidframework_tpu_torch.ops import map_fold_cuda as mfc
    from fluidframework_tpu_torch.ops import sequencer_cuda as seqc
    cuda = device.type == "cuda"
    if cuda:
        build_kernels()
    sets = [generate(config, work, seed, i, device)
            for i in range(work["input_sets"])]
    stack = Stack(config, device)
    join_launches = {"map_fold": mfc.launches,
                     "sequencer_tick": seqc.launches}
    served = Served(config, stack, sets)
    storm = stack.storm
    # Warm-up: one epoch of every input set, untimed.
    for _ in range(len(sets) * served.epoch_rounds):
        served.step()
    launches0 = (mfc.launches, seqc.launches)
    depth0, tick0 = storm.pipeline_depth, storm._tick_counter
    served.measuring = True
    prof_out, profiled_keys, profiled_ticks = None, [], range(0)
    # What set-up built stays: the collector need not walk it again.
    gc.collect()
    gc.freeze()
    rss0 = rss_bytes()
    setup_s = now() - t_start
    start = now()
    while now() - start < seconds:
        if (trace and prof_out is None and served.round == 0
                and now() - start >= seconds / 3):
            prof_out, profiled_keys, profiled_ticks = served.profiled_epochs(
                work["trace_epochs"], cuda)
            continue
        served.step()
    served.settle()
    if cuda:
        torch.cuda.synchronize()
    window_s = now() - start
    rss1 = rss_bytes()
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    launches = {"map_fold": mfc.launches - launches0[0],
                "sequencer_tick": seqc.launches - launches0[1]}
    stages = [r for r in storm.ledger.records()
              if r["tick"] >= tick0 and r["tick"] not in profiled_ticks]
    depths = sorted({r["depth"] for r in stages})
    map_slots = stack.merge._map_slots
    served.stack = served.storm = stack = storm = None
    if cuda:
        torch.cuda.empty_cache()

    # The check: after the window, with the program's state freed.
    values = judge(config, sets, served, map_slots, control)
    verdict = check.summary(values)
    compared = values.pop("compared_docs")
    latency = served.latency_s
    out = {"correct": verdict["correct"], "attempted": served.attempted,
           "failed": served.attempted - served.ops,
           "memory_peak_bytes": int(peak), "compared_docs": compared,
           "rounds": served.rounds_run, "epochs": served.epochs_done,
           "pipeline_depth": {"window_start": depth0, "rounds": depths},
           "launches": launches, "join_launches": join_launches,
           "round_ms_quartiles": [1e3 * q for q in statistics.quantiles(
               latency, n=4)] if len(latency) > 1 else None,
           "stage_p50_ms": {m: read_metric(m, {"stages": stages})
                            for m in STAGE_METRICS},
           "restore_ms": mean_ms(served.restore_s),
           "trim_ms": mean_ms(served.trim_s),
           "trimmed_blobs": served.trimmed,
           "rss_bytes": {"window_start": rss0, "window_end": rss1},
           "control": control}
    if not trace:
        values = {"merged_ops_per_s": served.ops / window_s,
                  "tick_p95_ms": 1e3 * p95(latency),
                  "setup_s": setup_s}
    else:
        run_ = {"stages": stages, **(prof_out or {"kernels": {}}),
                "work": {"k1_bytes": sum(
                    module("metrics", "_work_fold").fold_bytes(
                        sets[i]["words"][r]) for i, r in profiled_keys)}}
        values = {m: read_metric(m, run_) for m in metrics}
        out.update(busy_s=run_.get("busy_s"), window_s=run_.get("window_s"),
                   breakdown=run_.get("breakdown"))
    out["metrics"] = {m: {"value": float(v), "unit": metrics[m]}
                      for m, v in values.items()
                      if m in metrics and v is not None}
    out["checks"] = verdict["checks"]
    return out


def mean_ms(seconds: list):
    return 1e3 * sum(seconds) / len(seconds) if seconds else None


def judge(config: dict, sets: list, served: Served, map_slots: int,
          control: bool) -> dict:
    """The four numbers of ``check.summary`` and the documents compared.
    With ``control`` the outputs judged are the control's: the reference
    deli's acks, and every set's sampled rows replayed with each round's
    ops in reverse (``perfbench/control.py``'s broken guarantee)."""
    from perfbench import control as ctl
    deli = module("reference", "deli")
    ref_map = module("reference", "map")
    read = module("readout", "map")
    tickets = [deli.replay(config["clients"], s["scalars"]) for s in sets]

    def want_acks(i: int, r: int) -> np.ndarray:
        return np.stack([tickets[i][name][r] for name in
                         ("n_seq", "first", "last", "msn")], axis=1)

    def replay(i: int, doc: int, order=None) -> dict:
        return ref_map.replay(sets[i]["words"][:, doc],
                              tickets[i]["first"][:, doc], map_slots,
                              order=order)

    harvest = 0 if control else served.ack_faults
    for (i, r), acks in served.first_acks.items():
        got = want_acks(i, r) if control else acks
        harvest += int(np.count_nonzero(got != want_acks(i, r)))
    states = 0
    compared = 0
    judged = range(len(sets)) if control else served.first_planes
    for i in judged:
        planes = None if control else served.first_planes[i]
        for j, doc in enumerate(sets[i]["sample"].tolist()):
            want = replay(i, doc)
            if control:
                got = replay(i, doc, order=ctl.reversed_order)
            else:
                got = read.visible({f: planes[f][j] for f in planes})
            compared += 1
            states += not read.equal(got, want)
    return {"harvest_diffs": harvest, "state_diffs": states,
            "repeat_diffs": 0 if control else served.repeat_diffs,
            "sets_unchecked": 0 if control
            else len(sets) - len(served.first_planes),
            "compared_docs": compared}
