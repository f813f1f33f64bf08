"""The served path made durable: ``served_map``'s cell on a controller
with a group-commit WAL under a spill directory and a git snapshot store
beside it, whose acks wait until their tick is fsynced.

* The stack is ``served_map.Stack``, its controller given the spill
  directory (``spill/``) and a ``GitSnapshotStore`` (``git/``) of a
  folder made for the run under the configuration's ``spill_root`` (a
  folder of the checkout). The folder is removed when the run ends,
  failed or not. The filesystem under it, read from ``/proc/mounts``, is
  reported as ``wal_fs``.
* Set-up, the window and the epoch closes are ``served_map``'s. A
  round's latency ends at the push of its last ack, which the controller
  makes only once the WAL's durable watermark has passed the round's
  tick; the epoch close's trim rewrites the WAL.
* Every ack, of set-up, window and check alike, is held at its push to
  two facts: its ``dw`` exceeds its tick, and so does the writer's own
  count of fsynced records (``StormController.wal_counters``).
* After the window, untimed: the controller settles and every document
  returns to the joined snapshot; ``checkpoint()``; one more epoch of
  input set 0; a settle, and the live WAL closed; the WAL file read by
  the plain reader (``reference/wal.py``); a fresh stack over the same
  directories on the same device, ``recover()``-ed; its sampled map rows
  and every document's sequencer checkpoint read.
* The check is ``served_map.judge``'s four numbers with the durable facts
  folded in. ``harvest_diffs`` also counts the acks pushed ahead of their
  fsync, rounds that did not run as one tick each, and the check epoch's
  ack fields that differ from the reference deli. ``state_diffs`` also
  counts the recovered sampled documents whose map rows differ from the
  plain replay of set 0 (``reference/map.py``), the documents whose
  recovered sequencer checkpoint differs from the live stack's, a WAL
  file the plain reader stops in, and the check epoch's records it
  cannot decode or whose documents, clients, ops or tickets differ from
  what was submitted and from the reference deli."""

from __future__ import annotations

import gc
import os
import pathlib
import shutil
import statistics
import sys
import tempfile

import numpy as np

from perfbench.drivers.served_map import (EPOCH_CLOSE, STAGE_METRICS, Served,
                                          Stack, generate, judge, mean_ms,
                                          rss_bytes)
from perfbench.harness import check
from perfbench.harness.bench import build_kernels, p95, read_metric
from perfbench.harness.cell import HERE, module, now
from perfbench.harness.trace import TICK, WINDOW, reduce

#: The checkout's root, under which the configuration's spill root lies.
ROOT = HERE.parent
#: The WAL's file in the controller's spill directory.
WAL_FILE = "storm_tick_words.log"
#: The program's profiler ranges of the durable path.
RANGES = ("wal.write", "wal.fsync", "storm.durable_drain")
#: Readers of the WAL writer's batches, also read untraced.
WAL_METRICS = ("wal_write_ms", "wal_fsync_ms", "wal_records_per_fsync")


def wal_fs(path: pathlib.Path) -> str:
    """The type of the filesystem mounted where ``path`` lies, from
    ``/proc/mounts`` (the longest mount point above it)."""
    path = str(path.resolve())
    best, kind = "", "unknown"
    with open("/proc/mounts") as f:
        for line in f:
            fields = line.split()
            if len(fields) < 3:
                continue
            mount = fields[1].replace("\\040", " ")
            inside = path == mount or path.startswith(
                mount.rstrip("/") + "/")
            if inside and len(mount) > len(best):
                best, kind = mount, fields[2]
    return kind


def durable_config(config: dict, folder: pathlib.Path) -> dict:
    """``config`` with its controller's spill directory and snapshot store
    in ``folder`` (a new store object over the same files each call, as a
    restarted process opens them)."""
    from fluidframework_tpu_torch.server.durable_store import \
        GitSnapshotStore
    stack = dict(config["stack"])
    stack["storm"] = {**stack["storm"], "spill_dir": str(folder / "spill"),
                      "snapshots": GitSnapshotStore(folder / "git")}
    return {**config, "stack": stack}


class DurableServed(Served):
    """``Served`` with each round's tick, each ack's durability held to
    its tick, the WAL's size before each trim, and a check epoch whose
    acks are kept apart."""

    def __init__(self, config: dict, stack: Stack, sets: list,
                 wal_path: pathlib.Path) -> None:
        super().__init__(config, stack, sets)
        self.wal_path = wal_path
        self.next_tick = self.storm._tick_counter
        self.tick_of: dict = {}
        self.early_acks = 0
        self.tick_faults = 0
        self.wal_bytes_max = 0
        self.checking = False
        self.check_acks: dict = {}

    def serve_round(self) -> None:
        self.tick_of[(self.set_index, self.round)] = self.next_tick
        self.next_tick += 1
        super().serve_round()

    def on_ack(self, key: tuple, payload: dict) -> None:
        tick = self.tick_of.get(key[:2], self.next_tick)
        fsynced = self.storm.wal_counters()["records"]
        if not (payload.get("dw", -1) > tick and fsynced > tick):
            self.early_acks += 1
        super().on_ack(key, payload)

    def finish(self, rnd, t: float) -> None:
        if not self.checking:
            super().finish(rnd, t)
            return
        del self.open[rnd.key]
        self.check_acks[rnd.key] = np.concatenate(
            [rnd.rows[f] for f in range(self.frames)])

    def settle(self) -> None:
        """``Served.settle``; every round served so far has to have run as
        one tick of its own."""
        super().settle()
        if self.storm._tick_counter != self.next_tick:
            self.tick_faults += abs(self.storm._tick_counter - self.next_tick)
            self.next_tick = self.storm._tick_counter

    def close_epoch(self) -> None:
        self.settle()
        self.wal_bytes_max = max(self.wal_bytes_max,
                                 self.wal_path.stat().st_size)
        super().close_epoch()

    def restart(self, index: int) -> None:
        """Settle, every document back at the joined snapshot and the open
        epoch's ticks trimmed; the next round is round 0 of set
        ``index``."""
        storm = self.storm
        self.settle()
        self.stack.restore(self.epoch_tick0)
        storm.trim_tick_blobs(set(range(self.epoch_tick0,
                                        storm._tick_counter)))
        self.epoch_tick0 = storm._tick_counter
        self.round, self.set_index = 0, index

    def profiled_epochs(self, epochs: int, cuda: bool) -> tuple:
        """``Served.profiled_epochs`` with every thread profiled, so the
        WAL writer's ranges lie in the trace; also returns how many of
        each of :data:`RANGES` the trace holds."""
        import torch
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        keys = []
        tick0 = self.storm._tick_counter
        self.profiling = True
        with profile(activities=acts, experimental_config=(
                _ExperimentalConfig(profile_all_threads=True))) as prof:
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
        ranges = dict.fromkeys(RANGES, 0)
        for e in prof.events():
            if e.name in ranges:
                ranges[e.name] += 1
        return (reduce(prof), keys, range(tick0, self.storm._tick_counter),
                ranges)


def recover_stack(config: dict, device) -> tuple:
    """A fresh stack of ``config`` (its spill directory and snapshot store
    those of the live one) recovered: (its controller, ``recover()``'s
    report)."""
    from fluidframework_tpu_torch.server.kernel_host import \
        KernelSequencerHost
    from fluidframework_tpu_torch.server.merge_host import KernelMergeHost
    from fluidframework_tpu_torch.server.routerlicious import \
        RouterliciousService
    from fluidframework_tpu_torch.server.storm import StormController
    spec = config["stack"]
    seq = KernelSequencerHost(device=device, **spec["sequencer"])
    merge = KernelMergeHost(device=device, **spec["merge_host"])
    service = RouterliciousService(merge_host=merge, batched_deli_host=seq,
                                   **spec["service"])
    storm = StormController(service, seq, merge, **spec["storm"])
    return storm, storm.recover()


def check_durability(served: DurableServed, config: dict, folder, device,
                     cuda: bool) -> dict:
    """The untimed durability check after the window (see the module's
    docstring): what the judge reads, and the seconds of its steps."""
    import torch
    wal = module("reference", "wal")
    storm, stack = served.storm, served.stack
    secs = {}
    served.restart(0)
    t0 = now()
    storm.checkpoint()
    secs["checkpoint"] = now() - t0
    tick0 = storm._tick_counter
    t0 = now()
    served.checking = True
    for _ in range(served.epoch_rounds):
        served.serve_round()
    served.settle()
    served.checking = False
    secs["check_epoch"] = now() - t0
    live_heads = stack.seq.checkpoint_all()
    served.wal_bytes_max = max(served.wal_bytes_max,
                               served.wal_path.stat().st_size)
    storm._group_wal.close()
    t0 = now()
    payloads, fault = wal.records(served.wal_path)
    on_disk = []
    for t in range(tick0, tick0 + served.epoch_rounds):
        try:
            on_disk.append(wal.decode(payloads[t]))
        except (IndexError, wal.WalError):
            on_disk.append(None)
    del payloads
    secs["wal_read"] = now() - t0
    t0 = now()
    fresh, info = recover_stack(durable_config(config, folder), device)
    if cuda:
        torch.cuda.synchronize()
    secs["recover"] = now() - t0
    try:
        names = stack.names
        rows = [fresh._storm_map_row(names[d])
                for d in served.sets[0]["sample"].tolist()]
        planes = fresh.merge_host.read_map_rows(rows)
        heads = fresh.seq_host.checkpoint_all()
    finally:
        fresh._group_wal.close()
    return {"names": stack.names, "ids": stack.ids, "wal_fault": fault,
            "wal_ticks": on_disk, "recovered_planes": planes,
            "recovered_heads": heads, "live_heads": live_heads,
            "recover_info": info, "seconds": secs}


def judge_durable(config: dict, sets: list, served: DurableServed,
                  map_slots: int, control: bool, facts: dict) -> dict:
    """``served_map.judge``'s numbers with the durable facts folded in (see
    the module's docstring)."""
    from perfbench import control as ctl
    values = judge(config, sets, served, map_slots, control)
    deli = module("reference", "deli")
    ref_map = module("reference", "map")
    read = module("readout", "map")
    s0 = sets[0]
    tickets = deli.replay(config["clients"], s0["scalars"])
    want = {name: tickets[name] for name in ("n_seq", "first", "last",
                                             "msn")}
    harvest = 0 if control else (served.early_acks + served.tick_faults)
    for r in range(served.epoch_rounds):
        acks = served.check_acks.get((0, r))
        if acks is None:
            harvest += 1
            continue
        if not control:
            got = acks.T
            harvest += sum(int(np.count_nonzero(got[c] != want[name][r]))
                           for c, name in enumerate(want))
    states = 0
    planes = facts["recovered_planes"]
    for j, doc in enumerate(s0["sample"].tolist()):
        words, first = s0["words"][:, doc], tickets["first"][:, doc]
        if control:
            got = ref_map.replay(words, first, map_slots,
                                 order=ctl.reversed_order)
        else:
            got = read.visible({f: planes[f][j] for f in planes})
        states += not read.equal(got, ref_map.replay(words, first,
                                                     map_slots))
    if not control:
        live, heads = facts["live_heads"], facts["recovered_heads"]
        states += sum(heads.get(doc) != cp for doc, cp in live.items())
        states += len(set(heads) - set(live))
        states += facts["wal_fault"] is not None
        states += sum(not record_matches(tick, config, s0, r, want, facts)
                      for r, tick in enumerate(facts["wal_ticks"]))
    values["harvest_diffs"] += harvest
    values["state_diffs"] += states
    values["compared_docs"] += len(s0["sample"])
    return values


def record_matches(tick, config: dict, s0: dict, r: int, want: dict,
                   facts: dict) -> bool:
    """Whether the WAL record of round ``r`` of input set ``s0``, as the
    plain reader decoded it (``None``: it could not), holds what was
    submitted and the reference deli's tickets ``want``."""
    if tick is None:
        return False
    slot = s0["scalars"][r, :, 0]
    names, ids = facts["names"], facts["ids"]
    if tick["docs"] != names or tick["clients"] != [
            ids[d][slot[d]] for d in range(config["docs"])]:
        return False
    sc = tick["scalars"]
    submitted = s0["scalars"][r, :, 1:3].astype(np.int64)
    if not (np.array_equal(sc[:, :2], submitted)
            and np.all(sc[:, 2] == config["k"])
            and all(np.array_equal(sc[:, 3 + c], want[name][r])
                    for c, name in enumerate(want))):
        return False
    return all(np.array_equal(ops, s0["words"][r, d].view(np.uint32))
               for d, ops in enumerate(tick["ops"]))


def run(work: dict, config: dict, seed: int, seconds: float, trace: bool,
        device, t_start: float, metrics: dict,
        control: bool = False) -> dict:
    """``bench.run_cell`` for a cell this driver serves: the same fields
    and the same four checks."""
    from fluidframework_tpu_torch.server.storm import StormController
    if not hasattr(StormController, "wal_counters"):
        # The ack check reads the writer's count of fsynced records.
        raise RuntimeError("the program keeps no count of the WAL's fsynced "
                           "records (StormController.wal_counters)")
    root = ROOT / config["spill_root"]
    root.mkdir(exist_ok=True)
    folder = pathlib.Path(tempfile.mkdtemp(prefix=f"run-{os.getpid()}-",
                                           dir=root))
    fs = wal_fs(folder)
    print(f"wal_fs {fs} ({folder})", file=sys.stderr, flush=True)
    try:
        out = serve(work, durable_config(config, folder), seed, seconds,
                    trace, device, t_start, metrics, control, folder)
    finally:
        # Failed or not, no byte of the run stays in the checkout.
        shutil.rmtree(folder, ignore_errors=True)
        try:
            root.rmdir()
        except OSError:
            pass  # another run's folder is still there
    out["wal_fs"] = fs
    return out


def serve(work: dict, config: dict, seed: int, seconds: float, trace: bool,
          device, t_start: float, metrics: dict, control: bool,
          folder: pathlib.Path) -> dict:
    """Set-up, the window and the check of a run whose files lie in
    ``folder``."""
    import torch

    from fluidframework_tpu_torch.ops import map_fold_cuda as mfc
    from fluidframework_tpu_torch.ops import sequencer_cuda as seqc
    cuda = device.type == "cuda"
    if cuda:
        build_kernels()
    sets = [generate(config, work, seed, i, device)
            for i in range(work["input_sets"])]
    stack = Stack(config, device)
    storm = stack.storm
    wal = storm._group_wal
    try:
        join_launches = {"map_fold": mfc.launches,
                         "sequencer_tick": seqc.launches}
        served = DurableServed(config, stack, sets,
                               folder / "spill" / WAL_FILE)
        # Warm-up: one epoch of every input set, untimed.
        for _ in range(len(sets) * served.epoch_rounds):
            served.step()
        launches0 = (mfc.launches, seqc.launches)
        depth0, tick0 = storm.pipeline_depth, storm._tick_counter
        wal0 = storm.wal_counters()
        served.measuring = True
        prof_out, profiled_keys, profiled_ticks = None, [], range(0)
        ranges = None
        # What set-up built stays: the collector need not walk it again.
        gc.collect()
        gc.freeze()
        rss0 = rss_bytes()
        setup_s = now() - t_start
        start = now()
        while now() - start < seconds:
            if (trace and prof_out is None and served.round == 0
                    and now() - start >= seconds / 3):
                prof_out, profiled_keys, profiled_ticks, ranges = \
                    served.profiled_epochs(work["trace_epochs"], cuda)
                continue
            served.step()
        served.settle()
        if cuda:
            torch.cuda.synchronize()
        window_s = now() - start
        rss1 = rss_bytes()
        gc.unfreeze()
        served.measuring = False
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        launches = {"map_fold": mfc.launches - launches0[0],
                    "sequencer_tick": seqc.launches - launches0[1]}
        wal1 = storm.wal_counters()
        window_ticks = (set(range(tick0, storm._tick_counter))
                        - set(profiled_ticks))
        stages = [r for r in storm.ledger.records()
                  if r["tick"] in window_ticks]
        batches = [b for b in wal.batches()
                   if set(range(b[0], b[0] + b[1])) <= window_ticks]
        depths = sorted({r["depth"] for r in stages})
        map_slots = stack.merge._map_slots
        facts = check_durability(served, config, folder, device, cuda)
    finally:
        wal.close()
    served.stack = served.storm = stack = storm = wal = None
    if cuda:
        torch.cuda.empty_cache()

    # The check: after the window, with the program's state freed.
    values = judge_durable(config, sets, served, map_slots, control, facts)
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
                            for m in STAGE_METRICS
                            + ("stage_ms.commit_wait",)},
           "wal": {"window": {k: wal1[k] - wal0[k] for k in wal1},
                   "per_batch": {m: read_metric(m, {"wal_batches": batches})
                                 for m in WAL_METRICS},
                   "bytes_max": served.wal_bytes_max,
                   "early_acks": served.early_acks,
                   "tick_faults": served.tick_faults},
           "recovery": {"replayed_ticks":
                        facts["recover_info"]["replayed_ticks"],
                        "seconds": facts["seconds"]},
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
        run_ = {"stages": stages, "wal_batches": batches,
                **(prof_out or {"kernels": {}}),
                "work": {"k1_bytes": sum(
                    module("metrics", "_work_fold").fold_bytes(
                        sets[i]["words"][r]) for i, r in profiled_keys)}}
        values = {m: read_metric(m, run_) for m in metrics}
        out.update(busy_s=run_.get("busy_s"), window_s=run_.get("window_s"),
                   breakdown=run_.get("breakdown"), ranges=ranges)
    out["metrics"] = {m: {"value": float(v), "unit": metrics[m]}
                      for m, v in values.items()
                      if m in metrics and v is not None}
    out["checks"] = verdict["checks"]
    return out
