"""The history plane of the port (``server/history.py``, the storm's
history hooks, ``drivers/history_driver.py``) against the JAX package's,
on ``device="cpu"``.

The classes of ``tests/test_history.py`` as differentials: each scenario
runs once per package over its own directories with one pinned service
clock, makes the reference test's own assertions on its side, and
returns what it observed — ``read_at`` at every seq, summary-record
handles and records (the store is content-addressed, so equal handles
are equal bytes), the ``hp`` WAL records' bytes, every spill and store
file's bytes, the storm snapshot's ``history`` field, map planes, acks,
sequencer checkpoints and ``stats``. The two records must be equal. Each
side also ``recover()``s the other side's directories.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
import shutil
import struct
from types import SimpleNamespace

import numpy as np
import pytest

from fluidframework_tpu.drivers import history_driver as j_drv
from fluidframework_tpu.server import durable_store as j_ds
from fluidframework_tpu.server import history as j_hist
from fluidframework_tpu.server import kernel_host as j_kh
from fluidframework_tpu.server import merge_host as j_mh
from fluidframework_tpu.server import residency as j_res
from fluidframework_tpu.server import riddler as j_rid
from fluidframework_tpu.server import routerlicious as j_rl
from fluidframework_tpu.server import storm as j_storm
from fluidframework_tpu_torch.drivers import history_driver as t_drv
from fluidframework_tpu_torch.server import durable_store as t_ds
from fluidframework_tpu_torch.server import history as t_hist
from fluidframework_tpu_torch.server import kernel_host as t_kh
from fluidframework_tpu_torch.server import merge_host as t_mh
from fluidframework_tpu_torch.server import residency as t_res
from fluidframework_tpu_torch.server import riddler as t_rid
from fluidframework_tpu_torch.server import routerlicious as t_rl
from fluidframework_tpu_torch.server import storm as t_storm

PKG = {
    "jax": SimpleNamespace(ds=j_ds, hist=j_hist, kh=j_kh, mh=j_mh,
                           res=j_res, rid=j_rid, rl=j_rl, storm=j_storm,
                           drv=j_drv, dev={}),
    "torch": SimpleNamespace(ds=t_ds, hist=t_hist, kh=t_kh, mh=t_mh,
                             res=t_res, rid=t_rid, rl=t_rl, storm=t_storm,
                             drv=t_drv, dev={"device": "cpu"}),
}
SIDES = ("jax", "torch")
K = 8


def host(a) -> np.ndarray:
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def stack(side, root, residency=False, spill=True, **hist_kw):
    """The reference test's ``_stack`` on one side, with a pinned clock."""
    P = PKG[side]
    seq_host = P.kh.KernelSequencerHost(num_slots=2, initial_capacity=8,
                                        **P.dev)
    merge_host = P.mh.KernelMergeHost(flush_threshold=10**9, **P.dev)
    service = P.rl.RouterliciousService(merge_host=merge_host,
                                        batched_deli_host=seq_host,
                                        auto_pump=False,
                                        idle_check_interval=10**9)
    service._clock = itertools.count(1000, 7).__next__
    kw: dict = {}
    if spill:
        kw.update(spill_dir=str(root / "spill"), durability="group")
    storm = P.storm.StormController(
        service, seq_host, merge_host, flush_threshold_docs=10**9,
        pipeline_depth=0, snapshots=P.ds.GitSnapshotStore(str(root / "git")),
        **kw)
    hist = P.hist.HistoryPlane(storm, **hist_kw)
    res = None
    if residency:
        res = P.res.ResidencyManager(storm, idle_evict_s=1e9,
                                     hydration_rate_per_s=1e9)
    return SimpleNamespace(side=side, P=P, root=root, service=service,
                           storm=storm, hist=hist, res=res, seq=seq_host,
                           merge=merge_host, acks=[])


def close(s):
    if s.storm._group_wal is not None:
        s.storm._group_wal.close()


def words(seed, r, i, k=K, clears=True):
    rng = np.random.default_rng([seed, r, i])
    kinds = rng.choice([0, 0, 0, 1, 2] if clears else [0, 0, 0, 1],
                       size=k).astype(np.uint32)
    slots = rng.integers(0, 16, k).astype(np.uint32)
    vals = rng.integers(0, 1 << 20, k).astype(np.uint32)
    return (kinds | (slots << 2) | (vals << 12)).astype(np.uint32)


def sink(s):
    def push(p):
        if hasattr(p, "rows"):
            s.acks.append([repr(p.get("rid")), host(p.rows).tolist()])
        else:  # a nack; its dw is thread-timed
            s.acks.append({k: repr(v) for k, v in p.items() if k != "dw"})
    return push


def submit(s, doc, client, cseq, ref, w, rid):
    s.storm.submit_frame(sink(s), {"rid": rid,
                                   "docs": [[doc, client, cseq, ref, K]]},
                         memoryview(w.tobytes()))
    s.storm.flush()


def serve(s, docs, rounds, seed=7, clears=True, checkpoint_first=True):
    clients = {d: s.service.connect(d, lambda m: None).client_id
               for d in docs}
    s.service.pump()
    if checkpoint_first and s.storm.snapshots is not None:
        s.storm.checkpoint()
    for r in range(rounds):
        for i, d in enumerate(docs):
            s.storm.submit_frame(
                sink(s), {"rid": (r, d),
                          "docs": [[d, clients[d], 1 + r * K, 1, K]]},
                memoryview(words(seed, r, i, clears=clears).tobytes()))
        s.storm.flush()
    return clients


def naive_prefixes(s, doc):
    """{seq: entries after the ops through seq} from the materialized
    delta stream — the reference fold ``read_at`` must match."""
    by_seq = {}
    for m in s.service.get_deltas(doc, 0):
        if int(m.type) == 8:  # MessageType.OPERATION
            by_seq[m.sequence_number] = m.contents["contents"]["contents"]
    head = max(by_seq, default=0)
    state: dict = {}
    out = {0: {}}
    for q in range(1, head + 1):
        c = by_seq.get(q)
        if c is not None:
            if c["type"] == "set":
                state[c["key"]] = c["value"]
            elif c["type"] == "delete":
                state.pop(c["key"], None)
            else:
                state.clear()
        out[q] = dict(state)
    return out


def entries(s, doc):
    return s.merge.map_entries(doc, s.storm.datastore, s.storm.channel)


def planes(s, doc):
    ckey = s.P.mh.ChannelKey(doc, s.storm.datastore, s.storm.channel)
    row = s.merge._map_rows[ckey].row
    xs = s.merge._xstate
    return {f: host(getattr(xs, f))[row].tolist()
            for f in ("present", "value", "vseq", "cleared_seq")}


def checkpoint_of(s, doc):
    cp = dataclasses.asdict(s.seq.checkpoint(doc))
    for c in cp["clients"]:
        c["last_update"] = 0  # arrival clock, not replica state
    return cp


def read_all(s, doc, lo=0, hi=None):
    """``read_at`` at every seq in [lo, hi] (the head by default); a
    refused read records its error class."""
    hi = s.hist.head_seq(doc) if hi is None else hi
    out = {}
    for q in range(lo, hi + 1):
        try:
            out[q] = s.hist.read_at(doc, q)
        except s.P.hist.HistoryError:
            out[q] = "HistoryError"
    return out


def summary(s, doc):
    key = s.P.hist.HIST_KEY_PREFIX + doc
    handle = s.storm.snapshots.head(key)
    return handle, (s.storm.snapshots.get(key, handle)
                    if handle is not None else None)


def hp_records(s):
    """Raw bytes of every ``hp`` control record in the WAL, by tick."""
    out = {}
    for t in range(s.storm._tick_counter):
        try:
            blob = s.storm._read_blob(t)
        except Exception:
            continue
        (n,) = struct.unpack_from("<I", blob, 0)
        header = json.loads(blob[4:4 + n])
        if header.get("hp") is not None:
            out[t] = blob.hex()
    return out


def files(s):
    """sha256 of every file the stack wrote (spill WAL, snapshot store)."""
    out = {}
    for base, _dirs, names in os.walk(s.root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, s.root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def storm_snapshot(s):
    head = s.storm.snapshots.head(s.P.storm.StormController.SNAPSHOT_DOC)
    snap = s.storm.snapshots.get(s.P.storm.StormController.SNAPSHOT_DOC,
                                 head)
    return None if snap is None else snap.get("history")


def finish(s, docs, rec):
    """Common tail of every record: planes, checkpoints, acks, stats,
    summaries, hp records, files."""
    rec["entries"] = {d: entries(s, d) for d in docs}
    rec["checkpoints"] = {d: checkpoint_of(s, d) for d in docs}
    rec["summaries"] = {d: summary(s, d) for d in docs}
    rec["acks"] = s.acks
    rec["hist_stats"] = dict(s.hist.stats)
    rec["hp"] = hp_records(s)
    rec["snapshot_history"] = storm_snapshot(s)
    close(s)
    rec["files"] = files(s)
    return rec


def both(tmp_path, fn):
    recs = {side: fn(side, tmp_path / side) for side in SIDES}
    assert recs["torch"] == recs["jax"]
    return recs["torch"]


def raises(fn, exc):
    try:
        fn()
    except exc as err:
        return type(err).__name__
    return None


# -- time travel ---------------------------------------------------------------


def _every_seq(side, root):
    s = stack(side, root)
    serve(s, ["d0"], rounds=6)
    ref = naive_prefixes(s, "d0")
    head = s.hist.head_seq("d0")
    assert head == max(ref)
    reads = read_all(s, "d0")
    for q in range(head + 1):
        assert reads[q]["entries"] == ref[q], q
    assert reads[head]["entries"] == entries(s, "d0")
    rec = {"reads": reads, "planes": planes(s, "d0")}
    return finish(s, ["d0"], rec)


def _cold_reads(side, root):
    s = stack(side, root, residency=True)
    serve(s, ["d0"], rounds=4)
    ref = naive_prefixes(s, "d0")
    head = s.hist.head_seq("d0")
    handle = s.res.evict("d0")
    assert not s.res.is_resident("d0")
    before = s.res.stats["hydrations"]
    reads = {q: s.hist.read_at("d0", q) for q in (1, head // 2, head)}
    for q, got in reads.items():
        assert got["entries"] == ref[q]
    assert not s.res.is_resident("d0")
    assert s.res.stats["hydrations"] == before
    rec = {"reads": reads, "cold_handle": handle,
           "res_stats": dict(s.res.stats)}
    s.res.ensure_resident("d0", gate=False)
    return finish(s, ["d0"], rec)


def _beyond_and_below(side, root):
    s = stack(side, root, tail_retention_summaries=0)
    serve(s, ["d0"], rounds=4)
    head = s.hist.head_seq("d0")
    rec = {"beyond": raises(lambda: s.hist.read_at("d0", head + 1),
                            s.P.hist.HistoryError)}
    s.storm.checkpoint()
    rec["handle"] = s.hist.compact("d0")
    assert rec["handle"] is not None
    assert s.hist.tail_floor("d0") == head
    assert s.hist.read_at("d0", head)["entries"]
    rec["below"] = raises(lambda: s.hist.read_at("d0", head - 1),
                          s.P.hist.HistoryError)
    assert rec["beyond"] == rec["below"] == "HistoryError"
    rec["reads"] = read_all(s, "d0")
    return finish(s, ["d0"], rec)


class TestTimeTravel:
    def test_materialize_at_n_equals_replay_to_n_every_seq(self,
                                                           tmp_path):
        both(tmp_path, _every_seq)

    def test_read_at_serves_cold_docs_without_hydrating(self, tmp_path):
        both(tmp_path, _cold_reads)

    def test_read_beyond_head_and_below_floor(self, tmp_path):
        both(tmp_path, _beyond_and_below)


# -- compaction ----------------------------------------------------------------


def _compacted_vs_twin(side, root):
    a = stack(side, root / "a", tail_retention_summaries=1)
    b = stack(side, root / "b")
    serve(a, ["d0"], rounds=6)
    serve(b, ["d0"], rounds=6)
    a.storm.checkpoint()
    mid = a.hist.compact("d0")
    assert mid is not None
    for r in range(6, 9):
        for x in (a, b):
            submit(x, "d0", "client-1", 1 + r * K, 1, words(7, r, 0), r)
    a.storm.checkpoint()
    assert a.hist.compact("d0") is not None
    trimmed = a.hist.trim_now()
    floor = a.hist.tail_floor("d0")
    assert floor > 0
    head = a.hist.head_seq("d0")
    assert head == b.hist.head_seq("d0")
    for q in range(floor, head + 1):
        assert a.hist.read_at("d0", q) == b.hist.read_at("d0", q), q
    chain_seq = a.hist.summary_seq("d0")
    assert a.hist.read_at("d0", chain_seq) == b.hist.read_at("d0",
                                                             chain_seq)
    rec = {"mid": mid, "trimmed": trimmed, "floor": floor,
           "reads_a": read_all(a, "d0"), "reads_b": read_all(b, "d0")}
    rec["b"] = finish(b, ["d0"], {})
    return finish(a, ["d0"], rec)


def _trim_and_restart(side, root):
    s = stack(side, root, tail_retention_summaries=0, trim_batch_ticks=1)
    serve(s, ["d0", "d1"], rounds=6)
    s.storm.checkpoint()
    spill = root / "spill" / "storm_tick_words.log"
    before = os.path.getsize(spill)
    assert s.hist.compact("d0") and s.hist.compact("d1")
    assert s.hist.trim_now() == 0
    assert s.hist.stats["trimmed_ticks"] > 0
    after = os.path.getsize(spill)
    assert after < before, (before, after)
    live = {d: entries(s, d) for d in ("d0", "d1")}
    live_reads = {d: s.hist.read_at(d, s.hist.head_seq(d))
                  for d in ("d0", "d1")}
    live_planes = {d: planes(s, d) for d in ("d0", "d1")}
    rec = finish(s, ["d0", "d1"], {"spill": (before, after)})
    s2 = stack(side, root)
    rec["info"] = s2.storm.recover()
    for d in ("d0", "d1"):
        assert entries(s2, d) == live[d]
        assert s2.hist.read_at(d, s2.hist.head_seq(d)) == live_reads[d]
        assert planes(s2, d) == live_planes[d]
    rec["recovered"] = {d: read_all(s2, d) for d in ("d0", "d1")}
    close(s2)
    return rec


def _cadence(side, root):
    s = stack(side, root, summary_interval_ops=2 * K,
              compact_check_every=1)
    serve(s, ["d0"], rounds=6)
    assert s.hist.stats["compactions"] >= 1
    assert s.hist.summary_seq("d0") > 0
    head = s.hist.head_seq("d0")
    assert s.hist.read_at("d0", head)["entries"] == entries(s, "d0")
    rec = {"reads": read_all(s, "d0"), "planes": planes(s, "d0"),
           "summary_seq": s.hist.summary_seq("d0")}
    return finish(s, ["d0"], rec)


def _quarantined(side, root):
    s = stack(side, root, tail_retention_summaries=0, trim_batch_ticks=1)
    serve(s, ["d0"], rounds=4)
    s.storm.checkpoint()
    assert s.hist.compact("d0")
    expect = entries(s, "d0")
    got = s.storm.quarantined_map_entries("d0")
    assert got == expect
    return finish(s, ["d0"], {"quarantined": got})


class TestCompaction:
    def test_compacted_reads_match_never_compacted_twin(self, tmp_path):
        both(tmp_path, _compacted_vs_twin)

    def test_trim_shrinks_spill_and_survives_restart(self, tmp_path):
        both(tmp_path, _trim_and_restart)

    def test_maybe_compact_cadence_rolls_long_tails(self, tmp_path):
        both(tmp_path, _cadence)

    def test_quarantined_read_path_survives_trim(self, tmp_path):
        both(tmp_path, _quarantined)


# -- branches ------------------------------------------------------------------


def _fork_planes(side, root):
    s = stack(side, root, spill=False)
    clients = serve(s, ["d0"], rounds=3, checkpoint_first=False)
    at_n = planes(s, "d0")
    seq_n = s.seq.checkpoint("d0").sequence_number
    for r in range(3, 6):
        submit(s, "d0", clients["d0"], 1 + r * K, 1, words(7, r, 0), r)
    branch = s.hist.fork("d0", seq_n, name="b0")
    assert planes(s, branch) == at_n
    cp = s.seq.checkpoint(branch)
    assert cp.sequence_number == seq_n
    assert s.hist.read_at(branch, seq_n)["entries"] == \
        s.hist.read_at("d0", seq_n)["entries"]
    rec = {"branch": branch, "at_n": at_n, "planes": planes(s, branch),
           "reads": read_all(s, branch)}
    return finish(s, ["d0", branch], rec)


def _branch_reads(side, root):
    s = stack(side, root)
    serve(s, ["d0"], rounds=4)
    ref = naive_prefixes(s, "d0")
    branch = s.hist.fork("d0", 17, name="b0")
    for q in (1, 9, 17):
        assert s.hist.read_at(branch, q)["entries"] == ref[q]
    assert s.hist.branch_info(branch) == {"parent": "d0", "seq": 17,
                                          "name": "b0"}
    rec = {"reads": read_all(s, branch), "planes": planes(s, branch)}
    return finish(s, ["d0", branch], rec)


def _residency_citizen(side, root):
    s = stack(side, root, residency=True)
    serve(s, ["d0"], rounds=3)
    branch = s.hist.fork("d0", 13, name="b0")
    rec = {"resident_at_fork": s.res.is_resident(branch)}
    seed = s.hist.read_at(branch, 13)["entries"]
    rec["resident_after_read"] = s.res.is_resident(branch)
    client = s.service.connect(branch, lambda m: None).client_id
    s.service.pump()
    rec["resident_after_connect"] = s.res.is_resident(branch)
    assert entries(s, branch) == seed
    rec["hydrated_planes"] = planes(s, branch)
    submit(s, branch, client, 1, 14, words(11, 0, 0), "bw")
    head = s.hist.head_seq(branch)
    assert head > 14
    assert s.hist.read_at(branch, head)["entries"] == entries(s, branch)
    rec["served_planes"] = planes(s, branch)
    rec["evicted"] = s.res.evict(branch)
    assert s.hist.read_at(branch, head)["entries"]
    assert not rec["resident_at_fork"] and not rec["resident_after_read"]
    assert rec["resident_after_connect"]
    rec["reads"] = read_all(s, branch)
    rec["res_stats"] = dict(s.res.stats)
    s.res.ensure_resident(branch, gate=False)
    return finish(s, ["d0", branch], rec)


def _fork_replays(side, root):
    s = stack(side, root)
    serve(s, ["d0"], rounds=4)
    branch = s.hist.fork("d0", 17, name="b0", writer="w0")
    submit(s, branch, "w0", 1, 17, words(11, 0, 0), "bw")
    live_map = entries(s, branch)
    live_cp = checkpoint_of(s, branch)
    live_planes = planes(s, branch)
    rec = finish(s, ["d0", branch], {"live_planes": live_planes})
    s2 = stack(side, root)
    rec["info"] = s2.storm.recover()
    assert s2.hist.branch_info(branch) == {"parent": "d0", "seq": 17,
                                           "name": "b0"}
    assert entries(s2, branch) == live_map
    assert checkpoint_of(s2, branch) == live_cp
    assert planes(s2, branch) == live_planes
    rec["recovered_reads"] = read_all(s2, branch)
    close(s2)
    return rec


def _fork_refusals(side, root):
    s = stack(side, root)
    serve(s, ["d0"], rounds=2)
    s.hist.fork("d0", 9, name="b0")
    rec = {"taken": raises(lambda: s.hist.fork("d0", 9, name="b0"),
                           ValueError),
           "self": raises(lambda: s.hist.fork("d0", 5, name="d0"),
                          ValueError),
           "beyond": raises(lambda: s.hist.fork("d0", 10**6, name="b1"),
                            s.P.hist.HistoryError)}
    assert rec == {"taken": "ValueError", "self": "ValueError",
                   "beyond": "HistoryError"}
    return finish(s, ["d0", "b0"], rec)


class TestBranches:
    def test_fork_seeds_byte_identical_planes(self, tmp_path):
        both(tmp_path, _fork_planes)

    def test_branch_reads_below_fork_delegate_to_parent(self, tmp_path):
        both(tmp_path, _branch_reads)

    def test_branch_is_full_residency_citizen(self, tmp_path):
        both(tmp_path, _residency_citizen)

    def test_fork_control_replays_identically(self, tmp_path):
        both(tmp_path, _fork_replays)

    def test_fork_rejects_colliding_and_out_of_range(self, tmp_path):
        both(tmp_path, _fork_refusals)


# -- merge back ----------------------------------------------------------------


def _merge_scenario(side, root):
    s = stack(side, root)
    clients = serve(s, ["d0"], rounds=3)
    branch = s.hist.fork("d0", 1 + 3 * K, name="b0", writer="w0")
    for r in range(3, 5):
        s.storm.submit_frame(
            sink(s), {"rid": r,
                      "docs": [["d0", clients["d0"], 1 + r * K, 1, K]]},
            memoryview(words(7, r, 0).tobytes()))
        rb = r - 3
        s.storm.submit_frame(
            sink(s), {"rid": ("b", r),
                      "docs": [[branch, "w0", 1 + rb * K, 1 + 3 * K, K]]},
            memoryview(words(19, r, 0).tobytes()))
        s.storm.flush()
    report = s.hist.merge_back(branch)
    final = entries(s, "d0")
    head = s.hist.head_seq("d0")
    at_head = s.hist.read_at("d0", head)
    assert report["merged_ops"] == 2 * K
    assert at_head["entries"] == final
    rec = {"report": report, "at_head": at_head, "planes": planes(s, "d0"),
           "reads": read_all(s, "d0")}
    return finish(s, ["d0", branch], rec)


def _merge_noop(side, root):
    s = stack(side, root)
    serve(s, ["d0"], rounds=2)
    branch = s.hist.fork("d0", 9, name="b0")
    before = s.seq.checkpoint("d0").sequence_number
    report = s.hist.merge_back(branch)
    assert report["merged_ops"] == 0
    assert s.seq.checkpoint("d0").sequence_number == before
    return finish(s, ["d0", branch], {"report": report})


class TestMergeBack:
    def test_merge_back_resequences_through_ordinary_path(self, tmp_path):
        both(tmp_path, _merge_scenario)

    def test_merge_back_deterministic_under_concurrent_writes(
            self, tmp_path):
        """Two runs of the port and one of JAX converge identically (the
        files too: a fresh service clock each run)."""
        a = _merge_scenario("torch", tmp_path / "a")
        b = _merge_scenario("torch", tmp_path / "b")
        j = _merge_scenario("jax", tmp_path / "j")
        assert a == b == j

    def test_merge_back_of_unwritten_branch_is_noop(self, tmp_path):
        both(tmp_path, _merge_noop)


# -- service surface -----------------------------------------------------------


def _driver_surface(side, root):
    s = stack(side, root)
    serve(s, ["d0"], rounds=3)
    ref = naive_prefixes(s, "d0")
    svc = s.P.drv.HistoricalDocumentService(s.service, "d0", seq=9)
    assert svc.entries() == ref[9]
    assert svc.read_at(5)["entries"] == ref[5]
    deltas = svc.get_deltas(0)
    assert max(m.sequence_number for m in deltas) <= 9
    br = svc.fork(name="b0")
    assert s.hist.is_branch(br.doc_id)
    assert br.entries() == ref[9]
    with pytest.raises(TypeError):
        br.connect(lambda m: None)
    report = br.merge_back()
    assert report["merged_ops"] == 0
    rec = {"deltas": [(m.sequence_number, m.client_sequence_number)
                      for m in deltas],
           "branch": br.doc_id, "report": report,
           "service_read": s.service.read_at("d0", 7),
           "head": svc.head_seq()}
    return finish(s, ["d0", br.doc_id], rec)


def _requires_snapshots(side, root):
    P = PKG[side]
    seq_host = P.kh.KernelSequencerHost(num_slots=2, initial_capacity=4,
                                        **P.dev)
    merge_host = P.mh.KernelMergeHost(flush_threshold=10**9, **P.dev)
    service = P.rl.RouterliciousService(merge_host=merge_host,
                                        batched_deli_host=seq_host,
                                        auto_pump=False,
                                        idle_check_interval=10**9)
    storm = P.storm.StormController(service, seq_host, merge_host,
                                    flush_threshold_docs=10**9)
    with pytest.raises(ValueError) as err:
        P.hist.HistoryPlane(storm, snapshots=None)
    # Without a plane the service's history routes refuse alike.
    with pytest.raises(RuntimeError) as err2:
        service.read_at("d0", 0)
    return [str(err.value), str(err2.value)]


class TestServiceSurface:
    def test_routerlicious_and_driver_surface(self, tmp_path):
        both(tmp_path, _driver_surface)

    def test_history_plane_requires_snapshots(self, tmp_path):
        both(tmp_path, _requires_snapshots)


# -- re-anchoring and pins -----------------------------------------------------


def _reanchor(side, root):
    s = stack(side, root / "a", chain_reanchor_depth=4)
    t = stack(side, root / "b")
    serve(s, ["d0"], rounds=1)
    serve(t, ["d0"], rounds=1)
    handles = [s.hist.compact("d0")]
    seqs = [s.hist.summary_seq("d0")]
    for r in range(1, 10):
        for x in (s, t):
            submit(x, "d0", "client-1", 1 + r * K, 1, words(7, r, 0), r)
        handles.append(s.hist.compact("d0"))
        seqs.append(s.hist.summary_seq("d0"))
    assert all(handles)
    rec_head = s.hist._summary_record("d0")
    assert len(rec_head["chain"]) <= 4
    assert rec_head["anchor"]["handle"]
    assert s.hist.stats["reanchors"] >= 2
    for q in seqs:
        assert s.hist.read_at("d0", q) == t.hist.read_at("d0", q), q
    rec = {"handles": handles, "seqs": seqs, "head_record": rec_head,
           "reads": read_all(s, "d0")}
    rec["twin"] = finish(t, ["d0"], {})
    return finish(s, ["d0"], rec)


def _reanchor_off(side, root):
    s = stack(side, root, chain_reanchor_depth=None)
    serve(s, ["d0"], rounds=1)
    handles = []
    for r in range(6):
        if r:
            submit(s, "d0", "client-1", 1 + r * K, 1, words(7, r, 0), r)
        handles.append(s.hist.compact("d0"))
    assert all(handles)
    head = s.hist._summary_record("d0")
    assert len(head["chain"]) == 5 and "anchor" not in head
    assert s.hist.stats["reanchors"] == 0
    return finish(s, ["d0"], {"handles": handles, "head_record": head})


def _pins(side, root):
    s = stack(side, root / "a", tail_retention_summaries=0,
              trim_batch_ticks=10**9)
    t = stack(side, root / "b")
    serve(s, ["d0"], rounds=4)
    serve(t, ["d0"], rounds=4)
    s.storm.checkpoint()
    pin = s.hist.pin_range("tenant-a", "d0", 5, 20)
    assert s.hist.compact("d0")
    rec = {"pin": pin, "trimmed_1": s.hist.trim_now(),
           "floor_1": s.hist.tail_floor("d0")}
    assert rec["floor_1"] <= 5
    for q in (5, 12, 20):
        assert s.hist.read_at("d0", q) == t.hist.read_at("d0", q), q
    before = s.hist.stats["trimmed_ticks"]
    assert s.hist.unpin_range("tenant-a", "d0")
    assert not s.hist.unpin_range("tenant-a", "d0")
    for r in (4, 5):
        for x in (s, t):
            submit(x, "d0", "client-1", 1 + r * K, 1, words(7, r, 0), r)
    s.storm.checkpoint()
    assert s.hist.compact("d0")
    rec["trimmed_2"] = s.hist.trim_now()
    assert s.hist.stats["trimmed_ticks"] > before
    rec["floor_2"] = s.hist.tail_floor("d0")
    assert rec["floor_2"] > 5
    rec["reads"] = read_all(s, "d0")
    rec["twin"] = finish(t, ["d0"], {})
    return finish(s, ["d0"], rec)


def _pins_gated(side, root):
    tm = PKG[side].rid.TenantManager()
    tm.create_tenant("pro-t", tier="pro")
    tm.create_tenant("free-t", tier="free")
    tm.create_tenant("std-t", tier="standard")
    s = stack(side, root, tenant_source=tm)
    serve(s, ["d0"], rounds=2)
    rec = {t: raises(lambda t=t: s.hist.pin_range(t, "d0", 1, 8),
                     s.P.hist.HistoryError)
           for t in ("free-t", "std-t", "no-such-tenant")}
    assert set(rec.values()) == {"HistoryError"}
    assert s.hist.stats["pins"] == 0
    rec["pin"] = s.hist.pin_range("pro-t", "d0", 1, 8)
    assert rec["pin"] == {"tenant": "pro-t", "doc": "d0", "lo": 1, "hi": 8}
    assert s.hist.stats["pins"] == 1
    rec["inverted"] = raises(lambda: s.hist.pin_range("pro-t", "d0", 9, 2),
                             ValueError)
    assert rec["inverted"] == "ValueError"
    return finish(s, ["d0"], rec)


def _pins_replay(side, root):
    s = stack(side, root)
    serve(s, ["d0"], rounds=2)
    s.hist.pin_range("tenant-a", "d0", 3, 9)
    s.hist.pin_range("tenant-b", "d0", 1, 4)
    s.hist.unpin_range("tenant-b", "d0")
    rec = finish(s, ["d0"], {})
    s2 = stack(side, root)
    rec["info"] = s2.storm.recover()
    assert s2.hist.pins == {("tenant-a", "d0"): (3, 9)}
    rec["pins"] = sorted(s2.hist.pins.items())
    close(s2)
    return rec


class TestReanchorAndPins:
    def test_chain_reanchors_past_depth_cap(self, tmp_path):
        both(tmp_path, _reanchor)

    def test_reanchor_disabled_keeps_unbounded_chain(self, tmp_path):
        both(tmp_path, _reanchor_off)

    def test_pin_blocks_trim_then_unpin_releases(self, tmp_path):
        both(tmp_path, _pins)

    def test_pins_gated_on_riddler_paid_tier(self, tmp_path):
        both(tmp_path, _pins_gated)

    def test_pins_replay_through_recovery(self, tmp_path):
        both(tmp_path, _pins_replay)


# -- the snapshot's history field and cross-recovery ---------------------------


def _checkpointed_branches(side, root):
    """Forks on both sides of a checkpoint (the snapshot's ``history``
    field carries the first; the WAL tail's ``hp`` control the second),
    pins, compaction and trim, branch frames past the checkpoint."""
    s = stack(side, root, tail_retention_summaries=1, trim_batch_ticks=1)
    serve(s, ["d0", "d1"], rounds=4)
    b0 = s.hist.fork("d0", 17, name="b0", writer="w0")
    submit(s, b0, "w0", 1, 17, words(11, 0, 0), "b0w")
    s.hist.pin_range("tenant-a", "d1", 2, 12)
    s.storm.checkpoint()
    assert s.hist.compact("d1") is not None
    b1 = s.hist.fork("d1", 25, name="b1", writer="w1")
    submit(s, b1, "w1", 1, 25, words(13, 0, 0), "b1w")
    submit(s, b0, "w0", 1 + K, 17, words(11, 1, 0), "b0w2")
    docs = ["d0", "d1", b0, b1]
    live = {"entries": {d: entries(s, d) for d in docs},
            "planes": {d: planes(s, d) for d in docs},
            "checkpoints": {d: checkpoint_of(s, d) for d in docs},
            "reads": {d: read_all(s, d) for d in docs},
            "branches": s.hist.export_state()}
    rec = finish(s, docs, {"live": live})
    assert rec["snapshot_history"]["branches"] == {
        "b0": {"parent": "d0", "seq": 17, "name": "b0"}}
    assert len(rec["hp"]) == 3  # fork, pin, fork
    return rec


def test_snapshot_history_field_and_hp_bytes_equal_jax(tmp_path):
    both(tmp_path, _checkpointed_branches)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_each_side_recovers_the_others_history(tmp_path, writer, reader):
    rec = _checkpointed_branches(writer, tmp_path / "w")
    live = rec["live"]
    shutil.copytree(tmp_path / "w", tmp_path / "r")
    s = stack(reader, tmp_path / "r", tail_retention_summaries=1,
              trim_batch_ticks=1)
    info = s.storm.recover()
    assert info["restored_from"] is not None
    assert s.hist.export_state() == live["branches"]
    for d in live["entries"]:
        assert entries(s, d) == live["entries"][d], d
        assert planes(s, d) == live["planes"][d], d
        assert checkpoint_of(s, d) == live["checkpoints"][d], d
        assert read_all(s, d) == live["reads"][d], d
    close(s)
