"""Tiered hot/cold residency of the port (``server/residency.py`` and the
storm's residency hooks) against the JAX package's, on ``device="cpu"``.

The classes of ``tests/test_residency.py`` as differentials: each
scenario runs once per package over its own directories with a pinned
service clock and returns what it observed — planes, sequencer
checkpoints, acks and nacks, ``stats``, cold-snapshot handles (the store
is content-addressed, so equal handles are equal snapshot bytes), store
file counts, refusals — and the two records must be equal. The cold
store is also crossed: each side hydrates and ``recover()``s the other's
directories.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

from fluidframework_tpu.ops import sequencer as j_seqk
from fluidframework_tpu.server import durable_store as j_ds
from fluidframework_tpu.server import kernel_host as j_kh
from fluidframework_tpu.server import megadoc as j_mg
from fluidframework_tpu.server import merge_host as j_mh
from fluidframework_tpu.server import residency as j_res
from fluidframework_tpu.server import routerlicious as j_rl
from fluidframework_tpu.server import storm as j_storm
from fluidframework_tpu.tools import chaos as j_chaos
from fluidframework_tpu_torch.ops import sequencer as t_seqk
from fluidframework_tpu_torch.server import durable_store as t_ds
from fluidframework_tpu_torch.server import kernel_host as t_kh
from fluidframework_tpu_torch.server import megadoc as t_mg
from fluidframework_tpu_torch.server import merge_host as t_mh
from fluidframework_tpu_torch.server import residency as t_res
from fluidframework_tpu_torch.server import routerlicious as t_rl
from fluidframework_tpu_torch.server import storm as t_storm
from fluidframework_tpu_torch.tools import chaos as t_chaos

PKG = {
    "jax": SimpleNamespace(ds=j_ds, kh=j_kh, mh=j_mh, res=j_res, rl=j_rl,
                           storm=j_storm, chaos=j_chaos, mg=j_mg,
                           seqk=j_seqk, dev={}),
    "torch": SimpleNamespace(ds=t_ds, kh=t_kh, mh=t_mh, res=t_res,
                             rl=t_rl, storm=t_storm, chaos=t_chaos,
                             mg=t_mg, seqk=t_seqk, dev={"device": "cpu"}),
}
SIDES = ("jax", "torch")
K = 8


def host(a) -> np.ndarray:
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def build_stack(side, root, num_docs=4, residency=True, clock=None,
                storm_kw=None, **res_kw):
    """The reference test's stack (durable bus + store, group WAL, git
    snapshots) on one side, with a pinned service clock."""
    P = PKG[side]
    seq_host = P.kh.KernelSequencerHost(num_slots=2,
                                        initial_capacity=num_docs, **P.dev)
    merge_host = P.mh.KernelMergeHost(flush_threshold=10**9, **P.dev)
    service = P.rl.RouterliciousService(
        bus=P.ds.DurableMessageBus(str(root / "bus")),
        store=P.ds.FileStateStore(str(root / "state")),
        merge_host=merge_host, batched_deli_host=seq_host,
        auto_pump=False, idle_check_interval=10**9)
    service._clock = itertools.count(1000, 7).__next__
    storm = P.storm.StormController(
        service, seq_host, merge_host, flush_threshold_docs=10**9,
        spill_dir=str(root / "spill"), durability="group",
        snapshots=P.ds.GitSnapshotStore(root / "git"),
        **(storm_kw or {}))
    res = None
    if residency:
        kw = dict(idle_evict_s=1e9, hydration_rate_per_s=1e9)
        kw.update(res_kw)
        if clock is not None:
            kw["clock"] = clock
        res = P.res.ResidencyManager(storm, **kw)
    return SimpleNamespace(side=side, P=P, service=service, storm=storm,
                           seq=seq_host, merge=merge_host, res=res)


def tick_words(seed, k=K):
    rng = np.random.default_rng(seed)
    kinds = rng.choice([0, 0, 0, 1, 2], size=k).astype(np.uint32)
    slots = rng.integers(0, 16, k).astype(np.uint32)
    vals = rng.integers(0, 1 << 20, k).astype(np.uint32)
    return (kinds | (slots << 2) | (vals << 12)).astype(np.uint32)


def set_words(r, k=K):
    slots = np.arange(k, dtype=np.uint32)
    vals = np.arange(1 + r * k, 1 + (r + 1) * k, dtype=np.uint32)
    return (slots << np.uint32(2)) | (vals << np.uint32(12))


def drive(s, doc, client, r, k=K, push=None, rid=None, words=None):
    payload = (words if words is not None
               else tick_words((zlib.crc32(doc.encode()) & 0xFFFF, r),
                               k)).tobytes()
    s.storm.submit_frame(push,
                         {"rid": r if rid is None else rid,
                          "docs": [[doc, client, 1 + r * k, 1, k]]},
                         memoryview(payload))
    s.storm.flush()


def connect_docs(s, docs):
    clients = {d: s.service.connect(d, lambda m: None).client_id
               for d in docs}
    s.service.pump()
    return clients


def ack(payload) -> dict:
    return {k: payload[k] for k in payload.keys()}


def row_planes(s, doc) -> dict:
    ckey = s.P.mh.ChannelKey(doc, s.storm.datastore, s.storm.channel)
    row = s.merge._map_rows[ckey].row
    xs = s.merge._xstate
    return {f: host(getattr(xs, f))[row].tolist()
            for f in ("present", "value", "vseq", "cleared_seq")}


def digest(s, docs):
    return s.P.chaos._digest(s.service, s.storm, s.seq, s.merge, docs,
                             residency=s.res)


def close(s):
    if s.storm._group_wal is not None:
        s.storm._group_wal.close()


def both(tmp_path, fn):
    """Run ``fn(side, root)`` for each package; return both records."""
    out = [fn(side, tmp_path / side) for side in SIDES]
    return out


# -- lifecycle -----------------------------------------------------------------


def _lifecycle(side, root):
    s = build_stack(side, root)
    clients = connect_docs(s, ["a", "b"])
    for r in range(2):
        for d in ("a", "b"):
            drive(s, d, clients[d], r, words=set_words(r))
    rec = {"before": row_planes(s, "a"),
           "cp": dataclasses.asdict(s.seq.checkpoint("a"))}
    want_hist = [(m.sequence_number, m.client_sequence_number)
                 for m in s.service.get_deltas("a", 0)]
    handle = s.res.evict("a")
    ckey = s.P.mh.ChannelKey("a", s.storm.datastore, s.storm.channel)
    rec.update(handle=handle, resident=s.res.is_resident("a"),
               rows_gone=("a" not in s.seq._rows
                          and ckey not in s.merge._map_rows),
               trimmed=("a" not in s.storm._doc_ticks
                        and "a" not in s.storm.doc_tick_counts),
               head=s.storm.snapshots.head(t_res.COLD_KEY_PREFIX + "a"))
    # A gap fetch on the cold doc reads its cold index, no hydration.
    rec["cold_read"] = [(m.sequence_number, m.client_sequence_number)
                        for m in s.service.get_deltas("a", 0)]
    rec["cold_read_ok"] = rec["cold_read"] == want_hist
    rec["still_cold"] = not s.res.is_resident("a")
    s.res.ensure_resident("a", gate=False)
    rec["after"] = row_planes(s, "a")
    rec["cp_after"] = dataclasses.asdict(s.seq.checkpoint("a"))
    acks = []
    drive(s, "a", clients["a"], 2, push=acks.append)
    rec["acks"] = [ack(a) for a in acks]
    # A cold connect hydrates (the document loads on connect).
    s.res.evict("b")
    s.service.connect("b", lambda m: None)
    rec["b_resident"] = s.res.is_resident("b")
    rec["stats"] = dict(s.res.stats)
    rec["storm_stats"] = dict(s.storm.stats)
    close(s)
    return rec


def test_lifecycle_evict_hydrate_rehydrate_matches_jax(tmp_path):
    j, t = both(tmp_path, _lifecycle)
    assert t == j
    assert t["handle"] and t["handle"] == t["head"]
    assert not t["resident"] and t["rows_gone"] and t["trimmed"]
    assert t["cold_read_ok"] and t["still_cold"]
    assert t["after"] == t["before"] and t["cp_after"] == t["cp"]
    assert max(t["before"]["vseq"]) > 0
    assert t["acks"] and not t["acks"][0].get("error")
    assert t["b_resident"] and t["stats"]["cold_hydrations"] == 2


def _rehydrate_twin(side, root):
    docs = ["a", "b", "c"]
    out = {}
    for name, kw in (("churn", dict(max_resident=1)),
                     ("twin", dict(residency=False))):
        s = build_stack(side, root / name, **kw)
        clients = connect_docs(s, docs)
        for r in range(4):
            for d in docs:
                drive(s, d, clients[d], r)
        out[name] = {"digest": digest(s, docs),
                     "stats": dict(s.res.stats) if s.res else None}
        close(s)
    return out


def test_rehydrate_equals_never_evicted_twin_and_jax(tmp_path):
    j, t = both(tmp_path, _rehydrate_twin)
    assert t == j
    assert t["churn"]["digest"] == t["twin"]["digest"]
    assert t["churn"]["stats"]["evictions"] >= 8
    assert t["churn"]["stats"]["cold_hydrations"] >= 8


def _idle_and_per_op(side, root):
    from fluidframework_tpu_torch.protocol.messages import (
        DocumentMessage, MessageType)
    clk = [0.0]
    s = build_stack(side, root, clock=lambda: clk[0], idle_evict_s=10.0)
    conn = s.service.connect("a", lambda m: None)
    clients = connect_docs(s, ["b"])
    s.service.pump()
    if side == "jax":
        from fluidframework_tpu.protocol.messages import (
            DocumentMessage, MessageType)

    def per_op(i):
        s.service.submit("a", conn.client_id, [DocumentMessage(
            type=MessageType.OPERATION, contents={"op": i},
            client_sequence_number=i, reference_sequence_number=1)])
        s.service.pump()

    rec = {}
    per_op(1)
    seq_before = s.seq.checkpoint("a").sequence_number
    clk[0] = 12.0
    per_op(2)
    # The per-op touch kept a hot; b (idle since its connect) evicts.
    rec["idle_first"] = s.res.evict_idle()
    drive(s, "b", clients["b"], 0)
    clk[0] = 40.0
    rec["idle_all"] = s.res.evict_idle()
    per_op(3)  # cold doc + per-op submit: hydrates tracked
    rec["a_resident"] = s.res.is_resident("a")
    rec["tracked"] = set(s.seq._rows) <= set(s.res.resident)
    rec["seq_grew"] = s.seq.checkpoint("a").sequence_number > seq_before
    s.service.disconnect("a", conn.client_id)
    s.service.pump()
    rec["after_leave"] = sorted(s.res.resident)
    rec["stats"] = dict(s.res.stats)
    rec["cp"] = dataclasses.asdict(s.seq.checkpoint("a"))
    close(s)
    return rec


def test_idle_eviction_and_per_op_hydration_match_jax(tmp_path):
    j, t = both(tmp_path, _idle_and_per_op)
    assert t == j
    assert t["idle_first"] == ["b"] and "a" in t["idle_all"]
    assert t["a_resident"] and t["tracked"] and t["seq_grew"]


def _recover(side, root):
    s = build_stack(side, root)
    clients = connect_docs(s, ["a", "b"])
    for r in range(2):
        for d in ("a", "b"):
            drive(s, d, clients[d], r)
    s.res.evict("a")
    s.storm.checkpoint()
    drive(s, "b", clients["b"], 2)  # a WAL tail past the checkpoint
    want = digest(s, ["a", "b"])
    close(s)
    s2 = build_stack(side, root)
    info = s2.storm.recover()
    rec = {"info": info, "want": want,
           "b_hot": s2.res.is_resident("b"),
           "a_cold": not s2.res.is_resident("a"),
           "a_trimmed": "a" not in s2.storm._doc_ticks}
    rec["got"] = digest(s2, ["a", "b"])
    rec["stats"] = dict(s2.res.stats)
    close(s2)
    return rec


def test_recover_trims_cold_docs_and_rehydrates_like_jax(tmp_path):
    j, t = both(tmp_path, _recover)
    assert t == j
    assert t["info"]["restored_from"] is not None
    assert t["b_hot"] and t["a_cold"] and t["a_trimmed"]
    assert t["got"] == t["want"]
    assert t["stats"]["cold_hydrations"] >= 1


def _replay_hydrates(side, root):
    """A doc cold at the checkpoint and served after it: the recovery's
    WAL replay hydrates it on first touch."""
    s = build_stack(side, root)
    clients = connect_docs(s, ["a", "b"])
    drive(s, "a", clients["a"], 0)
    drive(s, "b", clients["b"], 0)
    s.res.evict("a")
    s.storm.checkpoint()
    drive(s, "a", clients["a"], 1)
    drive(s, "b", clients["b"], 1)
    want = digest(s, ["a", "b"])
    close(s)
    s2 = build_stack(side, root)
    info = s2.storm.recover()
    rec = {"info": info, "replay": s2.res.stats["replay_hydrations"],
           "got": digest(s2, ["a", "b"]), "want": want}
    close(s2)
    return rec


def test_replay_hydrates_on_first_touch_like_jax(tmp_path):
    j, t = both(tmp_path, _replay_hydrates)
    assert t == j
    assert t["replay"] == 1 and t["got"] == t["want"]


# -- the cold store ------------------------------------------------------------


def _blob_count(root) -> int:
    return sum(len(files) for _r, _d, files in
               os.walk(root / "git" / "objects"))


def _gc(side, root):
    s = build_stack(side, root)
    clients = connect_docs(s, ["g1", "g2"])
    drive(s, "g1", clients["g1"], 0, words=set_words(0))
    handles = [s.res.evict("g1")]
    counts = [_blob_count(root)]
    for r in range(1, 4):
        drive(s, "g1", clients["g1"], r, words=set_words(r))
        handles.append(s.res.evict("g1"))
        counts.append(_blob_count(root))
    s.res.ensure_resident("g1", gate=False)
    rec = {"handles": handles, "counts": counts,
           "planes": row_planes(s, "g1"), "stats": dict(s.res.stats)}
    close(s)
    return rec


def test_cold_store_gc_matches_jax(tmp_path):
    j, t = both(tmp_path, _gc)
    assert t == j
    assert len(set(t["handles"])) == 4
    assert t["counts"][-1] <= t["counts"][0] + 2


def test_cold_snapshot_bytes_equal_jax(tmp_path):
    """The uploaded cold record itself, read back raw from both stores."""
    recs = {}
    for side in SIDES:
        s = build_stack(side, tmp_path / side)
        clients = connect_docs(s, ["a"])
        for r in range(3):
            drive(s, "a", clients["a"], r)
        handle = s.res.evict("a")
        recs[side] = (handle, s.storm.snapshots.get(
            t_res.COLD_KEY_PREFIX + "a", handle))
        close(s)
    assert recs["torch"] == recs["jax"]
    snap = recs["torch"][1]
    assert snap["kind"] == "cold-doc"
    assert snap["format_version"] == t_res.COLD_DOC_VERSION
    assert snap["map_row"]["present"]["d"] == "|b1"
    assert snap["map_row"]["vseq"]["d"] == "<i4"


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_each_side_hydrates_and_recovers_the_others(tmp_path, writer,
                                                    reader):
    root = tmp_path / "shared"
    s = build_stack(writer, root)
    clients = connect_docs(s, ["a", "b"])
    for r in range(2):
        for d in ("a", "b"):
            drive(s, d, clients[d], r)
    s.res.evict("a")
    s.storm.checkpoint()
    drive(s, "a", clients["a"], 2)  # hydrates a past the checkpoint
    s.res.evict("a")
    drive(s, "b", clients["b"], 2)
    want = digest(s, ["a", "b"])
    close(s)
    s2 = build_stack(reader, root)
    info = s2.storm.recover()
    assert info["restored_from"] is not None
    # a's replayed tick lies below its cold watermark: it stays cold.
    assert not s2.res.is_resident("a") and s2.res.is_resident("b")
    got = digest(s2, ["a", "b"])
    assert got == want
    assert s2.res.stats["cold_hydrations"] == 1
    close(s2)


# -- refusals ------------------------------------------------------------------


def _refusals(side, root):
    clk = [0.0]
    s = build_stack(side, root, clock=lambda: clk[0], idle_evict_s=10.0)
    clients = connect_docs(s, ["a", "b", "m"])
    for d in ("a", "b", "m"):
        drive(s, d, clients[d], 0)
    rec = {}

    def refused(doc):
        try:
            s.res.evict(doc)
        except s.P.res.EvictionRefused as err:
            return str(err)
        return None

    mgr = s.P.mg.MegaDocManager(s.storm, default_lanes=2)
    mgr.promote("m")
    rec["promoted"] = refused("m")
    s.storm.quarantined["a"] = {"reason": "test", "tick": 0}
    rec["quarantined"] = refused("a")
    clk[0] = 20.0
    rec["idle"] = s.res.evict_idle()  # a and m skipped: pinned resident
    s.storm.quarantined.clear()
    s.storm._replay = True
    rec["replay"] = refused("a")
    s.storm._replay = False
    s.storm._in_round = True
    rec["in_round"] = refused("a")
    s.storm._in_round = False
    s.storm._group_wal.breaker.record_failure()
    rec["degraded"] = refused("a")
    s.storm._group_wal.breaker.record_success()
    mgr.demote("m")
    rec["after_demote"] = refused("m")
    rec["evicted_a"] = refused("a")
    rec["stats"] = dict(s.res.stats)
    close(s)
    return rec


def test_refusals_match_jax(tmp_path):
    j, t = both(tmp_path, _refusals)
    assert t == j
    for key in ("quarantined", "replay", "in_round", "degraded",
                "promoted"):
        assert t[key], key
    assert t["idle"] == ["b"]  # a quarantined, m promoted: pinned
    assert t["after_demote"] is None and t["evicted_a"] is None
    assert t["stats"]["evict_refusals"] >= 5


def _full_pool(side, root):
    s = build_stack(side, root, max_resident=1)
    clients = connect_docs(s, ["a"])
    drive(s, "a", clients["a"], 0)
    s.storm.quarantined["a"] = {"reason": "test", "tick": 0}
    nacks = []
    drive(s, "b", "client-99", 0, push=nacks.append, rid=77)
    rec = {"nacks": [ack(n) for n in nacks],
           "b": s.res.is_resident("b"), "stats": dict(s.res.stats)}
    # A frame wider than the pool nacks terminal.
    wide = []
    entries = [[f"w{i}", f"client-{i}", 1, 1, K] for i in range(3)]
    payload = b"".join(set_words(0).tobytes() for _ in range(3))
    s.storm.submit_frame(wide.append, {"rid": 1, "docs": entries},
                         memoryview(payload))
    rec["wide"] = [ack(n) for n in wide]
    rec["storm_stats"] = dict(s.storm.stats)
    close(s)
    return rec


def test_full_pool_and_frame_too_wide_nack_like_jax(tmp_path):
    j, t = both(tmp_path, _full_pool)
    assert t == j
    assert t["nacks"][0]["error"] == "busy" and not t["b"]
    assert t["wide"][0]["error"] == "frame-too-wide"
    assert t["wide"][0]["retryable"] is False


# -- capacity and admission (fake clock) ---------------------------------------


def _capacity(side, root):
    s = build_stack(side, root, max_resident=2)
    clients = connect_docs(s, ["a", "b"])
    drive(s, "a", clients["a"], 0)
    drive(s, "b", clients["b"], 0)
    drive(s, "c", "client-42", 0)
    rec = {"resident": list(s.res.resident), "rows": s.seq._row_count,
           "stats": dict(s.res.stats)}
    close(s)
    return rec


def test_lru_capacity_eviction_matches_jax(tmp_path):
    j, t = both(tmp_path, _capacity)
    assert t == j
    assert t["resident"] == ["b", "c"] and t["rows"] <= 3


def _storm_gate(side, root):
    clk = [0.0]
    s = build_stack(side, root, clock=lambda: clk[0],
                    hydration_rate_per_s=1.0, hydration_burst=1.0)
    clients = connect_docs(s, ["a"])
    drive(s, "a", clients["a"], 0)
    s.res.evict("a")
    s.res.evict_idle()
    drive(s, "a", clients["a"], 1)
    rec = {"a": s.res.is_resident("a")}
    nacks = []
    drive(s, "b", "client-9", 0, push=nacks.append, rid=5)
    rec["nacks"] = [ack(n) for n in nacks]
    clk[0] += nacks[0]["retry_after_s"]
    acks = []
    drive(s, "b", "client-9", 0, push=acks.append, rid=6)
    rec["acks"] = [ack(a) for a in acks]
    # Early return keeps the same reservation (ensure_resident path).
    r1 = s.res.ensure_resident("y")
    clk[0] += (r1 or 0) / 2
    r2 = s.res.ensure_resident("y")
    clk[0] += r2 or 0
    rec["ladder"] = [r1, r2, s.res.ensure_resident("y")]
    rec["stats"] = dict(s.res.stats)
    rec["gauges"] = {k: v for k, v in s.merge.metrics.snapshot().items()
                     if k.startswith("residency.")
                     and not k.endswith("rss_mb")
                     and "_s." not in k and not k.endswith("_s")}
    close(s)
    return rec


def test_hydration_storm_admission_matches_jax(tmp_path):
    j, t = both(tmp_path, _storm_gate)
    assert t == j
    assert t["a"] and t["nacks"][0]["error"] == "hydrating"
    assert t["nacks"][0]["retry_after_s"] > 0
    assert t["acks"] and not t["acks"][0].get("error")
    assert t["ladder"][0] is not None and t["ladder"][2] is None
    assert t["stats"]["hydration_nacks"] >= 1


# -- bounded bookkeeping, cohort cache, row recycling --------------------------


def _churn(side, root):
    hot = 4
    s = build_stack(side, root, num_docs=hot, max_resident=hot)
    clients = {}
    for i in range(24):
        doc = f"doc-{i}"
        clients[doc] = s.service.connect(doc, lambda m: None).client_id
        s.service.pump()
        drive(s, doc, clients[doc], 0)
    rec = {"stats": dict(s.res.stats), "resident": list(s.res.resident),
           "ticks": len(s.storm._doc_ticks),
           "counts": len(s.storm.doc_tick_counts),
           "rows": s.seq._row_count, "map_rows": s.merge._map_row_count}
    drive(s, "doc-0", clients["doc-0"], 1)
    rec["doc0"] = (s.storm.doc_tick_counts["doc-0"],
                   list(s.storm._doc_ticks["doc-0"]))
    snap = s.merge.metrics.snapshot()
    rec["cohort"] = (snap["storm.cohort_cache.hits"],
                     snap["storm.cohort_cache.misses"])
    close(s)
    return rec


def test_bookkeeping_stays_o_hot_under_churn_like_jax(tmp_path):
    j, t = both(tmp_path, _churn)
    assert t == j
    assert t["stats"]["evictions"] >= 20 and len(t["resident"]) == 4
    assert t["ticks"] <= 4 and t["counts"] <= 4 and t["rows"] <= 4
    assert t["doc0"][0] == 2 and len(t["doc0"][1]) == 2


def _recycle(side, root):
    s = build_stack(side, root, storm_kw=dict(doc_index_retention_ticks=3))
    clients = connect_docs(s, ["a", "b"])
    for r in range(6):
        for d in ("a", "b"):
            drive(s, d, clients[d], r)
    rec = {"ticks_a": list(s.storm._doc_ticks["a"])}
    row = s.seq._rows["a"]
    gen = s.seq.membership_gen
    s.res.evict("a")
    rec["gen_moved"] = s.seq.membership_gen > gen
    rec["free"] = list(s.seq._free_rows)
    blank = s.P.seqk.init_state(1, s.seq._alloc_slots + 1, **s.P.dev)
    rec["blank"] = all(
        np.array_equal(host(getattr(s.seq._state, f))[row],
                       host(getattr(blank, f))[0])
        for f in type(s.seq._state)._fields)
    xs = s.merge._xstate
    rec["map_free"] = list(s.merge._free_map_rows)
    mrow = rec["map_free"][0]
    rec["map_blank"] = [host(getattr(xs, f))[mrow].tolist()
                        for f in ("present", "value", "vseq",
                                  "cleared_seq")]
    # The recycled rows reissue to the next doc, and the cohort cache
    # keyed on the old membership generation misses.
    c = s.service.connect("c", lambda m: None).client_id
    s.service.pump()
    drive(s, "c", c, 0)
    rec["c_row"] = s.seq._rows["c"] == row
    snap = s.merge.metrics.snapshot()
    rec["cohort"] = (snap["storm.cohort_cache.hits"],
                     snap["storm.cohort_cache.misses"])
    rec["planes"] = row_planes(s, "c")
    close(s)
    return rec


def test_row_recycling_and_cohort_cache_match_jax(tmp_path):
    j, t = both(tmp_path, _recycle)
    assert t == j
    assert len(t["ticks_a"]) <= 4
    assert t["gen_moved"] and t["blank"] and t["c_row"]
    assert t["map_blank"][0] == [False] * len(t["map_blank"][0])


def test_eviction_reads_each_row_once(tmp_path):
    """The port's eviction export is one gather and one copy per doc."""
    s = build_stack("torch", tmp_path)
    clients = connect_docs(s, ["a", "b", "c"])
    for d in ("a", "b", "c"):
        drive(s, d, clients[d], 0)
    before = s.merge.map_row_reads
    for d in ("a", "b", "c"):
        s.res.evict(d)
    assert s.merge.map_row_reads - before == 3
    close(s)
