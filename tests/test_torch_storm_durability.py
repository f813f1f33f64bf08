"""Crash-safe storm serving of the port against the JAX StormController.

Both stacks are built as ``tests/test_torch_storm.py`` builds them (the
port on ``device="cpu"``, where its kernels run their plain PyTorch
versions; a pinned service clock), now with a spill dir for the tick WAL
and a ``GitSnapshotStore``. The same frames go through both at every
durability mode and pipeline depth, and what each writes and answers
must be equal: the WAL file byte for byte, the pushed acks (with the
durability watermark ``dw``), the sequencer and map planes, ``stats``,
``export_state()``, the checkpoint snapshots, what ``recover()`` rebuilds
(each side from its own directories and from the other's), the per-doc
quarantine's read and readmit, and the pipeline depth ``"auto"`` picks.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import struct

import numpy as np
import pytest

from fluidframework_tpu.server import storm as jax_storm_mod
from fluidframework_tpu.server.durable_store import \
    GitSnapshotStore as JaxGit
from fluidframework_tpu.server.kernel_host import \
    KernelSequencerHost as JaxSeqHost
from fluidframework_tpu.server.merge_host import \
    KernelMergeHost as JaxMergeHost
from fluidframework_tpu.server.routerlicious import \
    RouterliciousService as JaxService
from fluidframework_tpu_torch.server import storm as torch_storm_mod
from fluidframework_tpu_torch.server.durable_store import \
    GitSnapshotStore as TorchGit
from fluidframework_tpu_torch.server.kernel_host import \
    KernelSequencerHost as TorchSeqHost
from fluidframework_tpu_torch.server.merge_host import \
    KernelMergeHost as TorchMergeHost
from fluidframework_tpu_torch.server.routerlicious import \
    RouterliciousService as TorchService

SIDES = ("jax", "torch")
DOCS = [f"doc{i}" for i in range(6)]
SNAP = "__storm__"


def _stack(side: str, root, depth=1, durability="group", snapshots=True,
           num_docs=4, threshold=10**9, **kw):
    """(service, storm, seq_host, merge_host) of one side over ``root``:
    the tick WAL in ``root/spill``, snapshots in ``root/git``."""
    if side == "jax":
        seq = JaxSeqHost(num_slots=1, initial_capacity=num_docs)
        merge = JaxMergeHost(flush_threshold=10**9)
        svc = JaxService(merge_host=merge, batched_deli_host=seq,
                         auto_pump=False)
        ctl, git = jax_storm_mod.StormController, JaxGit
    else:
        seq = TorchSeqHost(num_slots=1, initial_capacity=num_docs,
                           device="cpu")
        merge = TorchMergeHost(flush_threshold=10**9, device="cpu")
        svc = TorchService(merge_host=merge, batched_deli_host=seq,
                           auto_pump=False)
        ctl, git = torch_storm_mod.StormController, TorchGit
    storm = ctl(svc, seq, merge, flush_threshold_docs=threshold,
                pipeline_depth=depth,
                spill_dir=str(root / "spill") if durability else None,
                durability=durability,
                snapshots=git(root / "git") if snapshots else None, **kw)
    svc._clock = itertools.count(1000, 7).__next__
    return svc, storm, seq, merge


def _words(rng, k, num_slots=16, clears=True):
    kinds = rng.choice([0, 0, 0, 1, 2] if clears else [0, 0, 0, 1],
                       size=k).astype(np.uint32)
    slots = rng.integers(0, num_slots, k).astype(np.uint32)
    vals = rng.integers(0, 1 << 20, k).astype(np.uint32)
    return (kinds | (slots << 2) | (vals << 12)).astype(np.uint32)


def _script(seed: int, rounds: int = 4):
    """Rounds of two disjoint frames (one tick each round): uneven counts,
    a doc absent, a dup resend of an acked tail and a gap that nacks."""
    rng = np.random.default_rng(seed)
    cseq = {(d, c): 1 for d in DOCS for c in range(2)}
    out, rid = [], itertools.count()
    for t in range(rounds):
        frames = []
        for part in (DOCS[:3], DOCS[3:]):
            entries, payload = [], b""
            for j, d in enumerate(part):
                if t == 2 and j == 2:
                    continue
                c = (t + j) % 2
                k = 16 if t % 2 == 0 else int(rng.integers(1, 16))
                c0 = cseq[(d, c)]
                if t == 3 and j == 0:
                    c0 = max(1, c0 - 5)
                if t == 3 and j == 1 and d == DOCS[1]:
                    c0 += 3
                entries.append((d, c, c0, 1 if t < 2 else 3, k))
                payload += _words(rng, k).tobytes()
                cseq[(d, c)] = max(cseq[(d, c)], c0 + k)
            frames.append((next(rid), entries, payload))
        out.append(frames)
    return out


def _join(svc):
    clients = {(d, c): svc.connect(d, lambda m: None).client_id
               for d in DOCS for c in range(2)}
    svc.pump()
    return clients


def _submit(storm, clients, frames, sink):
    for rid, entries, payload in frames:
        storm.submit_frame(sink, {"rid": rid, "docs": [
            [d, clients[(d, c)], c0, ref, k]
            for d, c, c0, ref, k in entries]}, memoryview(payload))


def _ack(payload) -> dict:
    return {k: payload[k] for k in payload.keys()}


def _planes(side, seq, merge) -> dict:
    out = {}
    for name, st in (("seq", seq._state), ("map", merge._xstate)):
        for f in st._fields:
            a = getattr(st, f)
            out[f"{name}.{f}"] = np.asarray(a) if side == "jax" \
                else a.cpu().numpy()
    return out


def _assert_planes_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for f in a:
        assert a[f].dtype == b[f].dtype, f
        assert np.array_equal(a[f], b[f]), f


def _digest(storm, seq, merge, docs=DOCS) -> str:
    """Every doc's sequencer checkpoint, map entries and catch-up
    records, as canonical JSON."""
    out = {}
    for d in docs:
        if d not in seq._rows:
            continue
        out[d] = {"cp": dataclasses.asdict(seq.checkpoint(d)),
                  "map": merge.map_entries(d, "default", "root"),
                  "recs": storm.records_overlapping(d, 0)}
    return json.dumps(out, sort_keys=True)


def _wal(root) -> bytes:
    return (root / "spill" / "storm_tick_words.log").read_bytes()


def _close(storm) -> None:
    if storm._group_wal is not None:
        storm._group_wal.close()


# -- serving: every durability mode x pipeline depth ---------------------------


def _serve_forced(side, root, depth, durability):
    """One tick per forced flush, so the watermark each ack carries is
    exact on both sides."""
    svc, storm, seq, merge = _stack(side, root, depth, durability)
    clients = _join(svc)
    pushed = []
    for frames in _script(seed=depth):
        _submit(storm, clients, frames, pushed.append)
        storm.flush()
    return svc, storm, seq, merge, pushed


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
@pytest.mark.parametrize("durability", ["group", "sync", "none"])
def test_durable_serving_matches_jax(tmp_path, durability, depth):
    runs = {side: _serve_forced(side, tmp_path / side, depth, durability)
            for side in SIDES}
    (_, js, jseq, jmerge, jacks), (_, ts, tseq, tmerge, tacks) = (
        runs["jax"], runs["torch"])
    assert _wal(tmp_path / "torch") == _wal(tmp_path / "jax")
    assert [_ack(a) for a in tacks] == [_ack(a) for a in jacks]
    want_dw = {"group": [1, 2, 3, 4], "sync": [1, 2, 3, 4],
               "none": [0, 0, 0, 0]}[durability]
    assert [a["dw"] for a in tacks] == [w for w in want_dw for _ in (0, 1)]
    assert js.stats["nacked_or_ignored_ops"] > 0
    assert ts.stats == js.stats
    assert ts.durable_watermark == js.durable_watermark
    _assert_planes_equal(_planes("jax", jseq, jmerge),
                         _planes("torch", tseq, tmerge))
    assert _digest(ts, tseq, tmerge) == _digest(js, jseq, jmerge)
    assert ts._doc_ticks == js._doc_ticks
    assert tmerge.export_state() == jmerge.export_state()
    for storm in (js, ts):
        _close(storm)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_overlapped_serving_matches_jax(tmp_path, depth):
    """Un-forced rounds (the threshold flush runs each tick as it fills):
    the group commit overlaps the next dispatch, so when an ack leaves
    depends on the writer thread; everything else is equal, and every
    ack's watermark is monotone and past its own tick."""
    out = {}
    for side in SIDES:
        svc, storm, seq, merge = _stack(side, tmp_path / side, depth,
                                        threshold=len(DOCS))
        clients = _join(svc)
        pushed = []
        rng = np.random.default_rng(3)
        for t in range(6):
            k = 8 if t != 3 else 16  # a geometry change mid-run
            entries = [[d, clients[(d, 0)], 1 + t * 16, 1, k] for d in DOCS]
            payload = b"".join(_words(rng, k).tobytes() for _ in DOCS)
            storm.submit_frame(pushed.append, {"rid": t, "docs": entries},
                               memoryview(payload))
        storm.flush()
        out[side] = (storm, seq, merge, pushed)
    (js, jseq, jmerge, jacks), (ts, tseq, tmerge, tacks) = (
        out["jax"], out["torch"])
    assert _wal(tmp_path / "torch") == _wal(tmp_path / "jax")
    strip = [{k: v for k, v in _ack(a).items() if k != "dw"} for a in tacks]
    assert strip == [{k: v for k, v in _ack(a).items() if k != "dw"}
                     for a in jacks]
    dws = [a["dw"] for a in tacks]
    assert [a["rid"] for a in tacks] == list(range(6))
    assert dws == sorted(dws)
    assert all(dw > tick for tick, dw in enumerate(dws))
    assert ts.stats == js.stats
    _assert_planes_equal(_planes("jax", jseq, jmerge),
                         _planes("torch", tseq, tmerge))
    assert _digest(ts, tseq, tmerge) == _digest(js, jseq, jmerge)
    for storm in (js, ts):
        _close(storm)


# -- pipeline depth "auto" -------------------------------------------------------


def _attribution(commit_ms, dispatch_ms, ticks=16):
    return {"_window": {"ticks": ticks},
            "wal_commit_wait": {"total_ms": commit_ms},
            "device_dispatch": {"total_ms": dispatch_ms}}


REGIMES = [  # (attribution, current depth): tests/test_megadoc.py's pins
    (_attribution(520.0, 410.0), 0), (_attribution(520.0, 410.0), 2),
    (_attribution(20.0, 400.0), 1), (_attribution(20.0, 400.0), 0),
    (_attribution(150.0, 400.0), 0), (_attribution(150.0, 400.0), 1),
    (_attribution(520.0, 410.0, ticks=3), 0), ({}, 1),
    (_attribution(100.0, 0.0), 2), (_attribution(200.0, 400.0), 3)]


@pytest.mark.parametrize("attribution,current", REGIMES)
def test_choose_pipeline_depth_matches_jax(attribution, current):
    assert torch_storm_mod.choose_pipeline_depth(attribution, current) \
        == jax_storm_mod.choose_pipeline_depth(attribution, current)


def test_auto_depth_makes_jaxs_decisions(tmp_path):
    """With ``pipeline_depth="auto"`` both controllers start overlapped
    and re-decide at the same cadence; fed the same observed attribution
    (a scripted ledger window per check), they pick the same depths and
    still write the same WAL."""
    windows = [_attribution(20.0, 400.0), _attribution(150.0, 400.0),
               _attribution(520.0, 410.0), _attribution(520.0, 410.0, 3),
               _attribution(10.0, 400.0), _attribution(300.0, 400.0)]
    depths = {}
    for side in SIDES:
        svc, storm, seq, merge = _stack(side, tmp_path / side, "auto")
        assert storm.pipeline_depth == 1 and storm._auto_depth
        storm.depth_adapt_every = 1
        script = iter(windows)
        storm.ledger.attribution = lambda script=script: next(script)
        clients = _join(svc)
        seen = []
        for t in range(len(windows)):
            entries = [[d, clients[(d, 0)], 1 + t * 4, 1, 4] for d in DOCS]
            payload = b"".join(
                _words(np.random.default_rng([t, i]), 4).tobytes()
                for i in range(len(DOCS)))
            storm.submit_frame(None, {"rid": t, "docs": entries},
                               memoryview(payload))
            storm.flush()
            seen.append(storm.pipeline_depth)
        depths[side] = seen
        _close(storm)
    assert depths["torch"] == depths["jax"] == [0, 0, 1, 1, 0, 1]
    assert _wal(tmp_path / "torch") == _wal(tmp_path / "jax")


# -- checkpoint and recover -------------------------------------------------------


def _serve_and_checkpoint(side, root, durability="group", depth=1):
    """Joins, a genesis checkpoint, two rounds, a checkpoint, two more
    rounds. Returns the live stack and the two snapshot handles."""
    svc, storm, seq, merge = _stack(side, root, depth, durability)
    clients = _join(svc)
    handles = [storm.checkpoint()]
    for t, frames in enumerate(_script(seed=5)):
        _submit(storm, clients, frames, None)
        storm.flush()
        if t == 1:
            handles.append(storm.checkpoint())
    return (svc, storm, seq, merge), handles


def test_checkpoint_snapshots_match_jax(tmp_path):
    snaps = {}
    for side in SIDES:
        (_svc, storm, *_), handles = _serve_and_checkpoint(
            side, tmp_path / side)
        snaps[side] = (handles, [storm.snapshots.get(SNAP, h)
                                 for h in handles])
        assert storm.snapshots.head(SNAP) == handles[-1]
        _close(storm)
    assert snaps["torch"][0] == snaps["jax"][0]  # content-addressed
    for a, b in zip(snaps["torch"][1], snaps["jax"][1]):
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert snaps["jax"][1][1]["tick_watermark"] == 2


@pytest.mark.parametrize("durability", ["group", "sync"])
def test_recover_matches_jax(tmp_path, durability):
    """A fresh stack over the same dirs restores the tick-2 head and
    replays the two-tick WAL tail through the serving tick, on both
    sides, to the live stack's state (per doc: a recovered host lays its
    rows out in the snapshot's doc order, the live one in join order) —
    and keeps serving alike."""
    results = {}
    for side in SIDES:
        (svc, storm, seq, merge), _h = _serve_and_checkpoint(
            side, tmp_path / side, durability)
        live = _digest(storm, seq, merge)
        _close(storm)
        svc2, storm2, seq2, merge2 = _stack(side, tmp_path / side, 1,
                                            durability)
        info = storm2.recover()
        assert info["replayed_ticks"] == 2
        assert storm2._tick_counter == 4
        assert _digest(storm2, seq2, merge2) == live
        recovered = _planes(side, seq2, merge2)
        # A verbatim resend of the last round dedups; a fresh round
        # sequences.
        clients = {(d, c): f"client-{1 + 2 * i + c}"
                   for i, d in enumerate(DOCS) for c in range(2)}
        acks = []
        _submit(storm2, clients, _script(seed=5)[-1], acks.append)
        storm2.flush()
        results[side] = (info, [_ack(a) for a in acks], recovered,
                         _planes(side, seq2, merge2),
                         _digest(storm2, seq2, merge2))
        _close(storm2)
    assert results["torch"][0]["replayed_ticks"] \
        == results["jax"][0]["replayed_ticks"]
    assert results["torch"][1] == results["jax"][1]
    assert all(row[0] == 0 for a in results["torch"][1] for row in a["acks"])
    _assert_planes_equal(results["jax"][2], results["torch"][2])
    _assert_planes_equal(results["jax"][3], results["torch"][3])
    assert results["torch"][4] == results["jax"][4]


@pytest.mark.parametrize("reader", SIDES)
@pytest.mark.parametrize("writer", SIDES)
def test_cross_recovery(tmp_path, writer, reader):
    """Each side recovers the spill dir and snapshot store the other
    wrote: to the writer's live state per doc, and to the planes the
    writer's own recovery of the same dirs rebuilds."""
    (svc, storm, seq, merge), _h = _serve_and_checkpoint(writer, tmp_path)
    live = _digest(storm, seq, merge)
    _close(storm)
    planes = {}
    for side in (reader, writer):
        _svc2, storm2, seq2, merge2 = _stack(side, tmp_path)
        info = storm2.recover()
        assert info["replayed_ticks"] == 2
        assert _digest(storm2, seq2, merge2) == live
        planes[side] = _planes(side, seq2, merge2)
        _close(storm2)
    _assert_planes_equal(planes[writer], planes[reader])


def test_recover_pads_filler_ticks_when_watermark_ahead(tmp_path):
    """Under durability="sync" the snapshot watermark may pass the WAL (a
    lost unfsynced tail): both sides pad the same filler ticks, restore
    the same state and then append the next live tick at the same id."""
    out = {}
    for side in SIDES:
        root = tmp_path / side
        svc, storm, seq, merge = _stack(side, root, 1, "sync")
        clients = {"a": svc.connect("a", lambda m: None).client_id}
        svc.pump()
        rng = np.random.default_rng(9)
        for t in range(2):
            storm.submit_frame(None, {"rid": t, "docs": [
                ["a", clients["a"], 1 + t * 8, 1, 8]]},
                memoryview(_words(rng, 8).tobytes()))
            storm.flush()
        storm.checkpoint()  # watermark 2
        full = _wal(root)
        (n0,) = struct.unpack_from("<I", full, 0)
        (root / "spill" / "storm_tick_words.log").write_bytes(full[:8 + n0])
        svc2, storm2, seq2, merge2 = _stack(side, root, 1, "sync")
        assert storm2._tick_counter == 1
        info = storm2.recover()
        assert storm2._tick_counter == 2 and info["replayed_ticks"] == 0
        acks = []
        storm2.submit_frame(acks.append, {"rid": 2, "docs": [
            ["a", clients["a"], 17, 1, 8]]},
            memoryview(_words(rng, 8).tobytes()))
        storm2.flush()
        out[side] = ([_ack(a) for a in acks], _wal(root),
                     [r["tick"] for r in storm2.records_overlapping("a", 0)],
                     merge2.map_entries("a", "default", "root"))
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][2] == out["jax"][2] == [0, 2]
    assert out["torch"][3] == out["jax"][3]


@pytest.mark.parametrize("side", SIDES)
def test_recover_refuses_empty_state_over_acked_history(tmp_path, side):
    svc, storm, *_ = _stack(side, tmp_path)
    client = svc.connect("a", lambda m: None).client_id
    svc.pump()
    storm.submit_frame(None, {"rid": 0, "docs": [["a", client, 1, 1, 8]]},
                       memoryview(_words(np.random.default_rng(1),
                                         8).tobytes()))
    storm.flush()  # a durable tick, no checkpoint
    _close(storm)
    _svc2, storm2, *_ = _stack(side, tmp_path)
    with pytest.raises(RuntimeError, match="no snapshot head"):
        storm2.recover()
    _close(storm2)


def test_torn_tick_wal_recovers_last_complete_tick(tmp_path):
    """The tick WAL cut at every byte offset of its last record: both
    sides reopen to the same two complete ticks (index and catch-up
    reads), at a few cuts through a full controller rebuild."""
    svc, storm, *_ = _stack("jax", tmp_path / "src", 1, "sync",
                            snapshots=False)
    client = svc.connect("a", lambda m: None).client_id
    svc.pump()
    rng = np.random.default_rng(2)
    for t in range(3):
        storm.submit_frame(None, {"rid": t, "docs": [
            ["a", client, 1 + t * 4, 1, 4]]},
            memoryview(_words(rng, 4).tobytes()))
        storm.flush()
    full = _wal(tmp_path / "src")
    starts, pos = [], 0
    while pos < len(full):
        starts.append(pos)
        pos += 8 + struct.unpack_from("<I", full, pos)[0]
    assert len(starts) == 3 and pos == len(full)
    from fluidframework_tpu_torch.native import OpLog
    probe = tmp_path / "probe.log"
    for cut in range(starts[-1], len(full)):
        probe.write_bytes(full[:cut])
        log = OpLog(probe)
        assert len(log) == 2, cut
        log.close()
    for cut in (starts[-1], starts[-1] + 9, len(full) - 1):
        recs = {}
        for side in SIDES:
            root = tmp_path / f"{side}-{cut}"
            (root / "spill").mkdir(parents=True)
            (root / "spill" / "storm_tick_words.log").write_bytes(full[:cut])
            _s, storm2, *_ = _stack(side, root, 1, "sync", snapshots=False)
            assert storm2._tick_counter == 2
            recs[side] = storm2.records_overlapping("a", 0)
        assert recs["torch"] == recs["jax"]
        assert [r["tick"] for r in recs["torch"]] == [0, 1]


@pytest.mark.parametrize("durability", ["group", "sync"])
@pytest.mark.parametrize("side", SIDES)
def test_explicit_durability_without_spill_dir_is_rejected(side,
                                                           durability):
    seq = (JaxSeqHost(num_slots=2, initial_capacity=2) if side == "jax"
           else TorchSeqHost(num_slots=2, initial_capacity=2, device="cpu"))
    merge = (JaxMergeHost(flush_threshold=10**9) if side == "jax"
             else TorchMergeHost(flush_threshold=10**9, device="cpu"))
    svc = (JaxService if side == "jax" else TorchService)(
        merge_host=merge, batched_deli_host=seq, auto_pump=False)
    ctl = (jax_storm_mod if side == "jax" else torch_storm_mod).StormController
    with pytest.raises(ValueError, match="needs a spill_dir"):
        ctl(svc, seq, merge, durability=durability)


@pytest.mark.parametrize("side", SIDES)
def test_catchup_read_barriers_group_commit(tmp_path, side):
    """Reading an in-flight tick forces the WAL barrier first, so a
    record never leaves the process ahead of its fsync."""
    svc, storm, *_ = _stack(side, tmp_path)
    client = svc.connect("a", lambda m: None).client_id
    svc.pump()
    storm.submit_frame(None, {"rid": 0, "docs": [["a", client, 1, 1, 8]]},
                       memoryview(_words(np.random.default_rng(0),
                                         8).tobytes()))
    storm._flush_round()
    storm._harvest()  # enqueued on the WAL, fsync maybe pending
    words = storm.read_tick_words(0)
    assert storm.durable_watermark >= 1
    assert len(words) == 8 * 4
    _close(storm)


def test_snapshot_interval_checkpoints_alike(tmp_path):
    heads = {}
    for side in SIDES:
        svc, storm, *_ = _stack(side, tmp_path / side,
                                snapshot_interval_ticks=2)
        clients = _join(svc)
        seen = []
        for frames in _script(seed=1):
            _submit(storm, clients, frames, None)
            storm.flush()
            seen.append(storm.snapshots.head(SNAP))
        heads[side] = seen
        _close(storm)
    assert heads["torch"] == heads["jax"]
    assert heads["jax"][0] is None and heads["jax"][1] is not None
    assert heads["jax"][2] == heads["jax"][1] != heads["jax"][3]


def test_multi_tenant_recovery_restores_equal_qos(tmp_path):
    """Three tenants under a slot budget: the scheduler state rides every
    tick header and the snapshot, and a recovered stack of either side
    holds the live one's ``qos.export_state()``."""
    tenants = ("tn-a", "tn-b", "tn-c")
    out = {}
    for side in SIDES:
        root = tmp_path / side
        kw = dict(tenant_weights={"tn-a": 1.0, "tn-b": 2.0, "tn-c": 1.0},
                  tick_slot_budget=3)
        svc, storm, seq, merge = _stack(side, root, **kw)
        clients = _join(svc)
        rng = np.random.default_rng(11)
        for t in range(4):
            for i, d in enumerate(DOCS):
                storm.submit_frame(
                    None, {"rid": (t, d), "docs": [
                        [d, clients[(d, 0)], 1 + t * 4, 1, 4]]},
                    memoryview(_words(rng, 4).tobytes()),
                    tenant_id=tenants[i % 3])
            if t == 1:
                storm.checkpoint()
        storm.flush()
        live_qos = json.dumps(storm.qos.export_state(), sort_keys=True)
        live = _digest(storm, seq, merge)
        _close(storm)
        svc2, storm2, seq2, merge2 = _stack(side, root, **kw)
        info = storm2.recover()
        assert json.dumps(storm2.qos.export_state(), sort_keys=True) \
            == live_qos
        assert _digest(storm2, seq2, merge2) == live
        out[side] = (live_qos, info["replayed_ticks"], _wal(root))
        _close(storm2)
    assert out["torch"] == out["jax"]
    assert out["jax"][1] > 0


# -- quarantine: read and readmit ----------------------------------------------------


def _poison(side, storm, merge, doc, slot=40):
    row = storm._storm_map_row(doc)
    if side == "jax":
        import jax.numpy as jnp

        from fluidframework_tpu.ops import map_kernel as jmk
        xs = merge._xstate
        merge._xstate = jmk.MapState(
            present=xs.present.at[row, slot].set(True), value=xs.value,
            vseq=xs.vseq.at[row, slot].set(jnp.int32(2**30)),
            cleared_seq=xs.cleared_seq)
    else:
        merge._xstate.present[row, slot] = True
        merge._xstate.vseq[row, slot] = 2**30


def test_quarantine_read_and_readmit_match_jax(tmp_path):
    """Serve from a genesis snapshot, poison one doc's device row, let the
    sentinel freeze it, read it through the durable records' fold while
    frozen, readmit it from the genesis snapshot + its WAL tail, and
    resend what it missed: both sides answer alike at every step, and
    the readmitted planes equal an unpoisoned run's."""
    out = {}
    for side in SIDES:
        results = {}
        for poisoned in (False, True):
            svc, storm, seq, merge = _stack(
                side, tmp_path / f"{side}-{poisoned}", max_key_slots=64)
            docs = DOCS[:4]
            clients = {d: svc.connect(d, lambda m: None).client_id
                       for d in docs}
            svc.pump()
            storm.checkpoint()  # genesis: the readmit rebuild source
            rng = np.random.default_rng(4)
            pushed = []
            cseq = {d: 1 for d in docs}

            def frame(rid, names, storm=storm, clients=clients,
                      pushed=pushed, cseq=cseq, rng=rng):
                entries, payload = [], b""
                for d in names:
                    entries.append([d, clients[d], cseq[d], 1, 8])
                    payload += _words(rng, 8, clears=False).tobytes()
                    cseq[d] += 8
                storm.submit_frame(pushed.append,
                                   {"rid": rid, "docs": entries},
                                   memoryview(payload))
                storm.flush()
            frame(0, docs)
            if poisoned:
                _poison(side, storm, merge, DOCS[1])
            frame(1, docs)
            frame(2, [DOCS[0], DOCS[2], DOCS[3]])
            read = None
            info = None
            if poisoned:
                assert list(storm.quarantined) == [DOCS[1]]
                read = storm.quarantined_map_entries(DOCS[1])
                info = storm.readmit_doc(DOCS[1])
                assert not storm.quarantined
            else:
                read = merge.map_entries(DOCS[1], "default", "root")
            frame(3, docs)
            results[poisoned] = {
                "acks": [_ack(a) for a in pushed], "read": read,
                "info": info, "stats": dict(storm.stats),
                "planes": _planes(side, seq, merge),
                "entries": {d: merge.map_entries(d, "default", "root")
                            for d in docs}}
            _close(storm)
        p, c = results[True], results[False]
        assert p["read"] == c["read"]  # the fold of the durable records
        assert p["entries"] == c["entries"]
        assert p["info"]["replayed_ticks"] == 2
        out[side] = p
    t, j = out["torch"], out["jax"]
    assert t["acks"] == j["acks"] and t["read"] == j["read"]
    assert t["info"] == j["info"] and t["stats"] == j["stats"]
    assert t["entries"] == j["entries"]
    _assert_planes_equal(j["planes"], t["planes"])


@pytest.mark.parametrize("durability", ["group", "sync", None])
def test_trim_tick_blobs_matches_jax(tmp_path, durability):
    """Superseded ticks shrink to docs-less filler records in place
    (tick ids stay WAL positions): the same trim leaves the same WAL on
    both sides, and a reopened spill dir rescans to the same index."""
    out = {}
    for side in SIDES:
        root = tmp_path / side
        svc, storm, *_ = _stack(side, root, 1, durability, snapshots=False)
        clients = _join(svc)
        for frames in _script(seed=2):
            _submit(storm, clients, frames, None)
            storm.flush()
        changed = storm.trim_tick_blobs({0, 2})
        blobs = [storm._read_blob(t) for t in range(storm._tick_counter)]
        _close(storm)
        rescan = None
        if durability is not None:
            _s, storm2, *_ = _stack(side, root, 1, durability,
                                    snapshots=False)
            rescan = (storm2._tick_counter, storm2._doc_ticks)
            _close(storm2)
        out[side] = (changed, blobs, rescan)
    assert out["torch"] == out["jax"]
    assert out["jax"][0] == 2
