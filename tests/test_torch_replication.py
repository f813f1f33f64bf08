"""Quorum replication and failover of the port (``server/replication.py``,
``server/historian.py`` and the storm's replication hooks) against the
JAX package's, on ``device="cpu"``.

The cases of ``tests/test_replication.py`` and ``tests/test_historian.py``
as differentials: each scenario runs once per package over its own
directories with a pinned service clock, makes the reference test's own
assertions on its side, and returns what it observed — the sha256 of
every file it wrote (leader WAL, replica WALs, head journals, retention
and incarnation files, snapshot store), frame responses,
``replicated_len`` and the ack gate, plane and node ``stats``, promotion
reports (but the wall-clock blackout), the promoted host's map planes
and its own replicated serving. The two records must be equal.
"""

from __future__ import annotations

import hashlib
import itertools
import os
from types import SimpleNamespace

import numpy as np
import pytest

from fluidframework_tpu.parallel import placement as j_pl
from fluidframework_tpu.protocol import codec as j_codec
from fluidframework_tpu.server import durable_store as j_ds
from fluidframework_tpu.server import historian as j_hn
from fluidframework_tpu.server import history as j_hist
from fluidframework_tpu.server import replication as j_rep
from fluidframework_tpu_torch.parallel import placement as t_pl
from fluidframework_tpu_torch.protocol import codec as t_codec
from fluidframework_tpu_torch.server import durable_store as t_ds
from fluidframework_tpu_torch.server import historian as t_hn
from fluidframework_tpu_torch.server import history as t_hist
from fluidframework_tpu_torch.server import replication as t_rep

PKG = {
    "jax": SimpleNamespace(pl=j_pl, codec=j_codec, ds=j_ds, hn=j_hn,
                           hist=j_hist, rep=j_rep, dev={}),
    "torch": SimpleNamespace(pl=t_pl, codec=t_codec, ds=t_ds, hn=t_hn,
                             hist=t_hist, rep=t_rep, dev={"device": "cpu"}),
}
SIDES = ("jax", "torch")
K = 8


def both(tmp_path, scenario, **kw):
    """Run ``scenario(side, root, **kw)`` for each package; the records
    must be equal. Returns the port's record."""
    got = {side: scenario(side, tmp_path / side, **kw) for side in SIDES}
    assert got["torch"] == got["jax"]
    return got["torch"]


def files(root) -> dict:
    """sha256 of every file under ``root``, by relative path — but the
    per-op bus and state stores (``bus/``, ``state/``): the deli stamps
    its join records' traces with the host's performance counter."""
    out = {}
    for base, dirs, names in os.walk(root):
        dirs[:] = [d for d in dirs if d not in ("bus", "state")]
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def pin(storm):
    storm.service._clock = itertools.count(1000, 7).__next__
    return storm


def _words(seed, k=K):
    rng = np.random.default_rng(seed)
    kinds = rng.choice([0, 0, 0, 1], size=k).astype(np.uint32)  # set/del
    slots = rng.integers(0, 16, k).astype(np.uint32)
    vals = rng.integers(0, 1 << 20, k).astype(np.uint32)
    return (kinds | (slots << 2) | (vals << 12)).astype(np.uint32)


def _build(side, root, followers=1, acks_required=None, label="hostA",
           num_docs=8):
    P = PKG[side]
    git = P.ds.GitSnapshotStore(str(root / "git"))
    f_dirs = [str(root / f"f{i}") for i in range(followers)]
    storm, plane = P.rep.make_replicated_host(
        label, str(root / label), git, f_dirs,
        acks_required=acks_required, num_docs=num_docs, **P.dev)
    return git, pin(storm), plane


def _serve(storm, docs, rounds, cseq=None, clients=None, seed=3, k=K,
           sink=None):
    if clients is None:
        clients = {d: storm.service.connect(d, lambda m: None).client_id
                   for d in docs}
        storm.service.pump()
    cseq = cseq if cseq is not None else {d: 1 for d in docs}
    for r in range(rounds):
        for i, d in enumerate(docs):
            w = _words([seed, cseq[d], i], k)
            storm.submit_frame(
                sink or (lambda p: None),
                {"rid": (cseq[d], d),
                 "docs": [[d, clients[d], cseq[d], 1, k]]},
                memoryview(w.tobytes()))
            cseq[d] += k
        storm.flush()
    return clients, cseq


def _entries(storm, docs):
    return {d: storm.merge_host.map_entries(d, storm.datastore,
                                            storm.channel)
            for d in docs}


def _close(storm):
    if storm._group_wal is not None:
        storm._group_wal.close()


def record(p) -> dict:
    """An ack or nack as a comparable record (``dw`` is thread-timed)."""
    if hasattr(p, "rows"):
        return {"rid": repr(p.get("rid")),
                "rows": np.asarray(p.rows).tolist()}
    return {k: repr(v) for k, v in p.items() if k != "dw"}


#: Counters that count shipped BATCHES: the group-commit writer thread
#: decides how many records each fsync batch holds, so these move with
#: thread timing in either package (records and lengths do not).
BATCH_STATS = frozenset({"batches_shipped", "ship_failures", "ship_retries",
                         "resyncs", "batches", "dup_records", "gap_nacks"})


def counters(stats) -> dict:
    return {k: v for k, v in stats.items() if k not in BATCH_STATS}


def plane_state(storm, plane) -> dict:
    return {"replicated": plane.replicated_len,
            "durable": storm._group_wal.durable_len,
            "acked": storm.acked_watermark,
            "lag": plane.follower_lag, "stats": counters(plane.stats),
            "role": plane.role, "incarnation": plane.incarnation,
            "nodes": {lk.node.node_id: (lk.node.log_len,
                                        counters(lk.node.stats))
                      for lk in plane.links}}


def test_port_module_keeps_the_references_names():
    for name in ("REPLICATION_STREAM_VERSION", "REPLICATION_KILL_POINTS",
                 "REPLICA_WAL_RELPATH", "REPLICA_HEADS_RELPATH",
                 "REPLICA_RETENTION_RELPATH", "REPLICA_INCARNATION_RELPATH",
                 "RESYNC_BATCH_RECORDS", "__all__"):
        assert getattr(t_rep, name) == getattr(j_rep, name), name
    assert t_rep._trimmed_filler() == j_rep._trimmed_filler()


def test_historian_module_is_the_references_verbatim():
    import inspect
    assert inspect.getsource(t_hn) == inspect.getsource(j_hn)


def test_entry_points_default_to_the_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults serve on it")
    git = t_ds.GitSnapshotStore(str(tmp_path / "git"))
    with pytest.raises(RuntimeError, match="cuda"):
        t_rep.make_replicated_host("hostA", str(tmp_path / "a"), git,
                                   [str(tmp_path / "f0")])
    with pytest.raises(RuntimeError, match="cuda"):
        t_rep.promote("hostA", [t_rep.ReplicaNode(tmp_path / "f1")], git,
                      follower_dirs=[str(tmp_path / "f2")])


# -- shipped-batch stream hygiene (torn / reordered / duplicated) --------------


def _frame(side, kind, header, payload=b""):
    return PKG[side].rep._frame(kind, header, payload)


def _torn(side, root):
    R = PKG[side].rep
    node = R.ReplicaNode(root / "f")
    torn = _frame(side, "batch", {"seq": 0, "lens": [4, 4]}, b"only5")
    resp = node.on_frame(torn)
    hdr, _ = PKG[side].codec.decode_storm_body(resp)
    assert hdr["k"] == "nack" and hdr["reason"] == "torn-payload"
    assert node.log_len == 0 and node.stats["rejected"] == 1
    good = _frame(side, "batch", {"seq": 0, "lens": [4, 4]}, b"aaaabbbb")
    hdr2 = R.ReplicaLink(node).call(good)
    assert hdr2["k"] == "ack" and hdr2["len"] == 2
    assert node.read(0) == b"aaaa" and node.read(1) == b"bbbb"
    node.close()
    return {"resp": bytes(resp), "hdr2": hdr2, "stats": node.stats,
            "files": files(root)}


def test_torn_payload_rejected_whole(tmp_path):
    both(tmp_path, _torn)


def _truncated(side, root):
    R = PKG[side].rep
    node = R.ReplicaNode(root / "f")
    link = R.ReplicaLink(node)
    link.transform = lambda b: b[:max(1, len(b) // 2)]
    hdr = link.call(_frame(side, "batch", {"seq": 0, "lens": [3]}, b"abc"))
    assert hdr["k"] == "nack" and node.log_len == 0
    node.close()
    return {"hdr": hdr, "stats": node.stats, "files": files(root)}


def test_truncated_frame_on_the_wire_rejected(tmp_path):
    both(tmp_path, _truncated)


def _reordered(side, root):
    R = PKG[side].rep
    node = R.ReplicaNode(root / "f")
    link = R.ReplicaLink(node)
    hdr = link.call(_frame(side, "batch", {"seq": 5, "lens": [3]}, b"abc"))
    assert hdr["k"] == "nack" and hdr["reason"] == "gap"
    assert hdr["len"] == 0 and node.stats["gap_nacks"] == 1
    assert node.log_len == 0
    node.close()
    return {"hdr": hdr, "stats": node.stats}


def test_reordered_batch_gap_nacks_with_local_length(tmp_path):
    both(tmp_path, _reordered)


def _duplicates(side, root):
    R = PKG[side].rep
    node = R.ReplicaNode(root / "f")
    link = R.ReplicaLink(node)
    out = [link.call(_frame(side, "batch", {"seq": 0, "lens": [2, 2]},
                            b"aabb"))]
    hdr = link.call(_frame(side, "batch", {"seq": 0, "lens": [2, 2]},
                           b"aabb"))
    assert hdr["k"] == "ack" and hdr["len"] == 2
    assert node.stats["dup_records"] == 2
    out.append(hdr)
    hdr = link.call(_frame(side, "batch", {"seq": 1, "lens": [2, 2]},
                           b"bbcc"))
    assert hdr["k"] == "ack" and hdr["len"] == 3
    assert [node.read(i) for i in range(3)] == [b"aa", b"bb", b"cc"]
    out.append(hdr)
    node.close()
    return {"hdrs": out, "stats": node.stats, "files": files(root)}


def test_duplicate_and_overlapping_batches_idempotent(tmp_path):
    both(tmp_path, _duplicates)


def _newer_version(side, root):
    R = PKG[side].rep
    node = R.ReplicaNode(root / "f")
    frame = PKG[side].codec.encode_storm_body(
        {"v": R.REPLICATION_STREAM_VERSION + 1, "k": "batch",
         "seq": 0, "lens": [1]}, b"x")
    hdr = R.ReplicaLink(node).call(frame)
    assert hdr["k"] == "nack" and hdr["reason"] == "version"
    assert node.log_len == 0
    node.close()
    return {"frame": frame, "hdr": hdr, "stats": node.stats}


def test_newer_stream_version_refused(tmp_path):
    both(tmp_path, _newer_version)


def _head_journal(side, root):
    R = PKG[side].rep
    node = R.ReplicaNode(root / "f")
    link = R.ReplicaLink(node)
    link.call(_frame(side, "head", {"hseq": 1, "key": "a", "handle": "h1"}))
    link.call(_frame(side, "head", {"hseq": 2, "key": "a", "handle": "h2"}))
    hdr = link.call(_frame(side, "head",
                           {"hseq": 1, "key": "a", "handle": "h1"}))
    assert hdr["k"] == "ack" and hdr["hseq"] == 2
    assert node.heads["a"] == (2, "h2")
    node.close()
    again = R.ReplicaNode(root / "f")
    assert again.heads["a"] == (2, "h2") and again.max_hseq == 2
    again.close()
    return {"hdr": hdr, "heads": again.heads, "stats": node.stats,
            "files": files(root)}


def test_head_flips_journal_monotonic_and_survive_reopen(tmp_path):
    both(tmp_path, _head_journal)


# -- quorum watermark gating ---------------------------------------------------


def _tracks_durable(side, root):
    _git, storm, plane = _build(side, root, followers=1)
    acks = []
    _serve(storm, ["doc-0", "doc-1"], rounds=3,
           sink=lambda p: acks.append(record(p)))
    assert storm._group_wal.durable_len > 0
    assert plane.replicated_len == storm._group_wal.durable_len
    assert storm.acked_watermark == storm._group_wal.durable_len
    assert plane.follower_lag == 0
    assert plane.stats["batches_shipped"] >= 3
    out = {"plane": plane_state(storm, plane), "acks": acks}
    _close(storm)
    out["files"] = files(root)
    return out


def test_replicated_watermark_tracks_durable_f1(tmp_path):
    both(tmp_path, _tracks_durable)


def _partition_heals(side, root):
    _git, storm, plane = _build(side, root, followers=1)
    acks = []
    sink = lambda p: acks.append(record(p))  # noqa: E731
    clients, cseq = _serve(storm, ["doc-0"], rounds=2, sink=sink)
    frozen = plane.replicated_len
    assert frozen == storm._group_wal.durable_len
    plane.links[0].down = True
    _serve(storm, ["doc-0"], rounds=2, cseq=cseq, clients=clients,
           sink=sink)
    assert storm._group_wal.durable_len > frozen
    assert plane.replicated_len == frozen
    assert storm.acked_watermark == frozen
    assert plane.stats["ship_failures"] >= 2
    mid = {"plane": plane_state(storm, plane), "acks": list(acks)}
    plane.links[0].down = False
    _serve(storm, ["doc-0"], rounds=1, cseq=cseq, clients=clients,
           sink=sink)
    assert plane.replicated_len == storm._group_wal.durable_len
    assert storm.acked_watermark == storm._group_wal.durable_len
    assert plane.links[0].node.log_len == plane.replicated_len
    out = {"mid": mid, "plane": plane_state(storm, plane), "acks": acks}
    _close(storm)
    out["files"] = files(root)
    return out


def test_partitioned_quorum_freezes_acks_then_heals(tmp_path):
    got = both(tmp_path, _partition_heals)
    # The partitioned rounds' acks were withheld, then drained on heal.
    assert len(got["mid"]["acks"]) < len(got["acks"])


def _f2_majority(side, root):
    _git, storm, plane = _build(side, root, followers=2)
    assert plane.acks_required == 1
    plane.links[1].down = True
    _serve(storm, ["doc-0", "doc-1"], rounds=3)
    assert plane.replicated_len == storm._group_wal.durable_len
    assert plane.follower_lag == storm._group_wal.durable_len
    out = plane_state(storm, plane)
    _close(storm)
    return out


def test_f2_majority_tolerates_one_follower_down(tmp_path):
    both(tmp_path, _f2_majority)


def _chain(side, root):
    _git, storm, plane = _build(side, root, followers=2, acks_required=2)
    plane.links[1].down = True
    acks = []
    _serve(storm, ["doc-0"], rounds=2, sink=acks.append)
    assert plane.replicated_len == 0
    assert storm.acked_watermark == 0
    assert acks == []
    out = plane_state(storm, plane)
    _close(storm)
    return out


def test_chain_replication_waits_for_every_follower(tmp_path):
    both(tmp_path, _chain)


def _gauges(side, root):
    _git, storm, plane = _build(side, root, followers=2)
    plane.links[1].down = True
    _serve(storm, ["doc-0"], rounds=2)
    snap = storm.merge_host.metrics.snapshot()
    assert snap["repl.role_code"] == 1
    assert snap["repl.followers"] == 2
    assert snap["repl.lag"] >= 1
    assert plane.follower_lag == storm._group_wal.durable_len
    assert snap["repl.watermark_gap"] == 0
    assert snap["repl.shipped_batches"] >= 2
    # The sampled lag and the batch count move with the writer thread's
    # batching (BATCH_STATS); the degraded clock is wall time.
    out = {k: snap[k] for k in sorted(snap)
           if k.startswith("repl.") and k not in (
               "repl.degraded_s", "repl.lag", "repl.shipped_batches")}
    _close(storm)
    return out


def test_gauges_reflect_plane_state(tmp_path):
    both(tmp_path, _gauges)


# -- follower restart / retention-floor resync ---------------------------------


def _follower_restart(side, root):
    R = PKG[side].rep
    _git, storm, plane = _build(side, root, followers=1)
    clients, cseq = _serve(storm, ["doc-0", "doc-1"], rounds=2)
    link = plane.links[0]
    link.down = True
    _serve(storm, ["doc-0", "doc-1"], rounds=2, cseq=cseq, clients=clients)
    behind = link.node.log_len
    assert behind < storm._group_wal.durable_len
    link.node.close()
    link.node = R.ReplicaNode(root / "f0")
    assert link.node.log_len == behind
    link.down = False
    _serve(storm, ["doc-0", "doc-1"], rounds=1, cseq=cseq, clients=clients)
    durable = storm._group_wal.durable_len
    assert link.node.log_len == durable
    assert plane.replicated_len == durable
    assert [link.node.read(i) for i in range(durable)] == \
        [storm._group_wal.read(i) for i in range(durable)]
    assert plane.stats["resyncs"] >= 1
    out = {"behind": behind, "plane": plane_state(storm, plane)}
    _close(storm)
    link.node.close()
    out["files"] = files(root)
    return out


def test_follower_restart_mid_stream_resumes_from_disk(tmp_path):
    both(tmp_path, _follower_restart)


def _lag_beyond_floor(side, root):
    P = PKG[side]
    docs = ["doc-0", "doc-1"]
    git, storm, plane = _build(side, root, followers=2)
    hist = P.hist.HistoryPlane(storm, summary_interval_ops=1,
                               tail_retention_summaries=0,
                               trim_batch_ticks=1)
    clients, cseq = _serve(storm, docs, rounds=2)
    lagger = plane.links[1]
    lagger.down = True
    behind = lagger.node.log_len
    _serve(storm, docs, rounds=3, cseq=cseq, clients=clients)
    storm.checkpoint()
    for d in docs:
        hist.compact(d)
    hist.trim_now()
    assert hist.stats["trimmed_ticks"] > 0
    lagger.down = False
    _serve(storm, docs, rounds=1, cseq=cseq, clients=clients)
    want = _entries(storm, docs)
    durable = storm._group_wal.durable_len
    assert lagger.node.log_len == durable
    assert [lagger.node.read(i) for i in range(behind, durable)] \
        == [storm._group_wal.read(i) for i in range(behind, durable)]
    assert any(b"trimmed" in lagger.node.read(i)
               for i in range(behind, durable))
    lagger_log = [lagger.node.read(i).hex() for i in range(durable)]
    _close(storm)
    new_storm, new_plane, report = P.rep.promote(
        "hostA", [lagger.node], git,
        follower_dirs=[str(root / "fresh")], num_docs=8, **P.dev)
    pin(new_storm)
    assert report["promoted_node"] == "f1"
    assert _entries(new_storm, docs) == want
    report.pop("blackout_ms")
    out = {"want": want, "report": report, "lagger_log": lagger_log,
           "hist": dict(hist.stats),
           "plane": plane_state(new_storm, new_plane)}
    _close(new_storm)
    out["files"] = files(root)
    return out


def test_lag_beyond_retention_floor_converges_on_snapshot_plus_tail(
        tmp_path):
    both(tmp_path, _lag_beyond_floor)


# -- replicated head flips (ship-then-flip) ------------------------------------


def _ship_then_flip(side, root):
    git, storm, plane = _build(side, root, followers=1)
    store = storm.snapshots
    assert isinstance(store, PKG[side].rep.ReplicatedHeadStore)
    handle = git.upload("docX", {"kind": "x", "n": 1})
    store.set_head("docX", handle)
    assert git.head("docX") == handle
    node = plane.links[0].node
    assert node.heads["docX"][1] == handle
    out = {"handle": handle, "heads": dict(node.heads)}
    _close(storm)
    node.close()
    out["files"] = files(root)
    return out


def test_set_head_ships_before_backend_flip(tmp_path):
    both(tmp_path, _ship_then_flip)


def _quorum_refusal(side, root):
    R = PKG[side].rep
    git, storm, plane = _build(side, root, followers=1)
    _serve(storm, ["doc-0"], rounds=1)
    plane.links[0].down = True
    handle = git.upload("docX", {"kind": "x", "n": 1})
    with pytest.raises(R.ReplicationQuorumError):
        storm.snapshots.set_head("docX", handle)
    assert git.head("docX") is None
    assert plane.stats["quorum_refusals"] == 1
    with pytest.raises(R.ReplicationQuorumError):
        storm.checkpoint()
    plane.links[0].down = False
    cp = storm.checkpoint()
    out = {"checkpoint": cp, "plane": plane_state(storm, plane)}
    _close(storm)
    out["files"] = files(root)
    return out


def test_quorum_refusal_leaves_backend_untouched(tmp_path):
    both(tmp_path, _quorum_refusal)


def _promote_heads(side, root):
    P = PKG[side]
    git = P.ds.GitSnapshotStore(str(root / "git"))
    node = P.rep.ReplicaNode(root / "f0")
    plane = P.rep.ReplicationPlane([node])
    h1 = git.upload("docX", {"kind": "x", "n": 1})
    plane.ship_head("docX", h1)
    git.set_head("docX", h1)
    h2 = git.upload("docX", {"kind": "x", "n": 2})
    plane.ship_head("docX", h2)
    assert git.head("docX") == h1
    assert P.rep.promote_heads([node], git) == 1
    assert git.head("docX") == h2
    assert P.rep.promote_heads([node], git) == 0
    node.close()
    return {"heads": (h1, h2), "files": files(root)}


def test_promote_heads_rolls_crash_window_forward(tmp_path):
    both(tmp_path, _promote_heads)


def _candidate(side, root):
    R = PKG[side].rep
    a = R.ReplicaNode(root / "a")
    b = R.ReplicaNode(root / "b")
    R.ReplicaLink(b).call(_frame(side, "batch", {"seq": 0, "lens": [2]},
                                 b"xy"))
    assert R.choose_promotion_candidate([a, b]) is b
    R.ReplicaLink(a).call(_frame(side, "batch", {"seq": 0, "lens": [2]},
                                 b"xy"))
    R.ReplicaLink(a).call(_frame(side, "head", {"hseq": 1, "key": "k",
                                                "handle": "h"}))
    assert R.choose_promotion_candidate([a, b]) is a
    a.close()
    b.close()
    return files(root)


def test_candidate_choice_prefers_longest_log(tmp_path):
    both(tmp_path, _candidate)


# -- promotion + fencing -------------------------------------------------------


def _promotion(side, root):
    P = PKG[side]
    docs = ["doc-0", "doc-1"]
    git, storm, plane = _build(side, root, followers=2)
    clients, cseq = _serve(storm, docs, rounds=2)
    storm.checkpoint()
    _serve(storm, docs, rounds=2, cseq=cseq, clients=clients)
    want = _entries(storm, docs)
    durable = storm._group_wal.durable_len
    _close(storm)
    nodes = [lk.node for lk in plane.links]
    new_storm, new_plane, report = P.rep.promote(
        "hostA", nodes, git, follower_dirs=[str(root / "fresh")],
        num_docs=8, **P.dev)
    pin(new_storm)
    assert report["log_len"] == durable
    assert report.pop("blackout_ms") > 0
    assert report["replayed_ticks"] > 0
    assert _entries(new_storm, docs) == want
    assert new_plane.replicated_len == durable
    fresh = [lk for lk in new_plane.links
             if lk.node.node_id == "fresh"][0]
    assert fresh.node.log_len == durable
    acks = []
    _serve(new_storm, docs, rounds=1, cseq=cseq, clients=None,
           sink=lambda p: acks.append(record(p)))
    assert new_plane.replicated_len \
        == new_storm._group_wal.durable_len > durable
    out = {"want": want, "report": report, "acks": acks,
           "after": _entries(new_storm, docs),
           "plane": plane_state(new_storm, new_plane)}
    _close(new_storm)
    out["files"] = files(root)
    return out


def test_promotion_reproduces_acked_state_and_rearms(tmp_path):
    both(tmp_path, _promotion)


def _fenced(side, root):
    R = PKG[side].rep
    _git, storm, plane = _build(side, root, followers=1)
    clients, cseq = _serve(storm, ["doc-0"], rounds=1)
    frozen = storm.acked_watermark
    plane.fence(moved_to="hostA")
    shed = []
    storm.submit_frame(
        shed.append,
        {"rid": (99, "doc-0"),
         "docs": [["doc-0", clients["doc-0"], cseq["doc-0"], 1, K]]},
        memoryview(_words([9, 9]).tobytes()))
    storm.flush()
    assert len(shed) == 1
    assert shed[0]["moved_to"] == {"doc-0": "hostA"}
    with pytest.raises(RuntimeError):
        storm.checkpoint()
    with pytest.raises(R.ReplicationQuorumError):
        plane.ship_head("k", "h")
    assert storm.acked_watermark == frozen
    snap = storm.merge_host.metrics.snapshot()
    assert snap["repl.role_code"] == 3
    out = {"shed": [record(p) for p in shed], "stats": dict(storm.stats),
           "plane": plane_state(storm, plane)}
    _close(storm)
    return out


def test_fenced_leader_sheds_refuses_and_never_acks(tmp_path):
    got = both(tmp_path, _fenced)
    assert got["shed"][0]["error"] == "'moved'"


def _fail_over(side, root):
    P = PKG[side]
    docs = ["doc-0", "doc-1"]
    git = P.ds.GitSnapshotStore(str(root / "git"))
    hist_front = P.hn.Historian(git, head_ttl_s=1e9)
    old, plane = P.rep.make_replicated_host(
        "hostA", str(root / "hostA"), git,
        [str(root / "f0"), str(root / "f1")], num_docs=8, **P.dev)
    pin(old)
    other = pin(P.pl.make_cluster_host("hostB", str(root / "hostB"),
                                       git, num_docs=8, **P.dev))
    cluster = P.pl.StormCluster({"hostA": old, "hostB": other},
                                hist_front)
    clients, cseq = _serve(old, docs, rounds=2)
    old.checkpoint()
    h1 = git.upload("stale-doc", {"kind": "x", "n": 1})
    git.set_head("stale-doc", h1)
    assert hist_front.head("stale-doc") == h1
    h2 = git.upload("stale-doc", {"kind": "x", "n": 2})
    git.set_head("stale-doc", h2)
    assert hist_front.head("stale-doc") == h1
    _close(old)
    new_storm, _p, rep = P.rep.promote(
        "hostA", [lk.node for lk in plane.links], git, num_docs=8, **P.dev)
    pin(new_storm)
    inc0 = cluster.directory.incarnation_of("hostA")
    inc = cluster.fail_over("hostA", new_storm,
                            blackout_ms=rep["blackout_ms"])
    assert inc == inc0 + 1
    assert cluster.directory.incarnation_of("hostA") == inc
    assert plane.fenced and plane.moved_to == "hostA"
    assert cluster.hosts["hostA"] is new_storm
    assert hist_front.head("stale-doc") == h2
    snap = new_storm.merge_host.metrics.snapshot()
    assert snap["repl.last_failover_blackout_ms"] \
        == round(rep["blackout_ms"], 3)
    rebuilt = P.pl.StormCluster({"hostA": new_storm, "hostB": other}, git)
    assert rebuilt.directory.incarnation_of("hostA") == inc
    rep.pop("blackout_ms")
    # The reference scenario serves both docs at hostA whatever their
    # owner, so a doc hostB owns was shed ``moved`` and has no row.
    owners = {d: cluster.owner_of(d) for d in docs}
    mine = [d for d in docs if owners[d] == "hostA"]
    out = {"inc": inc, "report": rep, "stats": cluster.stats,
           "owners": owners, "entries": _entries(new_storm, mine),
           "shed": old.stats["shed_frames"],
           "placement": git.head(P.pl.StormClusterDirectory.KEY),
           "historian": {k: v for k, v in hist_front.stats().items()
                         if k != "bytes"}}
    _close(new_storm)
    _close(other)
    out["files"] = files(root)
    return out


def test_cluster_fail_over_bumps_incarnation_and_flushes_caches(tmp_path):
    both(tmp_path, _fail_over)


# -- ship-failure triage (transient vs permanent) ------------------------------


class _FlakyLink:
    """Raise ``exc`` for the next ``times`` calls, then delegate."""

    def __init__(self, inner, exc, times=1):
        self.inner, self.exc, self.times = inner, exc, times

    @property
    def node(self):
        return self.inner.node

    def call(self, frame):
        if self.times:
            self.times -= 1
            raise self.exc
        return self.inner.call(frame)


class _VersionRefusingLink:
    """A follower that can NEVER read this stream format."""

    def __init__(self, node_id, version):
        self.node_id = node_id
        self.version = version
        self.log_len = 0
        self.max_hseq = 0
        self.closed = False

    @property
    def node(self):
        return self

    def call(self, frame):
        return {"v": self.version, "k": "nack", "len": 0,
                "reason": "version"}

    def close(self):
        self.closed = True


def _transient_linkdown(side, root):
    R = PKG[side].rep
    _git, storm, plane = _build(side, root, followers=1)
    real = plane.links[0]
    plane.links[0] = _FlakyLink(real, R.ReplicationLinkDown("timed out"))
    _serve(storm, ["doc-0"], rounds=1)
    assert plane.stats["ship_retries"] == 1
    assert plane.stats["ship_failures"] == 1
    assert plane.stats["followers_dropped"] == 0
    assert len(plane.links) == 1
    assert storm.acked_watermark == storm._group_wal.durable_len > 0
    assert real.node.log_len == storm._group_wal.durable_len
    out = plane_state(storm, plane)
    _close(storm)
    return out


def test_transient_linkdown_retries_once_and_acks_same_round(tmp_path):
    both(tmp_path, _transient_linkdown)


def _transient_reset(side, root):
    _git, storm, plane = _build(side, root, followers=1)
    real = plane.links[0]
    plane.links[0] = _FlakyLink(real, ConnectionResetError("reset"))
    _serve(storm, ["doc-0"], rounds=1)
    assert plane.stats["ship_failures"] == 1
    assert plane.stats["followers_dropped"] == 0
    assert storm.acked_watermark == 0
    _serve(storm, ["doc-0"], rounds=1)
    assert plane.stats["resyncs"] >= 1
    assert storm.acked_watermark == storm._group_wal.durable_len
    assert real.node.log_len == storm._group_wal.durable_len
    out = plane_state(storm, plane)
    _close(storm)
    return out


def test_transient_reset_freezes_then_resyncs_on_next_contact(tmp_path):
    both(tmp_path, _transient_reset)


def _version_drop(side, root):
    R = PKG[side].rep
    _git, storm, plane = _build(side, root, followers=2, acks_required=2)
    stub = _VersionRefusingLink(plane.links[1].node.node_id,
                                R.REPLICATION_STREAM_VERSION)
    plane.links[1] = stub
    _serve(storm, ["doc-0"], rounds=1)
    assert plane.stats["followers_dropped"] == 1
    assert stub not in plane.links and len(plane.links) == 1
    assert stub.closed
    assert plane.acks_required == 2
    assert storm.acked_watermark == 0
    assert not plane.quorum_ok
    with pytest.raises(R.ReplicationQuorumError):
        plane.ship_head("doc-0", "h1")
    out = plane_state(storm, plane)
    _close(storm)
    return out


def test_permanent_version_nack_drops_follower_loudly(tmp_path):
    both(tmp_path, _version_drop)


# -- quorum parking: a lost quorum parks writes FIFO, then sheds ---------------


def _quorum_parking(side, root):
    _git, storm, plane = _build(side, root, followers=1)
    acks = []
    sink = lambda p: acks.append(record(p))  # noqa: E731
    clients, cseq = _serve(storm, ["doc-0", "doc-1"], rounds=1, sink=sink)
    # An armed detector with a lease nobody can renew: the quorum is lost.
    plane.lease_s = 0.0
    plane._last_ok = {nid: -1e9 for nid in plane._last_ok}
    plane.park_max_s = 1e9
    _serve(storm, ["doc-0", "doc-1"], rounds=2, cseq=cseq, clients=clients,
           sink=sink)
    parked = {"acks": len(acks), "frames": len(storm._frames),
              "gauge": storm.merge_host.metrics.snapshot()[
                  "repl.parked_docs"],
              "durable": storm._group_wal.durable_len}
    assert parked["frames"] == 4 and parked["acks"] == 2
    # Past park_max_s the next frame sheds "quorum-lost".
    plane.park_max_s = 0.0
    _serve(storm, ["doc-0"], rounds=1, cseq=dict(cseq), clients=clients,
           sink=sink)
    assert acks[-1] == {k: repr(v) for k, v in {
        "rid": (cseq["doc-0"], "doc-0"), "storm": True,
        "error": "quorum-lost", "retryable": True,
        "retry_after_s": storm.busy_retry_s}.items()}
    # Healed: the parked frames sequence in arrival order and ack.
    plane.lease_s = None
    storm.flush()
    out = {"parked": parked, "acks": acks, "stats": dict(storm.stats),
           "entries": _entries(storm, ["doc-0", "doc-1"]),
           "plane": plane_state(storm, plane)}
    _close(storm)
    out["files"] = files(root)
    return out


def test_lost_quorum_parks_writes_in_order_then_sheds(tmp_path):
    got = both(tmp_path, _quorum_parking)
    assert got["stats"]["quorum_rejects"] == 1
    assert got["plane"]["replicated"] == got["plane"]["durable"]


# -- historian (read-through LRU over the snapshot store) ----------------------


class _CountingBackend:
    """Wraps a GitSnapshotStore counting backend object reads."""

    def __init__(self, store):
        self._store = store
        self.object_reads = 0

    def __getattr__(self, name):
        return getattr(self._store, name)

    def get_object(self, sha):
        self.object_reads += 1
        return self._store.get_object(sha)


def _hist_warm(side, root):
    P = PKG[side]
    backend = _CountingBackend(P.ds.GitSnapshotStore(root))
    historian = P.hn.Historian(backend)
    handle = historian.upload("doc", {"text": "hello" * 100})
    historian.set_head("doc", handle)
    first = historian.get("doc", handle)
    assert first == {"text": "hello" * 100}
    assert backend.object_reads == 0
    assert historian.get("doc", handle) == first
    assert backend.object_reads == 0
    assert historian.stats()["object_hits"] > 0
    return {"handle": handle, "stats": historian.stats(),
            "files": files(root)}


def test_historian_upload_warms_cache_and_reads_hit(tmp_path):
    both(tmp_path, _hist_warm)


def _hist_cold(side, root):
    P = PKG[side]
    store = P.ds.GitSnapshotStore(root)
    handle = store.upload("doc", {"text": "cold"})
    backend = _CountingBackend(store)
    historian = P.hn.Historian(backend)
    assert historian.get("doc", handle) == {"text": "cold"}
    reads = backend.object_reads
    assert reads > 0
    assert historian.get("doc", handle) == {"text": "cold"}
    assert backend.object_reads == reads
    return {"reads": reads, "stats": historian.stats()}


def test_historian_cold_reads_through(tmp_path):
    both(tmp_path, _hist_cold)


def _hist_ttl(side, root):
    P = PKG[side]
    now = [0.0]
    backend = P.ds.GitSnapshotStore(root)
    historian = P.hn.Historian(backend, head_ttl_s=5.0,
                               clock=lambda: now[0])
    h1 = historian.upload("doc", {"v": 1})
    historian.set_head("doc", h1)
    assert historian.head("doc") == h1
    other = P.hn.Historian(backend, head_ttl_s=5.0, clock=lambda: now[0])
    h2 = other.upload("doc", {"v": 2})
    other.set_head("doc", h2)
    assert historian.head("doc") == h1
    now[0] += 6.0
    assert historian.head("doc") == h2
    return {"heads": (h1, h2), "stats": historian.stats()}


def test_historian_head_write_through_and_ttl(tmp_path):
    both(tmp_path, _hist_ttl)


def _hist_lru(side, root):
    P = PKG[side]
    historian = P.hn.Historian(P.ds.GitSnapshotStore(root), max_objects=4,
                               max_bytes=10_000)
    shas = [historian.put_object(f"payload-{i}".encode() * 50)
            for i in range(10)]
    stats = historian.stats()
    assert stats["objects"] <= 4
    assert stats["bytes"] <= 10_000
    assert stats["evictions"] > 0
    assert historian.get_object(shas[0]).startswith(b"payload-0")
    return {"shas": shas, "stats": historian.stats()}


def test_historian_lru_eviction_bounds(tmp_path):
    both(tmp_path, _hist_lru)


def _hist_oversized(side, root):
    P = PKG[side]
    historian = P.hn.Historian(P.ds.GitSnapshotStore(root), max_objects=8,
                               max_bytes=100)
    sha = historian.put_object(b"x" * 1000)
    assert historian.get_object(sha) == b"x" * 1000
    assert historian.stats()["objects"] == 0
    return {"sha": sha, "stats": historian.stats()}


def test_historian_oversized_object_served_not_cached(tmp_path):
    both(tmp_path, _hist_oversized)


def test_historian_service_snapshot_path(tmp_path):
    """The reference suite's service-assembly case: a summary written and
    read back through each package's ``alfred.build_default_service``,
    whose snapshot store is a historian over a git store."""
    from fluidframework_tpu.server.alfred import build_default_service
    from fluidframework_tpu_torch.server import alfred as t_alfred

    got = {}
    for side in SIDES:
        root = tmp_path / side
        if side == "jax":
            service = build_default_service(str(root), merge_host=False)
        else:
            service = t_alfred.build_default_service(
                str(root), merge_host=False, device="cpu")
        assert isinstance(service.snapshots, PKG[side].hn.Historian)
        service.upload_snapshot("doc", {"tree": {"a": 1}})
        assert service.get_latest_snapshot("doc") == {"tree": {"a": 1}}
        assert service.get_latest_snapshot("doc") == {"tree": {"a": 1}}
        assert service.snapshots.stats()["object_hits"] > 0
        got[side] = {"stats": service.snapshots.stats(),
                     "head": service.snapshots.head("doc"),
                     "git": files(root / "git")}
    assert got["torch"] == got["jax"]
