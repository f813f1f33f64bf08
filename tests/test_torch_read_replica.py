"""The port's read-replica tier (``server/read_replica.py``: follower-
tailing read hosts, the replica directory and router, and the viewer
plane a replica runs) against the JAX package's, on ``device="cpu"``.

The cases of ``tests/test_read_replica.py`` as differentials: each runs
once per package over its own directories with the service clock and
the deli's trace clock pinned, makes the reference test's own
assertions on its side (replica reads == the leader's), and returns what
it observed — ``read_at`` at every tested seq, ``get_deltas`` in wire
form, re-broadcast viewer frames, redirects with their ``moved_to``,
staleness sheds, directory heads and replica ``stats``. The two records
must be equal.
"""

from __future__ import annotations

import itertools
import time
from types import SimpleNamespace

import numpy as np
import pytest

from fluidframework_tpu.parallel import placement as j_pl
from fluidframework_tpu.protocol import codec as j_codec
from fluidframework_tpu.protocol import messages as j_messages
from fluidframework_tpu.server import durable_store as j_ds
from fluidframework_tpu.server import history as j_hist
from fluidframework_tpu.server import megadoc as j_mega
from fluidframework_tpu.server import read_replica as j_rr
from fluidframework_tpu.server import replication as j_rep
from fluidframework_tpu_torch.parallel import placement as t_pl
from fluidframework_tpu_torch.protocol import codec as t_codec
from fluidframework_tpu_torch.protocol import messages as t_messages
from fluidframework_tpu_torch.server import durable_store as t_ds
from fluidframework_tpu_torch.server import history as t_hist
from fluidframework_tpu_torch.server import megadoc as t_mega
from fluidframework_tpu_torch.server import read_replica as t_rr
from fluidframework_tpu_torch.server import replication as t_rep

PKG = {
    "jax": SimpleNamespace(pl=j_pl, codec=j_codec, messages=j_messages,
                           ds=j_ds, hist=j_hist, mega=j_mega, rr=j_rr,
                           rep=j_rep, dev={}),
    "torch": SimpleNamespace(pl=t_pl, codec=t_codec, messages=t_messages,
                             ds=t_ds, hist=t_hist, mega=t_mega, rr=t_rr,
                             rep=t_rep, dev={"device": "cpu"}),
}
SIDES = ("jax", "torch")
OP = j_messages.MessageType.OPERATION
K = 8


def both(tmp_path, scenario, **kw):
    """Run ``scenario(side, root, **kw)`` for each package with the deli's
    trace clock pinned; the records must be equal."""
    got = {}
    for side in SIDES:
        mod = PKG[side].messages
        saved = mod.time
        mod.time = SimpleNamespace(monotonic=itertools.count(1).__next__)
        try:
            got[side] = scenario(side, tmp_path / side, **kw)
        finally:
            mod.time = saved
    assert got["torch"] == got["jax"]
    return got["torch"]


def _words(seed, r, i, k=K):
    rng = np.random.default_rng([seed, r, i])
    kinds = rng.choice([0, 0, 0, 1, 2], size=k).astype(np.uint32)
    slots = rng.integers(0, 16, k).astype(np.uint32)
    vals = rng.integers(0, 1 << 20, k).astype(np.uint32)
    return (kinds | (slots << 2) | (vals << 12)).astype(np.uint32)


def _build(P, root, followers=1, label="hostA", num_docs=8, **hist_kw):
    git = P.ds.GitSnapshotStore(str(root / "git"))
    f_dirs = [str(root / f"f{i}") for i in range(followers)]
    storm, plane = P.rep.make_replicated_host(
        label, str(root / label), git, f_dirs, num_docs=num_docs, **P.dev)
    storm.service._clock = itertools.count(1000, 7).__next__
    hist = P.hist.HistoryPlane(storm, **hist_kw)
    return git, storm, plane, hist


def _serve(storm, docs, rounds, seed=7, clients=None, cseq=None):
    if clients is None:
        clients = {d: storm.service.connect(d, lambda m: None).client_id
                   for d in docs}
        storm.service.pump()
    cseq = cseq if cseq is not None else {d: 1 for d in docs}
    for _r in range(rounds):
        for i, d in enumerate(docs):
            w = _words(seed, cseq[d], i)
            storm.submit_frame(
                lambda p: None,
                {"rid": (cseq[d], d),
                 "docs": [[d, clients[d], cseq[d], 1, K]]},
                memoryview(w.tobytes()))
            cseq[d] += K
        storm.flush()
    return clients, cseq


def _wire_ops(P, messages):
    return [P.codec.to_wire(m) for m in messages if m.type == OP]


def _close(storm):
    if storm._group_wal is not None:
        storm._group_wal.close()


def _replica(P, plane, git, i=0, **kw):
    return P.rr.ReadReplica(plane.links[i].node, git, f"replica{i}",
                            leader_label="hostA", **kw)


# -- differential byte-exactness ----------------------------------------------


def test_read_surface_byte_identical(tmp_path):
    def scenario(side, root):
        P = PKG[side]
        git, storm, plane, hist = _build(P, root)
        docs = ["doc-0", "doc-1"]
        _serve(storm, docs, rounds=4)
        rep = _replica(P, plane, git)
        assert rep.lag == 0
        out = {}
        for d in docs:
            head = storm.service.read_at(d, 0)["head_seq"]
            assert rep.head_seq(d) == head
            reads = []
            for s in range(head + 1):
                leader = storm.service.read_at(d, s)
                assert rep.read_at(d, s) == leader, (d, s)
                reads.append(leader)
            deltas = _wire_ops(P, rep.get_deltas(d, 0, head))
            assert deltas == _wire_ops(P, storm.service.get_deltas(d, 0,
                                                                   head))
            tail = _wire_ops(P, rep.get_deltas(d, head // 2))
            assert tail == _wire_ops(P, storm.service.get_deltas(
                d, head // 2, head))
            out[d] = [head, reads, deltas, tail]
        _close(storm)
        return [out, rep.stats, rep.applied]

    both(tmp_path, scenario)


def test_branch_reads_and_write_redirects(tmp_path):
    def scenario(side, root):
        P = PKG[side]
        git, storm, plane, hist = _build(P, root)
        _serve(storm, ["doc-0"], rounds=3)
        branch = hist.fork("doc-0", 16, name="b1")
        storm.flush()
        rep = _replica(P, plane, git)
        assert rep.branches[branch]["parent"] == "doc-0"
        reads = []
        for s in (0, 7, 16):
            got = rep.read_at(branch, s)
            assert got == storm.service.read_at(branch, s)
            reads.append(got)
        moved = []
        for verb in (lambda: rep.connect("doc-0"),
                     lambda: rep.fork_doc("doc-0", 8),
                     lambda: rep.merge_back(branch)):
            with pytest.raises(P.rr.ReplicaRedirect) as err:
                verb()
            assert err.value.moved_to == "hostA"
            moved.append([err.value.moved_to, err.value.retry_after_s])
        _close(storm)
        return [branch, rep.branches, reads, moved]

    both(tmp_path, scenario)


def test_stale_reads_wait_then_shed(tmp_path):
    def scenario(side, root):
        P = PKG[side]
        git, storm, plane, hist = _build(P, root)
        _serve(storm, ["doc-0"], rounds=2)
        rep = _replica(P, plane, git, read_wait_s=0.02)
        head = rep.head_seq("doc-0")
        with pytest.raises(P.rr.ReplicaRedirect) as err:
            rep.read_at("doc-0", head + 100)
        assert err.value.moved_to == "hostA"
        with pytest.raises(P.rr.ReplicaRedirect):
            rep.get_deltas("doc-0", 0, head + 100)
        assert rep.stats["stale_redirects"] == 2
        assert rep.metrics.counter("replica.stale_redirects").value == 2
        _close(storm)
        return [head, rep.stats]

    both(tmp_path, scenario)


def test_mega_promoted_doc_redirects(tmp_path):
    def scenario(side, root):
        P = PKG[side]
        git, storm, plane, hist = _build(P, root)
        mgr = P.mega.MegaDocManager(storm, default_lanes=2)
        _serve(storm, ["hot"], rounds=1)
        mgr.promote("hot")
        _serve(storm, ["plain"], rounds=1)
        rep = _replica(P, plane, git)
        assert not rep.can_serve("hot")
        assert rep.can_serve("plain")
        with pytest.raises(P.rr.ReplicaRedirect) as err:
            rep.read_at("hot", 1)
        assert err.value.moved_to == "hostA"
        routes = [rep.read_router.route_read("hot", "read_at"),
                  rep.read_router.route_read("plain", "read_at")]
        assert routes == ["hostA", None]
        _close(storm)
        return [routes, rep.stats, rep.read_at("plain", 4)]

    both(tmp_path, scenario)


# -- viewer plane on the replica ----------------------------------------------


def test_rebroadcast_matches_leader_frames(tmp_path):
    """A viewer re-homed onto the replica sees the leader's frame BYTES
    for the same ticks."""
    def scenario(side, root):
        P = PKG[side]
        git, storm, plane, hist = _build(P, root)
        leader_raw: list = []
        storm.service.connect("doc-0", leader_raw.append, mode="viewer")
        clients, cseq = _serve(storm, ["doc-0"], rounds=1)
        rep = _replica(P, plane, git)
        replica_raw: list = []
        hello = rep.viewers.join("doc-0", replica_raw.append)
        assert hello["seq"] == 0
        _serve(storm, ["doc-0"], rounds=2, clients=clients, cseq=cseq)
        rep.poll()

        def ticks(raw):
            return [bytes(b) for b in raw
                    if isinstance(b, (bytes, bytearray))
                    and P.codec.is_storm_body(b)]

        assert ticks(replica_raw) == ticks(leader_raw)[1:]
        assert rep.stats["broadcast_ticks"] == 2
        _close(storm)
        return [ticks(leader_raw), ticks(replica_raw), hello,
                rep.viewers.stats, rep.stats]

    both(tmp_path, scenario)


# -- retention + restart ------------------------------------------------------


def test_trim_then_restart_serves_identical_bytes(tmp_path):
    def scenario(side, root):
        P = PKG[side]
        git, storm, plane, hist = _build(
            P, root, num_docs=4, tail_retention_summaries=0,
            trim_batch_ticks=1)
        clients, cseq = _serve(storm, ["doc-0"], rounds=4)
        assert hist.compact("doc-0")
        _serve(storm, ["doc-0"], rounds=2, clients=clients, cseq=cseq)
        storm.checkpoint()
        node = plane.links[0].node
        assert node.retained_floor > 0
        rep = P.rr.ReadReplica(node, git, "replica0", leader_label="hostA")
        restarted = P.rr.ReadReplica(node, git, "replica0b",
                                     leader_label="hostA")
        assert restarted.applied == rep.applied
        head = storm.service.read_at("doc-0", 0)["head_seq"]
        floor = hist.tail_floor("doc-0")
        reads = []
        for s in range(head + 1):
            try:
                leader = storm.service.read_at("doc-0", s)
            except P.hist.HistoryError:
                if s > floor:
                    raise
                for r in (rep, restarted):
                    with pytest.raises(P.hist.HistoryError):
                        r.read_at("doc-0", s)
                reads.append("trimmed")
                continue
            assert rep.read_at("doc-0", s) == leader, s
            assert restarted.read_at("doc-0", s) == leader, s
            reads.append(leader)
        deltas = _wire_ops(P, restarted.get_deltas("doc-0", floor, head))
        assert deltas == _wire_ops(P, storm.service.get_deltas(
            "doc-0", floor, head))
        _close(storm)
        return [node.retained_floor, head, floor, reads, deltas,
                restarted.applied]

    both(tmp_path, scenario)


# -- directory + routing ------------------------------------------------------


def test_directory_assignment_and_hash_spread(tmp_path):
    def scenario(side, root):
        P = PKG[side]
        git = P.ds.GitSnapshotStore(str(root / "git"))
        d = P.rr.ReplicaDirectory(git)
        d.register("r0")
        d.register("r1")
        d.assign_room("hot", ["r0", "r1"])
        spread = [d.replica_for("hot", "viewer", key=f"c{i}")
                  for i in range(16)]
        assert set(spread) == {"r0", "r1"}
        assert d.replica_for("hot", "viewer", key="c1") \
            == d.replica_for("hot", "viewer", key="c1")
        d.assign_reads("read_at", "r1")
        assert d.replica_for("cold", "read_at") == "r1"
        assert d.replica_for("cold", "viewer") is None
        with pytest.raises(ValueError):
            d.assign_reads("write", "r0")
        d2 = P.rr.ReplicaDirectory(git)
        assert d2.rooms() == {"hot": ["r0", "r1"]}
        d.deregister("r1")
        d2.reload()
        assert d2.replica_for("cold", "read_at") is None
        assert set(d2.rooms()["hot"]) == {"r0"}
        return [spread, d2.rooms(), git.head(P.rr.REPLICA_DIRECTORY_KEY)]

    both(tmp_path, scenario)


def test_router_local_short_circuit(tmp_path):
    def scenario(side, root):
        P = PKG[side]
        git = P.ds.GitSnapshotStore(str(root / "git"))
        d = P.rr.ReplicaDirectory(git)
        d.register("r0")
        d.assign_room("hot", "r0")
        router = P.rr.ReplicaRouter(d, local_label="hostA")
        routes = [router.route_read("hot", "viewer"),
                  router.route_read("hot", "write"),
                  router.route_read("cold", "viewer")]
        assert routes == ["r0", None, None]
        local = P.rr.ReplicaRouter(d, local_label="r0")
        assert local.route_read("hot", "viewer") is None
        assert router.metrics.counter("replica.redirects").value == 1
        return [routes, router.retry_after_s]

    both(tmp_path, scenario)


def test_balancer_spread_rehomes_room(tmp_path):
    def scenario(side, root):
        P = PKG[side]
        git, storm, plane, hist = _build(P, root, followers=2)
        moved: list = []

        def _viewer(payload):
            if isinstance(payload, dict) \
                    and payload.get("event") == "viewer_resync":
                moved.append(payload)

        for _ in range(3):
            storm.service.connect("doc-0", _viewer, mode="viewer")
        _serve(storm, ["doc-0"], rounds=2)
        reps = {f"replica{i}": _replica(P, plane, git, i) for i in range(2)}
        directory = P.rr.ReplicaDirectory(git)
        bal = P.pl.ReplicaBalancer(directory, reps, leader_storm=storm)
        out = bal.spread_room("doc-0", n=2)
        assert sorted(out["labels"]) == ["replica0", "replica1"]
        assert sum(out["rehomed"].values()) == 3
        assert sorted(m["moved_to"] for m in moved) == sorted(
            lb for lb, n in out["rehomed"].items() for _ in range(n))
        assert bal.room_staleness() == {
            "doc-0": {"replica0": 0, "replica1": 0}}
        m = bal.metrics
        assert m.gauge("replica.hosts").value == 2
        assert m.gauge("replica.rooms").value == 1
        assert m.gauge("replica.staleness_worst").value == 0
        bal.unspread_room("doc-0")
        assert directory.rooms() == {}
        _close(storm)
        return [out, moved, bal.stats, storm.service.viewers.stats]

    both(tmp_path, scenario)


# -- promoted fork ≡ demote-then-fork ---------------------------------------


def test_promoted_fork_equals_demote_then_fork(tmp_path):
    def scenario(side, root):
        P = PKG[side]

        def play(demote_first: bool, sub):
            git, storm, plane, hist = _build(P, sub, num_docs=4)
            mgr = P.mega.MegaDocManager(storm, default_lanes=2)
            clients, cseq = _serve(storm, ["hot"], rounds=1, seed=11)
            mgr.promote("hot")
            _serve(storm, ["hot"], rounds=3, seed=11, clients=clients,
                   cseq=cseq)
            if demote_first:
                mgr.demote("hot")
                storm.flush()
            branch = hist.fork("hot", 20, name="fb")
            storm.flush()
            reads = {s: hist.read_at(branch, s)["entries"]
                     for s in (0, 10, 20)}
            history = _wire_ops(P, storm.service.get_deltas("hot", 0, 20))
            _close(storm)
            return reads, history

        direct = play(False, root / "direct")
        demoted = play(True, root / "demoted")
        assert direct == demoted
        return direct

    both(tmp_path, scenario)


# -- per-room staleness -------------------------------------------------------


def test_room_staleness_bound_and_early_shed(tmp_path):
    def scenario(side, root):
        P = PKG[side]
        git, storm, plane, hist = _build(P, root)
        _serve(storm, ["doc-0"], rounds=2)
        rep = _replica(P, plane, git, read_wait_s=5.0)
        head = rep.head_seq("doc-0")
        gaps = [rep.room_staleness("doc-0"),
                rep.room_staleness("doc-0", leader_seq=head),
                rep.room_staleness("doc-0", leader_seq=head + 7),
                rep.room_staleness("doc-0", leader_seq=head - 3)]
        assert gaps == [0, 0, 7, 0]
        t0 = time.monotonic()
        with pytest.raises(P.rr.ReplicaRedirect) as err:
            rep.read_at("doc-0", head + 50)
        assert time.monotonic() - t0 < 2.0
        assert err.value.moved_to == "hostA"
        with pytest.raises(P.rr.ReplicaRedirect):
            rep.get_deltas("doc-0", 0, head + 50)
        assert rep.stats["room_stale_sheds"] == 2
        assert rep.metrics.counter("replica.room_stale_sheds").value == 2
        _close(storm)
        return [head, gaps, rep.stats]

    both(tmp_path, scenario)


def test_balancer_scores_per_room_gap_and_gauges_stale_rooms(tmp_path):
    def scenario(side, root):
        P = PKG[side]
        git, storm, plane, hist = _build(P, root, followers=2)
        _serve(storm, ["doc-0"], rounds=1)
        reps = {f"replica{i}": _replica(P, plane, git, i) for i in range(2)}
        directory = P.rr.ReplicaDirectory(git)
        bal = P.pl.ReplicaBalancer(directory, reps, leader_storm=storm)
        directory.assign_room("doc-0", ["replica0", "replica1"])
        _serve(storm, ["doc-0"], rounds=2)
        reps["replica0"].poll()
        stale = bal.room_staleness()
        gap = stale["doc-0"]["replica1"]
        assert stale["doc-0"]["replica0"] == 0 and gap > 0
        s0, s1 = bal.score("replica0"), bal.score("replica1")
        assert s0[0] == s1[0] == 1
        assert s0[1] == 0 and s1[1] == gap
        assert s0 < s1
        assert bal.pick(1) == ["replica0"]
        out = bal.spread_room("doc-1", n=1)
        assert out["labels"] == ["replica0"]
        bal.update_gauges()
        m = bal.metrics
        assert m.gauge("replica.stale_rooms").value == 1
        assert m.gauge("replica.staleness_worst").value == gap
        reps["replica1"].poll()
        bal.update_gauges()
        assert bal.room_staleness()["doc-0"]["replica1"] == 0
        assert m.gauge("replica.stale_rooms").value == 0
        _close(storm)
        return [stale, list(s0), list(s1), out, directory.rooms()]

    both(tmp_path, scenario)
