"""The port's networked replication transport (``server/transport.py``)
and cluster launcher (``tools/launch_cluster.py``) against the JAX
package's, on ``device="cpu"``.

The classes of ``tests/test_transport.py`` run against the port. Where a
case's observations are deterministic (frame responses, follower WAL
bytes, heads, node and fault stats, acks on a pinned service clock) it
runs once per package and the two records must be equal; where they are
wall-clock (deadlines, backoff, a bounced server) the port alone is held
to the reference test's own bounds. Then the packages meet on the wire:
the same seeded rounds leave byte-equal follower WALs over TCP, in
process, and on the reference's networked follower; a port leader ships
to a follower child process of the reference and a reference leader to
one of the port, with identical WAL bytes; and each package promotes
the other's follower directory.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import shutil
import socket
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from fluidframework_tpu.server import durable_store as j_ds
from fluidframework_tpu.server import replication as j_rep
from fluidframework_tpu.server import transport as j_tr
from fluidframework_tpu.tools import launch_cluster as j_lc
from fluidframework_tpu.utils import faults as j_faults
from fluidframework_tpu_torch.server import durable_store as t_ds
from fluidframework_tpu_torch.server import replication as t_rep
from fluidframework_tpu_torch.server import transport as t_tr
from fluidframework_tpu_torch.tools import launch_cluster as t_lc
from fluidframework_tpu_torch.utils import faults as t_faults

PKG = {
    "jax": SimpleNamespace(ds=j_ds, rep=j_rep, tr=j_tr, lc=j_lc,
                           faults=j_faults, dev={}),
    "torch": SimpleNamespace(ds=t_ds, rep=t_rep, tr=t_tr, lc=t_lc,
                             faults=t_faults, dev={"device": "cpu"}),
}
SIDES = ("jax", "torch")
K = 8
T = PKG["torch"]


@pytest.fixture(autouse=True)
def _reap_port_children():
    """Every child either package's launcher spawned is reaped, even when
    a case fails mid-launch."""
    yield
    t_lc.reap_all()
    j_lc.reap_all()


def both(tmp_path, scenario, **kw):
    """Run ``scenario(side, root, **kw)`` for each package; the records
    must be equal. Returns the port's record."""
    got = {side: scenario(side, tmp_path / side, **kw) for side in SIDES}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _words(seed, k=K):
    rng = np.random.default_rng(seed)
    kinds = rng.choice([0, 0, 0, 1], size=k).astype(np.uint32)
    slots = rng.integers(0, 16, k).astype(np.uint32)
    vals = rng.integers(0, 1 << 20, k).astype(np.uint32)
    return (kinds | (slots << 2) | (vals << 12)).astype(np.uint32)


def _batch(P, seq, records, **extra):
    return P.rep._frame("batch", {"seq": seq,
                                  "lens": [len(r) for r in records],
                                  **extra}, b"".join(records))


def _records(n, seed=0, size=24):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size).astype(np.uint8).tobytes()
            for _ in range(n)]


def _wal_bytes(P, data_dir):
    return (Path(data_dir) / P.rep.REPLICA_WAL_RELPATH).read_bytes()


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def pin(storm):
    storm.service._clock = itertools.count(1000, 7).__next__
    return storm


def _close(storm):
    if storm._group_wal is not None:
        storm._group_wal.close()


def _ack(p) -> dict:
    """An ack as a comparable record (``dw`` is thread-timed)."""
    if hasattr(p, "rows"):
        return {"rid": repr(p.get("rid")),
                "rows": np.asarray(p.rows).tolist()}
    return {k: repr(v) for k, v in p.items() if k != "dw"}


def _serve(storm, docs, rounds, sink, seed=9, cseq=None, clients=None):
    if clients is None:
        clients = {d: storm.service.connect(d, lambda m: None).client_id
                   for d in docs}
        storm.service.pump()
    cseq = cseq if cseq is not None else {d: 1 for d in docs}
    for _ in range(rounds):
        for i, d in enumerate(docs):
            w = _words([seed, cseq[d], i])
            storm.submit_frame(sink, {"rid": (cseq[d], d),
                                      "docs": [[d, clients[d], cseq[d], 1,
                                                K]]},
                               memoryview(w.tobytes()))
            cseq[d] += K
        storm.flush()
    return clients, cseq


def test_port_module_keeps_the_references_names():
    for name in j_tr.__all__:
        assert hasattr(t_tr, name), name
    for name in ("DEFAULT_CALL_TIMEOUT_S", "DEFAULT_RETRIES",
                 "BACKOFF_BASE_S", "BACKOFF_MAX_S", "HEARTBEAT_INTERVAL_S",
                 "LEASE_S", "LINK_FAULTS"):
        assert getattr(t_tr, name) == getattr(j_tr, name), name
    assert t_lc.CHILD_READY_TIMEOUT_S == j_lc.CHILD_READY_TIMEOUT_S


# -- wire round trip (TestWireRoundTrip) --------------------------------------


def _batch_over_wire(side, root):
    P = PKG[side]
    node = P.rep.ReplicaNode(root / "fnet", node_id="fnet")
    server = P.tr.ReplicaServerThread(node)
    twin = P.rep.ReplicaNode(root / "floc", node_id="floc")
    link = P.tr.NetworkReplicaLink(server.port)
    local = P.rep.ReplicaLink(twin)
    out = []
    try:
        recs = _records(6, seed=1)
        for lk in (link, local):
            out.append(lk.call(_batch(P, 0, recs[:4])))
            out.append(lk.call(_batch(P, 4, recs[4:])))
            out.append(lk.call(P.rep._frame(
                "heads", {"entries": [[3, "doc/a", "h3"]]})))
        assert node.log_len == twin.log_len == 6
        assert node.heads == twin.heads == {"doc/a": (3, "h3")}
        wire = _wal_bytes(P, node.data_dir)
        assert wire == _wal_bytes(P, twin.data_dir)
        return [out, _sha(wire), dict(node.stats), server.server.stats]
    finally:
        link.close()
        twin.close()
        server.close()
        node.close()


def test_batch_lands_byte_identical_to_in_process(tmp_path):
    both(tmp_path, _batch_over_wire)


def _hello(side, root):
    P = PKG[side]
    node = P.rep.ReplicaNode(root / "fnet", node_id="fnet")
    server = P.tr.ReplicaServerThread(node)
    link = P.tr.NetworkReplicaLink(server.port)
    try:
        assert link.node is link
        first = [link.node_id, link.role, link.log_len, link.max_hseq]
        d0 = link.hello()
        assert d0["leader_silence_s"] is None
        link.call(_batch(P, 0, _records(2)))
        link.call(P.rep._frame("heads", {"entries": [[7, "doc/b", "h7"]]}))
        d1 = link.hello()
        assert d1["leader_silence_s"] is not None
        d1.pop("leader_silence_s")
        return [first, d0, d1, link.heads]
    finally:
        link.close()
        server.close()
        node.close()


def test_hello_handshake_populates_node_surface(tmp_path):
    rec = both(tmp_path, _hello)
    assert rec[0] == ["fnet", "follower", 0, 0]
    assert rec[2]["len"] == 2 and rec[2]["hseq"] == 7
    assert rec[3] == {"doc/b": (7, "h7")}


def _control(side, root):
    P = PKG[side]
    node = P.rep.ReplicaNode(root / "f0", node_id="f0")
    server = P.tr.ReplicaServerThread(
        node, handlers={"echo": lambda req: {"back": req["x"]}})
    link = P.tr.NetworkReplicaLink(server.port)
    try:
        out = [link.control("ping"), link.control("no_such_verb"),
               link.control("echo", x=41)]
        server.server.handlers["boom"] = lambda req: 1 / 0
        out += [link.control("boom"), link.control("ping"),
                server.server.stats]
        assert out[0] == {"ok": True} and "error" in out[1]
        assert out[2]["back"] == 41
        assert "ZeroDivisionError" in out[3]["error"]
        return out
    finally:
        link.close()
        server.close()
        node.close()


def test_control_ping_unknown_op_and_custom_handler(tmp_path):
    both(tmp_path, _control)


def _shutdown(side, root):
    P = PKG[side]
    node = P.rep.ReplicaNode(root / "f0", node_id="f0")
    server = P.tr.ReplicaServerThread(node)
    link = P.tr.NetworkReplicaLink(server.port)
    try:
        link.call(_batch(P, 0, _records(3, seed=2)))
        out = link.control("shutdown")
        assert out == {"ok": True, "closed": True}
        reopened = P.rep.ReplicaNode(root / "f0")
        got = [out, reopened.log_len]
        reopened.close()
        return got
    finally:
        link.close()
        server.close()


def test_shutdown_closes_node_and_releases_wal(tmp_path):
    assert both(tmp_path, _shutdown)[1] == 3


# -- deadline / retry / reconnect (TestRetryReconnect), the port alone --------


def test_dead_port_raises_linkdown_within_budget():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.monotonic()
    with pytest.raises(t_rep.ReplicationLinkDown):
        t_tr.NetworkReplicaLink(port, retries=2, backoff_base_s=0.01,
                                call_timeout_s=0.5)
    assert time.monotonic() - t0 < 5.0


def test_silent_peer_times_out_not_hangs():
    gate = socket.socket()
    gate.bind(("127.0.0.1", 0))
    gate.listen(1)
    try:
        t0 = time.monotonic()
        with pytest.raises(t_rep.ReplicationLinkDown):
            t_tr.NetworkReplicaLink(gate.getsockname()[1], retries=1,
                                    call_timeout_s=0.2,
                                    backoff_base_s=0.01)
        assert 0.2 <= time.monotonic() - t0 < 3.0
    finally:
        gate.close()


def test_reconnects_transparently_after_server_bounce(tmp_path):
    node = t_rep.ReplicaNode(tmp_path / "f0")
    server = t_tr.ReplicaServerThread(node)
    port = server.port
    link = t_tr.NetworkReplicaLink(port, retries=3, backoff_base_s=0.02)
    try:
        assert link.call(_batch(T, 0, _records(2)))["k"] == "ack"
        dials = link.stats["reconnects"]
        server.close()
        server = t_tr.ReplicaServerThread(node, port=port)
        hdr = link.call(_batch(T, 2, _records(2, seed=5)))
        assert hdr["k"] == "ack" and hdr["len"] == 4
        assert link.stats["reconnects"] > dials
        assert link.stats["retransmits"] >= 1
    finally:
        link.close()
        server.close()
        node.close()


def test_transport_stats_shape(tmp_path):
    node = t_rep.ReplicaNode(tmp_path / "fnet", node_id="fnet")
    server = t_tr.ReplicaServerThread(node)
    link = t_tr.NetworkReplicaLink(server.port)
    try:
        link.call(t_rep._frame("probe", {}))
        ts = link.transport_stats()
        assert ts["calls"] >= 2 and len(ts["rtt_s"]) >= 2
        assert all(r >= 0 for r in ts["rtt_s"])
        assert set(ts) == {"rtt_s", "calls", "retransmits", "reconnects",
                           "timeouts"}
    finally:
        link.close()
        server.close()
        node.close()


# -- fault semantics (TestFaultSemantics): every LINK_FAULTS fault ------------


def _partition(P, node, ft):
    ft.install("partition")
    with pytest.raises(P.rep.ReplicationLinkDown):
        ft.call(_batch(P, 0, _records(2)))
    out = [node.log_len, dict(ft.stats)]
    ft.heal("partition")
    out.append(ft.call(_batch(P, 0, _records(2))))
    return out


def _partition_send(P, node, ft):
    ft.install("partition_send")
    with pytest.raises(P.rep.ReplicationLinkDown):
        ft.call(_batch(P, 0, _records(2)))
    return [node.log_len, dict(ft.stats)]


def _partition_recv(P, node, ft):
    frame = _batch(P, 0, _records(3, seed=3))
    ft.install("partition_recv")
    with pytest.raises(P.rep.ReplicationLinkDown):
        ft.call(frame)
    out = [node.log_len]
    ft.heal()
    out += [ft.call(frame), node.stats["dup_records"], dict(ft.stats)]
    assert out[0] == 3 and out[2] == 3
    return out


def _drop(P, node, ft):
    ft.install("drop", p=1.0)
    for _ in range(3):
        with pytest.raises(P.rep.ReplicationLinkDown):
            ft.call(_batch(P, 0, _records(1)))
    return [node.log_len, dict(ft.stats)]


def _dup(P, node, ft):
    ft.install("dup", p=1.0)
    out = [ft.call(_batch(P, 0, _records(4, seed=4))), node.log_len,
           node.stats["dup_records"], dict(ft.stats)]
    assert out[1:3] == [4, 4]
    return out


def _slow(P, node, ft):
    ft.install("slow", s=0.05)
    t0 = time.perf_counter()
    hdr = ft.call(_batch(P, 0, _records(1)))
    assert time.perf_counter() - t0 >= 0.05
    return [hdr, dict(ft.stats)]


def _delay(P, node, ft):
    ft.install("delay", s=0.01, p=1.0)
    t0 = time.perf_counter()
    hdr = ft.call(_batch(P, 0, _records(1)))
    assert time.perf_counter() - t0 >= 0.01
    return [hdr, dict(ft.stats)]


def _reorder(P, node, ft):
    ft.install("reorder", p=1.0)
    out = [ft.call(_batch(P, 0, _records(2, seed=6))), node.log_len]
    ft.heal("reorder")
    out += [ft.call(P.rep._frame("probe", {})), node.log_len,
            dict(ft.stats)]
    assert out[0]["reason"] == "reorder" and out[0]["len"] == 0
    assert out[1] == 0 and out[3] == 2
    return out


FAULT_CASES = {"partition": _partition, "partition_send": _partition_send,
               "partition_recv": _partition_recv, "drop": _drop,
               "dup": _dup, "slow": _slow, "delay": _delay,
               "reorder": _reorder}


def test_fault_cases_cover_every_link_fault():
    assert set(FAULT_CASES) == set(t_tr.LINK_FAULTS) == set(j_tr.LINK_FAULTS)


@pytest.mark.parametrize("wire", [False, True], ids=["in_process", "tcp"])
@pytest.mark.parametrize("fault", list(FAULT_CASES))
def test_link_fault_matches_reference(tmp_path, fault, wire):
    """Each fault over an in-process link and over a real socket: the
    frames the node sees, its log and the wrapper's stats equal the
    reference's."""
    def scenario(side, root):
        P = PKG[side]
        node = P.rep.ReplicaNode(root / "f0", node_id="f0")
        server = P.tr.ReplicaServerThread(node) if wire else None
        inner = (P.tr.NetworkReplicaLink(server.port) if wire
                 else P.rep.ReplicaLink(node))
        ft = P.tr.FaultyTransport(inner, edge="f0", seed=7)
        try:
            out = FAULT_CASES[fault](P, node, ft)
            return [out, node.log_len, _sha(_wal_bytes(P, node.data_dir))
                    if node.log_len else None]
        finally:
            if wire:
                inner.close()
                server.close()
            node.close()

    both(tmp_path, scenario)


def test_seeded_faults_replay_identically():
    """The per-edge seeded RNG draws the reference's sequence."""
    class _Sink:
        node = None

        def call(self, frame):
            return {"k": "ack", "len": 0}

    def outcomes(P, seed):
        ft = P.tr.FaultyTransport(_Sink(), edge="f1", seed=seed)
        ft.install("drop", p=0.5)
        out = []
        for _ in range(32):
            try:
                ft.call(b"x")
                out.append(1)
            except P.rep.ReplicationLinkDown:
                out.append(0)
        return out

    for seed in (11, 12):
        assert outcomes(T, seed) == outcomes(PKG["jax"], seed)
    assert outcomes(T, 11) != outcomes(T, 12)


def test_plan_dict_and_env_parser_install_per_edge(tmp_path, monkeypatch):
    monkeypatch.setenv("FFTPU_LINKFAULTS",
                       "f0:drop@p=0.2;f0:delay@s=0.01,p=0.5;f1:partition")
    plan = t_faults.link_fault_plan_from_env()
    assert plan == j_faults.link_fault_plan_from_env() == {
        "f0": {"drop": {"p": 0.2}, "delay": {"s": 0.01, "p": 0.5}},
        "f1": {"partition": {}}}
    node = t_rep.ReplicaNode(tmp_path / "f0")
    try:
        ft0 = t_tr.FaultyTransport(t_rep.ReplicaLink(node), edge="f0",
                                   plan=plan)
        assert set(ft0.faults) == {"drop", "delay"}
        ft1 = t_tr.FaultyTransport(t_rep.ReplicaLink(node), edge="f1",
                                   plan=plan)
        with pytest.raises(t_rep.ReplicationLinkDown):
            ft1.call(t_rep._frame("probe", {}))
        ft2 = t_tr.FaultyTransport(t_rep.ReplicaLink(node), edge="f9",
                                   plan=plan)
        assert ft2.faults == {}
        with pytest.raises(ValueError, match="unknown link fault"):
            ft2.install("blackhole")
        assert ft0.node is node  # link.node passthrough
        ft0.heal()
        ft0.call(t_rep._frame("heads", {"entries": [[2, "doc/c", "h2"]]}))
        assert ft0.node.max_hseq == 2
    finally:
        node.close()


# -- fencing on the wire (TestWireFencing) ------------------------------------


def _fencing(side, root):
    P = PKG[side]
    node = P.rep.ReplicaNode(root / "fnet", node_id="fnet")
    server = P.tr.ReplicaServerThread(node)
    link = P.tr.NetworkReplicaLink(server.port)
    try:
        out = [link.call(_batch(P, 0, _records(1), inc=3)),
               link.hello()["incarnation"],
               link.call(_batch(P, 1, _records(1), inc=2)),
               link.call(P.rep._frame("probe", {})),
               node.stats["fenced_frames"], node.log_len]
        assert out[2]["reason"] == "fenced" and out[2]["inc"] == 3
        assert out[4:] == [2, 1]
    finally:
        link.close()
        server.close()
    node.close()
    reopened = P.rep.ReplicaNode(node.data_dir)
    out.append(reopened.incarnation)
    reopened.close()
    return out


def test_lower_incarnation_refused_over_socket(tmp_path):
    assert both(tmp_path, _fencing)[-1] == 3


# -- degraded mode: park, drain, shed (TestDegradedMode) ----------------------


def _degraded_build(P, root, park_max_s=5.0):
    git = P.ds.GitSnapshotStore(str(root / "git"))
    node = P.rep.ReplicaNode(root / "f0")
    ft = P.tr.FaultyTransport(P.rep.ReplicaLink(node), edge="f0", seed=0)
    storm, plane = P.rep.make_replicated_host(
        "hostA", str(root / "hostA"), git, [ft], num_docs=8, **P.dev)
    plane.lease_s = 0.2
    plane.park_max_s = park_max_s
    return pin(storm), plane, ft


def _expire_leases(plane):
    for nid in list(plane._last_ok):
        plane._last_ok[nid] -= 10.0


def _one_write(storm, doc, cseq, sink):
    client = storm.service.connect(doc, lambda m: None).client_id
    storm.service.pump()
    w = _words([1, cseq])
    storm.submit_frame(sink, {"rid": cseq,
                              "docs": [[doc, client, cseq, 1, K]]},
                       memoryview(w.tobytes()))
    storm.flush()


def _park_and_drain(side, root):
    P = PKG[side]
    storm, plane, ft = _degraded_build(P, root)
    acks: list = []
    try:
        ft.install("partition")
        _expire_leases(plane)
        out = [plane.heartbeat(), plane.quorum_ok]
        _one_write(storm, "doc/p", 1, acks.append)
        out += [len(acks), storm.stats.get("quorum_rejects", 0)]
        ft.heal()
        out += [plane.heartbeat(), plane.quorum_ok]
        storm.flush()
        out += [[_ack(a) for a in acks], plane.quorum_degraded_s()]
        assert out[:4] == [False, False, 0, 0]
        assert out[4:6] == [True, True] and out[7] is None
        return out
    finally:
        _close(storm)


def test_quorum_loss_parks_writes_then_heal_drains(tmp_path):
    both(tmp_path, _park_and_drain)


def _park_past_max(side, root):
    P = PKG[side]
    storm, plane, ft = _degraded_build(P, root, park_max_s=0.0)
    acks: list = []
    try:
        ft.install("partition")
        _expire_leases(plane)
        assert plane.heartbeat() is False
        _one_write(storm, "doc/s", 1, acks.append)
        assert storm.stats["quorum_rejects"] >= 1 and len(acks) == 1
        assert acks[0]["error"] == "quorum-lost"
        assert acks[0]["retryable"] is True and acks[0]["retry_after_s"] > 0
        return [acks[0]["error"], acks[0]["retryable"],
                storm.stats["quorum_rejects"]]
    finally:
        _close(storm)


def test_park_past_max_sheds_with_retry_hint(tmp_path):
    both(tmp_path, _park_past_max)


def _heartbeat_resync(side, root):
    P = PKG[side]
    storm, plane, ft = _degraded_build(P, root)
    acks: list = []
    try:
        _one_write(storm, "doc/r", 1, acks.append)
        shipped = ft.node.log_len
        ft.install("partition")
        _one_write(storm, "doc/r", 1 + K, acks.append)
        lost = ft.node.log_len
        ft.heal()
        _expire_leases(plane)
        out = [len(acks), shipped, lost, plane.heartbeat(),
               ft.node.log_len, storm._group_wal.durable_len,
               _sha(_wal_bytes(P, ft.node.data_dir))]
        assert out[1] > 0 and out[2] == out[1] and out[4] == out[5]
        assert plane.stats["resyncs"] >= 1
        return out
    finally:
        _close(storm)


def test_heartbeat_resyncs_lagging_follower(tmp_path):
    both(tmp_path, _heartbeat_resync)


# -- a storm serving over real sockets (TestNetworkedHost) --------------------


DOCS = ["doc/x", "doc/y"]


def _networked_host(side, root):
    P = PKG[side]
    node = P.rep.ReplicaNode(root / "fnet", node_id="fnet")
    server = P.tr.ReplicaServerThread(node)
    git = P.ds.GitSnapshotStore(str(root / "git"))
    link = P.tr.NetworkReplicaLink(server.port)
    storm, plane = P.rep.make_replicated_host(
        "hostA", str(root / "hostA"), git, [link, str(root / "floc")],
        num_docs=8, **P.dev)
    pin(storm)
    acks: list = []
    try:
        _serve(storm, DOCS, 3, acks.append)
        local = next(lk for lk in plane.links
                     if not isinstance(lk, P.tr.NetworkReplicaLink))
        assert len(acks) == 6 and all("error" not in a for a in acks)
        assert node.log_len == local.node.log_len > 0
        wire = _wal_bytes(P, node.data_dir)
        assert wire == _wal_bytes(P, local.node.data_dir)
        ts = link.transport_stats()
        assert ts["calls"] >= 4 and len(ts["rtt_s"]) >= 3
        storm.checkpoint()
        link.hello()
        assert link.max_hseq == local.node.max_hseq > 0
        assert link.heads == local.node.heads
        plane._update_gauges()
        snap = storm.merge_host.metrics.snapshot()
        assert snap["transport.links"] == 1
        assert snap["transport.rtt_p99_ms"] >= snap["transport.rtt_p50_ms"]
        assert snap["transport.open_partitions"] == 0
        return [[_ack(a) for a in acks], _sha(wire), node.log_len,
                link.max_hseq, sorted(link.heads.items())]
    finally:
        link.close()
        server.close()
        node.close()
        _close(storm)


def test_replicated_host_over_tcp_matches_in_process_follower(tmp_path):
    both(tmp_path, _networked_host)


# -- the packages on one wire -------------------------------------------------


def _leader(P, root, links):
    git = P.ds.GitSnapshotStore(str(root / "git"))
    storm, plane = P.rep.make_replicated_host(
        "hostA", str(root / "hostA"), git, links, num_docs=8, **P.dev)
    return git, pin(storm), plane


def test_follower_wal_bytes_equal_over_tcp_in_process_and_reference(
        tmp_path):
    """A port leader ships the same seeded rounds to a port follower over
    TCP and to one in process; a reference leader ships them to a
    reference follower over TCP. The three follower WALs are
    byte-equal, and so are the leaders' acks."""
    wals, acks = {}, {}
    for side in SIDES:
        P = PKG[side]
        root = tmp_path / side
        node = P.rep.ReplicaNode(root / "fnet", node_id="fnet")
        server = P.tr.ReplicaServerThread(node)
        link = P.tr.NetworkReplicaLink(server.port)
        links = [link] + ([str(root / "floc")] if side == "torch" else [])
        _, storm, plane = _leader(P, root, links)
        got: list = []
        try:
            _serve(storm, DOCS, 4, got.append, seed=21)
            storm.checkpoint()
            acks[side] = [_ack(a) for a in got]
            wals[side] = _wal_bytes(P, node.data_dir)
            if side == "torch":
                wals["in_process"] = _wal_bytes(P, root / "floc")
        finally:
            link.close()
            server.close()
            node.close()
            _close(storm)
    assert acks["torch"] == acks["jax"]
    assert len(wals["torch"]) > 0
    assert wals["torch"] == wals["in_process"] == wals["jax"]


def test_leaders_ship_to_the_other_packages_follower_child(tmp_path):
    """Real processes on both ends, crossed: the port's leader ships to a
    follower child launched by the reference's launcher (the reference's
    ``ReplicaServer``), the reference's leader to one launched by the
    port's. Both child WALs are byte-equal, and each child reports the
    log the other package's plane replicated."""
    out = {}
    for leader, child_side in (("torch", "jax"), ("jax", "torch")):
        P, C = PKG[leader], PKG[child_side]
        root = tmp_path / f"{leader}-leads"
        child = C.lc.launch_follower(str(root / "f0"), label="f0")
        link = P.tr.NetworkReplicaLink(child.port)
        _, storm, plane = _leader(P, root, [link])
        got: list = []
        try:
            _serve(storm, DOCS, 3, got.append, seed=5)
            storm.checkpoint()
            hello = link.hello()
            assert hello["len"] == plane.replicated_len \
                == storm._group_wal.durable_len
            stats = link.control("stats")
            assert stats["len"] == hello["len"]
        finally:
            link.close()
            _close(storm)
            child.shutdown()
        out[leader] = {"acks": [_ack(a) for a in got],
                       "wal": _wal_bytes(C, child.data_dir),
                       "len": hello["len"], "hseq": hello["hseq"],
                       "heads": hello["heads"]}
    assert out["torch"]["acks"] == out["jax"]["acks"]
    assert out["torch"]["wal"] == out["jax"]["wal"]
    assert out["torch"]["len"] == out["jax"]["len"] > 0
    assert out["torch"]["heads"] == out["jax"]["heads"]


def test_each_package_promotes_the_others_follower(tmp_path):
    """Each package serves, checkpoints and ships to a follower over TCP;
    then each promotes the OTHER's follower directory over the other's
    snapshot store. The promoted hosts hold the same map planes as the
    dead leaders, and their promotion reports (but the wall clock)
    agree."""
    served = {}
    for side in SIDES:
        P = PKG[side]
        root = tmp_path / side
        node = P.rep.ReplicaNode(root / "f0", node_id="f0")
        server = P.tr.ReplicaServerThread(node)
        link = P.tr.NetworkReplicaLink(server.port)
        _, storm, plane = _leader(P, root, [link])
        try:
            clients, cseq = _serve(storm, DOCS, 2, lambda p: None, seed=8)
            storm.checkpoint()
            _serve(storm, DOCS, 2, lambda p: None, seed=8, cseq=cseq,
                   clients=clients)
            served[side] = {d: storm.merge_host.map_entries(
                d, storm.datastore, storm.channel) for d in DOCS}
        finally:
            link.close()
            server.close()
            node.close()
            _close(storm)
    promoted = {}
    for side, other in (("torch", "jax"), ("jax", "torch")):
        P = PKG[side]
        src = tmp_path / other
        dst = tmp_path / f"{side}-promotes"
        shutil.copytree(src / "f0", dst / "f0")
        shutil.copytree(src / "git", dst / "git")
        git = P.ds.GitSnapshotStore(str(dst / "git"))
        storm, plane, rep = P.rep.promote(
            "hostA", [P.rep.ReplicaNode(dst / "f0")], git,
            follower_dirs=[str(dst / "fresh")], num_docs=8, **P.dev)
        try:
            rep.pop("blackout_ms")
            promoted[side] = {
                "report": rep,
                "maps": {d: storm.merge_host.map_entries(
                    d, storm.datastore, storm.channel) for d in DOCS}}
        finally:
            _close(storm)
    assert served["torch"] == served["jax"]
    assert promoted["torch"]["maps"] == served["jax"]
    assert promoted["jax"]["maps"] == served["torch"]
    assert promoted["torch"]["report"] == promoted["jax"]["report"]


# -- the launcher -------------------------------------------------------------


def test_launch_cluster_over_the_wire_and_promote(tmp_path):
    """``launch_cluster`` (one follower child, the reference's defaults for
    the parked-write bench) and ``promote_over_wire`` on the port: the
    child's WAL is a byte prefix of the leader's tick log, a partition
    parks a write that the heal drains, and a promotion over the wire
    reproduces the leader's maps."""
    from fluidframework_tpu_torch.server.replication import \
        REPLICA_WAL_RELPATH
    c = t_lc.launch_cluster(str(tmp_path / "c"), followers=2, num_docs=4,
                            detector=True, hb_interval_s=0.05, lease_s=0.3,
                            park_max_s=3600.0,
                            fault_plan={"f0": {}, "f1": {}},
                            device="cpu")
    storm = pin(c.storm)
    acks: list = []
    try:
        assert [ch.kind for ch in c.children] == ["follower", "follower"]
        assert all(ch.alive for ch in c.children)
        assert c.link_to(c.children[0]) is c.plane.links[0]
        clients, cseq = _serve(storm, DOCS, 2, acks.append)
        assert len(acks) == 4
        leader_log = (Path(c.workdir) / "leader" / "spill"
                      / "storm_tick_words.log").read_bytes()
        for ch in c.children:
            wal = (Path(ch.data_dir) / REPLICA_WAL_RELPATH).read_bytes()
            assert wal and leader_log.startswith(wal)
        for lk in c.plane.links:
            lk.install("partition")
        deadline = time.monotonic() + 10
        while c.plane.quorum_ok:
            assert time.monotonic() < deadline, "never degraded"
            time.sleep(0.02)
        _serve(storm, DOCS, 1, acks.append, cseq=cseq, clients=clients)
        assert len(acks) == 4
        assert storm.stats.get("quorum_rejects", 0) == 0
        for lk in c.plane.links:
            lk.heal()
        deadline = time.monotonic() + 10
        while len(acks) < 6:
            assert time.monotonic() < deadline, "parked writes never drained"
            storm.flush()
            time.sleep(0.01)
        storm.checkpoint()
        want = {d: storm.merge_host.map_entries(d, storm.datastore,
                                                storm.channel)
                for d in DOCS}
        c.plane.stop_failure_detector()
        for lk in c.plane.links:
            lk.close()
        _close(storm)
        storm2, plane2, rep = t_lc.promote_over_wire(
            c.children, c.store, num_docs=4, device="cpu",
            follower_dirs=[str(tmp_path / "fresh")])
        try:
            assert rep["blackout_ms"] > 0
            assert {d: storm2.merge_host.map_entries(
                d, storm2.datastore, storm2.channel) for d in DOCS} == want
            assert str(storm2.merge_host.device) == "cpu"
        finally:
            _close(storm2)
    finally:
        c.close()
    assert not any(ch.alive for ch in c.children)


def test_launcher_waits_on_a_child_past_1024_descriptors(tmp_path):
    """A parent holding more than 1,024 descriptors (a serving process
    with many sockets and files) still launches a follower: the port's
    launcher polls the child's pipe. The reference's ``select`` refuses
    a descriptor past 1,023 (a reference fault the port does not
    mirror)."""
    import resource

    soft, _ = resource.getrlimit(resource.RLIMIT_NOFILE)
    assert soft > 1200
    held: list = []
    try:
        # Fill every descriptor below 1,024: the child's pipe lands past.
        while not held or held[-1].fileno() < 1024:
            held.append(open(os.devnull))
        child = t_lc.launch_follower(str(tmp_path / "f0"))
        try:
            link = child.link()
            assert link.hello()["len"] == 0
            link.close()
        finally:
            child.shutdown()
        with pytest.raises(ValueError, match="filedescriptor out of range"):
            j_lc.launch_follower(str(tmp_path / "g0"))
    finally:
        for fh in held:
            fh.close()
