"""Differential: the port's KernelSequencerHost against the JAX package's.

The same raw-op streams — joins past the slot count (slot growth), more
documents than rows (row growth), leaves, dups, gaps, unknown writers
on the ghost lane, idle eviction, checkpoint/restore — go through both
hosts on the synchronous per-op path and the batched flush path. Tickets,
slot maps and every sequencer plane must be equal.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import pytest

from fluidframework_tpu.protocol.messages import MessageType
from fluidframework_tpu.server import sequencer as jsq
from fluidframework_tpu.server.kernel_host import \
    KernelSequencerHost as JaxHost
from fluidframework_tpu_torch import convert
from fluidframework_tpu_torch.server import sequencer as tsq
from fluidframework_tpu_torch.server.kernel_host import \
    KernelSequencerHost as TorchHost


def _raw(mod, spec: dict):
    return mod.RawOperation(**spec)


def _stream(rng: random.Random, n: int, clients: list[str]) -> list[dict]:
    """RawOperation field dicts: joins/leaves (system), client ops with
    dups and gaps, noops, unknown writers, nack_future controls."""
    cseq = {c: 0 for c in clients}
    out = []
    for i in range(n):
        ts = 100 + 10 * i
        r = rng.random()
        c = rng.choice(clients)
        if r < 0.15:
            out.append(dict(client_id=None, type=MessageType.CLIENT_JOIN,
                            data=c, timestamp=ts,
                            can_evict=rng.random() < 0.8))
            cseq[c] = 0
        elif r < 0.22:
            out.append(dict(client_id=None, type=MessageType.CLIENT_LEAVE,
                            data=c, timestamp=ts))
        elif r < 0.25:
            out.append(dict(client_id="stranger", type=MessageType.OPERATION,
                            client_seq=1, ref_seq=0, timestamp=ts))
        elif r < 0.27:
            out.append(dict(client_id=None, type=MessageType.NO_CLIENT,
                            timestamp=ts))
        elif r < 0.33:
            cseq[c] += 1
            out.append(dict(client_id=c, type=MessageType.NOOP,
                            client_seq=cseq[c], ref_seq=max(0, i - 4),
                            timestamp=ts,
                            contents={"x": 1} if rng.random() < .5 else None))
        else:
            cseq[c] += rng.choice([1, 1, 1, 0, 2])
            out.append(dict(client_id=c, type=MessageType.OPERATION,
                            client_seq=cseq[c], ref_seq=rng.randrange(i + 1),
                            timestamp=ts, contents={"op": i}))
    return out


def _ticket(t) -> tuple:
    return (t.kind, t.seq, t.msn, t.send, t.nack_code)


def _assert_hosts_equal(jh, th):
    for f in jh._state._fields:
        a = np.asarray(getattr(jh._state, f))
        b = getattr(th._state, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert th._rows == jh._rows
    assert th._slots == jh._slots
    assert th._alloc_slots == jh._alloc_slots
    assert th._capacity == jh._capacity
    assert th.membership_gen == jh.membership_gen


def _hosts(num_slots=2, capacity=2):
    return (JaxHost(num_slots=num_slots, initial_capacity=capacity),
            TorchHost(num_slots=num_slots, initial_capacity=capacity,
                      device="cpu"))


@pytest.mark.parametrize("seed", range(2))
def test_sync_path_matches_jax(seed):
    rng = random.Random(seed)
    jh, th = _hosts()
    docs = ["a", "b", "c"]  # 3 docs > capacity 2 forces row growth
    for spec in _stream(rng, 80, ["c1", "c2", "c3", "c4"]):
        doc = rng.choice(docs)
        got = th.sequence(doc, _raw(tsq, spec))
        want = jh.sequence(doc, _raw(jsq, spec))
        assert _ticket(got) == _ticket(want), spec
    _assert_hosts_equal(jh, th)


@pytest.mark.parametrize("seed", range(3))
def test_batched_flush_matches_jax(seed):
    rng = random.Random(10 + seed)
    jh, th = _hosts()
    docs = [f"d{i}" for i in range(5)]
    clients = [f"c{i}" for i in range(5)]  # > 2 slots: slot growth
    for _tick in range(4):
        for doc in docs:
            for spec in _stream(rng, rng.randrange(0, 9), clients):
                jh.submit(doc, _raw(jsq, spec))
                th.submit(doc, _raw(tsq, spec))
        jout, tout = jh.flush(), th.flush()
        assert {d: [_ticket(t) for t in ts] for d, ts in tout.items()} \
            == {d: [_ticket(t) for t in ts] for d, ts in jout.items()}
        _assert_hosts_equal(jh, th)
    # Mixed: a sync call flushes pending batched ops first.
    spec = dict(client_id=None, type=MessageType.CLIENT_JOIN, data="late",
                timestamp=9999)
    jh.submit("d0", _raw(jsq, spec))
    th.submit("d0", _raw(tsq, spec))
    spec2 = dict(client_id="late", type=MessageType.OPERATION, client_seq=1,
                 ref_seq=0, timestamp=10_000)
    assert _ticket(th.sequence("d0", _raw(tsq, spec2))) \
        == _ticket(jh.sequence("d0", _raw(jsq, spec2)))
    _assert_hosts_equal(jh, th)


def test_idle_eviction_and_release_match_jax():
    jh, th = _hosts(num_slots=4, capacity=4)
    for doc in ("x", "y"):
        for i, c in enumerate(("p", "q", "r")):
            spec = dict(client_id=None, type=MessageType.CLIENT_JOIN,
                        data=c, timestamp=100 * (i + 1),
                        can_evict=c != "r")
            jh.sequence(doc, _raw(jsq, spec))
            th.sequence(doc, _raw(tsq, spec))
    spec = dict(client_id="p", type=MessageType.OPERATION, client_seq=1,
                ref_seq=0, timestamp=5000)
    jh.sequence("x", _raw(jsq, spec))
    th.sequence("x", _raw(tsq, spec))
    for now, timeout in ((6000, 1000), (6000, 5500), (400, None)):
        assert th.idle_clients(now, timeout) == jh.idle_clients(now, timeout)
    for doc, c in th.idle_clients(6000, 1000):
        spec = dict(client_id=None, type=MessageType.CLIENT_LEAVE, data=c,
                    timestamp=6000)
        assert _ticket(th.sequence(doc, _raw(tsq, spec))) \
            == _ticket(jh.sequence(doc, _raw(jsq, spec)))
    _assert_hosts_equal(jh, th)
    assert th.release_doc("y") == jh.release_doc("y")
    _assert_hosts_equal(jh, th)


def test_checkpoint_restore_matches_jax():
    rng = random.Random(7)
    jh, th = _hosts()
    for spec in _stream(rng, 60, ["c1", "c2", "c3"]):
        doc = rng.choice(["m", "n"])
        jh.sequence(doc, _raw(jsq, spec))
        th.sequence(doc, _raw(tsq, spec))
    jcp, tcp = jh.checkpoint_all(), th.checkpoint_all()
    assert {d: dataclasses.asdict(c) for d, c in tcp.items()} \
        == {d: dataclasses.asdict(c) for d, c in jcp.items()}
    # The reference's checkpoints restore into fresh hosts of both kinds.
    jh2, th2 = _hosts(num_slots=1, capacity=1)
    for doc, cp in jcp.items():
        jh2.restore(doc, cp)
    convert.restore_sequencer_host(th2, jcp)
    _assert_hosts_equal(jh2, th2)
    spec = dict(client_id="c1", type=MessageType.OPERATION,
                client_seq=10**4, ref_seq=0, timestamp=77)
    assert _ticket(th2.sequence("m", _raw(tsq, spec))) \
        == _ticket(jh2.sequence("m", _raw(jsq, spec)))
    # A whole host carried across as numpy planes + maps.
    th3 = convert.sequencer_host_from_numpy(
        convert.sequencer_host_to_numpy(jh), device="cpu")
    _assert_hosts_equal(jh, th3)
