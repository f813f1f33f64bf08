"""Differential: the port's deli (ops/sequencer.py process_batch — the plain
version of the CUDA deli kernel — and the closed-form storm_tickets)
against the JAX package's XLA scan and its Pallas tick kernel in interpret
mode, on seeded numpy streams. Every plane is integer: equality is exact.
"""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import sequencer as jseq
from fluidframework_tpu.ops import sequencer_pallas as jseqp
from fluidframework_tpu.protocol.messages import MessageType
from fluidframework_tpu_torch import convert
from fluidframework_tpu_torch.ops import sequencer as tseq
from fluidframework_tpu_torch.ops import sequencer_cuda as tseqc


def _random_stream(rng: random.Random, n_ops: int, n_clients: int):
    """Mixed op stream exercising joins/leaves/dups/gaps/nacks/noops (the
    generator tests/test_sequencer_pallas.py drives the Pallas kernel with)."""
    ops = []
    cseq = [0] * n_clients
    for i in range(n_ops):
        r = rng.random()
        if r < 0.12:
            target = rng.randrange(n_clients)
            kind = (MessageType.CLIENT_JOIN if r < 0.08
                    else MessageType.CLIENT_LEAVE)
            ops.append(dict(kind=int(kind), slot=-1, target=target,
                            timestamp=i + 1))
            if kind == MessageType.CLIENT_JOIN:
                cseq[target] = 0
        elif r < 0.2:
            slot = rng.randrange(n_clients)
            ops.append(dict(kind=int(MessageType.NOOP), slot=slot,
                            client_seq=cseq[slot] + 1, ref_seq=max(0, i - 3),
                            timestamp=i + 1,
                            has_contents=rng.random() < 0.5))
            cseq[slot] += 1
        else:
            slot = rng.randrange(n_clients)
            cseq[slot] += rng.choice([1, 1, 1, 0, 2])  # dups and gaps
            ops.append(dict(kind=int(MessageType.OPERATION), slot=slot,
                            client_seq=cseq[slot],
                            ref_seq=rng.randrange(max(1, i)) if i else 0,
                            timestamp=i + 1))
    return ops


def _raw_planes(rng: np.random.Generator, b: int, k: int, c: int) -> dict:
    """Unstructured op planes: every kind, out-of-range slots and targets,
    padding, nack_future controls — the fuzz a kernel must survive."""
    kinds = [0, 1, 2, 5, 6, 7, 8, 8, 8, 8, 11, 13]
    return dict(
        valid=rng.random((b, k)) < 0.9,
        kind=rng.choice(kinds, size=(b, k)).astype(np.int32),
        slot=rng.integers(-2, c + 1, (b, k)).astype(np.int32),
        target=rng.integers(-1, c + 1, (b, k)).astype(np.int32),
        client_seq=rng.integers(0, 5, (b, k)).astype(np.int32),
        ref_seq=rng.integers(-1, 6, (b, k)).astype(np.int32),
        timestamp=rng.integers(0, 1000, (b, k)).astype(np.int32),
        has_contents=rng.random((b, k)) < 0.5,
        can_summarize=rng.random((b, k)) < 0.5,
        can_evict=rng.random((b, k)) < 0.5,
        is_nack_future=rng.random((b, k)) < 0.1)


def _assert_equal(jax_nt, torch_nt, where=""):
    for f in jax_nt._fields:
        a = np.asarray(getattr(jax_nt, f))
        b = getattr(torch_nt, f).numpy()
        assert a.dtype == b.dtype, (where, f, a.dtype, b.dtype)
        assert np.array_equal(a, b), (where, f)


@pytest.mark.parametrize("seed", range(3))
def test_process_batch_matches_jax_and_pallas(seed):
    rng = random.Random(seed)
    n_docs = rng.choice([1, 5, 9])
    n_clients, k, ticks = 5, 16, 4
    streams = [_random_stream(rng, k * ticks, n_clients)
               for _ in range(n_docs)]
    js = jseq.init_state(n_docs, n_clients + 2)
    ps = js
    ts = tseq.init_state(n_docs, n_clients + 2, device="cpu")
    for t in range(ticks):
        chunk = [s[t * k:(t + 1) * k] for s in streams]
        chunk = [c[:rng.randrange(len(c) // 2, len(c) + 1)] for c in chunk]
        js, jt = jseq.process_batch(js, jseq.make_op_batch(chunk, n_docs, k))
        ps, pt = jseqp.process_batch_pallas(
            ps, jseq.make_op_batch(chunk, n_docs, k), interpret=True)
        ts, tt = tseq.process_batch(
            ts, tseq.make_op_batch(chunk, n_docs, k, device="cpu"))
        _assert_equal(jt, tt, (seed, t, "xla"))
        _assert_equal(pt, tt, (seed, t, "pallas"))
    _assert_equal(js, ts, (seed, "state xla"))
    _assert_equal(ps, ts, (seed, "state pallas"))


@pytest.mark.parametrize("seed", range(2))
def test_process_batch_fuzz_planes(seed):
    rng = np.random.default_rng(seed)
    b, c, k = 12, 5, 24
    js = jseq.init_state(b, c)
    ts = tseq.init_state(b, c, device="cpu")
    for t in range(3):
        planes = _raw_planes(rng, b, k, c)
        js, jt = jseq.process_batch(
            js, jseq.OpBatch(**{n: jnp.asarray(v) for n, v in planes.items()}))
        ts, tt = tseqc.process_batch_best(
            ts, tseq.OpBatch(**{n: torch.from_numpy(v)
                                for n, v in planes.items()}))
        _assert_equal(jt, tt, (seed, t))
    _assert_equal(js, ts, (seed, "state"))


def _random_prior(rng: random.Random, b: int, c: int) -> dict:
    """A randomized prior state (tests/test_sequencer.py storm cases):
    active clients with varied cseq/cref, nacked clients, nack_future."""
    active = np.zeros((b, c), np.bool_)
    cseq = np.zeros((b, c), np.int32)
    cref = np.zeros((b, c), np.int32)
    cnack = np.zeros((b, c), np.bool_)
    seq = np.zeros(b, np.int32)
    msn = np.zeros(b, np.int32)
    nack_future = np.zeros(b, np.bool_)
    for d in range(b):
        seq[d] = rng.randrange(5, 60)
        for s in range(c):
            if rng.random() < 0.7:
                active[d, s] = True
                cseq[d, s] = rng.randrange(0, 20)
                cref[d, s] = rng.randrange(0, seq[d] + 1)
                cnack[d, s] = rng.random() < 0.15
        live = [cref[d, s] for s in range(c) if active[d, s]]
        msn[d] = min(live) if live else seq[d]
        nack_future[d] = rng.random() < 0.1
    return dict(seq=seq, msn=msn, last_sent_msn=msn.copy(),
                nack_future=nack_future, active=active, cseq=cseq,
                cref=cref, clu=np.zeros((b, c), np.int32),
                csum=np.zeros((b, c), np.bool_), cnack=cnack,
                cevict=np.ones((b, c), np.bool_))


@pytest.mark.parametrize("seed", range(3))
def test_storm_tickets_matches_jax(seed):
    """Closed-form storm ticket: port == JAX storm_tickets, and port ==
    the port's own per-op process_batch on the storm shape (dup prefixes,
    gaps, inactive/nacked slots, nack_future, refSeq<MSN, refSeq=-1)."""
    rng = random.Random(seed)
    b, c, kmax = 32, 8, 12
    prior = _random_prior(rng, b, c)
    slot = np.zeros(b, np.int32)
    cseq0 = np.zeros(b, np.int32)
    ref = np.zeros(b, np.int32)
    ts = np.full(b, 1234, np.int32)
    counts = np.zeros(b, np.int32)
    for d in range(b):
        s = rng.randrange(c)
        slot[d] = s
        counts[d] = rng.randrange(0, kmax + 1)
        cseq0[d] = prior["cseq"][d, s] + 1 + rng.choice([-3, -1, 0, 0, 1, 2])
        ref[d] = rng.choice([-1, max(0, prior["msn"][d] - 2),
                             prior["msn"][d], int(prior["seq"][d])])
    jstate = jseq.SequencerState(**{f: jnp.asarray(v)
                                    for f, v in prior.items()})
    tstate = convert.sequencer_state_from_numpy(prior, "cpu")
    args = [slot, cseq0, ref, ts, counts]
    jout = jseq.storm_tickets(jstate, *map(jnp.asarray, args))
    tout = tseq.storm_tickets(tstate, *map(torch.from_numpy, args))
    _assert_equal(jout[0], tout[0], seed)
    for a, b_ in zip(jout[1:], tout[1:]):
        assert np.array_equal(np.asarray(a), b_.numpy())

    ops_per_doc = [
        [dict(kind=int(MessageType.OPERATION), slot=int(slot[d]),
              client_seq=int(cseq0[d] + i), ref_seq=int(ref[d]),
              timestamp=int(ts[d]), has_contents=True)
         for i in range(int(counts[d]))]
        for d in range(b)]
    per_op, tickets = tseq.process_batch(
        tstate, tseq.make_op_batch(ops_per_doc, b, kmax, device="cpu"))
    for f in tseq.SequencerState._fields:
        assert torch.equal(getattr(per_op, f), getattr(tout[0], f)), f
    dups, n_seq = tout[1], tout[2]
    iota = torch.arange(kmax)[None, :]
    sequenced = (iota >= dups[:, None]) & (iota < (dups + n_seq)[:, None])
    assert torch.equal(tickets.kind == 1, sequenced)


def test_init_state_and_find_idle_match_jax():
    j = jseq.init_state(3, 4)
    t = tseq.init_state(3, 4, device="cpu")
    _assert_equal(j, t)
    rng = np.random.default_rng(3)
    prior = _random_prior(random.Random(3), 6, 4)
    prior["clu"] = rng.integers(0, 5000, (6, 4)).astype(np.int32)
    prior["cevict"] = rng.random((6, 4)) < 0.7
    jstate = jseq.SequencerState(**{f: jnp.asarray(v)
                                    for f, v in prior.items()})
    tstate = convert.sequencer_state_from_numpy(prior, "cpu")
    for now, timeout in ((6000, 1500), (3000, 0), (100, 10_000)):
        assert np.array_equal(np.asarray(jseq.find_idle(jstate, now, timeout)),
                              tseq.find_idle(tstate, now, timeout).numpy())


def test_entry_points_default_to_cuda():
    """Without a card, the default device raises instead of serving on the
    CPU (the tests pass device='cpu')."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        tseq.init_state(2, 2)
