"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips (decided in
the ``cuda`` fixture, never at import). The file imports only torch,
numpy and the port, so on a machine with a card and no JAX it runs
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py

Inputs are made from seeded numpy generators and copied to the card and
to the CPU; every plane is integer, so kernel and plain version must be
exactly equal.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from fluidframework_tpu_torch.ops import map_fold_cuda as mfc
from fluidframework_tpu_torch.ops import map_kernel as mk
from fluidframework_tpu_torch.ops import sequencer as seqk
from fluidframework_tpu_torch.ops import sequencer_cuda as seqc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _on(planes, cls, device):
    return cls(*(torch.from_numpy(np.ascontiguousarray(planes[f])).to(device)
                 for f in cls._fields))


def _assert_equal(got, want, where=""):
    for f, a, b in zip(type(want)._fields, got, want):
        assert a.dtype == b.dtype, (where, f)
        assert torch.equal(a.cpu(), b.cpu()), (where, f)


def _fold_inputs(rng, b, k, s):
    r = rng.random((b, k))
    kind = np.where(r < 0.1, 2, np.where(r < 0.3, 1, 0)).astype(np.uint32)
    slot = rng.integers(0, min(s + 3, 1024), (b, k)).astype(np.uint32)
    value = rng.integers(0, 1 << 20, (b, k)).astype(np.uint32)
    words = (kind | (slot << 2) | (value << 12)).view(np.int32)
    lo = rng.integers(-2, max(1, k // 4), b).astype(np.int32)
    hi = rng.integers(0, k + 3, b).astype(np.int32)
    empty = rng.random(b) < 0.2
    hi[empty] = lo[empty]  # empty windows
    state = {"present": rng.random((b, s)) < 0.5,
             "value": rng.integers(0, 1 << 20, (b, s)).astype(np.int32),
             "vseq": rng.integers(-1, 1 << 20, (b, s)).astype(np.int32),
             "cleared_seq": rng.integers(-1, 1 << 10, b).astype(np.int32)}
    base = rng.integers(0, 1 << 20, b).astype(np.int32)
    return state, words, lo, hi, base


@pytest.mark.parametrize("b,k,s", [(1, 1, 1), (37, 300, 1024),
                                   (64, 2048, 64), (513, 33, 7)])
def test_map_fold_kernel_matches_plain(cuda, b, k, s):
    rng = np.random.default_rng(b * 7 + k + s)
    state, words, lo, hi, base = _fold_inputs(rng, b, k, s)
    args = [torch.from_numpy(a) for a in (words, lo, hi, base)]
    want = mk.fold_words_plain(_on(state, mk.MapState, "cpu"), *args)
    before = mfc.launches
    got = mfc.fold_words(_on(state, mk.MapState, cuda),
                         *(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert mfc.launches == before + 1
    _assert_equal(got, want, (b, k, s))


def _deli_inputs(rng, b, k, c):
    active = rng.random((b, c)) < 0.7
    active[:, -1] = False  # the ghost lane
    seq = rng.integers(10, 40, b).astype(np.int32)
    cref = np.minimum(rng.integers(0, 20, (b, c)), seq[:, None])
    live = np.where(active, cref, 2**31 - 1).min(axis=1)
    msn = np.where(active.any(axis=1), live, seq).astype(np.int32)
    state = dict(seq=seq, msn=msn, last_sent_msn=msn.copy(),
                 nack_future=rng.random(b) < 0.05, active=active,
                 cseq=rng.integers(0, 6, (b, c)).astype(np.int32),
                 cref=cref.astype(np.int32),
                 clu=rng.integers(0, 1000, (b, c)).astype(np.int32),
                 csum=rng.random((b, c)) < 0.5,
                 cnack=(rng.random((b, c)) < 0.05) & active,
                 cevict=rng.random((b, c)) < 0.8)
    kinds = [0, 1, 2, 5, 6, 7, 8, 8, 8, 8, 8, 8, 11, 13]
    iota = np.arange(k)[None, :]
    ops = dict(
        valid=rng.random((b, k)) < 0.95,
        kind=rng.choice(kinds, size=(b, k)).astype(np.int32),
        slot=np.where(rng.random((b, k)) < 0.2, -1,
                      rng.integers(-1, c + 1, (b, k))).astype(np.int32),
        target=rng.integers(-1, c + 1, (b, k)).astype(np.int32),
        client_seq=(iota // 3 + rng.integers(0, 4, (b, k))).astype(np.int32),
        ref_seq=np.where(rng.random((b, k)) < 0.1, -1,
                         rng.integers(0, 60, (b, k))).astype(np.int32),
        timestamp=rng.integers(1000, 2000, (b, k)).astype(np.int32),
        has_contents=rng.random((b, k)) < 0.5,
        can_summarize=rng.random((b, k)) < 0.5,
        can_evict=rng.random((b, k)) < 0.8,
        is_nack_future=rng.random((b, k)) < 0.2)
    return state, ops


@pytest.mark.parametrize("b,k,c", [(1, 1, 2), (300, 7, 3), (1000, 32, 5),
                                   (129, 64, 17)])
def test_deli_kernel_matches_plain(cuda, b, k, c):
    rng = np.random.default_rng(b + 11 * k + c)
    state, ops = _deli_inputs(rng, b, k, c)
    want_s, want_t = seqk.process_batch(_on(state, seqk.SequencerState, "cpu"),
                                        _on(ops, seqk.OpBatch, "cpu"))
    before = seqc.launches
    got_s, got_t = seqc.process_batch_best(
        _on(state, seqk.SequencerState, cuda), _on(ops, seqk.OpBatch, cuda))
    torch.cuda.synchronize()
    assert seqc.launches == before + 1
    _assert_equal(got_s, want_s, (b, k, c, "state"))
    _assert_equal(got_t, want_t, (b, k, c, "tickets"))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    state = mk.init_state(4, 8, cuda)
    words = torch.zeros((4, 16), dtype=torch.int64, device=cuda)
    lohi = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="words"):
        mfc.fold_words(state, words, lohi, lohi, lohi)
    with pytest.raises(ValueError, match="key slots"):
        mfc.fold_words(mk.init_state(4, 2048, cuda), words.int(), lohi,
                       lohi, lohi)
    s = seqk.init_state(4, 3, cuda)
    ops = seqk.make_op_batch([[]] * 4, 4, 8, cuda)
    bad = ops._replace(kind=ops.kind.t().contiguous().t())
    with pytest.raises(ValueError, match="kind"):
        seqc.process_batch_best(s, bad)


def test_storm_slice_on_the_card_matches_the_cpu(cuda):
    """The port's whole serving stack on the card (both kernels) against
    the same stack on the CPU (their plain versions): equal acks, planes
    and tick blobs, at pipeline depth 1."""
    from fluidframework_tpu_torch.server.kernel_host import \
        KernelSequencerHost
    from fluidframework_tpu_torch.server.merge_host import KernelMergeHost
    from fluidframework_tpu_torch.server.routerlicious import \
        RouterliciousService
    from fluidframework_tpu_torch.server.storm import StormController

    docs = [f"doc{i}" for i in range(12)]
    rng = np.random.default_rng(3)
    rounds = []
    for t in range(3):
        k = 64 if t != 1 else 40
        r = rng.random((len(docs), k))
        kinds = np.where(r < 0.1, 2, np.where(r < 0.3, 1, 0))
        words = (kinds | (rng.integers(0, 64, (len(docs), k)) << 2)
                 | (rng.integers(0, 1 << 20, (len(docs), k)) << 12))
        rounds.append((k, words.astype(np.uint32)))

    def serve(device):
        seq_host = KernelSequencerHost(num_slots=2, initial_capacity=4,
                                       device=device)
        merge_host = KernelMergeHost(flush_threshold=10**9, device=device)
        service = RouterliciousService(merge_host=merge_host,
                                       batched_deli_host=seq_host,
                                       auto_pump=False)
        service._clock = itertools.count(1000, 7).__next__
        storm = StormController(service, seq_host, merge_host,
                                flush_threshold_docs=10**9, pipeline_depth=1)
        ids = {d: service.connect(d, lambda m: None).client_id for d in docs}
        service.pump()
        acks = []
        cseq = 1
        for t, (k, words) in enumerate(rounds):
            c0 = cseq - 5 if t == 2 else cseq  # the third frame resends 5
            hdr = {"rid": t, "docs": [[d, ids[d], c0, 1, k] for d in docs]}
            storm.submit_frame(acks.append, hdr, memoryview(words.tobytes()))
            storm.flush()
            cseq = c0 + k
        return storm, seq_host, merge_host, acks

    before = (mfc.launches, seqc.launches)
    g_storm, g_seq, g_merge, g_acks = serve(cuda)
    torch.cuda.synchronize()
    assert mfc.launches > before[0] and seqc.launches > before[1]
    c_storm, c_seq, c_merge, c_acks = serve("cpu")
    assert [{k: a[k] for k in a.keys()} for a in g_acks] \
        == [{k: a[k] for k in a.keys()} for a in c_acks]
    _assert_equal(g_seq._state, c_seq._state, "sequencer")
    _assert_equal(g_merge._xstate, c_merge._xstate, "map")
    assert g_storm._tick_blobs == c_storm._tick_blobs
