"""The port's CUDA kernels against their plain PyTorch versions, on the card
(the map fold, the deli tick, the block and flat merge ticks, the matrix
op tick and step tick), and the serving slices on the card against the
same slices on the CPU.

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
from fluidframework_tpu_torch.ops import matrix_cuda as mxc
from fluidframework_tpu_torch.ops import matrix_kernel as mxk
from fluidframework_tpu_torch.ops import mergetree_blocks as mtb
from fluidframework_tpu_torch.ops import mergetree_blocks_cuda as mtbc
from fluidframework_tpu_torch.ops import mergetree_cuda as mtc
from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
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


@pytest.mark.parametrize("variant", [None, "warp", "block"])
@pytest.mark.parametrize("b,k,s", [(1, 1, 1), (37, 300, 1024),
                                   (64, 2048, 64), (513, 33, 7),
                                   (9, 130, 64), (20, 1023, 1024)])
def test_map_fold_kernel_matches_plain(cuda, b, k, s, variant):
    """Kernel 1 == its plain version in both variants (None: the one the
    shape picks), with windows that start below 0, end past K or are
    empty, slots past S, K % 4 != 0 and S = 1,024."""
    rng = np.random.default_rng(b * 7 + k + s)
    state, words, lo, hi, base = _fold_inputs(rng, b, k, s)
    args = [torch.from_numpy(a) for a in (words, lo, hi, base)]
    want = mk.fold_words_plain(_on(state, mk.MapState, "cpu"), *args)
    picked = variant or mfc.fold_variant(b, k, s)
    assert picked == (variant or "warp")
    before = mfc.launches, mfc.variants[picked]
    got = mfc.fold_words(_on(state, mk.MapState, cuda),
                         *(a.to(cuda) for a in args), variant=variant)
    torch.cuda.synchronize()
    assert (mfc.launches, mfc.variants[picked]) == (before[0] + 1,
                                                    before[1] + 1)
    _assert_equal(got, want, (b, k, s, variant))


@pytest.mark.parametrize("variant", ["warp", "block"])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_map_fold_kernel_on_unaligned_rows_and_all_clear_rows(cuda, offset,
                                                              variant):
    """Kernel 1 == its plain version on a ``words`` view that starts 4,
    8 or 12 bytes past a 16-byte boundary (every row's window then has an
    unaligned head and tail), with every third row all clears."""
    b, k, s = 33, 257, 64
    rng = np.random.default_rng(offset)
    state, words, lo, hi, base = _fold_inputs(rng, b, k, s)
    words[::3] = mk.MAP_CLEAR | (5 << 2)
    flat = torch.zeros(b * k + 8, dtype=torch.int32, device=cuda)
    view = flat[offset:offset + b * k].view(b, k)
    view.copy_(torch.from_numpy(words).to(cuda))
    assert view.is_contiguous() and view.data_ptr() % 16 == 4 * offset
    args = [torch.from_numpy(a) for a in (lo, hi, base)]
    want = mk.fold_words_plain(_on(state, mk.MapState, "cpu"),
                               torch.from_numpy(words), *args)
    got = mfc.fold_words(_on(state, mk.MapState, cuda), view,
                         *(a.to(cuda) for a in args), variant=variant)
    torch.cuda.synchronize()
    _assert_equal(got, want, (offset, variant))
    assert bool((want.cleared_seq[::3]
                 != torch.from_numpy(state["cleared_seq"][::3])).any())


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


@pytest.mark.parametrize("variant", [None, "warp", "thread"])
@pytest.mark.parametrize("b,k,c", [(1, 1, 2), (300, 7, 3), (1000, 32, 5),
                                   (129, 64, 17)])
def test_deli_kernel_matches_plain(cuda, b, k, c, variant):
    rng = np.random.default_rng(b + 11 * k + c)
    state, ops = _deli_inputs(rng, b, k, c)
    want_s, want_t = seqk.process_batch(_on(state, seqk.SequencerState, "cpu"),
                                        _on(ops, seqk.OpBatch, "cpu"))
    picked = variant or seqc.deli_variant(b, k, c, seqc.smem_limit(cuda))
    before = seqc.launches, seqc.variants.get(picked, 0)
    got_s, got_t = seqc.process_batch_best(
        _on(state, seqk.SequencerState, cuda), _on(ops, seqk.OpBatch, cuda),
        variant)
    torch.cuda.synchronize()
    assert seqc.launches == before[0] + 1
    assert seqc.variants[picked] == before[1] + 1
    _assert_equal(got_s, want_s, (b, k, c, "state"))
    _assert_equal(got_t, want_t, (b, k, c, "tickets"))


def _deli_every_outcome(rng, b, k, c):
    """A deli tick whose ops reach every nack code and every outcome:
    C - 1 live lanes (90% active) and the ghost lane, client ops with
    dups and gaps, refSeq below MSN, summarize without scope, joins,
    leaves, noops, no-client ops and nack_future controls."""
    from fluidframework_tpu_torch.protocol.messages import MessageType as MT

    lanes = np.arange(c)[None, :]
    active = (lanes < c - 1) & (rng.random((b, c)) < 0.9)
    seq = rng.integers(20, 40, b).astype(np.int32)
    cref = np.minimum(rng.integers(5, 20, (b, c)), seq[:, None])
    live = np.where(active, cref, 2**31 - 1).min(axis=1)
    msn = np.where(active.any(axis=1), live, seq).astype(np.int32)
    state = dict(seq=seq, msn=msn, last_sent_msn=msn.copy(),
                 nack_future=rng.random(b) < 0.02, active=active,
                 cseq=rng.integers(0, 6, (b, c)).astype(np.int32),
                 cref=cref.astype(np.int32),
                 clu=rng.integers(0, 1000, (b, c)).astype(np.int32),
                 csum=rng.random((b, c)) < 0.5,
                 cnack=(rng.random((b, c)) < 0.05) & active,
                 cevict=np.ones((b, c), bool))
    choice = np.array([int(MT.OPERATION)] * 10 + [
        int(MT.NOOP), int(MT.SUMMARIZE), int(MT.CLIENT_JOIN),
        int(MT.CLIENT_LEAVE), int(MT.NO_CLIENT), int(MT.CONTROL),
        int(MT.SUMMARY_ACK)], np.int32)
    kind = rng.choice(choice, size=(b, k))
    system = np.isin(kind, [int(MT.CLIENT_JOIN), int(MT.CLIENT_LEAVE),
                            int(MT.NO_CLIENT), int(MT.CONTROL)])
    iota = np.arange(k)[None, :]
    ops = dict(
        valid=rng.random((b, k)) < 0.95, kind=kind,
        slot=np.where(system & (rng.random((b, k)) < 0.9), -1,
                      rng.integers(0, c, (b, k))).astype(np.int32),
        target=rng.integers(0, c, (b, k)).astype(np.int32),
        client_seq=(iota // 4 + rng.integers(0, 4, (b, k))).astype(np.int32),
        ref_seq=np.where(rng.random((b, k)) < 0.1, -1,
                         rng.integers(0, 60, (b, k))).astype(np.int32),
        timestamp=rng.integers(1000, 2000, (b, k)).astype(np.int32),
        has_contents=rng.random((b, k)) < 0.5,
        can_summarize=rng.random((b, k)) < 0.5,
        can_evict=rng.random((b, k)) < 0.8,
        is_nack_future=rng.random((b, k)) < 0.2)
    return state, ops


def _deli_emptying(rng, b, k, c):
    """A deli tick of service ops only (joins, leaves, no-client ops,
    noops, controls) over documents with at most three live clients: the
    leaves empty documents, so the MSN takes the no-client branch
    (INT32_MAX over no active lane, then the seq)."""
    state, ops = _deli_inputs(rng, b, k, c)
    state["active"][:, 3:] = False
    ops["kind"] = rng.choice(np.array([1, 2, 2, 2, 11, 0, 13], np.int32),
                             size=(b, k))
    ops["slot"] = np.where(rng.random((b, k)) < 0.9, -1,
                           ops["slot"]).astype(np.int32)
    ops["target"] = rng.integers(0, 3, (b, k)).astype(np.int32)
    return state, ops


@pytest.mark.parametrize("variant", ["warp", "thread"])
@pytest.mark.parametrize("b,k,c", [(64, 32, 5), (64, 32, 33),
                                   (32, 64, 129), (16, 128, 257)])
def test_deli_kernel_reaches_every_outcome(cuda, b, k, c, variant):
    """Both variants == the plain version where the ops reach every nack
    code and every outcome, at C = 5, 33, 129 and 257 (lanes not a
    multiple of 32, and more than one client a lane)."""
    state, ops = _deli_every_outcome(np.random.default_rng(b + k + c), b, k,
                                     c)
    want_s, want_t = seqk.process_batch(_on(state, seqk.SequencerState, "cpu"),
                                        _on(ops, seqk.OpBatch, "cpu"))
    assert (torch.bincount(want_t.nack_code.flatten().long(),
                           minlength=7)[1:] > 0).all()
    assert (torch.bincount(want_t.kind.flatten().long(), minlength=3)
            > 0).all()
    got_s, got_t = seqc.process_batch_best(
        _on(state, seqk.SequencerState, cuda), _on(ops, seqk.OpBatch, cuda),
        variant)
    torch.cuda.synchronize()
    _assert_equal(got_s, want_s, (b, k, c, variant, "state"))
    _assert_equal(got_t, want_t, (b, k, c, variant, "tickets"))


@pytest.mark.parametrize("variant", ["warp", "thread"])
@pytest.mark.parametrize("b,k,c", [(40, 64, 17), (9, 100, 129)])
def test_deli_kernel_when_leaves_empty_the_document(cuda, b, k, c, variant):
    state, ops = _deli_emptying(np.random.default_rng(b * 3 + k + c), b, k, c)
    want_s, want_t = seqk.process_batch(_on(state, seqk.SequencerState, "cpu"),
                                        _on(ops, seqk.OpBatch, "cpu"))
    assert not bool(want_s.active.any(dim=1).all())
    got_s, got_t = seqc.process_batch_best(
        _on(state, seqk.SequencerState, cuda), _on(ops, seqk.OpBatch, cuda),
        variant)
    torch.cuda.synchronize()
    _assert_equal(got_s, want_s, (b, k, c, variant, "state"))
    _assert_equal(got_t, want_t, (b, k, c, variant, "tickets"))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    state = mk.init_state(4, 8, cuda)
    words = torch.zeros((4, 16), dtype=torch.int64, device=cuda)
    lohi = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="words"):
        mfc.fold_words(state, words, lohi, lohi, lohi)
    with pytest.raises(ValueError, match="key slots"):
        mfc.fold_words(mk.init_state(4, 2048, cuda), words.int(), lohi,
                       lohi, lohi)
    before = mfc.launches
    with pytest.raises(ValueError, match="no variant"):
        mfc.fold_words(state, words.int(), lohi, lohi, lohi, "thread")
    assert mfc.launches == before
    s = seqk.init_state(4, 3, cuda)
    ops = seqk.make_op_batch([[]] * 4, 4, 8, cuda)
    bad = ops._replace(kind=ops.kind.t().contiguous().t())
    before = seqc.launches
    with pytest.raises(ValueError, match="kind"):
        seqc.process_batch_best(s, bad)
    with pytest.raises(ValueError, match="no variant"):
        seqc.process_batch_best(s, ops, "block")
    # The warp variant stages a block's four documents' client lanes in
    # shared memory: a C past the card's limit is refused, not launched.
    c = seqc.smem_limit(cuda) // (seqc.WARP_DOCS * seqc.WARP_CLIENT_BYTES) + 1
    wide = seqk.init_state(4, c, cuda)
    assert seqc.deli_variant(4, 8, c, seqc.smem_limit(cuda)) == "thread"
    with pytest.raises(ValueError, match="shared memory"):
        seqc.process_batch_best(wide, ops, "warp")
    assert seqc.launches == before


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


def _merge_ticks(rng, b, k, ticks, clients, head=0.0):
    """Op batches of ``ticks`` ticks: inserts, removes and annotates from
    ``clients`` writers at refs that lag the seq (concurrent), positions
    inside a tracked visible length; a ``head`` fraction of inserts lands
    at position 0 (the head-concentrated shape)."""
    length = np.zeros(b, np.int64)
    seq = np.zeros(b, np.int64)
    pool = np.zeros(b, np.int64)
    out = []
    for _ in range(ticks):
        f = {n: np.zeros((b, k), np.int32) for n in mtk.MergeOpBatch._fields}
        f["valid"] = rng.random((b, k)) < 0.9
        for j in range(k):
            seq += 1
            r = rng.random(b)
            kind = np.where((length > 4) & (r < 0.3), mtk.MT_REMOVE,
                            np.where((length > 4) & (r < 0.4),
                                     mtk.MT_ANNOTATE, mtk.MT_INSERT))
            pos = (rng.random(b) * (length + 1)).astype(np.int64)
            pos = np.where((kind == mtk.MT_INSERT) & (rng.random(b) < head),
                           0, pos)
            end = np.minimum(pos + rng.integers(1, 9, b), length)
            tlen = rng.integers(1, 9, b)
            f["kind"][:, j] = kind
            f["pos"][:, j] = pos
            f["end"][:, j] = end
            f["seq"][:, j] = seq
            f["ref_seq"][:, j] = np.maximum(seq - rng.integers(1, 6, b), 0)
            f["client"][:, j] = rng.integers(0, clients, b)
            f["pool_start"][:, j] = pool
            f["text_len"][:, j] = tlen
            f["prop_key"][:, j] = rng.integers(0, 5, b)
            f["prop_val"][:, j] = rng.integers(0, 4, b)
            v = f["valid"][:, j]
            ins = v & (kind == mtk.MT_INSERT)
            rem = v & (kind == mtk.MT_REMOVE)
            length += np.where(ins, tlen, 0) - np.where(rem, end - pos, 0)
            pool += np.where(ins, tlen, 0)
        out.append(f)
    return out


def _batch(fields, device):
    return mtk.MergeOpBatch(**{n: torch.from_numpy(np.ascontiguousarray(
        fields[n])).to(device) for n in mtk.MergeOpBatch._fields})


def _to(state, device):
    return type(state)(*(t.to(device) for t in state))


@pytest.mark.parametrize("variant", [None, "global"])
@pytest.mark.parametrize("b,s,k,p,w,ticks", [
    (1, 8, 1, 1, 1, 1), (5, 64, 16, 2, 1, 3), (33, 512, 32, 4, 4, 2),
    (7, 300, 40, 3, 2, 3), (2, 1000, 24, 4, 4, 2), (1, 1500, 16, 2, 2, 2),
    (2, 4096, 24, 4, 4, 2)])
def test_flat_kernel_matches_plain(cuda, b, s, k, p, w, ticks, variant):
    """Kernel 4 == its plain version tick by tick from an empty table
    (and past capacity, where segments fall off the end), in the variant
    the shape picks (shared memory, except the 4,096-slot rows, which do
    not fit) and in the global-memory one; the shared-memory walk's shift
    runs with one, two, four (S = 1,000) and six (S = 1,500) slots a
    thread."""
    rng = np.random.default_rng(b * 31 + s + k)
    want = mtk.init_state(b, s, p, w, device="cpu")
    got = _to(want, cuda)
    picked = variant or mtc.choose_variant(s, p, w, k, mtc.smem_limit(cuda))
    assert picked == ("global" if s > 2048 else "smem") or variant
    for fields in _merge_ticks(rng, b, k, ticks, 32 * w):
        want = mtk.apply_tick(want, _batch(fields, "cpu"))
        before = mtc.launches, mtc.variants[picked]
        got = mtc.apply_tick_best(got, _batch(fields, cuda), variant)
        torch.cuda.synchronize()
        assert (mtc.launches, mtc.variants[picked]) == (before[0] + 1,
                                                        before[1] + 1)
        _assert_equal(got, want, (b, s, k, variant))


def _wild_flat(rng, b, s, p, w, k):
    """(state, ops) of random flat tables: counts from below 0 to past S
    (the shift's wrapped reads), in every other document lengths near
    2**30 or negative (prefixes that wrap), removed and overlap-marked
    slots (sign bits included), clients past the overlap words, annotate
    keys out of range and positions off both ends."""
    rem = rng.random((b, s)) < 0.3
    over = rng.integers(-2**31, 2**31, (b, s, w), dtype=np.int64)
    wild = (np.arange(b) % 2 == 1)[:, None]
    planes = {
        "valid": rng.random((b, s)) < 0.85,
        "length": np.where(wild & (rng.random((b, s)) < 0.3),
                           rng.integers(-3, 2**30, (b, s)),
                           rng.integers(0, 9, (b, s))),
        "ins_seq": rng.integers(0, 40, (b, s)),
        "ins_client": rng.integers(0, 8, (b, s)),
        "rem_seq": np.where(rem, rng.integers(0, 40, (b, s)),
                            int(mtk.NONE_SEQ)),
        "rem_client": np.where(rem, rng.integers(0, 8, (b, s)), -1),
        "rem_overlap": np.where(rng.random((b, s, w)) < 0.2, over, 0),
        "pool_start": rng.integers(0, 1000, (b, s)),
        "prop_val": rng.integers(0, 5, (b, s, p)),
        "count": rng.integers(-2, s + 4, b)}
    state = mtk.MergeState(**{
        f: torch.from_numpy(np.ascontiguousarray(
            v if f == "valid" else v.astype(np.int32)))
        for f, v in planes.items()})
    pos = rng.integers(-2, 8 * s, (b, k))
    ops = {"valid": rng.random((b, k)) < 0.9,
           "kind": rng.integers(0, 3, (b, k)), "pos": pos,
           "end": pos + rng.integers(0, 12, (b, k)),
           "seq": 41 + np.arange(k)[None].repeat(b, 0),
           "ref_seq": rng.integers(0, 45, (b, k)),
           "client": rng.integers(0, 32 * w + 4, (b, k)),
           "pool_start": rng.integers(0, 1000, (b, k)),
           "text_len": rng.integers(1, 9, (b, k)),
           "prop_key": rng.integers(-1, p + 1, (b, k)),
           "prop_val": rng.integers(0, 5, (b, k))}
    ops = mtk.MergeOpBatch(**{
        f: torch.from_numpy(np.ascontiguousarray(
            v if f == "valid" else v.astype(np.int32)))
        for f, v in ops.items()})
    return state, ops


@pytest.mark.parametrize("variant", ["smem", "global"])
@pytest.mark.parametrize("b,s,p,w,k", [(16, 40, 2, 2, 30),
                                      (8, 300, 3, 1, 48),
                                      (6, 129, 1, 2, 64)])
def test_flat_kernel_on_wild_tables(cuda, b, s, p, w, k, variant):
    """Kernel 4 == its plain version, both variants, on random tables
    filled past capacity or with negative counts, whose prefixes wrap,
    with removes and annotates by clients at or past 32 * W."""
    state, ops = _wild_flat(np.random.default_rng(b + s + k), b, s, p, w, k)
    want = mtk.apply_tick(state, ops)
    got = mtc.apply_tick_best(_to(state, cuda), _to(ops, cuda), variant)
    torch.cuda.synchronize()
    _assert_equal(got, want, (b, s, variant))


@pytest.mark.parametrize("variant", [None, "global"])
@pytest.mark.parametrize("b,nb,bk,k,p,w,ticks,head", [
    (1, 1, 8, 1, 1, 1, 1, 0.0), (6, 4, 16, 8, 2, 1, 4, 0.0),
    (40, 4, 128, 32, 4, 4, 3, 0.2), (9, 3, 32, 70, 2, 2, 2, 0.9),
    (3, 16, 512, 16, 4, 4, 2, 0.5)])
def test_block_kernel_matches_plain(cuda, b, nb, bk, k, p, w, ticks, head,
                                    variant):
    """Kernel 3 == its plain version (planes, summaries, overflow index,
    rebalance stats) tick by tick through the serving step (the tick,
    then the rebalance ladder), in the variant the shape picks (shared
    memory, except the 16 x 512 rows, which do not fit) and in the
    global-memory one; the 0.9-head case overflows blocks mid-tick."""
    rng = np.random.default_rng(b * 13 + nb * bk + k)
    want = mtb.init_state(b, nb, bk, p, w, device="cpu")
    got = _to(want, cuda)
    saw_ovf = False
    ms = torch.zeros(b, dtype=torch.int32)
    picked = variant or mtbc.choose_variant(nb, bk, p, w, k,
                                            mtbc.smem_limit(cuda))
    assert picked == ("global" if nb * bk > 4096 else "smem") or variant
    for fields in _merge_ticks(rng, b, k, ticks, 32 * w, head):
        want, want_ovf = mtb.apply_tick_blocks(want, _batch(fields, "cpu"))
        want, want_rs = mtb.maybe_rebalance_stats(want, ms, min(k, 8))
        before = mtbc.launches, dict(mtbc.variants)
        got, got_ovf = mtbc.apply_tick_blocks_best(got, _batch(fields, cuda),
                                                   variant)
        got, got_rs = mtb.maybe_rebalance_stats(got, ms.to(cuda), min(k, 8))
        torch.cuda.synchronize()
        assert mtbc.launches == before[0] + 1
        assert mtbc.variants[picked] == before[1][picked] + 1
        _assert_equal(got, want, (b, nb, bk, k))
        assert torch.equal(got_ovf.cpu(), want_ovf)
        assert torch.equal(got_rs.cpu(), want_rs)
        saw_ovf |= bool((want_ovf != int(mtb.OVF_NONE)).any())
    assert saw_ovf or head < 0.9


def _inexact_blocks(rng, b, nb, bk, p, w, k):
    """(state, ops) of a block table whose summaries are NOT its planes':
    random fills, live lengths (some negative), newest seqs and tombstone
    counts, so hot and cold blocks give frames in which a position falls
    inside several slots or none; removed and overlap-marked slots (sign
    bits included), clients past the overlap words, annotate keys out of
    range and positions off both ends."""
    shape = (b, nb, bk)
    rem = rng.random(shape) < 0.3
    over = rng.integers(-2**31, 2**31, (b, nb, bk, w), dtype=np.int64)
    planes = {
        "length": rng.integers(0, 9, shape),
        "ins_seq": rng.integers(0, 40, shape),
        "ins_client": rng.integers(0, 8, shape),
        "rem_seq": np.where(rem, rng.integers(0, 40, shape),
                            int(mtk.NONE_SEQ)),
        "rem_client": np.where(rem, rng.integers(0, 8, shape), -1),
        "rem_overlap": np.where(rng.random((b, nb, bk, w)) < 0.2, over, 0),
        "pool_start": rng.integers(0, 1000, shape),
        "prop_val": rng.integers(0, 5, (b, nb, bk, p)),
        "blk_count": rng.integers(0, bk + 1, (b, nb)),
        "blk_live_len": rng.integers(-5, 8 * bk, (b, nb)),
        "blk_max_seq": rng.integers(0, 45, (b, nb)),
        "blk_tomb": rng.integers(0, 5, (b, nb))}
    planes["count"] = planes["blk_count"].sum(axis=1)
    state = mtb.BlockMergeState(**{
        f: torch.from_numpy(np.ascontiguousarray(v.astype(np.int32)))
        for f, v in planes.items()})
    pos = rng.integers(-2, 8 * bk, (b, k))
    ops = {"valid": rng.random((b, k)) < 0.9,
           "kind": rng.integers(0, 3, (b, k)), "pos": pos,
           "end": pos + rng.integers(0, 12, (b, k)),
           "seq": 41 + np.arange(k)[None].repeat(b, 0),
           "ref_seq": rng.integers(0, 45, (b, k)),
           "client": rng.integers(0, 32 * w + 4, (b, k)),
           "pool_start": rng.integers(0, 1000, (b, k)),
           "text_len": rng.integers(1, 9, (b, k)),
           "prop_key": rng.integers(-1, p + 1, (b, k)),
           "prop_val": rng.integers(0, 5, (b, k))}
    ops = mtk.MergeOpBatch(**{
        f: torch.from_numpy(np.ascontiguousarray(
            v if f == "valid" else v.astype(np.int32)))
        for f, v in ops.items()})
    return state, ops


@pytest.mark.parametrize("variant", ["smem", "global"])
@pytest.mark.parametrize("b,nb,bk,p,w,k", [(64, 4, 32, 2, 2, 16),
                                          (16, 3, 128, 4, 4, 24)])
def test_block_kernel_on_inexact_summaries(cuda, b, nb, bk, p, w, k,
                                           variant):
    """Kernel 3 == its plain version, both variants, on tables whose block
    summaries disagree with their slots: the reductions over the whole
    table decide alike."""
    state, ops = _inexact_blocks(np.random.default_rng(b + bk + k), b, nb,
                                 bk, p, w, k)
    want, want_ovf = mtb.apply_tick_blocks(state, ops)
    got, got_ovf = mtbc.apply_tick_blocks_best(_to(state, cuda),
                                               _to(ops, cuda), variant)
    torch.cuda.synchronize()
    _assert_equal(got, want, (b, nb, bk, variant))
    assert torch.equal(got_ovf.cpu(), want_ovf)


def test_merge_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    state = mtb.init_state(2, 2, 8, 2, 1, cuda)
    ops = mtk.make_merge_op_batch([[], []], 2, 4, device=cuda)
    with pytest.raises(ValueError, match="op kind"):
        mtbc.apply_tick_blocks_best(
            state, ops._replace(kind=ops.kind.t().contiguous().t()))
    with pytest.raises(ValueError, match="op pos"):
        mtbc.apply_tick_blocks_best(state, ops._replace(pos=ops.pos.long()))
    with pytest.raises(ValueError, match="blk_count"):
        mtbc.apply_tick_blocks_best(
            state._replace(blk_count=state.blk_count.cpu()), ops)
    flat = mtk.init_state(2, 16, 2, 1, cuda)
    with pytest.raises(ValueError, match="valid"):
        mtc.apply_tick_best(flat._replace(valid=flat.valid.int()), ops)
    with pytest.raises(ValueError, match="op valid"):
        mtc.apply_tick_best(flat, ops._replace(valid=ops.valid.cpu()))
    before = mtc.launches
    with pytest.raises(ValueError, match="no variant"):
        mtc.apply_tick_best(flat, ops, "warp")
    # A row past one block's shared memory is refused by the shared-memory
    # variant, not launched.
    wide = mtk.init_state(2, 4096, 4, 4, cuda)
    assert mtc.choose_variant(4096, 4, 4, 4, mtc.smem_limit(cuda)) \
        == "global"
    with pytest.raises(ValueError, match="shared memory"):
        mtc.apply_tick_best(wide, ops, "smem")
    assert mtc.launches == before


def _text_traffic(rng, docs, rounds, writers, head):
    """Rounds of concurrent SharedString ops, one per writer, at each
    doc's head ref, with positions valid in that frame: a list of rounds,
    each a list of (doc, op, client, seq, ref)."""
    out = []
    seq = {d: 0 for d in docs}
    length = {d: 0 for d in docs}
    for _ in range(rounds):
        out.append([])
        for d in docs:
            ref, covered, grown = seq[d], set(), 0
            for w in rng.permutation(writers)[:rng.integers(4, 24)]:
                L = length[d]
                if L > 2 and rng.random() < 0.3:
                    s = int(rng.integers(0, L - 1))
                    e = min(L, s + int(rng.integers(1, 8)))
                    op = {"type": "remove", "start": s, "end": e}
                    covered.update(range(s, e))
                elif L > 2 and rng.random() < 0.1:
                    s = int(rng.integers(0, L - 1))
                    op = {"type": "annotate", "start": s, "end": s + 1,
                          "props": {"b": int(rng.integers(0, 3))}}
                else:
                    n = int(rng.integers(1, 8))
                    pos = 0 if rng.random() < head else \
                        int(rng.integers(0, L + 1))
                    op = {"type": "insert", "pos": pos, "text": "x" * n}
                    grown += n
                seq[d] += 1
                out[-1].append((d, op, f"w{w}", seq[d], ref))
            length[d] += grown - len(covered)
    return out


def _bursty_text():
    """Eight rounds for six docs from 64 writers, most inserts at the
    head: with 16-slot blocks, blocks overflow and the flat replay runs."""
    return _text_traffic(np.random.default_rng(8),
                         [f"doc{i}" for i in range(6)], 8, 64, 0.6)


def _serve_text(host, traffic):
    """Feed ``traffic`` to ``host`` through ``ingest``, one flush per
    round."""
    from fluidframework_tpu_torch.protocol.messages import (
        MessageType,
        SequencedDocumentMessage,
    )
    for batch in traffic:
        for d, op, client, seq, ref in batch:
            host.ingest(d, SequencedDocumentMessage(
                client_id=client, sequence_number=seq,
                minimum_sequence_number=max(0, ref - 20),
                client_sequence_number=seq,
                reference_sequence_number=ref,
                type=MessageType.OPERATION,
                contents={"address": "ds", "contents": {
                    "address": "text", "contents": op}}))
        host.flush()
    return host


def test_text_host_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """The port's merge host serving SharedString traffic on the card
    (kernels 3 and 4) against the same host on the CPU (their plain
    versions): equal planes, text pools, stats and text. Small blocks
    and head bursts make blocks overflow, so the flat replay runs."""
    from fluidframework_tpu_torch.server import merge_host as mh

    monkeypatch.setattr(mh._BlockMergePool, "BK", 16)
    traffic = _bursty_text()
    before = (mtbc.launches, mtc.launches)
    card = _serve_text(mh.KernelMergeHost(flush_threshold=10**9,
                                          device=cuda), traffic)
    torch.cuda.synchronize()
    assert mtbc.launches > before[0] and mtc.launches > before[1]
    cpu = _serve_text(mh.KernelMergeHost(flush_threshold=10**9,
                                         device="cpu"), traffic)
    assert card.stats == cpu.stats
    assert card.stats["block_overflow_replays"] > 0
    assert sorted(card._merge_pools) == sorted(cpu._merge_pools)
    for slots, pool in cpu._merge_pools.items():
        _assert_equal(card._merge_pools[slots].state, pool.state, slots)
        assert card._merge_pools[slots].text.chunks == pool.text.chunks
    from fluidframework_tpu_torch.dds.mergetree import MergeEngine
    for key in cpu._merge_rows:
        assert card.text(*key) == cpu.text(*key)
        assert card.rich_text(*key) == cpu.rich_text(*key)
        engine = MergeEngine(local_client=None)
        for batch in traffic:
            for d, op, client, seq, ref in batch:
                if d == key.doc_id:
                    engine.apply_remote(op, seq, ref, client)
        assert card.text(*key) == engine.get_text()


def test_sharded_pool_on_the_card_ticks_with_kernel_4(cuda, monkeypatch):
    """A merge host with a virtual segment mesh of two shards of the card:
    documents migrate from block pools into its sequence-parallel pool,
    which ticks with kernel 4 (never the plain sharded program), and
    every pool, text and stat equals the same host on two CPU shards."""
    from fluidframework_tpu_torch.ops import mergetree_sharded as mts
    from fluidframework_tpu_torch.server import merge_host as mh

    def refuse(*args, **kw):
        raise AssertionError("the host ran the plain sharded tick")
    monkeypatch.setattr(mh._BlockMergePool, "BK", 16)
    monkeypatch.setattr(mts, "apply_tick_sharded", refuse)
    traffic = _bursty_text()
    mtc.shapes.clear()
    kw = dict(flush_threshold=10**9, merge_slots=32,
              sharded_slot_threshold=64)
    card = _serve_text(mh.KernelMergeHost(
        seg_mesh=mts.make_seg_mesh([cuda] * 2), device=cuda, **kw), traffic)
    torch.cuda.synchronize()
    cpu = _serve_text(mh.KernelMergeHost(
        seg_mesh=mts.make_seg_mesh(["cpu"] * 2), device="cpu", **kw),
        traffic)
    assert card.stats == cpu.stats and card.stats["migrations"] > 0
    sharded = [p for p in card._merge_pools.values()
               if isinstance(p, mh._ShardedMergePool)]
    assert sharded
    assert any(shape[0] == p.capacity and shape[2] == p.slots
               for shape in mtc.shapes for p in sharded)
    assert sorted(card._merge_pools) == sorted(cpu._merge_pools)
    for slots, pool in cpu._merge_pools.items():
        _assert_equal(card._merge_pools[slots].state, pool.state, slots)
        assert card._merge_pools[slots].text.chunks == pool.text.chunks
    for key in cpu._merge_rows:
        assert card.text(*key) == cpu.text(*key)


def test_failed_flat_launch_leaves_flush(cuda, monkeypatch):
    """A kernel-4 launch that fails (its launcher returns cudaError 700)
    raises out of the text host's ``flush()``: the overflowing channel is
    not quarantined onto the host's scalar engine, which would serve it
    on the CPU unnoticed."""
    from fluidframework_tpu_torch.ops import _build
    from fluidframework_tpu_torch.server import merge_host as mh

    monkeypatch.setattr(mh._BlockMergePool, "BK", 16)
    monkeypatch.setattr(mtc, "_lib", lambda variant="global": (
        lambda *args: 700))
    host = mh.KernelMergeHost(flush_threshold=10**9, device=cuda)
    before = mtc.launches
    with pytest.raises(_build.KernelError, match="cudaError 700"):
        _serve_text(host, _bursty_text())
    assert mtc.launches == before
    assert host.stats["quarantined_channels"] == 0
    assert host.stats["block_overflow_replays"] == 0
    assert all(r.scalar is None for r in host._merge_rows.values())


# -- the matrix ticks -----------------------------------------------------------


def _matrix_stream(rng, n_ops, clients, lag, seq0=0, rows=0, cols=0,
                   handles=(0, 0)):
    """One document's sequenced matrix ops in the mix of the reference's
    matrix benchmark (70% cells, 10% row inserts, 10% col inserts, 5% row
    and 5% col removes), each at a ref up to ``lag`` seqs back (so some
    cells resolve in a stale frame and some positions fall outside it)."""
    ops, (next_rh, next_ch) = [], handles
    for seq in range(seq0 + 1, seq0 + n_ops + 1):
        base = dict(seq=seq, ref_seq=max(seq0, seq - int(rng.integers(1,
                                                                 lag + 1))),
                    client=int(rng.integers(0, clients)))
        r = rng.random()
        if rows and cols and r < 0.7:
            ops.append(dict(base, target=mxk.MX_CELL,
                            row=int(rng.integers(0, rows + 1)),
                            col=int(rng.integers(0, cols)),
                            value=int(rng.integers(1, 1000))))
        elif r < 0.8 or not rows:
            n = int(rng.integers(1, 3))
            ops.append(dict(base, target=mxk.MX_ROWS, kind=mtk.MT_INSERT,
                            pos=int(rng.integers(0, rows + 1)), count=n,
                            handle_base=next_rh))
            next_rh, rows = next_rh + n, rows + n
        elif r < 0.9 or not cols:
            n = int(rng.integers(1, 3))
            ops.append(dict(base, target=mxk.MX_COLS, kind=mtk.MT_INSERT,
                            pos=int(rng.integers(0, cols + 1)), count=n,
                            handle_base=next_ch))
            next_ch, cols = next_ch + n, cols + n
        else:
            axis = mxk.MX_ROWS if r < 0.95 else mxk.MX_COLS
            size = rows if axis == mxk.MX_ROWS else cols
            if size < 3:
                continue
            pos = int(rng.integers(0, size - 1))
            ops.append(dict(base, target=axis, kind=mtk.MT_REMOVE, pos=pos,
                            end=pos + 1))
            rows, cols = (rows - 1, cols) if axis == mxk.MX_ROWS \
                else (rows, cols - 1)
    return ops


def _matrix_to(state, device):
    return mxk.MatrixState(_to(state.rows, device), _to(state.cols, device),
                           *(t.to(device) for t in state[2:]))


def _assert_matrix_equal(got, want, where=""):
    _assert_equal(got.rows, want.rows, (where, "rows"))
    _assert_equal(got.cols, want.cols, (where, "cols"))
    for f, a, b in zip(mxk.MatrixState._fields[2:], got[2:], want[2:]):
        assert a.dtype == b.dtype, (where, f)
        assert torch.equal(a.cpu(), b.cpu()), (where, f)


@pytest.mark.parametrize("b,s,c,k,w,ticks,variant", [
    (*shape, variant) for shape in [
        (1, 8, 4, 1, 1, 1), (5, 64, 64, 16, 1, 3), (16, 100, 128, 32, 4, 3),
        (24, 256, 1024, 32, 8, 3), (9, 128, 16, 40, 2, 2),
        (3, 4096, 64, 24, 1, 2)]
    for variant in (None, "smem", "global")
    if not (shape[1] == 4096 and variant == "smem")])
def test_matrix_tick_kernel_matches_plain(cuda, b, s, c, k, w, ticks,
                                          variant):
    """Kernel 5 == its plain version tick by tick: concurrent refs, up to
    256 writers (W = 8, overlap bits in the sign bit), removes; at the
    matrix host's batched shape (S = 100, C = 128, W = 4) and at full size;
    in the variant the shape picks (shared memory, except S = 4,096, which
    does not fit) and in each one that fits. The C = 16 case fills the cell
    log (the write clamps at C - 1 while the count passes C)."""
    fits = mxc.tick_variant(s, 1, w, c, k, mxc.smem_limit(cuda)) == "smem"
    assert fits == (s < 4096)
    picked = variant or ("smem" if fits else "global")
    rng = np.random.default_rng(b * 17 + s + c + k)
    streams = [_matrix_stream(rng, k * ticks, 32 * w, 4) for _ in range(b)]
    want = mxk.init_state(b, s, c, w, device="cpu")
    got = _matrix_to(want, cuda)
    for t in range(ticks):
        chunk = [x[t * k:(t + 1) * k] for x in streams]
        want = mxk.apply_tick(want, mxk.make_matrix_op_batch(chunk, b, k,
                                                             device="cpu"))
        before = mxc.tick.launches, mxc.tick.variants.get(picked, 0)
        got = mxc.apply_tick_best(got, mxk.make_matrix_op_batch(
            chunk, b, k, device=cuda), variant)
        torch.cuda.synchronize()
        assert mxc.tick.launches == before[0] + 1
        assert mxc.tick.variants[picked] == before[1] + 1
        _assert_matrix_equal(got, want, (b, s, c, k, t))
    if c == 16:
        assert int(want.cell_count.max()) > c


def _wild_ops(rng, b, k, w, vec_p):
    """A matrix op batch of random planes: a ``vec_p`` share of row and
    col ops of every kind (insert, remove, annotate) at random positions,
    cell ops at rows and cols from -1 to past the axes, a few ops with a
    target that is none of rows, cols or cell, 15% invalid ops, refs and
    clients at random (overlap bits past W words too)."""
    r = rng.random((b, k))
    target = np.where(r < vec_p, rng.integers(0, 2, (b, k)),
                      np.where(r < 0.95, mxk.MX_CELL, 3))
    pos = rng.integers(-1, 12, (b, k))
    planes = {"valid": rng.random((b, k)) < 0.85, "target": target,
              "kind": rng.integers(0, 3, (b, k)), "pos": pos,
              "end": pos + rng.integers(0, 4, (b, k)),
              "count": rng.integers(0, 4, (b, k)),
              "handle_base": rng.integers(0, 500, (b, k)),
              "row": rng.integers(-1, 14, (b, k)),
              "col": rng.integers(-1, 14, (b, k)),
              "value": rng.integers(1, 99, (b, k)),
              "seq": 41 + np.arange(k)[None].repeat(b, 0),
              "ref_seq": rng.integers(0, 45, (b, k)),
              "client": rng.integers(0, 32 * w + 4, (b, k))}
    return mxk.MatrixOpBatch(**{
        f: torch.from_numpy(np.ascontiguousarray(
            v if f == "valid" else v.astype(np.int32)))
        for f, v in planes.items()})


@pytest.mark.parametrize("variant", ["smem", "global"])
@pytest.mark.parametrize("b,s,c,w,k,vec_p", [
    (32, 40, 24, 1, 30, 0.15), (8, 256, 256, 2, 64, 0.15),
    (16, 100, 16, 2, 200, 0.03), (12, 33, 8, 1, 40, 0.5)])
def test_matrix_tick_kernel_on_wild_frames(cuda, b, s, c, w, k, vec_p,
                                          variant):
    """Kernel 5 == its plain version, both variants, on random planes
    whose frames wrap (every other document) and on small ones, cell logs
    with duplicate keys, unused entries and counts from -3 (appends at a
    negative index are dropped) to past C (they clamp at C - 1), and op
    lists whose cell stretches run long (200 ops, 3% vector ops) or are
    broken by every vector-op kind, invalid ops and other targets."""
    rng = np.random.default_rng(b + s + c + k)
    state, _ = _wild_matrix(rng, b, s, c, w, 1, 1)
    state = state._replace(cell_count=torch.from_numpy(
        rng.integers(-3, c + 3, b).astype(np.int32)))
    ops = _wild_ops(rng, b, k, w, vec_p)
    want = mxk.apply_tick(state, ops)
    got = mxc.apply_tick_best(_matrix_to(state, cuda), mxk.MatrixOpBatch(
        *(f.to(cuda) for f in ops)), variant)
    torch.cuda.synchronize()
    _assert_matrix_equal(got, want, (b, s, c, k, variant))


@pytest.mark.parametrize("variant", ["smem", "global"])
@pytest.mark.parametrize("count", [-1, -2])
def test_matrix_tick_kernel_drops_appends_at_negative_counts(cuda, count,
                                                            variant):
    """At a negative cell count a new key's append lands at
    min(count, C - 1) < 0 and is dropped, while the count still grows: the
    plain version's rule (and the JAX Pallas kernels'), in both
    variants."""
    layout = [dict(target=mxk.MX_ROWS, kind=mtk.MT_INSERT, pos=0, count=8,
                   handle_base=0, seq=1, ref_seq=0, client=0),
              dict(target=mxk.MX_COLS, kind=mtk.MT_INSERT, pos=0, count=8,
                   handle_base=0, seq=2, ref_seq=1, client=0)]
    state = mxk.apply_tick(mxk.init_state(2, 16, 8, 1, device="cpu"),
                           mxk.make_matrix_op_batch([layout] * 2, 2, 2,
                                                    device="cpu"))
    state = state._replace(cell_count=torch.tensor([count, 0],
                                                   dtype=torch.int32))
    cells = [[dict(target=mxk.MX_CELL, row=i, col=i, value=5 + i, seq=3 + i,
                   ref_seq=2, client=1) for i in range(3)]] * 2
    ops = mxk.make_matrix_op_batch(cells, 2, 3, device="cpu")
    want = mxk.apply_tick(state, ops)
    assert int(want.cell_used[0].sum()) == 3 + count
    assert want.cell_count.tolist() == [count + 3, 3]
    got = mxc.apply_tick_best(_matrix_to(state, cuda), mxk.MatrixOpBatch(
        *(f.to(cuda) for f in ops)), variant)
    torch.cuda.synchronize()
    _assert_matrix_equal(got, want, (count, variant))


@pytest.mark.parametrize("variant", [None, "global"])
@pytest.mark.parametrize("b,s,c,k,r,w,ticks", [
    (1, 8, 8, 2, 1, 1, 1), (6, 64, 64, 24, 4, 1, 3),
    (20, 256, 256, 64, 8, 8, 3), (9, 128, 16, 40, 8, 2, 2),
    (3, 4096, 64, 24, 4, 1, 2)])
def test_matrix_steps_kernel_matches_plain(cuda, b, s, c, k, r, w, ticks,
                                           variant):
    """Kernel 6 == its plain version tick by tick in the step layout
    (last_vec_seq carried across ticks, stale-ref cells alone in their
    runs), and both equal the op tick on the same flat stream; in the
    variant the shape picks (shared memory, except S = 4,096, which does
    not fit) and in the global-memory one. The C = 16 case fills the cell
    log: the write clamps at C - 1 while the count passes C."""
    rng = np.random.default_rng(b * 5 + s + k + r)
    streams = [_matrix_stream(rng, k * ticks, 32 * w, 3) for _ in range(b)]
    want = mxk.init_state(b, s, c, w, device="cpu")
    got = _matrix_to(want, cuda)
    flat = _matrix_to(want, cuda)
    lvs = [0] * b
    picked = variant or mxc.steps_variant(s, 1, w, c, r,
                                          mxc.smem_limit(cuda))
    assert picked == ("global" if s > 2048 else "smem") or variant
    for t in range(ticks):
        chunk = [x[t * k:(t + 1) * k] for x in streams]
        steps = mxk.make_matrix_step_batch(chunk, b, r, list(lvs), "cpu")
        want = mxk.apply_tick_steps(want, steps)
        before = mxc.steps.launches, mxc.steps.variants.get(picked, 0)
        got = mxc.apply_tick_steps_best(got, mxk.MatrixStepBatch(
            *(f.to(cuda) for f in steps)), variant)
        flat = mxc.apply_tick_best(flat, mxk.make_matrix_op_batch(
            chunk, b, k, device=cuda))
        torch.cuda.synchronize()
        assert mxc.steps.launches == before[0] + 1
        assert mxc.steps.variants[picked] == before[1] + 1
        _assert_matrix_equal(got, want, (b, s, c, k, t))
        _assert_matrix_equal(flat, want, (b, s, c, k, t, "flat"))
        for d, ops in enumerate(chunk):
            for op in ops:
                if op["target"] != mxk.MX_CELL:
                    lvs[d] = max(lvs[d], op["seq"])
    if c == 16:
        assert int(want.cell_count.max()) > c


def _wild_matrix(rng, b, s, c, w, t, r):
    """(state, steps) of random matrix planes: in every other document
    lengths near 2**30 or negative, so a frame's prefix wraps or falls
    (the lookups' linear pass); elsewhere small lengths (the binary
    search); cell logs with duplicate keys, unused entries and counts
    from 0 to past C; random vector ops, runs and frames."""
    def axis():
        wild = (np.arange(b) % 2 == 1)[:, None]
        big = rng.integers(-3, 2**30 + 9, (b, s))
        rem = rng.random((b, s)) < 0.3
        over = rng.integers(-2**31, 2**31, (b, s, w), dtype=np.int64)
        planes = {
            "valid": rng.random((b, s)) < 0.8,
            "length": np.where(wild & (rng.random((b, s)) < 0.5), big,
                               rng.integers(0, 4, (b, s))),
            "ins_seq": rng.integers(0, 40, (b, s)),
            "ins_client": rng.integers(0, 6, (b, s)),
            "rem_seq": np.where(rem, rng.integers(0, 40, (b, s)),
                                int(mtk.NONE_SEQ)),
            "rem_client": np.where(rem, rng.integers(0, 6, (b, s)), -1),
            "rem_overlap": np.where(rng.random((b, s, w)) < 0.2, over, 0),
            "pool_start": rng.integers(0, 500, (b, s)),
            "prop_val": rng.integers(0, 3, (b, s, 1)),
            "count": rng.integers(0, s + 1, b)}
        return mtk.MergeState(**{
            f: torch.from_numpy(np.ascontiguousarray(
                v if f == "valid" else v.astype(np.int32)))
            for f, v in planes.items()})
    cells = {"cell_rh": rng.integers(-1, 12, (b, c)),
             "cell_ch": rng.integers(-1, 12, (b, c)),
             "cell_val": rng.integers(0, 99, (b, c)),
             "cell_seq": rng.integers(0, 40, (b, c)),
             "cell_used": rng.random((b, c)) < 0.5,
             "cell_count": rng.integers(0, c + 3, b)}
    state = mxk.MatrixState(axis(), axis(), **{
        f: torch.from_numpy(np.ascontiguousarray(
            v if f == "cell_used" else v.astype(np.int32)))
        for f, v in cells.items()})
    pos = rng.integers(-1, 12, (b, t))
    vec = {"vec_valid": rng.random((b, t)) < 0.5,
           "kind": rng.integers(0, 2, (b, t)),
           "target": rng.integers(0, 3, (b, t)), "pos": pos,
           "end": pos + rng.integers(0, 4, (b, t)),
           "count": rng.integers(1, 4, (b, t)),
           "handle_base": rng.integers(0, 500, (b, t)),
           "seq": 41 + np.arange(t)[None].repeat(b, 0),
           "ref_seq": rng.integers(0, 45, (b, t)),
           "client": rng.integers(0, 32 * w + 4, (b, t)),
           "run_ref": rng.integers(0, 45, (b, t)),
           "run_client": rng.integers(0, 6, (b, t)),
           "r_valid": rng.random((b, t, r)) < 0.6,
           "r_row": rng.integers(-1, 14, (b, t, r)),
           "r_col": rng.integers(-1, 14, (b, t, r)),
           "r_value": rng.integers(1, 99, (b, t, r)),
           "r_seq": rng.integers(41, 99, (b, t, r))}
    steps = mxk.MatrixStepBatch(**{
        f: torch.from_numpy(np.ascontiguousarray(
            v if f in ("vec_valid", "r_valid") else v.astype(np.int32)))
        for f, v in vec.items()})
    return state, steps


@pytest.mark.parametrize("variant", ["smem", "global"])
@pytest.mark.parametrize("b,s,c,w,t,r", [(32, 40, 24, 1, 12, 4),
                                        (8, 256, 256, 2, 20, 8)])
def test_matrix_steps_kernel_on_wild_frames(cuda, b, s, c, w, t, r,
                                           variant):
    """Kernel 6 == its plain version, both variants, on random planes
    whose frames wrap (the lookups' linear pass), on small ones (the
    binary search), and on cell logs with duplicates and odd counts."""
    state, steps = _wild_matrix(np.random.default_rng(b + s + c + t), b, s,
                                c, w, t, r)
    want = mxk.apply_tick_steps(state, steps)
    got = mxc.apply_tick_steps_best(_matrix_to(state, cuda),
                                    mxk.MatrixStepBatch(
                                        *(f.to(cuda) for f in steps)),
                                    variant)
    torch.cuda.synchronize()
    _assert_matrix_equal(got, want, (b, s, c, variant))


def test_matrix_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """Non-contiguous, wrongly typed or misplaced tensors raise
    KernelInputError (a ValueError) before any launch."""
    from fluidframework_tpu_torch.ops import _build

    state = mxk.init_state(2, 8, 8, 1, cuda)
    ops = mxk.make_matrix_op_batch([[], []], 2, 4, device=cuda)
    steps = mxk.make_matrix_step_batch([[], []], 2, 2, device=cuda)
    cases = [
        (mxc.apply_tick_best, state,
         ops._replace(row=ops.row.t().contiguous().t()), "op row"),
        (mxc.apply_tick_best, state, ops._replace(value=ops.value.long()),
         "op value"),
        (mxc.apply_tick_best, state._replace(cell_rh=state.cell_rh.cpu()),
         ops, "cell_rh"),
        (mxc.apply_tick_best, state._replace(
            rows=state.rows._replace(valid=state.rows.valid.int())), ops,
         "rows.valid"),
        (mxc.apply_tick_steps_best, state,
         steps._replace(r_valid=steps.r_valid.int()), "step r_valid"),
        (mxc.apply_tick_steps_best, state._replace(
            cols=state.cols._replace(
                rem_overlap=state.cols.rem_overlap.transpose(1, 2))),
         steps, "cols.rem_overlap")]
    before = (mxc.tick.launches, mxc.steps.launches)
    for fn, st, batch, what in cases:
        with pytest.raises(_build.KernelInputError, match=what):
            fn(st, batch)
    # A variant that does not exist, and a document forced into shared
    # memory it does not fit (S = 4,096), are refused, not launched.
    with pytest.raises(_build.KernelInputError, match="no variant"):
        mxc.apply_tick_best(state, ops, "warp")
    large = mxk.init_state(2, 4096, 64, 1, cuda)
    assert mxc.tick_variant(4096, 1, 1, 64, 4, mxc.smem_limit(cuda)) \
        == "global"
    with pytest.raises(_build.KernelInputError, match="shared memory"):
        mxc.apply_tick_best(large, ops, "smem")
    assert (mxc.tick.launches, mxc.steps.launches) == before


def _matrix_rounds(rng, docs, rounds, writers):
    """Rounds of concurrent SharedMatrix ops at each doc's head ref: the
    first lays out an 8 x 8 grid, then cell writes, with row/col inserts
    and removes every other round."""
    out, seq, size = [], {d: 0 for d in docs}, {d: [0, 0] for d in docs}
    for n_round in range(rounds):
        out.append([])
        for d in docs:
            ref = seq[d]
            ops = []
            if n_round == 0:
                ops = [{"type": "insert", "target": axis, "pos": 0,
                        "count": 8} for axis in ("rows", "cols")]
                size[d] = [8, 8]
            else:
                for _ in range(int(rng.integers(4, 20))):
                    if n_round % 2 and rng.random() < 0.3:
                        axis = int(rng.integers(0, 2))
                        if rng.random() < 0.5 and size[d][axis] > 4:
                            ops.append({"type": "remove",
                                        "target": ("rows", "cols")[axis],
                                        "start": 1, "end": 2})
                        else:
                            ops.append({"type": "insert",
                                        "target": ("rows", "cols")[axis],
                                        "pos": 0, "count": 2})
                    else:
                        ops.append({"type": "set", "target": "cell",
                                    "row": int(rng.integers(0, 4)),
                                    "col": int(rng.integers(0, 4)),
                                    "value": int(rng.integers(0, 99))})
            for op in ops:
                seq[d] += 1
                out[-1].append((d, op, f"w{rng.integers(0, writers)}",
                                seq[d], ref if n_round else seq[d] - 1))
    return out


def _serve_matrix(host, traffic):
    from fluidframework_tpu_torch.protocol.messages import (
        MessageType,
        SequencedDocumentMessage,
    )
    for batch in traffic:
        for d, op, client, seq, ref in batch:
            host.ingest(d, SequencedDocumentMessage(
                client_id=client, sequence_number=seq,
                minimum_sequence_number=max(0, ref - 40),
                client_sequence_number=seq, reference_sequence_number=ref,
                type=MessageType.OPERATION,
                contents={"address": "ds", "contents": {
                    "address": "grid", "contents": op}}))
        host.flush()
    return host


def test_matrix_host_on_the_card_matches_the_cpu(cuda):
    """The port's merge host serving SharedMatrix traffic on the card
    (kernel 5 for the flushes with structural ops, the cell-run append
    for the rest) against the same host on the CPU: equal planes, stats,
    grids and exports."""
    from fluidframework_tpu_torch.server import merge_host as mh

    traffic = _matrix_rounds(np.random.default_rng(12),
                             [f"doc{i}" for i in range(10)], 7, 70)
    before = mxc.tick.launches
    card = _serve_matrix(mh.KernelMergeHost(flush_threshold=10**9,
                                            device=cuda), traffic)
    torch.cuda.synchronize()
    assert mxc.tick.launches > before
    cpu = _serve_matrix(mh.KernelMergeHost(flush_threshold=10**9,
                                           device="cpu"), traffic)
    assert card.stats == cpu.stats and card.stats["cell_run_ticks"] > 0
    _assert_matrix_equal(card._matrix_state, cpu._matrix_state)
    for key in cpu._matrix_rows:
        assert card.matrix_grid(*key) == cpu.matrix_grid(*key)
    assert card.export_state() == cpu.export_state()


def test_failed_matrix_launch_leaves_flush(cuda, monkeypatch):
    """A kernel-5 launch that fails (its launcher returns cudaError 700)
    raises out of the host's ``flush()``; nothing moves to the scalar
    vectors."""
    from fluidframework_tpu_torch.ops import _build
    from fluidframework_tpu_torch.server import merge_host as mh

    monkeypatch.setattr(_build, "bind", lambda *a: (lambda *args: 700))
    host = mh.KernelMergeHost(flush_threshold=10**9, device=cuda)
    before = mxc.tick.launches
    with pytest.raises(_build.KernelError, match="cudaError 700"):
        _serve_matrix(host, _matrix_rounds(np.random.default_rng(2),
                                           ["doc0"], 1, 4))
    assert mxc.tick.launches == before
    assert all(r.scalar is None for r in host._matrix_rows.values())


# -- the tree tick (plain PyTorch on either device) -----------------------------


def _tree_ops(rng, b, n, k):
    """Seeded tree ops of every kind, anchors anywhere in [-2, n + 2)."""
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    per_doc = []
    for _ in range(b):
        count = int(rng.integers(0, k + 1))
        per_doc.append([dict(kind=int(rng.integers(0, 12)),
                             node=int(rng.integers(-2, n + 2)),
                             parent=int(rng.integers(-2, n + 2)),
                             trait=int(rng.integers(0, 3)),
                             payload=int(rng.integers(0, 5)))
                        for _ in range(count)])
    # Chains so detaches and moves sweep deep subtrees.
    for d in range(0, b, 3):
        per_doc[d] = [dict(kind=tk.TREE_INSERT, node=i, parent=i - 1)
                      for i in range(1, k)] + [dict(kind=tk.TREE_DETACH,
                                                    node=1)]
    return per_doc


@pytest.mark.parametrize("b,n,k", [(5, 32, 32), (64, 64, 40)])
def test_tree_tick_on_the_card_matches_the_cpu(cuda, b, n, k):
    """The tree tick on CUDA tensors against the same call on CPU
    tensors, tick after tick: every plane, ``applied`` and ``overflow``
    equal."""
    from fluidframework_tpu_torch.ops import tree_kernel as tk

    rng = np.random.default_rng(3)
    card = tk.init_state(b, n, cuda)
    cpu = tk.init_state(b, n, "cpu")
    for _tick in range(4):
        per_doc = _tree_ops(rng, b, n, k)
        steps = tk.subtree_steps(per_doc, k)
        card, card_out = tk.apply_tick(
            card, tk.make_tree_op_batch(per_doc, b, k, cuda), steps)
        cpu, cpu_out = tk.apply_tick(
            cpu, tk.make_tree_op_batch(per_doc, b, k, "cpu"), steps)
        assert card.exists.device.type == "cuda"
        _assert_equal(card, cpu, "state")
        _assert_equal(card_out, cpu_out, "out")


# -- the multi-device tier --------------------------------------------------------


def _multihost():
    """``tests/test_torch_multihost.py`` (its seeded mixed script and
    serving settings), loaded by path: this file runs without the suite's
    package layout on a machine with a card."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).with_name("test_torch_multihost.py")
    spec = importlib.util.spec_from_file_location("torch_multihost_script",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mixed_states(n, device):
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.protocol.messages import MessageType
    mh = _multihost()
    sh, w = mh.SHAPE, mtk.overlap_words_for(mh.CLIENTS)
    CLIENTS = mh.CLIENTS
    seq = seqk.init_state(n, CLIENTS + 1, device)
    seq = seqk.process_batch(seq, seqk.make_op_batch(
        [[dict(kind=int(MessageType.CLIENT_JOIN), slot=-1, target=c,
               timestamp=1) for c in range(CLIENTS)] for _ in range(n)],
        n, CLIENTS, device))[0]
    return [seq, mk.init_state(n, sh["map_slots"], device),
            mtb.init_state(n, sh["text_blocks"], sh["text_bk"], 4, w,
                           device),
            mxk.init_state(n, sh["vec_slots"], sh["cell_slots"], w, device),
            tk.init_state(n, sh["tree_slots"], device)]


def test_mixed_tick_kernels_match_plain(cuda, monkeypatch):
    """The all-family mixed tick on the card — kernel 1 (map leg), kernel
    3 (text leg), kernel 5 (matrix leg) — against the same tick with every
    kernel's plain version on the card and on the CPU, tick after tick:
    all 12 outputs equal, and each kernel launched."""
    from fluidframework_tpu_torch.server import storm
    Script = _multihost().Script
    fams = [("map", "text", "matrix", "tree")[r % 4] for r in range(16)]
    script = Script(fams, 7)
    runs = {"kernel": (_mixed_states(16, cuda), cuda),
            "plain": (_mixed_states(16, cuda), cuda),
            "cpu": (_mixed_states(16, "cpu"), torch.device("cpu"))}
    plain = dict(
        mfc=type("P", (), {"fold_words": staticmethod(mk.fold_words_plain)}),
        mtbc=type("P", (), {"apply_tick_blocks_best": staticmethod(
            mtb.apply_tick_blocks)}),
        mxc=type("P", (), {"apply_tick_best": staticmethod(
            mxk.apply_tick)}))
    mfc.launches = 0
    mtbc.launches = 0
    mxc.tick.reset()
    for t in range(6):
        scalars, words, packs, _subs = script.tick(
            t, "resend" if t == 3 else "fresh")
        outs = {}
        for name, (states, dev) in runs.items():
            with monkeypatch.context() as m:
                if name == "plain":
                    for attr, mod in plain.items():
                        m.setattr(storm, attr, mod)
                out = storm._mixed_tick(
                    *states, torch.from_numpy(scalars).to(dev),
                    torch.from_numpy(words.view(np.int32)).to(dev),
                    *(torch.from_numpy(packs[f]).to(dev)
                      for f in ("text", "matrix", "tree")))
            runs[name] = (list(out[:5]), dev)
            outs[name] = out
        for name in ("plain", "cpu"):
            for i, (a, b) in enumerate(zip(outs["kernel"], outs[name])):
                for x, y in zip(_flat(a), _flat(b)):
                    assert torch.equal(x.cpu(), y.cpu()), (t, name, i)
        if t != 3:
            script.ack(outs["kernel"][7].cpu().numpy())
    assert mfc.launches == mtbc.launches == mxc.tick.launches == 6


def _flat(x):
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for part in x for t in _flat(part)]


@pytest.mark.parametrize("shards", [2, 4])
def test_stacked_sharded_tick_matches_kernel_4(cuda, shards):
    """The sequence-parallel tick on a virtual mesh of shards of the card
    against kernel 4 (the flat merge tick) and the plain flat tick, tick
    after tick: every plane equal."""
    from fluidframework_tpu_torch.ops import mergetree_sharded as mts
    rng = np.random.default_rng(11)
    mesh = mts.make_seg_mesh([cuda] * shards)
    b, s, k, p, w = 2, 256, 8, 4, 1
    sharded = kern = flat = mtk.init_state(b, s, p, w, cuda)
    for fields in _merge_ticks(rng, b, k, 6, 8):
        ops = _batch(fields, cuda)
        sharded = mts.apply_tick_sharded(sharded, ops, mesh)
        kern = mtc.apply_tick_best(kern, ops)
        flat = mtk.apply_tick(flat, ops)
        _assert_equal(sharded, flat, "sharded")
        _assert_equal(kern, flat, "kernel 4")


def test_sharded_serving_on_the_card_matches_the_cpu(cuda):
    """ShardedServing on a virtual mesh of two shards of the card against
    the same submissions on two CPU shards: every harvest and every plane
    equal (kernels 1, 2, 3 and 5 on the card)."""
    from fluidframework_tpu_torch.parallel.mesh import make_mesh
    from fluidframework_tpu_torch.parallel.serving import ShardedServing
    mh = _multihost()
    MIXED, Script, submit_script = mh.MIXED, mh.Script, mh.submit_script
    fams = [("map", "text", "matrix", "tree")[r % 4] for r in range(16)]
    sides = {dev: ShardedServing(make_mesh([dev] * 2), pipeline_depth=2,
                                 **MIXED)
             for dev in ("cuda", "cpu")}
    for s in sides.values():
        s.join_all(slots=(0, 1))
    script = Script(fams, 5)
    for t in range(5):
        subs = script.tick(t)[3]
        harvests = []
        for s in sides.values():
            submit_script(s, subs)
            harvests.append(s.tick())
        assert harvests[0] == harvests[1], t
    assert sides["cuda"].flush() == sides["cpu"].flush()
    for name in sides["cpu"]._family_states():
        for x, y in zip(_flat_np(sides["cuda"].family_rows(name)),
                        _flat_np(sides["cpu"].family_rows(name))):
            assert np.array_equal(x, y), name


def _flat_np(x):
    if isinstance(x, np.ndarray):
        return [x]
    return [t for part in x for t in _flat_np(part)]


def _plane_stack(device, root, num_docs, **res_kw):
    """A durable storm stack of the port on ``device`` over ``root``."""
    import itertools as it

    from fluidframework_tpu_torch.server.durable_store import (
        DurableMessageBus, FileStateStore, GitSnapshotStore)
    from fluidframework_tpu_torch.server.kernel_host import \
        KernelSequencerHost
    from fluidframework_tpu_torch.server.merge_host import KernelMergeHost
    from fluidframework_tpu_torch.server.routerlicious import \
        RouterliciousService
    from fluidframework_tpu_torch.server.storm import StormController
    seq = KernelSequencerHost(num_slots=4, initial_capacity=num_docs,
                              device=device)
    mh = KernelMergeHost(flush_threshold=10**9, device=device)
    svc = RouterliciousService(
        bus=DurableMessageBus(str(root / "bus")),
        store=FileStateStore(str(root / "state")),
        merge_host=mh, batched_deli_host=seq, auto_pump=False,
        idle_check_interval=10**9)
    svc._clock = it.count(1000, 7).__next__
    storm = StormController(svc, seq, mh, flush_threshold_docs=10**9,
                            spill_dir=str(root / "spill"),
                            durability="group",
                            snapshots=GitSnapshotStore(root / "git"))
    return svc, storm, seq, mh


def _plane_words(seed, k, clears=True):
    rng = np.random.default_rng(seed)
    kinds = rng.choice([0, 0, 0, 1, 2] if clears else [0, 0, 0, 1],
                       size=k).astype(np.uint32)
    slots = rng.integers(0, 16, k).astype(np.uint32)
    vals = rng.integers(0, 1 << 20, k).astype(np.uint32)
    return kinds | (slots << 2) | (vals << 12)


def test_residency_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Hydrate and evict on the card (pool of 2 over 5 docs: every frame
    evicts and hydrates) against the same frames on the CPU: acks, cold
    snapshot handles, stats and every doc's digest equal; then each
    side recovers its directories and still agrees."""
    from fluidframework_tpu_torch.server.residency import ResidencyManager
    from fluidframework_tpu_torch.tools.chaos import _digest
    docs = [f"d{i}" for i in range(5)]
    out = {}
    for dev in ("cuda", "cpu"):
        root = tmp_path / dev
        svc, storm, seq, mh = _plane_stack(dev, root, 2)
        res = ResidencyManager(storm, max_resident=2, idle_evict_s=1e9,
                               hydration_rate_per_s=1e9)
        clients = {d: svc.connect(d, lambda m: None).client_id
                   for d in docs}
        svc.pump()
        storm.checkpoint()
        acks, handles = [], []
        for r in range(4):
            for i, d in enumerate(docs):
                storm.submit_frame(acks.append, {
                    "rid": r * 10 + i,
                    "docs": [[d, clients[d], 1 + r * 8, 1, 8]]},
                    memoryview(_plane_words((r, i), 8).tobytes()))
                storm.flush()
            handles.append(res.cold_handle(docs[0]))
        rec = {"acks": [(a["rid"], np.asarray(a.rows).tolist())
                        for a in acks],
               "handles": handles, "stats": dict(res.stats),
               "reads": mh.map_row_reads,
               "digest": _digest(svc, storm, seq, mh, docs, residency=res)}
        storm._group_wal.close()
        svc2, storm2, seq2, mh2 = _plane_stack(dev, root, 2)
        res2 = ResidencyManager(storm2, max_resident=2, idle_evict_s=1e9,
                                hydration_rate_per_s=1e9)
        storm2.recover()
        rec["recovered"] = _digest(svc2, storm2, seq2, mh2, docs,
                                   residency=res2)
        storm2._group_wal.close()
        out[dev] = rec
    assert out["cuda"] == out["cpu"]
    assert out["cuda"]["stats"]["evictions"] > 10
    assert 0 < out["cuda"]["reads"] <= out["cuda"]["stats"]["evictions"]
    assert out["cuda"]["recovered"] == out["cuda"]["digest"]


def test_megadoc_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Promote → serve → demote → re-promote on the card (4 lanes, 8
    writers, the text row moved into a virtual 4-shard sequence-parallel
    pool of the card and back) against the CPU: acks, combiner state,
    converged map, text, planes and the recovered lifecycle equal."""
    from fluidframework_tpu_torch.ops.mergetree_sharded import make_seg_mesh
    from fluidframework_tpu_torch.protocol.messages import (
        DocumentMessage, MessageType)
    from fluidframework_tpu_torch.server.megadoc import MegaDocManager
    out = {}
    for dev in ("cuda", "cpu"):
        root = tmp_path / dev
        svc, storm, seq, mh = _plane_stack(dev, root, 2)
        mh.seg_mesh = make_seg_mesh([dev] * 4)
        mgr = MegaDocManager(storm, default_lanes=4)
        conns = [svc.connect("mega", lambda m: None) for _ in range(8)]
        svc.pump()
        conns[0].submit([DocumentMessage(
            client_sequence_number=1, reference_sequence_number=8,
            type=MessageType.OPERATION,
            contents={"address": "default", "contents": {
                "address": "text",
                "contents": {"type": "insert", "pos": 0,
                             "text": "mega-doc"}}})])
        svc.pump()
        mh.flush()
        storm.checkpoint()  # the recovery's restore source
        acks = []
        rec = {}
        for cycle in range(2):
            mgr.promote("mega")
            rec[f"text_pool_{cycle}"] = [
                type(mh._merge_rows[k].pool).__name__
                for k in sorted(mh._merge_rows)]
            for r in range(3):
                for w, c in enumerate(conns):
                    rr = cycle * 3 + r
                    storm.submit_frame(acks.append, {
                        "rid": f"{rr}.{w}",
                        "docs": [["mega", c.client_id, 1 + rr * 8, -1, 8]]},
                        memoryview(_plane_words((rr, w), 8,
                                                clears=False).tobytes()))
                storm.flush()
            rec[f"entries_{cycle}"] = mgr.map_entries("mega")
            mgr.demote("mega")
        rec.update(
            acks=[(a["rid"], np.asarray(a.rows).tolist()) for a in acks],
            state=mgr.export_state(), stats=dict(mh.stats),
            text=mh.text("mega", "default", "text"),
            map=mh.map_entries("mega", "default", "root"),
            planes=[getattr(mh._xstate, f).cpu().numpy().tolist()
                    for f in mh._xstate._fields],
            reads=mh.map_row_reads)
        storm._group_wal.close()
        svc2, storm2, seq2, mh2 = _plane_stack(dev, root, 2)
        mh2.seg_mesh = make_seg_mesh([dev] * 4)
        mgr2 = MegaDocManager(storm2, default_lanes=4)
        storm2.recover()
        rec["recovered"] = (mgr2.export_state(),
                            mh2.map_entries("mega", "default", "root"))
        storm2._group_wal.close()
        out[dev] = rec
    assert out["cuda"] == out["cpu"]
    assert out["cuda"]["stats"]["megadoc_promotions"] == 2
    assert out["cuda"]["recovered"] == (out["cuda"]["state"],
                                        out["cuda"]["map"])
    assert out["cuda"]["map"] == out["cuda"]["entries_1"]
    assert out["cuda"]["map"] and out["cuda"]["text"] == "mega-doc"
    assert out["cuda"]["text_pool_0"] == ["_ShardedMergePool"]


def test_megadoc_lanes_on_the_card_match_the_cpu(cuda):
    """MegaDocLanes over a 4-shard virtual mesh of the card against 4 CPU
    shards: decisions, entries and the lane rows' planes equal."""
    from fluidframework_tpu_torch.parallel.mesh import make_mesh
    from fluidframework_tpu_torch.parallel.serving import (
        MegaDocLanes, ShardedServing)
    out = {}
    for dev in ("cuda", "cpu"):
        serving = ShardedServing(make_mesh([dev] * 4), num_docs=64, k=8,
                                 num_hosts=1, num_clients=16, map_slots=16)
        serving.join_all(slots=list(range(16)))
        lanes = MegaDocLanes(serving, lane_rows=[1, 18, 35, 52])
        rng = np.random.default_rng(3)
        decs = []
        for r in range(4):
            for w in range(24):
                words = _plane_words((r, w), 8)
                cseq0 = 1 + r * 8 if rng.random() > 0.2 else 1 + r * 8 + 3
                dec = lanes.submit(f"w{w}", words, cseq0, ref_seq=1)
                decs.append((dec.n_seq, dec.first, dec.last, dec.msn))
            serving.flush()
        out[dev] = (decs, lanes.entries(),
                    serving.family_rows("map").vseq[[1, 18, 35, 52]]
                    .tolist())
    assert out["cuda"] == out["cpu"]


def test_history_fork_into_a_growing_pool_on_the_card(cuda, tmp_path):
    """History forks without residency on a pipelined storm whose map
    pool is full: each branch row is allocated past the capacity (the
    pool grows into new tensors on the card) and written in place. The
    branches' planes equal the fold's seed planes and the CPU run's,
    ``read_at`` at every seq equals the CPU run's, and at the head it
    equals the device row."""
    from fluidframework_tpu_torch.server.history import HistoryPlane

    docs = [f"d{i}" for i in range(4)]
    out = {}
    for dev in ("cuda", "cpu"):
        root = tmp_path / dev
        svc, storm, seq, mh = _plane_stack(dev, root, 4)
        storm.set_pipeline_depth(1)
        hist = HistoryPlane(storm)
        ids = {d: svc.connect(d, lambda m: None).client_id for d in docs}
        svc.pump()
        for r in range(4):
            for i, d in enumerate(docs):
                storm.submit_frame(None, {
                    "rid": (r, d), "docs": [[d, ids[d], 1 + r * 8, 1, 8]]},
                    memoryview(_plane_words((r, i), 8).tobytes()))
            storm.flush(force=False)
        cap0 = mh._map_capacity
        forks = [(docs[i % 4], 2 + (7 * i) % 31) for i in range(2 * cap0)]
        branches = [hist.fork(d, q, name=f"b{i}", writer=f"w{i}")
                    for i, (d, q) in enumerate(forks)]
        rec = {"grew": (cap0, mh._map_capacity)}
        for b, (d, q) in zip(branches, forks):
            state = hist._state_at(d, q)
            row = storm._storm_mrow(b).row
            want = state.planes(mh._xstate.present.shape[1])
            for f, w in zip(("present", "value", "vseq"), want):
                assert np.array_equal(
                    getattr(mh._xstate, f)[row].cpu().numpy(), w), (b, f)
        for r in range(2):
            for i, (b, (_d, q)) in enumerate(zip(branches, forks)):
                storm.submit_frame(None, {
                    "rid": (r, b),
                    "docs": [[b, f"w{i}", 1 + r * 8, q, 8]]},
                    memoryview(_plane_words((9, r, i), 8).tobytes()))
            storm.flush()
        for d in docs + branches:
            head = hist.head_seq(d)
            reads = [hist.read_at(d, q)["entries"] for q in range(head + 1)]
            assert reads[-1] == mh.map_entries(d, storm.datastore,
                                               storm.channel), d
            rec[d] = reads
        rec["planes"] = [getattr(mh._xstate, f).cpu().numpy().tolist()
                         for f in mh._xstate._fields]
        storm._group_wal.close()
        out[dev] = rec
    assert out["cuda"] == out["cpu"]
    assert out["cuda"]["grew"][1] > out["cuda"]["grew"][0]


def test_fleet_migration_and_promotion_on_the_card(cuda, tmp_path,
                                                   monkeypatch):
    """A 2-host cluster whose leader replicates to two followers, on the
    card: a live migration off the leader, then the leader fails over to
    a promoted follower that replays its WAL tail on the card. Every
    kernel-1 and kernel-2 call equals its plain version on the same
    inputs, and the cluster's digest equals the same run's on the CPU."""
    from fluidframework_tpu_torch.parallel.placement import (
        StormCluster, make_cluster_host)
    from fluidframework_tpu_torch.server.durable_store import \
        GitSnapshotStore
    from fluidframework_tpu_torch.server.replication import (
        ReplicatedHeadStore, make_replicated_host, promote)
    from fluidframework_tpu_torch.tools.chaos import _replication_digest

    fold, deli = mfc.fold_words, seqc.process_batch_best
    checked = {"map_fold": 0, "sequencer_tick": 0}

    def checked_fold(state, words, lo, hi, base_seq, variant=None):
        out = fold(state, words, lo, hi, base_seq, variant=variant)
        if words.is_cuda:
            _assert_equal(out, mk.fold_words_plain(state, words, lo, hi,
                                                   base_seq), "map fold")
            checked["map_fold"] += 1
        return out

    def checked_deli(state, ops, variant=None):
        new_state, tickets = deli(state, ops, variant)
        if ops.kind.is_cuda:
            want_state, want_tickets = seqk.process_batch(state, ops)
            _assert_equal(new_state, want_state, "deli state")
            _assert_equal(tickets, want_tickets, "deli tickets")
            checked["sequencer_tick"] += 1
        return new_state, tickets

    monkeypatch.setattr(mfc, "fold_words", checked_fold)
    monkeypatch.setattr(seqc, "process_batch_best", checked_deli)
    docs = [f"d{i}" for i in range(6)]

    def run(dev):
        root = tmp_path / dev
        git = GitSnapshotStore(root / "git")
        leader, plane = make_replicated_host(
            "hostA", str(root / "hostA"), git,
            [str(root / "f0"), str(root / "f1")], num_docs=4, device=dev)
        other = make_cluster_host("hostB", str(root / "hostB"), git,
                                  num_docs=4, device=dev)
        for storm in (leader, other):
            storm.service._clock = itertools.count(1000, 7).__next__
        cluster = StormCluster({"hostA": leader, "hostB": other},
                               ReplicatedHeadStore(git, plane))
        clients = {d: cluster.storm_for(d).service.connect(
            d, lambda m: None).client_id for d in docs}
        for storm in cluster.hosts.values():
            storm.service.pump()
            storm.checkpoint()

        def serve(r):
            for i, d in enumerate(docs):
                storm = cluster.storm_for(d)
                storm.submit_frame(None, {
                    "rid": (r, d), "docs": [[d, clients[d], 1 + r * 8, 1,
                                             8]]},
                    memoryview(_plane_words((r, i), 8).tobytes()))
                storm.flush()
        serve(0)
        serve(1)
        mine = [d for d in docs if cluster.owner_of(d) == "hostA"]
        assert len(mine) >= 2
        cluster.migrate(mine[0], "hostB")
        serve(2)
        leader._group_wal.close()
        new, new_plane, rep = promote(
            "hostA", [lk.node for lk in plane.links], git,
            follower_dirs=[str(root / "f2")], num_docs=4, device=dev)
        new.service._clock = itertools.count(5000, 7).__next__
        # The directory rode the dead leader's quorum: the cluster is
        # rebuilt over the promoted one's (as the chaos harness does).
        cluster = StormCluster({"hostA": new, "hostB": other},
                               ReplicatedHeadStore(git, new_plane))
        cluster.fail_over("hostA", new, blackout_ms=rep["blackout_ms"])
        serve(3)
        out = {"digest": _replication_digest(cluster, docs),
               "replayed": rep["replayed_ticks"],
               "log_len": rep["log_len"]}
        for storm in cluster.hosts.values():
            storm._group_wal.close()
        return out

    on_card = run("cuda")
    torch.cuda.synchronize()
    assert checked["map_fold"] > 0 and checked["sequencer_tick"] > 0
    assert on_card["replayed"] > 0
    assert on_card == run("cpu")
