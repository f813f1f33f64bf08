"""Differential: the port's SharedMap fold (ops/map_kernel.py apply_tick,
apply_tick_words and the windowed fold_words_plain — the plain version of
the CUDA map-fold kernel) against the JAX package's XLA path and its
Pallas fold in interpret mode (as tests/test_map_pallas.py runs it), on
seeded numpy word streams with clears, dup windows (lo > 0), partial
windows (hi < K) and empty rows. Every plane is integer: equality is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import map_kernel as jmk
from fluidframework_tpu.ops import map_pallas as jmp
from fluidframework_tpu_torch import convert
from fluidframework_tpu_torch.ops import map_fold_cuda as tmf
from fluidframework_tpu_torch.ops import map_kernel as tmk


def _rand_words(rng, b, k, slots):
    kinds = rng.choice([jmk.MAP_SET, jmk.MAP_DELETE, jmk.MAP_CLEAR],
                       p=[0.7, 0.2, 0.1], size=(b, k)).astype(np.uint32)
    slot = rng.integers(0, slots, (b, k)).astype(np.uint32)
    value = rng.integers(1, 1 << 20, (b, k)).astype(np.uint32)
    return kinds | (slot << 2) | (value << 12)


def _assert_equal(jax_state, torch_state, where=""):
    for f in jax_state._fields:
        a = np.asarray(getattr(jax_state, f))
        b = getattr(torch_state, f).numpy()
        assert a.dtype == b.dtype, (where, f)
        assert np.array_equal(a, b), (where, f)


def _t(a: np.ndarray) -> torch.Tensor:
    """u32 words reinterpreted as int32 before they become a tensor."""
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_tick_words_matches_jax_and_pallas(seed):
    rng = np.random.default_rng(seed)
    b, k, s = 24, 48, 16
    jstate = jmk.init_state(b, s)
    tstate = tmk.init_state(b, s, device="cpu")
    for t in range(4):
        words = _rand_words(rng, b, k, s + 4)  # some slots out of range
        counts = rng.integers(0, k + 1, b).astype(np.int32)
        base = (t * k + rng.integers(0, 3, b)).astype(np.int32)
        want = jmk.apply_tick_words(jstate, jnp.asarray(words),
                                    jnp.asarray(counts), jnp.asarray(base))
        pallas = jmp.apply_tick_words_pallas(
            jstate, jnp.asarray(words.view(np.int32)), jnp.asarray(counts),
            jnp.asarray(base), interpret=True)
        got = tmk.apply_tick_words(tstate, _t(words), _t(counts), _t(base))
        best = tmf.apply_tick_words_best(tstate, _t(words), _t(counts),
                                         _t(base))
        _assert_equal(want, got, (seed, t, "xla"))
        _assert_equal(pallas, got, (seed, t, "pallas"))
        _assert_equal(want, best, (seed, t, "best"))
        jstate, tstate = want, got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_windowed_fold_matches_pallas(seed):
    """lo > 0 (dup prefix), hi < K and empty (hi <= lo) windows, with
    seq = base + 1 + k - lo: the shape the storm tick feeds the fold."""
    rng = np.random.default_rng(100 + seed)
    b, k, s = 20, 40, 8
    prior = {"present": rng.random((b, s)) < 0.5,
             "value": rng.integers(0, 1 << 20, (b, s)).astype(np.int32),
             "vseq": rng.integers(-1, 100, (b, s)).astype(np.int32),
             "cleared_seq": rng.integers(-1, 50, b).astype(np.int32)}
    jstate = jmk.MapState(**{f: jnp.asarray(v) for f, v in prior.items()})
    tstate = convert.map_state_from_numpy(prior, "cpu")
    for t in range(3):
        words = _rand_words(rng, b, k, s)
        lo = rng.integers(0, 6, b).astype(np.int32)
        hi = np.where(rng.random(b) < 0.3, lo,
                      rng.integers(0, k + 1, b)).astype(np.int32)
        base = rng.integers(0, 500, b).astype(np.int32)
        pallas = jmp.fold_words(jstate, jnp.asarray(words.view(np.int32)),
                                jnp.asarray(lo), jnp.asarray(hi),
                                jnp.asarray(base), interpret=True)
        got = tmf.fold_words(tstate, _t(words), _t(lo), _t(hi), _t(base))
        _assert_equal(pallas, got, (seed, t))
        jstate, tstate = pallas, got


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_tick_matches_jax(seed):
    """The per-op map path (merge_host._flush_map): explicit MapOpBatch
    with interned values and host-assigned seqs."""
    rng = np.random.default_rng(200 + seed)
    b, k, s = 10, 12, 8
    jstate = jmk.init_state(b, s)
    tstate = tmk.init_state(b, s, device="cpu")
    seq = 0
    for t in range(4):
        per_doc = []
        for _d in range(b):
            ops = []
            for _i in range(int(rng.integers(0, k + 1))):
                seq += 1
                kind = int(rng.choice([0, 0, 1, 2], p=[.4, .3, .2, .1]))
                ops.append(dict(kind=kind, slot=int(rng.integers(0, s)),
                                value=int(rng.integers(1, 99)), seq=seq))
            per_doc.append(ops)
        jstate = jmk.apply_tick(jstate, jmk.make_map_op_batch(per_doc, b, k))
        tstate = tmk.apply_tick(
            tstate, tmk.make_map_op_batch(per_doc, b, k, device="cpu"))
        _assert_equal(jstate, tstate, (seed, t))


def test_map_state_round_trips_through_numpy():
    rng = np.random.default_rng(5)
    planes = {"present": rng.random((4, 8)) < 0.5,
              "value": rng.integers(0, 9, (4, 8)).astype(np.int32),
              "vseq": rng.integers(-1, 9, (4, 8)).astype(np.int32),
              "cleared_seq": rng.integers(-1, 9, 4).astype(np.int32)}
    state = convert.map_state_from_numpy(planes, "cpu")
    back = convert.state_to_numpy(state)
    for f, v in planes.items():
        assert back[f].dtype == v.dtype and np.array_equal(back[f], v)
    state.value[0, 0] = 123  # the port's copy never aliases the caller's
    assert planes["value"][0, 0] != 123


@pytest.mark.parametrize("case", ["lo_below_0", "hi_past_k", "all_clear",
                                  "k_not_multiple_of_4", "s_1024"])
def test_windowed_fold_matches_pallas_at_the_edges(case):
    """The windows and shapes both variants of the fold's kernel must
    take: windows that start below 0 (seq still counts from lo), end past
    K or are empty, rows of clears only, K % 4 != 0 (the warp variant's
    unaligned tails) and the most key slots, S = 1,024."""
    rng = np.random.default_rng(300 + len(case))
    b = 6
    k = 37 if case == "k_not_multiple_of_4" else 24
    s = 1024 if case == "s_1024" else 8
    words = _rand_words(rng, b, k, s + 2)
    lo = rng.integers(0, 4, b).astype(np.int32)
    hi = rng.integers(0, k + 1, b).astype(np.int32)
    if case == "lo_below_0":
        lo = rng.integers(-5, 0, b).astype(np.int32)
    if case == "hi_past_k":
        hi = rng.integers(k, k + 6, b).astype(np.int32)
        hi[0] = lo[0]  # and one empty window
    if case == "all_clear":
        words[::2] = jmk.MAP_CLEAR | (3 << 2)
    base = rng.integers(0, 500, b).astype(np.int32)
    prior = {"present": rng.random((b, s)) < 0.5,
             "value": rng.integers(0, 1 << 20, (b, s)).astype(np.int32),
             "vseq": rng.integers(-1, 100, (b, s)).astype(np.int32),
             "cleared_seq": rng.integers(-1, 50, b).astype(np.int32)}
    jstate = jmk.MapState(**{f: jnp.asarray(v) for f, v in prior.items()})
    tstate = convert.map_state_from_numpy(prior, "cpu")
    pallas = jmp.fold_words(jstate, jnp.asarray(words.view(np.int32)),
                            jnp.asarray(lo), jnp.asarray(hi),
                            jnp.asarray(base), interpret=True)
    got = tmf.fold_words(tstate, _t(words), _t(lo), _t(hi), _t(base))
    _assert_equal(pallas, got, case)
