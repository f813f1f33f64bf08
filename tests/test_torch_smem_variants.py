"""The two variants of kernels 1-6, without a card.

Which variant a wrapper launches is decided by shape alone: the bytes of
shared memory one document (the deli: one block of documents) takes
(``smem_bytes``, ``steps_smem_bytes``, ``tick_smem_bytes``,
``warp_smem_bytes``, the same formulas the launchers check) against the
card's per-block opt-in limit, for the deli the number of client lanes,
and for the map fold a rule by shape (the warp variant at every shape).
These tests pin that choice at the shapes the main paths launch (the map
path, text paths A and B, the burst tick, the flat tick's overflow
replays, the step layout, matrix paths A and B, the deli on the map, text
and matrix paths) and past the limit, read the new sources' pointer
layouts and sizes against the bindings, and hold the plain versions,
which both variants must equal on the card, to the JAX package on the
inputs the card tests use for the hard cases: block summaries that
disagree with their slots, matrix frames whose prefix wraps, and flat
tables filled past capacity.
"""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import matrix_kernel as jmxk
from fluidframework_tpu.ops import mergetree_blocks as jmtb
from fluidframework_tpu.ops import mergetree_kernel as jmtk
from fluidframework_tpu_torch.ops import _build
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
from tests.test_torch_cuda_kernels import (
    _deli_every_outcome,
    _fold_inputs,
    _inexact_blocks,
    _on,
    _wild_flat,
    _wild_matrix,
    _wild_ops,
)

#: cudaDevAttrMaxSharedMemoryPerBlockOptin of an H100.
H100_OPTIN = 232_448


@pytest.mark.parametrize("shape,nbytes,variant", [
    # text path A: 8 docs of 4 x 128 slots, K = 128, P = W = 4
    ((4, 128, 4, 4, 128), 39_616, "smem"),
    # text path B and the full-size check: K = 32
    ((4, 128, 4, 4, 32), 35_392, "smem"),
    # the 120-op burst tick
    ((4, 128, 4, 4, 120), 39_264, "smem"),
    # rows past one block's shared memory
    ((16, 512, 4, 4, 32), 527_152, "global"),
    ((4, 1024, 4, 4, 32), 264_768, "global")])
def test_block_tick_variant_by_shape(shape, nbytes, variant):
    assert mtbc.smem_bytes(*shape) == nbytes
    assert mtbc.choose_variant(*shape, H100_OPTIN) == variant
    assert mtbc.choose_variant(*shape, nbytes) == "smem"
    assert mtbc.choose_variant(*shape, nbytes - 1) == "global"


@pytest.mark.parametrize("shape,nbytes,variant", [
    # text paths A and B's overflow replays: one document of 256 or 512
    # slots, K = 32 (the full-size check's rows too), and a 120-op burst
    ((256, 4, 4, 32), 19_840, "smem"),
    ((512, 4, 4, 32), 37_248, "smem"),
    ((512, 4, 4, 120), 41_120, "smem"),
    # the largest row that fits the card, and one slot more
    ((3382, 4, 4, 32), 232_408, "smem"),
    ((3383, 4, 4, 32), 232_476, "global"),
    # the forced-global check's rows
    ((4096, 4, 4, 32), 280_960, "global")])
def test_flat_tick_variant_by_shape(shape, nbytes, variant):
    assert mtc.smem_bytes(*shape) == nbytes
    assert mtc.choose_variant(*shape, H100_OPTIN) == variant
    assert mtc.choose_variant(*shape, nbytes) == "smem"
    assert mtc.choose_variant(*shape, nbytes - 1) == "global"


@pytest.mark.parametrize("shape", [
    # the map path: 10,240 docs x K = 1,024 x 64 key slots
    (10240, 1024, 64),
    # the fewest and the most key slots, K % 4 != 0, an empty K
    (1, 1, 1), (37, 300, 1024), (513, 33, 7), (4, 0, 16)])
def test_fold_variant_by_shape(shape):
    """The map fold launches its warp variant at every shape: no shape
    where the block variant won has been measured."""
    assert mfc.fold_variant(*shape) == "warp"
    assert set(mfc.variants) == {"warp", "block"}


@pytest.mark.parametrize("shape,nbytes,variant", [
    # the step layout: S = C = 256, P = W = 1, runs of 8
    ((256, 1, 1, 256, 8), 29_216, "smem"),
    ((256, 1, 8, 1024, 8), 58_912, "smem"),
    # a document past one block's shared memory
    ((4096, 1, 1, 64, 4), 363_072, "global"),
    # runs longer than one thread per prefetched step plane
    ((64, 1, 1, 64, 49), 10_776, "global")])
def test_step_tick_variant_by_shape(shape, nbytes, variant):
    assert mxc.steps_smem_bytes(*shape) == nbytes
    assert mxc.steps_variant(*shape, H100_OPTIN) == variant
    assert mxc.SMEM_MAX_RUN == 48


@pytest.mark.parametrize("shape,nbytes,variant", [
    # matrix path B at batched width: S = 100, W = 4, C = 128, K = 32
    ((100, 1, 4, 128, 32), 16_672, "smem"),
    # the full-size check: S = 256, W = 8, C = 1,024
    ((256, 1, 8, 1024, 32), 59_008, "smem"),
    # matrix path A: the layout flush, then the mixed flushes of 256 ops
    # on 576 vector slots as the cell log grows to 4,097 entries
    ((64, 1, 1, 256, 32), 13_952, "smem"),
    ((576, 1, 8, 4097, 256), 175_636, "smem"),
    # one more doubling of that cell log, and a document of 4,096 slots,
    # do not fit
    ((576, 1, 8, 8193, 256), 257_556, "global"),
    ((4096, 1, 1, 64, 24), 332_256, "global")])
def test_op_tick_variant_by_shape(shape, nbytes, variant):
    assert mxc.tick_smem_bytes(*shape) == nbytes
    assert mxc.tick_variant(*shape, H100_OPTIN) == variant
    assert mxc.tick_variant(*shape, nbytes) == "smem"
    assert mxc.tick_variant(*shape, nbytes - 1) == "global"


@pytest.mark.parametrize("shape,nbytes,variant", [
    # the map path: 10,240 docs x 4 clients and the ghost lane
    ((10240, 4, 5), 320, "thread"),
    # text path A (128 clients) and matrix path A (256 clients)
    ((1, 128, 129), 8_256, "warp"),
    ((1, 256, 257), 16_448, "warp"),
    # the fewest lanes the warp variant takes
    ((64, 32, 15), 960, "thread"),
    ((64, 32, 16), 1_024, "warp"),
    # a block's four documents at the card's limit, and one lane past it
    ((1, 2, 3632), 232_448, "warp"),
    ((1, 2, 3633), 232_512, "thread"),
    ((64, 32, 4096), 262_144, "thread")])
def test_deli_variant_by_shape(shape, nbytes, variant):
    assert seqc.warp_smem_bytes(shape[2]) == nbytes
    assert seqc.deli_variant(*shape, H100_OPTIN) == variant


def _source(name: str) -> str:
    path = _build.CSRC / (name if name.endswith(".cuh") else f"{name}.cu")
    return path.read_text()


def _layout_and_reads(name: str) -> tuple[tuple, list]:
    src = _source(name)
    body = re.search(name + r"_layout\(\)\s*\{\s*return(.*?);", src,
                     re.S).group(1)
    layout = tuple("".join(re.findall(r'"([^"]*)"', body)).split(","))
    return layout, re.findall(r"a\.(\w+) = \([^)]*\)p\[(\d+)\];", src)


@pytest.mark.parametrize("name,layout", [
    ("mergetree_flat_smem", mtc.LAYOUT),
    ("mergetree_blocks_smem", mtbc.SMEM_LAYOUT),
    ("matrix_steps_smem", mxc.STEPS_SMEM_LAYOUT),
    ("matrix_tick_smem", mxc.TICK_LAYOUT),
    ("sequencer_tick_warp", seqc.LAYOUT)])
def test_smem_launchers_read_the_bindings_layout(name, layout):
    """The shared-memory (and warp) launchers read the other variants'
    pointers without the scratch planes, in the order their layout string
    names."""
    got, reads = _layout_and_reads(name)
    assert got == layout
    assert [int(i) for _, i in reads] == list(range(len(layout)))
    assert tuple(n for n, _ in reads) == layout
    assert "scratch_vis" not in layout and "frame" not in layout


def test_smem_constants_match_the_sources():
    """The byte formulas' constants are the kernels' own."""
    def define(name, macro):
        return int(re.search(rf"#define {macro} (\d+)", _source(name))[1])
    assert define("mergetree_blocks_smem", "MTS_HEADER_INTS") \
        == mtbc.SMEM_HEADER_INTS
    assert define("mergetree_blocks_smem", "MTS_OP_FIELDS") \
        == mtbc.SMEM_OP_FIELDS
    # Both matrix kernels take their header and threads from the shared
    # header.
    assert define("matrix_smem.cuh", "MXS_HEADER_INTS") \
        == mxc.SMEM_HEADER_INTS
    assert define("matrix_smem.cuh", "MXS_THREADS") == mxc.SMEM_THREADS
    for name in ("matrix_steps_smem", "matrix_tick_smem"):
        assert '#include "matrix_smem.cuh"' in _source(name)
    assert define("matrix_steps_smem", "MXS_VEC_FIELDS") == 12
    assert define("matrix_steps_smem", "MXS_RUN_FIELDS") == 5
    assert define("matrix_tick_smem", "MXT_STRETCH") == mxc.TICK_STRETCH
    assert define("matrix_tick_smem", "MXT_OP_FIELDS") \
        == mxc.TICK_OP_FIELDS == len(mxk.MatrixOpBatch._fields)
    assert define("sequencer_tick_warp", "DELI_WARPS") == seqc.WARP_DOCS
    assert define("sequencer_tick_warp", "DELI_CLIENT_BYTES") \
        == seqc.WARP_CLIENT_BYTES


def test_flat_smem_constants_match_the_sources():
    """Kernel 4's shared-memory byte formula takes its constants from
    the kernel, which stages every MergeOpBatch field; it and both
    shared-memory matrix kernels run the walk of ``flat_smem.cuh``."""
    def define(name, macro):
        return int(re.search(rf"#define {macro} (\d+)", _source(name))[1])
    assert define("mergetree_flat_smem", "MFS_HEADER_INTS") \
        == mtc.SMEM_HEADER_INTS
    assert define("mergetree_flat_smem", "MFS_OP_FIELDS") \
        == mtc.SMEM_OP_FIELDS == len(mtk.MergeOpBatch._fields)
    for name in ("mergetree_flat_smem", "matrix_smem.cuh"):
        assert '#include "flat_smem.cuh"' in _source(name)
    assert "void walk(" in _source("flat_smem.cuh")
    assert "void walk(" not in _source("matrix_smem.cuh")


def test_both_fold_launchers_take_the_same_arguments():
    """The warp and the block map-fold launchers take the same argument
    list, which the binding passes to either."""
    def params(name):
        src = _source(name)
        body = re.search(name + r"_launch\((.*?)\)\s*\{", src,
                         re.S).group(1)
        return [p.split()[-1].lstrip("*") for p in body.split(",")], \
            [" ".join(p.split()[:-1]) for p in body.split(",")]
    assert params("map_fold_warp") == params("map_fold")
    assert params("map_fold")[0][:3] == ["words", "B", "K"]


@pytest.mark.parametrize("variant", [None, "smem", "global"])
def test_cpu_flat_tick_takes_the_plain_version_and_counts_nothing(variant):
    state, ops = _wild_flat(np.random.default_rng(5), 3, 24, 2, 2, 12)
    before = mtc.launches, dict(mtc.shapes), dict(mtc.variants)
    want = mtk.apply_tick(state, ops)
    got = mtc.apply_tick_best(state, ops, variant)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert (mtc.launches, mtc.shapes, mtc.variants) == before


@pytest.mark.parametrize("variant", [None, "warp", "block"])
def test_cpu_fold_takes_the_plain_version_and_counts_nothing(variant):
    state, words, lo, hi, base = _fold_inputs(np.random.default_rng(6), 9,
                                              37, 16)
    st = _on(state, mk.MapState, "cpu")
    args = [torch.from_numpy(a) for a in (words, lo, hi, base)]
    before = mfc.launches, dict(mfc.shapes), dict(mfc.variants)
    want = mk.fold_words_plain(st, *args)
    got = mfc.fold_words(st, *args, variant=variant)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert (mfc.launches, mfc.shapes, mfc.variants) == before


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    """On the CPU every two-variant wrapper returns the plain result
    whatever variant is asked for, and no launch or variant is counted."""
    state, ops = _inexact_blocks(np.random.default_rng(1), 3, 2, 8, 2, 1, 6)
    before = mtbc.launches, dict(mtbc.variants)
    want, want_ovf = mtb.apply_tick_blocks(state, ops)
    for variant in (None, "smem", "global"):
        got, ovf = mtbc.apply_tick_blocks_best(state, ops, variant)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert torch.equal(ovf, want_ovf)
    assert (mtbc.launches, mtbc.variants) == before
    mstate, steps = _wild_matrix(np.random.default_rng(2), 2, 16, 8, 1, 4, 2)
    counted = mxc.steps.launches, dict(mxc.steps.variants)
    want = mxk.apply_tick_steps(mstate, steps)
    got = mxc.apply_tick_steps_best(mstate, steps, "smem")
    assert all(torch.equal(x, y)
               for x, y in zip(mxk.leaves(got), mxk.leaves(want)))
    assert (mxc.steps.launches, mxc.steps.variants) == counted
    ops = _wild_ops(np.random.default_rng(3), 2, 12, 1, 0.2)
    counted = mxc.tick.launches, dict(mxc.tick.variants)
    want = mxk.apply_tick(mstate, ops)
    for variant in (None, "smem", "global"):
        got = mxc.apply_tick_best(mstate, ops, variant)
        assert all(torch.equal(x, y)
                   for x, y in zip(mxk.leaves(got), mxk.leaves(want)))
    assert (mxc.tick.launches, mxc.tick.variants) == counted
    st, op = _deli_every_outcome(np.random.default_rng(4), 4, 12, 33)
    st, op = _on(st, seqk.SequencerState, "cpu"), _on(op, seqk.OpBatch, "cpu")
    counted = seqc.launches, dict(seqc.shapes), dict(seqc.variants)
    want_s, want_t = seqk.process_batch(st, op)
    for variant in (None, "warp", "thread"):
        got_s, got_t = seqc.process_batch_best(st, op, variant)
        assert all(torch.equal(x, y) for x, y in zip(got_s, want_s))
        assert all(torch.equal(x, y) for x, y in zip(got_t, want_t))
    assert (seqc.launches, seqc.shapes, seqc.variants) == counted


def test_launch_counters_split_by_variant():
    counts = mxc.Launches()
    counts.add((1, 2), "smem")
    counts.add((1, 2), "global")
    counts.add((3, 4), "smem")
    assert counts.launches == 3
    assert counts.shapes == {(1, 2): 2, (3, 4): 1}
    assert counts.variants == {"smem": 2, "global": 1}
    counts.reset()
    assert (counts.launches, counts.shapes, counts.variants) == (0, {}, {})


def _jax(planes, cls):
    return cls(**{f: jnp.asarray(getattr(planes, f).numpy())
                  for f in cls._fields})


@pytest.mark.parametrize("seed", range(2))
def test_plain_block_tick_matches_jax_on_inexact_summaries(seed):
    """The plain block tick equals the JAX package's on tables whose block
    summaries disagree with their slots (frames where a position falls
    inside several slots or none), with overflow."""
    state, ops = _inexact_blocks(np.random.default_rng(10 + seed), 6, 3,
                                 16, 2, 2, 8)
    jnew, jovf = jmtb.apply_tick_blocks(_jax(state, jmtb.BlockMergeState),
                                        _jax(ops, jmtk.MergeOpBatch))
    new, ovf = mtb.apply_tick_blocks(state, ops)
    for f in mtb.BlockMergeState._fields:
        assert np.array_equal(np.asarray(getattr(jnew, f)),
                              getattr(new, f).numpy()), f
    assert np.array_equal(np.asarray(jovf), ovf.numpy())


@pytest.mark.parametrize("seed", range(2))
def test_plain_step_tick_matches_jax_on_wild_frames(seed):
    """The plain step tick equals the JAX package's on random planes whose
    frames wrap, with duplicate cell keys and counts up to past C."""
    state, steps = _wild_matrix(np.random.default_rng(20 + seed), 4, 24, 12,
                                1, 6, 3)
    jstate = jmxk.MatrixState(
        _jax(state.rows, jmtk.MergeState), _jax(state.cols, jmtk.MergeState),
        **{f: jnp.asarray(getattr(state, f).numpy())
           for f in mxk.MatrixState._fields[2:]})
    jnew = jmxk.apply_tick_steps(jstate, _jax(steps, jmxk.MatrixStepBatch))
    new = mxk.apply_tick_steps(state, steps)
    got = [np.asarray(x) for x in (*jnew.rows, *jnew.cols, *jnew[2:])]
    for a, b in zip(got, mxk.leaves(new)):
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("seed,s,count_hi", [(0, 24, 30), (1, 40, 44),
                                             (2, 33, 0)])
def test_plain_flat_tick_matches_jax_on_wild_tables(seed, s, count_hi):
    """The plain flat tick equals the JAX package's on random tables
    filled past capacity (counts up to past S: the shift's wrapped reads)
    or with negative counts, whose prefixes wrap, with removes and
    annotates by clients at or past 32 * W: the inputs of the card's
    wild-table test, both variants of kernel 4 held to the same plain
    version."""
    state, ops = _wild_flat(np.random.default_rng(30 + seed), 4, s, 2, 2,
                            16)
    if count_hi == 0:
        state = state._replace(count=-state.count.abs() - 1)
    else:
        state = state._replace(count=torch.full_like(state.count, count_hi))
    jnew = jmtk.apply_tick(_jax(state, jmtk.MergeState),
                           _jax(ops, jmtk.MergeOpBatch))
    new = mtk.apply_tick(state, ops)
    for f in mtk.MergeState._fields:
        assert np.array_equal(np.asarray(getattr(jnew, f)),
                              getattr(new, f).numpy()), f
