"""The shared-memory variants of kernels 3 and 6, without a card.

Which variant a wrapper launches is decided by shape alone: the bytes of
shared memory one document takes (``smem_bytes``, ``steps_smem_bytes``,
the same formulas the launchers check) against the card's per-block
opt-in limit. These tests pin that choice at the shapes the main paths
launch (text paths A and B, the burst tick, the step layout) and past the
limit, read the new sources' pointer layouts and sizes against the
bindings, and hold the plain versions, which both variants must equal on
the card, to the JAX package on the inputs the card tests use for the
hard cases: block summaries that disagree with their slots, and matrix
frames whose prefix wraps.
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
from fluidframework_tpu_torch.ops import matrix_cuda as mxc
from fluidframework_tpu_torch.ops import matrix_kernel as mxk
from fluidframework_tpu_torch.ops import mergetree_blocks as mtb
from fluidframework_tpu_torch.ops import mergetree_blocks_cuda as mtbc
from tests.test_torch_cuda_kernels import _inexact_blocks, _wild_matrix

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


def _source(name: str) -> str:
    return (_build.CSRC / f"{name}.cu").read_text()


def _layout_and_reads(name: str) -> tuple[tuple, list]:
    src = _source(name)
    body = re.search(name + r"_layout\(\)\s*\{\s*return(.*?);", src,
                     re.S).group(1)
    layout = tuple("".join(re.findall(r'"([^"]*)"', body)).split(","))
    return layout, re.findall(r"a\.(\w+) = \([^)]*\)p\[(\d+)\];", src)


@pytest.mark.parametrize("name,layout", [
    ("mergetree_blocks_smem", mtbc.SMEM_LAYOUT),
    ("matrix_steps_smem", mxc.STEPS_SMEM_LAYOUT)])
def test_smem_launchers_read_the_bindings_layout(name, layout):
    """The shared-memory launchers read the global launchers' pointers
    without the scratch planes, in the order their layout string names."""
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
    assert define("matrix_steps_smem", "MXS_HEADER_INTS") \
        == mxc.SMEM_HEADER_INTS
    assert define("matrix_steps_smem", "MXS_THREADS") == mxc.SMEM_THREADS
    assert define("matrix_steps_smem", "MXS_VEC_FIELDS") == 12
    assert define("matrix_steps_smem", "MXS_RUN_FIELDS") == 5


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    """On the CPU both wrappers return the plain result whatever variant
    is asked for, and no launch or variant is counted."""
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
