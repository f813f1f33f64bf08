"""Differential: the port's sequence-parallel merge tick
(``ops/mergetree_sharded.py``) against the JAX package's and against the
port's flat tick, exactly.

The same seeded op streams go through JAX ``apply_tick_sharded`` on the
suite's 8 virtual CPU devices, the port's ``apply_tick_sharded`` on a
virtual mesh of 8 CPU shards (the stacked primitives) and of 2 and 4, the
port's flat tick ``mergetree_kernel.apply_tick`` and a one-shard mesh
(which runs the flat tick): every plane must be equal, including a
document whose segments span several shards.
"""

from __future__ import annotations

import random

import jax
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import mergetree_kernel as jmtk
from fluidframework_tpu.ops import mergetree_sharded as jmts
from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
from fluidframework_tpu_torch.ops import mergetree_sharded as mts
from tests.test_mergetree_sharded import _random_stream


def _assert_equal(j, t, ctx) -> None:
    for field in mtk.MergeState._fields:
        a = np.asarray(getattr(j, field))
        b = getattr(t, field).cpu().numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), (ctx, field)


def _assert_torch_equal(a, b, ctx) -> None:
    for field in mtk.MergeState._fields:
        assert torch.equal(getattr(a, field), getattr(b, field)), (ctx,
                                                                    field)


def _run(streams, s, k, n_shards_port=(8,)):
    n_docs = len(streams)
    jmesh = jmts.make_seg_mesh(jax.devices()[:8])
    meshes = {n: mts.make_seg_mesh(["cpu"] * n) for n in n_shards_port}
    lane_mesh = mts.make_seg_mesh(["cpu"])  # one shard: the flat tick
    state_j = jmts.shard_merge_state(jmtk.init_state(n_docs, s, 2), jmesh)
    flat = mtk.init_state(n_docs, s, 2, 1, "cpu")
    lanes = flat
    sharded = {n: mts.shard_merge_state(flat, m) for n, m in meshes.items()}
    longest = max(len(st) for st in streams)
    for start in range(0, longest, k):
        chunk = [st[start:start + k] for st in streams]
        jbatch = jmtk.make_merge_op_batch(chunk, n_docs, k)
        batch = mtk.make_merge_op_batch(chunk, n_docs, k, device="cpu")
        state_j = jmts.apply_tick_sharded(state_j, jbatch, jmesh)
        flat = mtk.apply_tick(flat, batch)
        lanes = mts.apply_tick_sharded(lanes, batch, lane_mesh)
        for n, m in meshes.items():
            sharded[n] = mts.apply_tick_sharded(sharded[n], batch, m)
    _assert_equal(state_j, flat, "flat")
    _assert_torch_equal(flat, lanes, "lanes")
    for n in meshes:
        _assert_equal(state_j, sharded[n], n)
    return flat


@pytest.mark.parametrize("seed", range(3))
def test_sharded_matches_jax_and_the_flat_tick(seed):
    rng = random.Random(40 + seed)
    n_docs = rng.choice([1, 3])
    streams = [_random_stream(rng, rng.randrange(10, 40))
               for _ in range(n_docs)]
    _run(streams, 32 * 8, 8, n_shards_port=(2, 4, 8))


def test_long_document_spans_shards():
    per_shard = 16
    rng = random.Random(7)
    stream = _random_stream(rng, 3 * per_shard)  # > one shard's capacity
    flat = _run([stream], per_shard * 8, 8)
    assert int(flat.count[0]) > per_shard
    pool = mtk.TextPool(1)
    pool.append(0, "x" * 4096)
    assert mtk.materialize(flat, pool, 0)


def test_shard_asserts_match_the_reference():
    state = mtk.init_state(1, 16, 2, 1, "cpu")
    batch = mtk.make_merge_op_batch([[]], 1, 2, device="cpu")
    with pytest.raises(AssertionError, match="divide"):
        mts.apply_tick_sharded(state, batch, mts.make_seg_mesh(["cpu"] * 3))
    with pytest.raises(AssertionError, match=">= 2"):
        mts.apply_tick_sharded(state, batch,
                               mts.make_seg_mesh(["cpu"] * 16))


def test_a_mesh_of_distinct_devices_is_refused():
    """Shards on distinct devices of one process are not implemented: the
    tick and the placement refuse such a mesh instead of running every
    shard on the first device."""
    state = mtk.init_state(1, 16, 2, 1, "cpu")
    batch = mtk.make_merge_op_batch([[]], 1, 2, device="cpu")
    mesh = mts.make_seg_mesh(["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="distinct devices"):
        mts.apply_tick_sharded(state, batch, mesh)
    with pytest.raises(ValueError, match="distinct devices"):
        mts.shard_merge_state(state, mesh)


def test_from_block_state_packs_like_the_reference():
    from fluidframework_tpu.ops import mergetree_blocks as jmtb
    from fluidframework_tpu_torch.ops import mergetree_blocks as mtb
    rng = random.Random(3)
    stream = _random_stream(rng, 30)
    jb = jmtb.init_state(1, 4, 16, 2, 1)
    tb = mtb.init_state(1, 4, 16, 2, 1, "cpu")
    for start in range(0, len(stream), 6):
        chunk = [stream[start:start + 6]]
        jb, _ = jmtb.apply_tick_blocks(jb, jmtk.make_merge_op_batch(
            chunk, 1, 6))
        tb, _ = mtb.apply_tick_blocks(tb, mtk.make_merge_op_batch(
            chunk, 1, 6, device="cpu"))
    _assert_equal(jmts.from_block_state(jb, 128),
                  mts.from_block_state(tb, 128), "packed")
