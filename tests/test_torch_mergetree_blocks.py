"""Differential: the port's block merge table (the plain version of the
block merge tick kernel) and its rebalance ladder against the JAX
package's.

The same concurrent streams (tests/test_mergetree_blocks.gen_stream, two
overlap words) tick both block tables; every plane, summary and overflow
index must be EXACTLY equal after every tick and after every
``maybe_rebalance_stats`` (incremental right and left spills and the full
rebalance), against ``mergetree_blocks.apply_tick_blocks`` and, at one
shape, against the Pallas kernel in interpret mode. Overflow is atomic at
a tiny block width, and the flat bridges (``flat_view``, ``to_flat``,
``from_flat``, ``rebalance``) agree.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import mergetree_blocks as jmtb
from fluidframework_tpu.ops import mergetree_blocks_pallas as jmtbp
from fluidframework_tpu.ops import mergetree_kernel as jmtk
from fluidframework_tpu_torch.ops import mergetree_blocks as mtb
from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
from tests.test_torch_mergetree import (
    B,
    K,
    P,
    W,
    assert_planes_equal,
    batches,
    jplanes,
    streams,
    tplanes,
)

NB, BK = 4, 16


def both_init():
    return (jmtb.init_state(B, NB, BK, P, W),
            mtb.init_state(B, NB, BK, P, W, device="cpu"))


def ms_pair(values):
    return jnp.asarray(values, jnp.int32), torch.tensor(values,
                                                       dtype=torch.int32)


@pytest.mark.parametrize("seed", range(2))
def test_apply_tick_blocks_matches_jax(seed):
    """Ticks with the serving ladder between them (tick width 4: a cap of
    6 per block, so the incremental spill runs)."""
    jb, tb = both_init()
    ss = streams(seed, 32)
    fired = 0
    for t, start in enumerate(range(0, 32, K)):
        jbt, tbt = batches([s[start:start + K] for s in ss])
        jb, jovf = jmtb.apply_tick_blocks(jb, jbt)
        tb, tovf = mtb.apply_tick_blocks(tb, tbt)
        assert_planes_equal(jplanes(jb), tplanes(tb), t)
        assert np.array_equal(np.asarray(jovf), tovf.numpy())
        jms, tms = ms_pair([start, 0, start // 2, -1])
        jb, jr = jmtb.maybe_rebalance_stats(jb, jms, 4)
        tb, tr = mtb.maybe_rebalance_stats(tb, tms, 4)
        assert_planes_equal(jplanes(jb), tplanes(tb), ("rebalance", t))
        assert np.array_equal(np.asarray(jr), tr.numpy())
        fired += int(tr[0])
    assert fired > 0


def test_apply_tick_blocks_matches_pallas_interpret():
    jb, tb = both_init()
    ss = streams(5, 16)
    for start in range(0, 16, K):
        jbt, tbt = batches([s[start:start + K] for s in ss])
        jb, jovf = jmtbp.apply_tick_blocks_pallas(jb, jbt, interpret=True)
        tb, tovf = mtb.apply_tick_blocks(tb, tbt)
        assert_planes_equal(jplanes(jb), tplanes(tb), start)
        assert np.array_equal(np.asarray(jovf), tovf.numpy())


def test_incremental_spill_matches_jax():
    """Head inserts overfill block 0 tick after tick: right conveyor
    steps, then the full rebalance once the spill is infeasible."""
    ops = [dict(kind=mtk.MT_INSERT, pos=0, seq=s, ref_seq=s - 1,
                client=s % 3, pool_start=2 * s, text_len=2)
           for s in range(1, 25)]
    jb = jmtb.init_state(1, NB, BK, P, W)
    tb = mtb.init_state(1, NB, BK, P, W, device="cpu")
    touched = []
    for start in range(0, 24, 6):
        chunk = [ops[start:start + 6]]
        jb, _ = jmtb.apply_tick_blocks(
            jb, jmtk.make_merge_op_batch(chunk, 1, K))
        tb, _ = mtb.apply_tick_blocks(
            tb, mtk.make_merge_op_batch(chunk, 1, K, device="cpu"))
        jb, jr = jmtb.maybe_rebalance_stats(jb, jnp.zeros(1, jnp.int32), 2)
        tb, tr = mtb.maybe_rebalance_stats(
            tb, torch.zeros(1, dtype=torch.int32), 2)
        assert_planes_equal(jplanes(jb), tplanes(tb), start)
        assert np.array_equal(np.asarray(jr), tr.numpy())
        touched.append(int(tr[1]))
    assert 2 in touched and NB in touched  # incremental, then full


def test_two_way_spill_matches_jax():
    """Blocks 0 and 3 over the cap of 10 (tick width 2): one call runs
    the right step (block 0's tail into block 1) and the left step
    (block 3's head into block 2)."""
    counts = [12, 3, 4, 12]
    planes = {f: np.full((1, 4, BK), mtb._FILL[f], np.int32)
              for f in mtb._SLOT_PLANES}
    planes["prop_val"] = np.zeros((1, 4, BK, P), np.int32)
    planes["rem_overlap"] = np.zeros((1, 4, BK, W), np.int32)
    seq = 0
    for blk, n in enumerate(counts):
        for j in range(n):
            seq += 1
            planes["length"][0, blk, j] = 1 + seq % 3
            planes["ins_seq"][0, blk, j] = seq
            planes["ins_client"][0, blk, j] = seq % 5
            planes["pool_start"][0, blk, j] = 3 * seq
            planes["prop_val"][0, blk, j, seq % P] = seq % 4
            if seq % 4 == 0:
                planes["rem_seq"][0, blk, j] = seq + 50
                planes["rem_client"][0, blk, j] = 1
    planes["blk_count"] = np.asarray([counts], np.int32)
    zeros = np.zeros((1, 4), np.int32)
    for f in ("blk_live_len", "blk_max_seq", "blk_tomb"):
        planes[f] = zeros
    planes["count"] = np.asarray([sum(counts)], np.int32)
    jb = jmtb.recompute_summaries(jmtb.BlockMergeState(
        **{f: jnp.asarray(planes[f]) for f in jmtb.BlockMergeState._fields}))
    tb = mtb.recompute_summaries(mtb.BlockMergeState(
        **{f: torch.from_numpy(planes[f])
           for f in mtb.BlockMergeState._fields}))
    jb, jr = jmtb.maybe_rebalance_stats(jb, jnp.zeros(1, jnp.int32), 2)
    tb, tr = mtb.maybe_rebalance_stats(tb, torch.zeros(1, dtype=torch.int32),
                                       2)
    assert_planes_equal(jplanes(jb), tplanes(tb))
    assert tr.tolist() == [1, 4] and tb.blk_count.tolist() == [[10, 5, 6, 10]]


def test_overflow_is_atomic_and_matches_jax():
    """A one-position insert storm at a tiny block width: the first
    overflowing op reverts entirely (a first split that succeeded
    included), the index is reported, later ops are inert, and the flat
    replay of the tail converges to the flat-only result."""
    n_ops = 24
    ops = [dict(kind=mtk.MT_INSERT, pos=0, seq=s, ref_seq=s - 1, client=0,
                pool_start=s * 4, text_len=2) for s in range(1, n_ops + 1)]
    # A remove that splits inside the full block 0 then overflows: its
    # first split must revert with it.
    ops.insert(5, dict(kind=mtk.MT_REMOVE, pos=1, end=3, seq=100,
                       ref_seq=99, client=1))
    jbatch = jmtk.make_merge_op_batch([ops], 1, 32)
    tbatch = mtk.make_merge_op_batch([ops], 1, 32, device="cpu")
    jb, jovf = jmtb.apply_tick_blocks(jmtb.init_state(1, 4, 4), jbatch)
    tb, tovf = mtb.apply_tick_blocks(
        mtb.init_state(1, 4, 4, device="cpu"), tbatch)
    assert_planes_equal(jplanes(jb), tplanes(tb))
    idx = int(tovf[0])
    assert idx == int(np.asarray(jovf)[0]) and 0 < idx < len(ops)
    assert int(tb.count[0]) == int(np.asarray(jb.count)[0])
    # The frozen table is the one the first idx ops build, exactly.
    head = mtk.make_merge_op_batch([ops[:idx]], 1, 32, device="cpu")
    frontier, fovf = mtb.apply_tick_blocks(
        mtb.init_state(1, 4, 4, device="cpu"), head)
    assert int(fovf[0]) == int(mtb.OVF_NONE)
    assert_planes_equal(tplanes(frontier), tplanes(tb))
    replay = mtk.make_merge_op_batch([ops[idx:]], 1, 32, device="cpu")
    replayed = mtk.apply_tick(mtb.to_flat(tb, slots=128), replay)
    flat_only = mtk.apply_tick(mtk.init_state(1, 128, device="cpu"), tbatch)
    pool = mtk.TextPool(1)
    pool.append(0, "".join(chr(97 + i % 26) for i in range(500)))
    assert mtk.materialize(replayed, pool, 0) \
        == mtk.materialize(flat_only, pool, 0)


@pytest.mark.parametrize("coalesce", [False, True])
def test_flat_bridges_match_jax(coalesce):
    jb, tb = both_init()
    ss = streams(2, 24)
    for start in range(0, 24, K):
        jbt, tbt = batches([s[start:start + K] for s in ss])
        jb, _ = jmtb.apply_tick_blocks(jb, jbt)
        tb, _ = mtb.apply_tick_blocks(tb, tbt)
    jms, tms = ms_pair([9, 0, 20, -1])
    assert_planes_equal(jplanes(jmtb.rebalance(jb, jms, coalesce)),
                        tplanes(mtb.rebalance(tb, tms, coalesce)))
    assert_planes_equal(jplanes(jmtb.flat_view(jb)),
                        tplanes(mtb.flat_view(tb)))
    jflat, tflat = jmtb.to_flat(jb, slots=80), mtb.to_flat(tb, slots=80)
    assert_planes_equal(jplanes(jflat), tplanes(tflat))
    assert_planes_equal(jplanes(jmtb.from_flat(jmtb.to_flat(jb), 2)),
                        tplanes(mtb.from_flat(mtb.to_flat(tb), 2)))
    assert np.array_equal(mtb.capacity_margin(tb),
                          jmtb.capacity_margin(jb))
    assert np.array_equal(mtb.max_block_fill(tb), jmtb.max_block_fill(jb))
    assert mtb.choose_block_geometry(1000, 32, 0.7) \
        == jmtb.choose_block_geometry(1000, 32, 0.7)
    row = {f: np.asarray(getattr(jflat, f))[1] for f in jflat._fields}
    got = mtb.host_block_row(row, 8, 16)
    want = jmtb.host_block_row(row, 8, 16)
    assert got.keys() == want.keys()
    for f in want:
        assert np.array_equal(got[f], want[f]), f
