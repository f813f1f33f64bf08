"""The port's docs-axis mesh (``parallel/mesh.py``) against the JAX
package's on the suite's 8 virtual CPU devices, exactly.

* ``shard_state`` lays the rows out as ``PartitionSpec("docs")`` does:
  shard i of the port holds exactly the rows (and values) of the
  reference's i-th addressable shard.
* ``aggregate_metrics`` gives the reference's psum totals (dtype too).
* The sequencer, map and merge ticks run shard by shard equal the
  unsharded run (after ``tests/test_mesh.py``), and equal JAX's.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from fluidframework_tpu.ops import map_kernel as jmk
from fluidframework_tpu.ops import mergetree_kernel as jmtk
from fluidframework_tpu.ops import sequencer as jseqk
from fluidframework_tpu.parallel import mesh as jmesh
from fluidframework_tpu_torch.ops import map_kernel as mk
from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
from fluidframework_tpu_torch.ops import sequencer as seqk
from fluidframework_tpu_torch.parallel import mesh as pmesh
from fluidframework_tpu_torch.protocol.messages import MessageType

NUM_DOCS = 16  # 2 per shard on the 8-shard mesh


@pytest.fixture(scope="module")
def meshes():
    return (jmesh.make_mesh(jax.devices()[:8]),
            pmesh.make_mesh(["cpu"] * 8))


def _seq_ops():
    return [[dict(kind=int(MessageType.CLIENT_JOIN), slot=-1, target=0,
                  timestamp=1),
             dict(kind=int(MessageType.CLIENT_JOIN), slot=-1, target=1,
                  timestamp=1),
             dict(kind=int(MessageType.OPERATION), slot=0, client_seq=1,
                  ref_seq=1, timestamp=2),
             dict(kind=int(MessageType.OPERATION), slot=1, client_seq=1,
                  ref_seq=2, timestamp=3),
             # dup: same client_seq again → ignored
             dict(kind=int(MessageType.OPERATION), slot=1, client_seq=1,
                  ref_seq=2, timestamp=4)]
            for _ in range(NUM_DOCS)]


def _run_sharded(fn, mesh, *trees):
    """``fn`` on every shard of the given trees, outputs gathered back to
    host rows in shard order."""
    shards = [pmesh.shard_state(t, mesh) for t in trees]
    outs = [fn(*parts) for parts in zip(*shards)]
    return pmesh.gather_rows(outs)


def _assert_tree_equal(jax_tree, host_tree) -> None:
    a = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_tree)]
    b = pmesh.tree_leaves(host_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        y = y.numpy() if isinstance(y, torch.Tensor) else y
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_shard_state_lays_rows_out_like_the_reference(meshes):
    jm, tm = meshes
    rng = np.random.default_rng(0)
    tree = {"a": rng.integers(0, 99, (NUM_DOCS, 3)).astype(np.int32),
            "b": rng.integers(0, 2, NUM_DOCS).astype(bool)}
    js = jmesh.shard_state(tree, jm)
    ts = pmesh.shard_state(tree, tm)
    assert len(ts) == 8 and tm.size == 8
    bounds = pmesh.shard_bounds(pmesh.doc_sharding(tm), NUM_DOCS)
    for name in tree:
        jshards = sorted(js[name].addressable_shards,
                         key=lambda s: s.index[0].start or 0)
        for i, (shard, (lo, hi)) in enumerate(zip(jshards, bounds)):
            assert (shard.index[0].start or 0, shard.index[0].stop) \
                == (lo, hi)
            assert np.array_equal(np.asarray(shard.data),
                                  ts[i][name].numpy())
            assert ts[i][name].device == tm.devices[i]
    assert pmesh.doc_count_for_mesh(tm, 2) \
        == jmesh.doc_count_for_mesh(jm, 2) == NUM_DOCS


def test_aggregate_metrics_matches_psum(meshes):
    jm, tm = meshes
    jstate, jtickets = jseqk.process_batch(
        jseqk.init_state(NUM_DOCS, 8),
        jseqk.make_op_batch(_seq_ops(), NUM_DOCS, 6))
    jtot = jmesh.aggregate_metrics(jm, {
        "seq": jstate.seq,
        "sequenced": (jtickets.kind == 1).astype(np.int32),
        "active": jstate.active})
    state = seqk.init_state(NUM_DOCS, 8, "cpu")
    ops = seqk.make_op_batch(_seq_ops(), NUM_DOCS, 6, "cpu")
    shards = [seqk.process_batch(s, o) for s, o in zip(
        pmesh.shard_state(state, tm), pmesh.shard_state(ops, tm))]
    ttot = pmesh.aggregate_metrics(tm, [
        {"seq": s.seq, "sequenced": (t.kind == 1).to(torch.int32),
         "active": s.active} for s, t in shards])
    for name in jtot:
        a, b = np.asarray(jtot[name]), ttot[name].numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert int(ttot["seq"]) == NUM_DOCS * 4
    # One unsharded tree aggregates the same.
    whole = seqk.process_batch(state, ops)[0]
    assert int(pmesh.aggregate_metrics(tm, {"seq": whole.seq})["seq"]) \
        == NUM_DOCS * 4


def test_sequencer_sharded_matches_unsharded(meshes):
    jm, tm = meshes
    state = seqk.init_state(NUM_DOCS, 8, "cpu")
    ops = seqk.make_op_batch(_seq_ops(), NUM_DOCS, 6, "cpu")
    got = _run_sharded(seqk.process_batch, tm, state, ops)
    plain = seqk.process_batch(state, ops)
    _assert_tree_equal(jax.tree.map(np.asarray, jseqk.process_batch(
        jmesh.shard_state(jseqk.init_state(NUM_DOCS, 8), jm),
        jmesh.shard_state(jseqk.make_op_batch(_seq_ops(), NUM_DOCS, 6),
                          jm))), got)
    _assert_tree_equal(tuple(pmesh.tree_map(lambda t: t.numpy(), plain)),
                       got)


def test_merge_tick_sharded_matches_unsharded(meshes):
    jm, tm = meshes
    rng = np.random.default_rng(7)
    per_doc = [[dict(kind=mtk.MT_INSERT, pos=0, seq=1, ref_seq=0, client=0,
                     pool_start=0, text_len=12),
                dict(kind=mtk.MT_INSERT, pos=int(rng.integers(0, 12)),
                     seq=2, ref_seq=1, client=1, pool_start=12, text_len=6),
                dict(kind=mtk.MT_REMOVE, pos=1, end=4, seq=3, ref_seq=2,
                     client=0)] for _ in range(NUM_DOCS)]
    state = mtk.init_state(NUM_DOCS, 32, 4, 1, "cpu")
    ops = mtk.make_merge_op_batch(per_doc, NUM_DOCS, 4, device="cpu")
    got = _run_sharded(mtk.apply_tick, tm, state, ops)
    jout = jmtk.apply_tick(
        jmesh.shard_state(jmtk.init_state(NUM_DOCS, 32), jm),
        jmesh.shard_state(jmtk.make_merge_op_batch(per_doc, NUM_DOCS, 4),
                          jm))
    _assert_tree_equal(jout, got)
    _assert_tree_equal(jout, pmesh.tree_map(lambda t: t.numpy(),
                                            mtk.apply_tick(state, ops)))


def test_map_tick_sharded_matches_unsharded(meshes):
    jm, tm = meshes
    per_doc = [[dict(kind=mk.MAP_SET, slot=3, value=41, seq=1),
                dict(kind=mk.MAP_SET, slot=3, value=42, seq=2),
                dict(kind=mk.MAP_DELETE, slot=5, seq=3)]
               for _ in range(NUM_DOCS)]
    state = mk.init_state(NUM_DOCS, 16, "cpu")
    ops = mk.make_map_op_batch(per_doc, NUM_DOCS, 4, "cpu")
    got = _run_sharded(mk.apply_tick, tm, state, ops)
    jout = jmk.apply_tick(
        jmesh.shard_state(jmk.init_state(NUM_DOCS, 16), jm),
        jmesh.shard_state(jmk.make_map_op_batch(per_doc, NUM_DOCS, 4), jm))
    _assert_tree_equal(jout, got)


def test_mesh_kinds_and_the_cuda_default():
    assert pmesh.mesh_kind(pmesh.make_mesh(["cpu"] * 4)) == "stacked"
    assert pmesh.mesh_kind(pmesh.make_mesh(["cpu", "cpu:0"])) == "stacked"
    assert pmesh.mesh_kind(pmesh.make_mesh(["cuda:0", "cuda:1"])) \
        == "devices"
    assert pmesh.mesh_kind(pmesh.make_mesh(["cpu"], world=2)) == "dist"
    assert pmesh.make_mesh(["cpu"] * 4).axis_names == (pmesh.DOCS_AXIS,)
    one = pmesh.make_mesh(["cpu"])
    assert pmesh.replicated(one) is pmesh.doc_sharding(one) is one
    with pytest.raises(ValueError, match="divide"):
        pmesh.shard_state({"a": np.zeros(5)}, pmesh.make_mesh(["cpu"] * 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pmesh.make_mesh()
