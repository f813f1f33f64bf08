"""Differential: the port's entry point (``fluidframework_tpu_torch/
entry.py``) against ``__graft_entry__.py``, exactly (every plane is
integer: max |err| 0).

* ``_example_tick`` builds the reference's six trees from the same draws;
* ``entry()``'s fused tick (deli -> flat merge -> map LWW) equals
  ``jax.jit(__graft_entry__._tick_fn())`` at 64 and at 40 docs;
* ``_dryrun_impl(n, device="cpu")``'s report equals its three stages built
  here from the reference's own modules on the suite's virtual CPU
  devices (a mesh of n of them, as ``__graft_entry__._dryrun_impl``
  builds it), for n = 2, 4 and 8: the sharded tick and its aggregated
  ``seq``; the sequence-parallel MergeState; and the sharded serving
  loop's harvest, map rows, texts, grids, tree orders, global metrics
  and every family's rows.

The reference's results depend on n only through the doc count, so each
n is one JAX compile of the tick and one of the serving loop, shared by
the module-scoped fixtures.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from fluidframework_tpu.ops import matrix_kernel as jmxk
from fluidframework_tpu.ops import mergetree_kernel as jmtk
from fluidframework_tpu.ops import mergetree_sharded as jmts
from fluidframework_tpu.ops import tree_kernel as jtk
from fluidframework_tpu.parallel import mesh as jmesh
from fluidframework_tpu.parallel.serving import \
    ShardedServing as JaxServing
from fluidframework_tpu_torch import entry as te
from fluidframework_tpu_torch.parallel.mesh import tree_leaves

SHARDS = (2, 4, 8)


def assert_trees_equal(jax_tree, port_tree) -> None:
    """Every leaf of a JAX tree == the port tree's (numpy or CPU
    tensors), dtype and value."""
    a = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_tree)]
    b = [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
         for x in tree_leaves(port_tree)]
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype, (i, x.dtype, y.dtype)
        assert x.shape == y.shape and np.array_equal(x, y), i


def populate(serving) -> None:
    """The reference dry run's mixed population (``default_rng(3)``,
    families by ``row % 4``), submitted to a JAX assembly."""
    rng = np.random.default_rng(3)
    for row in range(serving.num_docs):
        family = te.FAMILIES[row % 4]
        if family == "map":
            words = (rng.integers(0, 1 << 20, 8).astype(np.uint32) << 12
                     | (row % 4) << 2)
            serving.submit(row, words, first_cseq=1)
        elif family == "text":
            serving.submit_text(row, [
                dict(kind=jmtk.MT_INSERT, pos=0, text="world"),
                dict(kind=jmtk.MT_INSERT, pos=0, text="hello ")],
                first_cseq=1)
        elif family == "matrix":
            serving.submit_matrix(row, [
                dict(target=jmxk.MX_ROWS, kind=jmtk.MT_INSERT, pos=0,
                     count=2),
                dict(target=jmxk.MX_COLS, kind=jmtk.MT_INSERT, pos=0,
                     count=2),
                dict(target=jmxk.MX_CELL, row=0, col=1, value=42)],
                first_cseq=1)
        else:
            serving.submit_tree(row, [
                dict(kind=jtk.TREE_INSERT, node=1, parent=0, trait=1,
                     payload=5)], first_cseq=1)


def jax_dryrun(n: int) -> dict:
    """The reference dry run's three stages on a mesh of n virtual CPU
    devices, as ``__graft_entry__._dryrun_impl`` builds them, returning
    what it checks."""
    devices = jax.devices()[:n]
    assert len(devices) == n
    mesh = jmesh.make_mesh(devices)

    args = g._example_tick(n * 4, num_clients=8, k=8, seg_slots=32,
                           map_slots=16)
    out = jax.jit(g._tick_fn())(*(jmesh.shard_state(a, mesh)
                                  for a in args))
    total_seq = int(jmesh.aggregate_metrics(mesh, {"seq": out[0].seq})
                    ["seq"])

    seg_mesh = jmts.make_seg_mesh(devices)
    seg_slots = n * max(2, -(-64 // n))
    stream = [dict(kind=jmtk.MT_INSERT, pos=i, seq=i + 1, ref_seq=i,
                   client=i % 3, pool_start=i * 4, text_len=4)
              for i in range(24)]
    batch = jmtk.make_merge_op_batch([stream], 1, len(stream))
    seg = jmts.apply_tick_sharded(
        jmts.shard_merge_state(jmtk.init_state(1, seg_slots), seg_mesh),
        batch, seg_mesh)

    serving = JaxServing(mesh, num_docs=n * 2, k=8, num_hosts=2,
                         map_slots=16, text_slots=32, matrix_vec_slots=16,
                         matrix_cell_slots=32, tree_slots=8)
    serving.join_all()
    populate(serving)
    harvest = serving.tick()
    matrix = jax.tree.map(np.asarray, serving.matrix_state)
    tree = jax.tree.map(np.asarray, serving.tree_state)
    rows = range(serving.num_docs)
    return {
        "tick": {"outputs": jax.tree.map(np.asarray, out),
                 "total_seq": total_seq},
        "seg": {"merge_state": jax.tree.map(np.asarray, seg)},
        "serving": {
            "harvest": harvest,
            "map_rows": np.asarray(serving.map_rows()),
            "texts": {r: serving.text_of(r) for r in rows if r % 4 == 1},
            "grids": {r: jmxk.materialize_grid(matrix, r,
                                               {i: i for i in range(64)})
                      for r in rows if r % 4 == 2},
            "tree_orders": {r: jtk.trait_order(tree, r, 0, 1)
                            for r in rows if r % 4 == 3},
            "global_metrics": serving.global_metrics(),
            "states": serving._family_states()},
    }


@pytest.fixture(scope="module")
def dryruns():
    """n -> (JAX stages, port report), computed once per n."""
    cache: dict = {}

    def get(n: int):
        if n not in cache:
            cache[n] = (jax_dryrun(n), te._dryrun_impl(n, device="cpu"))
        return cache[n]
    return get


def test_example_tick_is_the_references():
    want = g._example_tick(64)
    got = te._example_tick(64, device="cpu")
    assert len(got) == len(want) == 6
    for w, t in zip(want, got):
        assert type(t).__name__ == type(w).__name__
        assert t._fields == w._fields
        assert_trees_equal(w, t)
    # Another width draws another stream, still the reference's.
    assert_trees_equal(g._example_tick(12, seg_slots=32, map_slots=16),
                       te._example_tick(12, seg_slots=32, map_slots=16,
                                        device="cpu"))


@pytest.mark.parametrize("num_docs", [64, 40])
def test_entry_tick_is_the_references(num_docs):
    fn, args = te.entry(device="cpu")
    if num_docs != 64:
        args = te._example_tick(num_docs, device="cpu")
    got = fn(*args)
    want = jax.jit(g._tick_fn())(*g._example_tick(num_docs))
    assert [type(x).__name__ for x in got] \
        == [type(x).__name__ for x in want]
    assert_trees_equal(want, got)
    # Every doc sequenced the join and the op; the text edits applied.
    assert got[0].seq.tolist() == [2] * num_docs
    assert bool((got[2].count > 0).all())


@pytest.mark.parametrize("n", SHARDS)
def test_dryrun_stage1_sharded_tick(dryruns, n):
    want, got = dryruns(n)
    assert_trees_equal(want["tick"]["outputs"], got["tick"]["outputs"])
    assert got["tick"]["total_seq"] == want["tick"]["total_seq"] \
        == 2 * 4 * n


@pytest.mark.parametrize("n", SHARDS)
def test_dryrun_stage2_sequence_parallel(dryruns, n):
    want, got = dryruns(n)
    assert_trees_equal(want["seg"]["merge_state"], got["seg"]["merge_state"])
    assert int(got["seg"]["merge_state"].count[0]) > 24


@pytest.mark.parametrize("n", SHARDS)
def test_dryrun_stage3_sharded_serving(dryruns, n):
    want, got = dryruns(n)
    w, t = want["serving"], got["serving"]
    assert t["harvest"] == w["harvest"]
    assert sorted(t["harvest"]) == [0, 1]
    assert np.array_equal(t["map_rows"], w["map_rows"]) \
        and t["map_rows"].dtype == w["map_rows"].dtype
    assert t["texts"] == w["texts"] and len(t["texts"]) == n // 2
    assert t["grids"] == w["grids"] and len(t["grids"]) == n // 2
    assert t["tree_orders"] == w["tree_orders"]
    assert t["global_metrics"] == w["global_metrics"]
    assert sorted(t["states"]) == sorted(w["states"])
    for name in w["states"]:
        assert_trees_equal(w["states"][name], t["states"][name])


def test_main_runs_on_the_cpu(capsys):
    te.main(["--device", "cpu", "--shards", "2"])
    assert capsys.readouterr().out.splitlines() == [
        "entry tick OK; cpu", "multichip dryrun OK"]


def test_the_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="cuda"):
        te.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        te.dryrun_multichip(8)
