"""Entry points of the port: the fused server tick and its
multi-device dry run.

Port of the repository's ``__graft_entry__.py``. The "flagship model" of
the framework is the batched document-merge step: the deli (kernel 2,
``process_batch_best``), the flat merge tick (kernel 4,
``apply_tick_best``) and the map LWW tick fused into one server tick over
the documents axis, and sharded over a mesh (documents are the
data-parallel axis; the merge path needs no collectives — see
``parallel/mesh.py``).

The tick is plain Python over tensors: on CUDA tensors the wrappers launch
their kernels (or raise), on CPU tensors they run their plain versions.
The dry run needs no extra devices: n shards of the one device it is
given form a virtual mesh (``make_mesh([dev] * n)``), on the card as on
the CPU.

Run:  python -m fluidframework_tpu_torch.entry [--device cpu] [--shards N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .device import resolve_device
from .ops import map_kernel as mk
from .ops import matrix_kernel as mxk
from .ops import mergetree_cuda as mtc
from .ops import mergetree_kernel as mtk
from .ops import mergetree_sharded as mts
from .ops import sequencer as seqk
from .ops import sequencer_cuda as seqc
from .ops import tree_kernel as tk
from .parallel import mesh as pmesh
from .parallel.serving import ShardedServing
from .protocol.messages import MessageType

FAMILIES = ("map", "text", "matrix", "tree")


def _check(cond: bool, what: str) -> None:
    """A dry-run check that holds under ``python -O`` too."""
    if not cond:
        raise AssertionError(what)


def _example_tick(num_docs: int, num_clients: int = 8, k: int = 8,
                  seg_slots: int = 64, map_slots: int = 32,
                  device: str | torch.device | None = None):
    """Build a representative tick: joins + text edits + map writes."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    seq_state = seqk.init_state(num_docs, num_clients, dev)
    seq_ops = seqk.make_op_batch(
        [[dict(kind=int(MessageType.CLIENT_JOIN), slot=-1, target=0,
               timestamp=1),
          dict(kind=int(MessageType.OPERATION), slot=0, client_seq=1,
               ref_seq=1, timestamp=2)]
         for _ in range(num_docs)], num_docs, k, dev)

    merge_state = mtk.init_state(num_docs, seg_slots, device=dev)
    merge_ops = mtk.make_merge_op_batch(
        [[dict(kind=mtk.MT_INSERT, pos=0, seq=1, ref_seq=0, client=0,
               pool_start=0, text_len=16),
          dict(kind=mtk.MT_INSERT, pos=int(rng.integers(0, 16)), seq=2,
               ref_seq=1, client=1, pool_start=16, text_len=8),
          dict(kind=mtk.MT_REMOVE, pos=2, end=6, seq=3, ref_seq=2,
               client=0)]
         for _ in range(num_docs)], num_docs, k, device=dev)

    map_state = mk.init_state(num_docs, map_slots, dev)
    map_ops = mk.make_map_op_batch(
        [[dict(kind=mk.MAP_SET, slot=int(rng.integers(0, map_slots)),
               value=7, seq=4),
          dict(kind=mk.MAP_DELETE, slot=int(rng.integers(0, map_slots)),
               seq=5)]
         for _ in range(num_docs)], num_docs, k, dev)

    return (seq_state, seq_ops, merge_state, merge_ops, map_state, map_ops)


def _tick_fn():
    """The fused server tick: deli (kernel 2) -> flat merge (kernel 4) ->
    map LWW (plain torch, as the reference's is XLA)."""

    def tick(seq_state, seq_ops, merge_state, merge_ops, map_state, map_ops):
        seq_state, tickets = seqc.process_batch_best(seq_state, seq_ops)
        merge_state = mtc.apply_tick_best(merge_state, merge_ops)
        map_state = mk.apply_tick(map_state, map_ops)
        return seq_state, tickets, merge_state, map_state

    return tick


def entry(device: str | torch.device | None = None):
    """(fn, example_args): one server tick on a 64-doc batch on
    ``device`` (None = the card; raises without one)."""
    return _tick_fn(), _example_tick(num_docs=64, device=device)


def dryrun_multichip(n_devices: int,
                     device: str | torch.device | None = None) -> dict:
    """Run the tick, the sequence-parallel merge and the sharded serving
    loop over a virtual mesh of ``n_devices`` shards of ``device`` (None
    = the card; raises without one) and check them; returns the
    :func:`_dryrun_impl` report."""
    return _dryrun_impl(n_devices, device)


def _on(tree, dev: torch.device) -> bool:
    """Every tensor of ``tree`` lies on ``dev``."""
    want = pmesh.canonical_device(dev)
    return all(pmesh.canonical_device(t.device) == want
               for t in pmesh.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _dryrun_impl(n_devices: int,
                 device: str | torch.device | None = None) -> dict:
    """The three stages on a virtual mesh of ``n_devices`` shards of one
    device. Returns a report of numpy arrays and host values:

    * ``tick``: the sharded tick's outputs gathered in row order
      (seq_state, tickets, merge_state, map_state) and ``total_seq``;
    * ``seg``: the sequence-parallel tick's MergeState;
    * ``serving``: ``harvest``, ``map_rows``, ``texts``, ``grids``,
      ``tree_orders``, ``global_metrics`` and every family's rows
      (``states``)."""
    dev = resolve_device(device)
    mesh = pmesh.make_mesh([dev] * n_devices)
    _check(mesh.size == n_devices and pmesh.mesh_kind(mesh) == "stacked",
           f"not a virtual mesh of {n_devices} shards: {mesh}")
    tick = _tick_fn()

    # Stage 1: the fused tick with the documents axis sharded.
    num_docs = n_devices * 4  # tiny per-shard batch
    args = _example_tick(num_docs, num_clients=8, k=8, seg_slots=32,
                         map_slots=16, device=dev)
    shards = [pmesh.shard_state(a, mesh) for a in args]
    outs = [tick(*parts) for parts in zip(*shards)]
    _check(len(outs) == n_devices and all(
        _on(out, d) for out, d in zip(outs, mesh.devices)),
        f"tick output not on {n_devices} shards of {dev}")
    gathered = pmesh.gather_rows(outs)
    _check(gathered[0].seq.shape[0] == num_docs, "lost rows")
    whole = pmesh.gather_rows([tick(*args)])
    for got, want in zip(pmesh.tree_leaves(gathered),
                         pmesh.tree_leaves(whole)):
        _check(np.array_equal(got, want),
               "sharded tick != the unsharded tick")
    # Metrics aggregate over the docs axis: each shard's sum, then the
    # shards' (then the processes', on a multi-process mesh).
    totals = pmesh.aggregate_metrics(mesh, [{"seq": out[0].seq}
                                            for out in outs])
    total_seq = int(totals["seq"])
    _check(total_seq >= num_docs, "a doc was not sequenced")

    # Stage 2: the SEGMENT axis of one long document sharded over the
    # same shards (the stacked sequence-parallel program), bit-checked
    # against the unsharded plain tick and kernel 4. Sized to the
    # stream's worst case (24 inserts -> up to 48 segments after splits)
    # and divisible over the shards with >= 2 slots each.
    seg_mesh = mts.make_seg_mesh([dev] * n_devices)
    seg_slots = n_devices * max(2, -(-64 // n_devices))
    stream = [dict(kind=mtk.MT_INSERT, pos=i, seq=i + 1, ref_seq=i,
                   client=i % 3, pool_start=i * 4, text_len=4)
              for i in range(24)]
    batch = mtk.make_merge_op_batch([stream], 1, len(stream), device=dev)
    blank = mtk.init_state(1, seg_slots, device=dev)
    ref = mtk.apply_tick(blank, batch)
    kern = mtc.apply_tick_best(blank, batch)
    sharded = mts.apply_tick_sharded(mts.shard_merge_state(blank, seg_mesh),
                                     batch, seg_mesh)
    _check(int(ref.count[0]) < seg_slots, "stream overflowed")
    _check(_on(sharded, dev), f"segment shards not on {dev}")
    for field in mtk.MergeState._fields:
        for other, name in ((sharded, "sharded"), (kern, "kernel 4")):
            _check(torch.equal(getattr(ref, field), getattr(other, field)),
                   f"{name} tick != the flat tick: {field}")

    # Stage 3: the serving loop sharded — two simulated hosts, each
    # owning half the documents, feed one fused deli + all-family tick
    # over the mesh and harvest only their own rows. The population
    # mixes map, text, matrix and tree rows.
    serving = ShardedServing(mesh, num_docs=n_devices * 2, k=8,
                             num_hosts=2, map_slots=16, text_slots=32,
                             matrix_vec_slots=16, matrix_cell_slots=32,
                             tree_slots=8)
    serving.join_all()
    rng = np.random.default_rng(3)
    expect_last: dict[int, int] = {}
    expect_n: dict[int, int] = {}
    for row in range(serving.num_docs):
        family = FAMILIES[row % 4]
        if family == "map":
            words = (rng.integers(0, 1 << 20, 8).astype(np.uint32) << 12
                     | (row % 4) << 2)
            serving.submit(row, words, first_cseq=1)
            expect_last[row] = int(words[-1]) >> 12
            expect_n[row] = 8
        elif family == "text":
            serving.submit_text(row, [
                dict(kind=mtk.MT_INSERT, pos=0, text="world"),
                dict(kind=mtk.MT_INSERT, pos=0, text="hello ")],
                first_cseq=1)
            expect_n[row] = 2
        elif family == "matrix":
            serving.submit_matrix(row, [
                dict(target=mxk.MX_ROWS, kind=mtk.MT_INSERT, pos=0,
                     count=2),
                dict(target=mxk.MX_COLS, kind=mtk.MT_INSERT, pos=0,
                     count=2),
                dict(target=mxk.MX_CELL, row=0, col=1, value=42)],
                first_cseq=1)
            expect_n[row] = 3
        else:
            serving.submit_tree(row, [
                dict(kind=tk.TREE_INSERT, node=1, parent=0, trait=1,
                     payload=5)], first_cseq=1)
            expect_n[row] = 1
    harvest = serving.tick()
    # Every host harvested exactly its own rows, all ops sequenced.
    for port in serving.hosts:
        rows = harvest[port.host_id]
        _check(set(rows) == set(range(port.start, port.stop)),
               f"host {port.host_id} harvested {sorted(rows)}")
        for row, (n_ok, first, last) in rows.items():
            _check(n_ok == expect_n[row], f"row {row}: {rows[row]}")
            _check(last == first + n_ok - 1, f"row {row}: {rows[row]}")
    # Every family's state on every shard; each family's content
    # converged.
    states = {"seq": serving.seq_state, "map": serving.map_state,
              "text": serving.merge_state, "matrix": serving.matrix_state,
              "tree": serving.tree_state}
    for name, state in states.items():
        _check(len(state) == n_devices and all(
            _on(s, d) for s, d in zip(state, mesh.devices)),
            f"{name} state not on {n_devices} shards of {dev}")
    values = serving.map_rows()
    for row, winner in expect_last.items():
        _check(int(values[row, row % 4]) == winner, f"map row {row}")
    matrix = pmesh.tree_map(torch.from_numpy, serving.family_rows("matrix"))
    tree = pmesh.tree_map(torch.from_numpy, serving.family_rows("tree"))
    texts, grids, orders = {}, {}, {}
    for row in range(serving.num_docs):
        family = FAMILIES[row % 4]
        if family == "text":
            texts[row] = serving.text_of(row)
            _check(texts[row] == "hello world", f"text row {row}")
        elif family == "matrix":
            grids[row] = mxk.materialize_grid(matrix, row,
                                              {i: i for i in range(64)})
            _check(grids[row][0][1] == 42, f"matrix row {row}")
        elif family == "tree":
            orders[row] = tk.trait_order(tree, row, 0, 1)
            _check(list(orders[row]) == [1], f"tree row {row}")
    metrics = serving.global_metrics()
    # Every doc sequenced its join + its family batch.
    _check(metrics["seq"] >= sum(expect_n.values()) + serving.num_docs,
           f"global seq {metrics['seq']}")
    _check(metrics["present"] == len(expect_last),  # one live key a map doc
           f"global present {metrics['present']}")

    return {
        "tick": {"outputs": gathered, "total_seq": total_seq},
        "seg": {"merge_state": pmesh.gather_rows([sharded])},
        "serving": {"harvest": harvest, "map_rows": values, "texts": texts,
                    "grids": grids, "tree_orders": orders,
                    "global_metrics": metrics,
                    "states": {name: serving.family_rows(name)
                               for name in states}},
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' runs "
                             "the kernels' plain versions)")
    parser.add_argument("--shards", type=int, default=8,
                        help="virtual shards of the dry run (default 8)")
    args = parser.parse_args(argv)
    fn, tick_args = entry(args.device)
    out = fn(*tick_args)
    dev = out[0].seq.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print("entry tick OK;", dev)
    dryrun_multichip(args.shards, args.device)
    print("multichip dryrun OK")


if __name__ == "__main__":
    main()
