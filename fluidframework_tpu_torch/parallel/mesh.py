"""Device mesh + sharding layout for the document axis.

Port of ``fluidframework_tpu/parallel/mesh.py``. The workload's
data-parallel axis is documents: every kernel state/op array has a leading
[B] docs dimension and no cross-document dataflow, so splitting B over a
1-D mesh scales merge throughput with no collectives on the merge path.

PyTorch has no single-controller SPMD arrays, so the layout is explicit:

* a :class:`Mesh` is an ordered tuple of ``torch.device`` s plus an axis
  name, and — across processes — this process's rank in a
  ``torch.distributed`` group of ``world`` processes, each holding the same
  number of devices. A device may repeat: several shards on ``cuda:0`` form
  a *virtual* mesh (the counterpart of the reference suite's virtual CPU
  devices), which is how one card runs an n-shard program;
* a sharded state is a LIST of per-shard trees (NamedTuples of tensors),
  shard i holding the contiguous row range i of this process's rows — the
  row order of the reference's ``PartitionSpec("docs")``.

Metrics aggregation sums each shard, then the shards, then — when a
process group of more than one process is up — runs one
``all_reduce(SUM)``: the only collective in the system.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

DOCS_AXIS = "docs"
SEGS_AXIS = "segs"


class Mesh:
    """1-D mesh: this process's devices (in shard order) on one named axis,
    plus the process's place in a ``torch.distributed`` group (``rank`` of
    ``world``; ``group`` None = the default group)."""

    def __init__(self, devices, axis_name: str = DOCS_AXIS, rank: int = 0,
                 world: int = 1, group=None) -> None:
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        self.axis_names = (axis_name,)
        self.rank = rank
        self.world = world
        self.group = group

    @property
    def local_size(self) -> int:
        """Shards held by this process."""
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards across every process (the reference's
        ``mesh.devices.size``)."""
        return len(self.devices) * self.world

    def __repr__(self) -> str:
        names = ", ".join(str(d) for d in self.devices)
        return (f"Mesh(({names}), axis={self.axis_names[0]!r}, "
                f"rank={self.rank}/{self.world})")


def make_mesh(devices=None, axis_name: str = DOCS_AXIS, rank: int = 0,
              world: int = 1, group=None) -> Mesh:
    """1-D mesh over the given devices, or over every visible CUDA device
    (raises without one: pass CPU devices explicitly to run on the CPU)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "make_mesh() with no devices means every CUDA device, and "
                "torch.cuda.is_available() is False; pass CPU devices, "
                "e.g. make_mesh(['cpu'] * 8)")
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(devices, axis_name, rank, world, group)


def canonical_device(dev) -> torch.device:
    """``dev`` with its index filled in (``"cuda"`` is the current card,
    ``"cpu"`` is ``"cpu:0"``), so that two names of one device compare
    equal."""
    dev = torch.device(dev)
    if dev.index is not None:
        return dev
    if dev.type == "cuda" and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(dev.type, 0)


def mesh_kind(mesh: Mesh) -> str:
    """``"dist"`` for a mesh spanning processes, ``"stacked"`` when every
    local shard sits on one device (a virtual mesh, or one shard),
    ``"devices"`` for distinct devices in one process."""
    if mesh.world > 1:
        return "dist"
    if len({canonical_device(d) for d in mesh.devices}) == 1:
        return "stacked"
    return "devices"


def doc_sharding(mesh: Mesh) -> Mesh:
    """The reference's names for a layout: here the mesh is the layout
    (rows split by :func:`shard_bounds`, scalars held whole)."""
    return mesh


replicated = doc_sharding


def shard_bounds(mesh: Mesh, num_rows: int) -> list[tuple[int, int]]:
    """[start, stop) of each local shard within ``num_rows`` local rows."""
    n = mesh.local_size
    if num_rows % n:
        raise ValueError(f"{num_rows} rows do not divide over {n} shards")
    per = num_rows // n
    return [(i * per, (i + 1) * per) for i in range(n)]


def _is_leaf(x) -> bool:
    return x is None or isinstance(x, (torch.Tensor, np.ndarray,
                                       np.generic, int, float, bool,
                                       str, torch.dtype))


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves (tensors, arrays, scalars, None) of parallel
    trees of NamedTuples, dicts, tuples and lists."""
    first = trees[0]
    if _is_leaf(first):
        return fn(*trees)
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_map(fn, *parts)
                             for parts in zip(*trees)))
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *parts) for parts in zip(*trees))
    raise TypeError(f"not a tree node: {type(first).__name__}")


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _to(x, dev: torch.device):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.as_tensor(np.ascontiguousarray(x)).to(dev)


def shard_state(tree, mesh: Mesh) -> list:
    """Place a kernel state/op tree with the docs axis split: a list of
    per-shard trees, shard i holding rows ``shard_bounds[i]`` on
    ``mesh.devices[i]``. Leaves may be tensors or numpy arrays; every leaf
    carries the [B] leading axis."""
    rows = tree_leaves(tree)[0].shape[0]
    return [tree_map(lambda a, lo=lo, hi=hi, dev=dev: _to(a[lo:hi], dev),
                     tree)
            for (lo, hi), dev in zip(shard_bounds(mesh, rows),
                                     mesh.devices)]


def gather_rows(shards: list):
    """Host (numpy) copy of a sharded tree, shards concatenated in row
    order — the verification surface of a single process."""
    return tree_map(lambda *parts: np.concatenate(
        [p.detach().cpu().numpy() for p in parts]), *shards)


def doc_count_for_mesh(mesh: Mesh, per_device: int) -> int:
    return mesh.size * per_device


def all_reduce(mesh: Mesh, x: torch.Tensor, op: str = "sum"
               ) -> torch.Tensor:
    """``x`` reduced over the mesh's processes (identity for one process).
    The tensor goes to the group's device type for the call (a CUDA device
    for NCCL, the CPU for gloo) and comes back to ``x``'s device."""
    if mesh.world <= 1:
        return x
    import torch.distributed as dist
    backend = dist.get_backend(mesh.group)
    dev = mesh.devices[0] if backend == "nccl" else torch.device("cpu")
    y = x.to(dev).contiguous()
    dist.all_reduce(y, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX,
                           "min": dist.ReduceOp.MIN}[op], group=mesh.group)
    return y.to(x.device)


def aggregate_metrics(mesh: Mesh, tree) -> Any:
    """Sum [B]-leading metric leaves over the docs axis.

    ``tree`` is a sharded tree (the list :func:`shard_state` returns) or
    one unsharded tree. Each shard sums its rows, the shards' partial sums
    add up on the host, and a multi-process mesh all-reduces them — the
    one collective in the system (per-lambda metric counters aggregated
    off the hot path). Returns the tree of totals as CPU tensors, the same
    in every process."""
    shards = tree if isinstance(tree, list) else [tree]
    partial = [tree_map(lambda x: x.sum(dim=0).cpu(), s) for s in shards]
    dtypes = tree_map(lambda x: torch.int32 if x.dtype == torch.bool
                      else x.dtype, shards[0])
    total = tree_map(lambda dt, *xs: torch.stack(xs).sum(dim=0).to(dt),
                     dtypes, *partial)
    return tree_map(lambda x: all_reduce(mesh, x), total)
