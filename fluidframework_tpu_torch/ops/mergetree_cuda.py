"""Hopper flat merge tick: K merge-tree ops per document on the card.

Replaces ``fluidframework_tpu/ops/mergetree_pallas.py:_tick_kernel``
(per-op body ``merge_apply_vec``; wrapper ``apply_tick_pallas``). Two CUDA
C++ kernels for ``sm_90a``, one thread block per document applying the
document's ops in order:

* ``csrc/mergetree_flat_smem.cu`` (variant ``"smem"``) stages the row and
  the ops in shared memory, field-major, and runs the shared-memory flat
  merge step of ``csrc/flat_smem.cuh`` (the walk the shared-memory
  SharedMatrix kernels run on their axes);
* ``csrc/mergetree_flat.cu`` (variant ``"global"``, with the per-op step
  in ``csrc/merge_apply.cuh``) copies the row to the outputs and works on
  it there, for rows too large for one block's shared memory.

Both are out of place: the inputs are never modified. Their bound is the
latency of a document's op chain, not the bytes they move.

:func:`apply_tick_best` picks the variant by shape alone
(:func:`choose_variant`: the shared-memory bytes :func:`smem_bytes` of the
shape against the card's per-block opt-in limit), never by failure, and
runs the plain version (:func:`.mergetree_kernel.apply_tick`) only for
tensors on the CPU. ``launches`` counts kernel launches, ``shapes`` counts
them by (B, K, S, P, W) and ``variants`` by variant.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import mergetree_kernel as mtk

#: Kernel launches since the last reset (the plain CPU path never counts).
launches = 0
#: The same launches by (B, K, S, P, W).
shapes: dict[tuple[int, int, int, int, int], int] = {}
#: The same launches by variant.
variants: dict[str, int] = {"smem": 0, "global": 0}

#: Ints of the shared-memory kernel's header (``MFS_HEADER_INTS``).
SMEM_HEADER_INTS = 256
#: Ints of one op in shared memory (``MFS_OP_FIELDS``).
SMEM_OP_FIELDS = 11

#: The order in which both launchers read their pointer array.
LAYOUT = (*mtk.MergeState._fields,
          *(f"op_{f}" for f in mtk.MergeOpBatch._fields),
          *(f"o_{f}" for f in mtk.MergeState._fields))

#: Each variant's source, and the ints its launcher takes after the
#: pointers (the shared-memory one also the bytes it takes).
_SOURCES = {"smem": ("mergetree_flat_smem", 6),
            "global": ("mergetree_flat", 5)}


def _lib(variant: str = "global"):
    name, n_ints = _SOURCES[variant]
    return _build.bind(name, _build.pointer_args(n_ints), LAYOUT)


def smem_bytes(s: int, p: int, w: int, k: int) -> int:
    """Dynamic shared memory the shared-memory kernel takes per document
    of shape (S, P, W, K): a header, the 7 + P + W slot planes, the walk's
    two scratch planes of S and the 11 op planes of K (``smem_ints`` in
    ``csrc/mergetree_flat_smem.cu``; its launcher refuses any other
    number)."""
    return 4 * (SMEM_HEADER_INTS + (7 + p + w) * s + 2 * s
                + SMEM_OP_FIELDS * k)


def choose_variant(s: int, p: int, w: int, k: int, limit: int) -> str:
    """``"smem"`` when one document of this shape and its ops fit
    ``limit`` bytes of shared memory (the card's per-block opt-in limit;
    the kernel has no static shared memory), else ``"global"``."""
    return "smem" if smem_bytes(s, p, w, k) <= limit else "global"


def smem_limit(dev: torch.device) -> int:
    """The per-block shared-memory opt-in limit of ``dev``."""
    return _build.device_smem_limit(dev, "mergetree_flat_smem")


def check_ops(ops: mtk.MergeOpBatch, b: int, k: int, dev, what: str) -> None:
    for name in mtk.MergeOpBatch._fields:
        _build.need(getattr(ops, name), f"{what}: op {name}",
                    torch.bool if name == "valid" else torch.int32, (b, k),
                    dev)


def apply_tick_best(state: mtk.MergeState, ops: mtk.MergeOpBatch,
                    variant: str | None = None) -> mtk.MergeState:
    """Drop-in for :func:`.mergetree_kernel.apply_tick`: a new
    :class:`MergeState`; the inputs are not modified. ``variant``
    ("smem" or "global") overrides the choice by shape (to time one
    against the other); a row that does not fit raises."""
    global launches
    dev = state.length.device
    if dev.type == "cpu":
        return mtk.apply_tick(state, ops)
    if dev.type != "cuda":
        raise _build.KernelInputError(
            f"flat merge tick: tensors on {dev}, not CUDA or CPU")
    b, s = state.length.shape
    p = state.prop_val.shape[2]
    w = state.rem_overlap.shape[2]
    k = ops.kind.shape[1]
    what = "flat merge tick"
    for name in mtk.MergeState._fields:
        shape = {"rem_overlap": (b, s, w), "prop_val": (b, s, p),
                 "count": (b,)}.get(name, (b, s))
        _build.need(getattr(state, name), f"{what}: {name}",
                    torch.bool if name == "valid" else torch.int32, shape,
                    dev)
    check_ops(ops, b, k, dev, what)
    if s < 1 or p < 1 or w < 1:
        raise _build.KernelInputError(
            f"{what}: empty axis (S={s}, P={p}, W={w})")
    if variant is None:
        variant = choose_variant(s, p, w, k, smem_limit(dev))
    elif variant not in variants:
        raise _build.KernelInputError(f"{what}: no variant {variant!r}")
    ints: tuple[int, ...] = ()
    if variant == "smem":
        nbytes = smem_bytes(s, p, w, k)
        if nbytes > smem_limit(dev):
            raise _build.KernelInputError(
                f"{what}: {nbytes} bytes of shared memory per document at "
                f"(S={s}, P={p}, W={w}, K={k}) exceed the card's "
                f"{smem_limit(dev)}")
        ints = (nbytes,)
    fn = _lib(variant)
    with torch.cuda.device(dev):
        out = mtk.MergeState(*(torch.empty_like(t) for t in state))
        ptrs = [t.data_ptr() for t in (*state, *ops, *out)]
        arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
        rc = fn(arr, b, s, p, w, k, *ints,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, f"{_SOURCES[variant][0]}_kernel")
    launches += 1
    shapes[(b, k, s, p, w)] = shapes.get((b, k, s, p, w), 0) + 1
    variants[variant] += 1
    return out
