"""Hopper flat merge tick: K merge-tree ops per document on the card.

Replaces ``fluidframework_tpu/ops/mergetree_pallas.py:_tick_kernel``
(per-op body ``merge_apply_vec``; wrapper ``apply_tick_pallas``). The
kernel is CUDA C++ for ``sm_90a`` in ``csrc/mergetree_flat.cu`` with the
per-op step in ``csrc/merge_apply.cuh``: one thread block per document
copies its row to the outputs and applies the document's ops in order,
in place, with block-wide prefix scans over the slot axis. It is bound by
the bytes it moves (the [B, S] table in and out once, the op planes in).

:func:`apply_tick_best` launches the kernel for CUDA tensors and runs the
plain version (:func:`.mergetree_kernel.apply_tick`) only for tensors on
the CPU. ``launches`` counts kernel launches and ``shapes`` counts them by
(B, K, S, P, W).
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

#: The order in which the launcher reads its pointer array.
LAYOUT = (*mtk.MergeState._fields,
          *(f"op_{f}" for f in mtk.MergeOpBatch._fields),
          *(f"o_{f}" for f in mtk.MergeState._fields))


def _lib():
    return _build.bind("mergetree_flat", _build.pointer_args(5), LAYOUT)


def check_ops(ops: mtk.MergeOpBatch, b: int, k: int, dev, what: str) -> None:
    for name in mtk.MergeOpBatch._fields:
        _build.need(getattr(ops, name), f"{what}: op {name}",
                    torch.bool if name == "valid" else torch.int32, (b, k),
                    dev)


def apply_tick_best(state: mtk.MergeState, ops: mtk.MergeOpBatch
                    ) -> mtk.MergeState:
    """Drop-in for :func:`.mergetree_kernel.apply_tick`: a new
    :class:`MergeState`; the inputs are not modified."""
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
    fn = _lib()
    with torch.cuda.device(dev):
        out = mtk.MergeState(*(torch.empty_like(t) for t in state))
        ptrs = [t.data_ptr() for t in (*state, *ops, *out)]
        arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
        rc = fn(arr, b, s, p, w, k, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "mergetree_flat_kernel")
    launches += 1
    shapes[(b, k, s, p, w)] = shapes.get((b, k, s, p, w), 0) + 1
    return out
