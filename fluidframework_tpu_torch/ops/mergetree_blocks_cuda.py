"""Hopper block merge tick: K merge-tree ops per document on the block table.

Replaces ``fluidframework_tpu/ops/mergetree_blocks_pallas.py:_tick_kernel``
(per-op body ``mergetree_blocks.block_apply_doc``; wrapper
``apply_tick_blocks_pallas``). The kernel is CUDA C++ for ``sm_90a`` in
``csrc/mergetree_blocks.cu``: one thread block per document copies its
row to the outputs and applies the document's ops in order, in place —
two-level frames, one-block splits and placements, atomic revert of an
op that overflows its block, the sticky per-doc overflow index. It is
bound by the bytes it moves (the [B, NB, Bk] table and [B, NB] summaries
in and out once, the op planes in).

:func:`apply_tick_blocks_best` launches the kernel for CUDA tensors and
runs the plain version (:func:`.mergetree_blocks.apply_tick_blocks`) only
for tensors on the CPU. ``launches`` counts kernel launches and
``shapes`` counts them by (B, K, NB, Bk, P, W).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import mergetree_blocks as mtb
from . import mergetree_kernel as mtk
from .mergetree_cuda import check_ops

#: Kernel launches since the last reset (the plain CPU path never counts).
launches = 0
#: The same launches by (B, K, NB, Bk, P, W).
shapes: dict[tuple[int, ...], int] = {}

#: The order in which the launcher reads its pointer array.
LAYOUT = (*mtb.BlockMergeState._fields,
          *(f"op_{f}" for f in mtk.MergeOpBatch._fields),
          *(f"o_{f}" for f in mtb.BlockMergeState._fields),
          "o_ovf", "scratch_vis", "scratch_wcum", "scratch_save")


def _lib():
    return _build.bind("mergetree_blocks", _build.pointer_args(6), LAYOUT)


def apply_tick_blocks_best(state: mtb.BlockMergeState, ops: mtk.MergeOpBatch
                           ) -> tuple[mtb.BlockMergeState, torch.Tensor]:
    """Drop-in for :func:`.mergetree_blocks.apply_tick_blocks`: (new
    state, first-overflow op index [B]); the inputs are not modified."""
    global launches
    dev = state.length.device
    if dev.type == "cpu":
        return mtb.apply_tick_blocks(state, ops)
    if dev.type != "cuda":
        raise _build.KernelInputError(
            f"block merge tick: tensors on {dev}, not CUDA or CPU")
    b, nb, bk = state.length.shape
    p = state.prop_val.shape[3]
    w = state.rem_overlap.shape[3]
    k = ops.kind.shape[1]
    what = "block merge tick"
    for name in mtb.BlockMergeState._fields:
        shape = {"rem_overlap": (b, nb, bk, w), "prop_val": (b, nb, bk, p),
                 "count": (b,)}.get(name, (b, nb) if name in mtb._SUMM
                                    else (b, nb, bk))
        _build.need(getattr(state, name), f"{what}: {name}", torch.int32,
                    shape, dev)
    check_ops(ops, b, k, dev, what)
    if nb < 1 or bk < 1 or p < 1 or w < 1:
        raise _build.KernelInputError(
            f"{what}: empty axis (NB={nb}, Bk={bk}, P={p}, W={w})")
    fn = _lib()
    with torch.cuda.device(dev):
        out = mtb.BlockMergeState(*(torch.empty_like(t) for t in state))
        ovf = torch.empty((b,), dtype=torch.int32, device=dev)
        vis = torch.empty((b, nb * bk), dtype=torch.int32, device=dev)
        wcum = torch.empty_like(vis)
        save = torch.empty((b, 2, bk, 6 + p + w), dtype=torch.int32,
                           device=dev)
        ptrs = [t.data_ptr() for t in (*state, *ops, *out, ovf, vis, wcum,
                                       save)]
        arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
        rc = fn(arr, b, nb, bk, p, w, k,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "mergetree_blocks_kernel")
    launches += 1
    key = (b, k, nb, bk, p, w)
    shapes[key] = shapes.get(key, 0) + 1
    return out, ovf

