"""Hopper block merge tick: K merge-tree ops per document on the block table.

Replaces ``fluidframework_tpu/ops/mergetree_blocks_pallas.py:_tick_kernel``
(per-op body ``mergetree_blocks.block_apply_doc``; wrapper
``apply_tick_blocks_pallas``). Two CUDA C++ kernels for ``sm_90a``, one
thread block per document applying the document's ops in order — two-level
frames, one-block splits and placements, atomic revert of an op that
overflows its block, the sticky per-doc overflow index:

* ``csrc/mergetree_blocks_smem.cu`` (variant ``"smem"``) stages the row in
  shared memory and works there;
* ``csrc/mergetree_blocks.cu`` (variant ``"global"``) works on the row in
  global memory, for rows too large for one block's shared memory.

:func:`apply_tick_blocks_best` picks the variant by shape alone
(:func:`choose_variant`: the shared-memory bytes :func:`smem_bytes` of the
shape against the card's per-block opt-in limit), never by failure, and
runs the plain version (:func:`.mergetree_blocks.apply_tick_blocks`) only
for tensors on the CPU. ``launches`` counts kernel launches, ``shapes``
counts them by (B, K, NB, Bk, P, W) and ``variants`` by variant.
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
#: The same launches by variant.
variants: dict[str, int] = {"smem": 0, "global": 0}

#: Ints of the shared-memory kernel's header (``MTS_HEADER_INTS``).
SMEM_HEADER_INTS = 256
#: Ints of one op in shared memory (``MTS_OP_FIELDS``).
SMEM_OP_FIELDS = 11

#: The order in which the launcher reads its pointer array.
LAYOUT = (*mtb.BlockMergeState._fields,
          *(f"op_{f}" for f in mtk.MergeOpBatch._fields),
          *(f"o_{f}" for f in mtb.BlockMergeState._fields),
          "o_ovf", "scratch_vis", "scratch_wcum", "scratch_save")
#: The shared-memory launcher's order: the same without the scratch.
SMEM_LAYOUT = LAYOUT[:-3]



def smem_bytes(nb: int, bk: int, p: int, w: int, k: int) -> int:
    """Dynamic shared memory the shared-memory kernel takes per document
    of shape (NB, Bk, P, W, K): a header, the 6 + P + W slot planes, the
    four [NB] summaries, the frame's two [S] planes and [NB] block sums, a
    split record's last slot per split, and the ops (``smem_ints`` in
    ``csrc/mergetree_blocks_smem.cu``; its launcher refuses any other
    number)."""
    s, f = nb * bk, 6 + p + w
    return 4 * (SMEM_HEADER_INTS + f * s + 4 * nb + 2 * s + nb + 2 * f
                + SMEM_OP_FIELDS * k)


def choose_variant(nb: int, bk: int, p: int, w: int, k: int,
                   limit: int) -> str:
    """``"smem"`` when one document of this shape fits ``limit`` bytes of
    shared memory (the card's per-block opt-in limit; the kernel has no
    static shared memory), else ``"global"``."""
    return "smem" if smem_bytes(nb, bk, p, w, k) <= limit else "global"


def smem_limit(dev: torch.device) -> int:
    """The per-block shared-memory opt-in limit of ``dev``."""
    return _build.device_smem_limit(dev, "mergetree_blocks_smem")


def apply_tick_blocks_best(state: mtb.BlockMergeState, ops: mtk.MergeOpBatch,
                           variant: str | None = None
                           ) -> tuple[mtb.BlockMergeState, torch.Tensor]:
    """Drop-in for :func:`.mergetree_blocks.apply_tick_blocks`: (new
    state, first-overflow op index [B]); the inputs are not modified.
    ``variant`` ("smem" or "global") overrides the choice by shape (to
    time one against the other); a row that does not fit raises."""
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
    if variant is None:
        variant = choose_variant(nb, bk, p, w, k, smem_limit(dev))
    elif variant not in variants:
        raise _build.KernelInputError(f"{what}: no variant {variant!r}")
    with torch.cuda.device(dev):
        out = mtb.BlockMergeState(*(torch.empty_like(t) for t in state))
        ovf = torch.empty((b,), dtype=torch.int32, device=dev)
        if variant == "smem":
            nbytes = smem_bytes(nb, bk, p, w, k)
            if nbytes > smem_limit(dev):
                raise _build.KernelInputError(
                    f"{what}: {nbytes} bytes of shared memory per document "
                    f"at (NB={nb}, Bk={bk}, P={p}, W={w}, K={k}) exceed "
                    f"the card's {smem_limit(dev)}")
            fn = _build.bind("mergetree_blocks_smem", _build.pointer_args(7),
                             SMEM_LAYOUT)
            tensors, ints = (*state, *ops, *out, ovf), (nbytes,)
        else:
            fn = _build.bind("mergetree_blocks", _build.pointer_args(6),
                             LAYOUT)
            vis = torch.empty((b, nb * bk), dtype=torch.int32, device=dev)
            save = torch.empty((b, 2, bk, 6 + p + w), dtype=torch.int32,
                               device=dev)
            tensors = (*state, *ops, *out, ovf, vis, torch.empty_like(vis),
                       save)
            ints = ()
        ptrs = [t.data_ptr() for t in tensors]
        arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
        rc = fn(arr, b, nb, bk, p, w, k, *ints,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "mergetree_blocks_smem_kernel" if variant == "smem"
                 else "mergetree_blocks_kernel")
    launches += 1
    key = (b, k, nb, bk, p, w)
    shapes[key] = shapes.get(key, 0) + 1
    variants[variant] += 1
    return out, ovf
