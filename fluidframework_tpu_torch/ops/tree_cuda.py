"""Hopper SharedTree tick: a tick's tree edits as one launch.

Replaces the XLA tick ``fluidframework_tpu/ops/tree_kernel.py:apply_tick``
(jitted JAX; the reference has no Pallas kernel for it). The kernel is
CUDA C++ for ``sm_90a`` (``csrc/tree_tick_smem.cu``): one warp a document
stages the document's node table in shared memory, applies its K ops in
order there (the subtree sweep a Jacobi sweep that stops at its fixed
point) and writes the row back once. Documents a block follow the slot
count alone (:func:`docs_per_block`); a document wider than the card's
per-block shared memory raises, and nothing falls back.

:func:`apply_tick_best` launches it for CUDA tensors and runs the plain
version (:func:`.tree_kernel.apply_tick`) only for tensors on the CPU.
:data:`tick` counts the launches, by (B, K, N) and by variant.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build
from . import tree_kernel as tk
from .matrix_cuda import Launches

#: The tree tick's launches, by (B, K, N).
tick = Launches()

#: The order in which the launcher reads its pointer array.
LAYOUT = (*tk.TreeState._fields,
          *(f"op_{f}" for f in tk.TreeOpBatch._fields),
          *(f"o_{f}" for f in tk.TreeState._fields),
          *tk.TreeOpOut._fields)

#: The kernel's one variant: a warp a document.
VARIANT = "warp"
#: Shared bytes a slot (``TT_SLOT_BYTES``): exists, parent, trait, rank,
#: payload and the sweep's two mark bytes.
SLOT_BYTES = 19
#: Documents a block holds at most (``TT_DOCS``), and the shared memory a
#: block is given before it holds fewer (``TT_BLOCK_BYTES``).
DOCS = 8
BLOCK_BYTES = 49152
#: 64-step words of the step mask the launch carries (``TT_STEP_WORDS``).
STEP_WORDS = 128


def doc_bytes(n: int) -> int:
    """Shared bytes one document of ``n`` slots takes, rounded to 16."""
    return (SLOT_BYTES * n + 15) // 16 * 16


def docs_per_block(n: int) -> int:
    """Documents (warps) one block holds at ``n`` slots (``tt_docs``)."""
    return max(1, min(DOCS, BLOCK_BYTES // doc_bytes(n)))


def smem_bytes(n: int) -> int:
    """Dynamic shared memory one block takes at ``n`` slots (the launcher
    refuses any other number)."""
    return docs_per_block(n) * doc_bytes(n)


def smem_limit(dev: torch.device) -> int:
    """The per-block shared-memory opt-in limit of ``dev``."""
    return _build.device_smem_limit(dev, "tree_tick_smem")


def step_words(steps: Sequence[bool] | None, k: int):
    """The launch's step mask: bit ``i & 63`` of word ``i >> 6`` is
    ``steps[i]``; None (every step sweeps) stays None."""
    if steps is None:
        return None
    if len(steps) < k:
        raise _build.KernelInputError(
            f"tree tick: {len(steps)} step flags for K = {k}")
    if k > 64 * STEP_WORDS:
        raise _build.KernelInputError(
            f"tree tick: K = {k} steps, the launch's step mask holds "
            f"{64 * STEP_WORDS}")
    bits = 0
    for i in range(k):
        if steps[i]:
            bits |= 1 << i
    n_words = (k + 63) // 64
    return (ctypes.c_uint64 * max(1, n_words))(
        *((bits >> (64 * w)) & (2 ** 64 - 1) for w in range(n_words)))


def fit_smem_bytes(n: int, limit: int) -> int:
    """:func:`smem_bytes` at ``n`` slots; raises
    :class:`~._build.KernelInputError` where one block's share passes
    ``limit`` (the card's per-block opt-in limit: past ~12,200 slots on
    an H100, where a block holds one document)."""
    nbytes = smem_bytes(n)
    if nbytes > limit:
        raise _build.KernelInputError(
            f"tree tick: a document of {n} slots takes {nbytes} bytes of "
            f"shared memory (the card has {limit})")
    return nbytes


def check_inputs(state: tk.TreeState, ops: tk.TreeOpBatch
                 ) -> tuple[int, int, int]:
    """(B, N, K) of a state and op batch the kernel takes: every plane
    contiguous, of its dtype and shape, on the state's device, and at
    least one slot; raises :class:`~._build.KernelInputError` on anything
    else."""
    what = "tree tick"
    dev = state.exists.device
    if state.exists.dim() != 2 or ops.valid.dim() != 2:
        raise _build.KernelInputError(
            f"{what}: state and ops must be [B, N] and [B, K], got "
            f"{tuple(state.exists.shape)} and {tuple(ops.valid.shape)}")
    b, n = state.exists.shape
    k = ops.valid.shape[1]
    for name, t in zip(tk.TreeState._fields, state):
        _build.need(t, f"{what}: {name}",
                    torch.bool if name == "exists" else torch.int32, (b, n),
                    dev)
    for name, t in zip(tk.TreeOpBatch._fields, ops):
        _build.need(t, f"{what}: op {name}",
                    torch.bool if name == "valid" else torch.int32, (b, k),
                    dev)
    if n < 1:
        raise _build.KernelInputError(f"{what}: no slots (N = {n})")
    return b, n, k


def apply_tick_best(state: tk.TreeState, ops: tk.TreeOpBatch,
                    steps: Sequence[bool] | None = None
                    ) -> tuple[tk.TreeState, tk.TreeOpOut]:
    """Drop-in for :func:`.tree_kernel.apply_tick`: (state', TreeOpOut) in
    new tensors; the inputs are not modified. ``steps`` is honoured as
    there: a step marked False takes the seed as its mask and never
    reports depth; None sweeps every step. A document too wide for one
    block's shared memory raises."""
    dev = state.exists.device
    if dev.type == "cpu":
        return tk.apply_tick(state, ops, steps)
    b, n, k = check_inputs(state, ops)
    if dev.type != "cuda":
        raise _build.KernelInputError(
            f"tree tick: tensors on {dev}, not CUDA or CPU")
    nbytes = fit_smem_bytes(n, smem_limit(dev))
    out = _launch(state, ops, step_words(steps, k), nbytes, dev)
    tick.add((b, k, n), VARIANT)
    return out


def _launch(state: tk.TreeState, ops: tk.TreeOpBatch, words, nbytes: int,
            dev) -> tuple[tk.TreeState, tk.TreeOpOut]:
    """One launch on ``dev``'s current stream into new output tensors."""
    b, n = state.exists.shape
    k = ops.valid.shape[1]
    out_state = tk.TreeState(*(torch.empty_like(t) for t in state))
    out = tk.TreeOpOut(*(torch.empty((b, k), dtype=torch.bool, device=dev)
                         for _ in tk.TreeOpOut._fields))
    fn = _build.bind("tree_tick_smem",
                     [ctypes.POINTER(ctypes.c_void_p), *[ctypes.c_int] * 4,
                      ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
                      ctypes.c_void_p], LAYOUT)
    with torch.cuda.device(dev):
        ptrs = [t.data_ptr() for t in (*state, *ops, *out_state, *out)]
        arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
        rc = fn(arr, b, n, k, nbytes, words,
                0 if words is None else len(words),
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "tree_tick_smem_kernel")
    return out_state, out
