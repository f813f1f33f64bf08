"""Hopper SharedMatrix ticks: the matrix op tick and the matrix step tick.

Replace ``fluidframework_tpu/ops/matrix_pallas.py:_tick_kernel`` (wrapper
``apply_tick_pallas``) and ``:_step_kernel`` (wrapper
``apply_tick_steps_pallas``). The kernels are CUDA C++ for ``sm_90a``
(``csrc/matrix_tick.cu`` and ``csrc/matrix_steps.cu``, with the shared
device functions in ``csrc/matrix_apply.cuh`` and the merge step in
``csrc/merge_apply.cuh``): one thread block per document copies its two
permutation-vector axes and its cell row to the outputs and applies the
document's ops (or steps) in order, in place. Each tick has a second
variant, ``csrc/matrix_tick_smem.cu`` and ``csrc/matrix_steps_smem.cu``
(``"smem"``, their common parts in ``csrc/matrix_smem.cuh``), which
stages the document in shared memory; the global-memory kernels
(``"global"``) take documents too large for it. :func:`tick_variant` and
:func:`steps_variant` pick one by shape alone, never by failure.

:func:`apply_tick_best` and :func:`apply_tick_steps_best` launch the
kernels for CUDA tensors and run the plain versions
(:func:`.matrix_kernel.apply_tick`, :func:`.matrix_kernel.
apply_tick_steps`) only for tensors on the CPU. :data:`tick` and
:data:`steps` count each kernel's launches, in all, by shape and by
variant.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import matrix_kernel as mxk
from . import mergetree_kernel as mtk


class Launches:
    """Launches of one kernel since the last :meth:`reset` (the plain CPU
    path never counts): ``launches`` in all, ``shapes`` by launch shape."""

    def __init__(self) -> None:
        self.launches = 0
        self.shapes: dict[tuple[int, ...], int] = {}
        self.variants: dict[str, int] = {}

    def reset(self) -> None:
        self.launches = 0
        self.shapes.clear()
        self.variants.clear()

    def add(self, shape: tuple[int, ...], variant: str = "global") -> None:
        self.launches += 1
        self.shapes[shape] = self.shapes.get(shape, 0) + 1
        self.variants[variant] = self.variants.get(variant, 0) + 1


#: The op tick's launches, by (B, K, S, C, W).
tick = Launches()
#: The step tick's launches, by (B, T, R, S, C, W).
steps = Launches()


def _state_names() -> tuple[str, ...]:
    return (*(f"{axis}_{f}" for axis in ("rows", "cols")
              for f in mtk.MergeState._fields),
            *(f for f in mxk.MatrixState._fields if f not in ("rows", "cols")))


#: The order in which each launcher reads its pointer array (both op
#: tick launchers read the same).
TICK_LAYOUT = (*_state_names(),
               *(f"op_{f}" for f in mxk.MatrixOpBatch._fields),
               *(f"o_{f}" for f in _state_names()))
STEPS_LAYOUT = (*_state_names(),
                *(f"step_{f}" for f in mxk.MatrixStepBatch._fields),
                *(f"o_{f}" for f in _state_names()), "frame")
#: The shared-memory step launcher's order: the same without the frame.
STEPS_SMEM_LAYOUT = STEPS_LAYOUT[:-1]

#: Ints of the shared-memory step kernel's header (``MXS_HEADER_INTS``).
SMEM_HEADER_INTS = 256
#: Threads of the shared-memory step kernel: one prefetches each step
#: plane, so a run holds at most (256 - 12) // 5 cells.
SMEM_THREADS = 256
SMEM_MAX_RUN = (SMEM_THREADS - 12) // 5
#: The most ops one stretch of the shared-memory op tick resolves before
#: its writes (``MXT_STRETCH``), and the op planes it stages
#: (``MXT_OP_FIELDS``).
TICK_STRETCH = 64
TICK_OP_FIELDS = 13


def tick_smem_bytes(s: int, p: int, w: int, c: int, k: int) -> int:
    """Dynamic shared memory the shared-memory op tick takes per document:
    a header, both axes' 7 + P + W planes of S, the five cell planes of C,
    the walk's two scratch planes of S, the 13 op planes of K and a
    stretch's handles, matches and written entries (``smem_ints`` in
    ``csrc/matrix_tick_smem.cu``; its launcher refuses any other
    number)."""
    return 4 * (SMEM_HEADER_INTS + 2 * (7 + p + w) * s + 5 * c + 2 * s
                + TICK_OP_FIELDS * k + 4 * TICK_STRETCH)


def tick_variant(s: int, p: int, w: int, c: int, k: int, limit: int) -> str:
    """``"smem"`` when one document and its ops fit ``limit`` bytes of
    shared memory (the card's per-block opt-in limit; the kernel has no
    static shared memory), else ``"global"``."""
    return "smem" if tick_smem_bytes(s, p, w, c, k) <= limit else "global"


def steps_smem_bytes(s: int, p: int, w: int, c: int, r: int) -> int:
    """Dynamic shared memory the shared-memory step kernel takes per
    document: a header, both axes' 7 + P + W planes of S, the five cell
    planes of C, the two axes' frames (vis and cum), two step buffers and
    the run's handles, matches and written entries (``smem_ints`` in
    ``csrc/matrix_steps_smem.cu``; its launcher refuses any other
    number)."""
    return 4 * (SMEM_HEADER_INTS + 2 * (7 + p + w) * s + 5 * c + 4 * s
                + 2 * (12 + 5 * r) + 4 * r)


def steps_variant(s: int, p: int, w: int, c: int, r: int,
                  limit: int) -> str:
    """``"smem"`` when one document fits ``limit`` bytes of shared memory
    (the card's per-block opt-in limit; the kernel has no static shared
    memory) and its runs are at most :data:`SMEM_MAX_RUN` cells, else
    ``"global"``."""
    fits = steps_smem_bytes(s, p, w, c, r) <= limit and r <= SMEM_MAX_RUN
    return "smem" if fits else "global"


def smem_limit(dev: torch.device) -> int:
    """The per-block shared-memory opt-in limit of ``dev``."""
    return _build.device_smem_limit(dev, "matrix_steps_smem")


def _check_state(state: mxk.MatrixState, what: str):
    """(device, B, S, P, W, C) of a matrix state the kernels take; raises
    :class:`~._build.KernelInputError` on anything else."""
    dev = state.rows.length.device
    if dev.type != "cuda":
        raise _build.KernelInputError(
            f"{what}: tensors on {dev}, not CUDA or CPU")
    b, s = state.rows.length.shape
    p = state.rows.prop_val.shape[2]
    w = state.rows.rem_overlap.shape[2]
    c = state.cell_rh.shape[1]
    for axis in ("rows", "cols"):
        ms = getattr(state, axis)
        for name in mtk.MergeState._fields:
            shape = {"rem_overlap": (b, s, w), "prop_val": (b, s, p),
                     "count": (b,)}.get(name, (b, s))
            _build.need(getattr(ms, name), f"{what}: {axis}.{name}",
                        torch.bool if name == "valid" else torch.int32,
                        shape, dev)
    for name in mxk.MatrixState._fields[2:]:
        _build.need(getattr(state, name), f"{what}: {name}",
                    torch.bool if name == "cell_used" else torch.int32,
                    (b,) if name == "cell_count" else (b, c), dev)
    if s < 1 or p < 1 or w < 1 or c < 1:
        raise _build.KernelInputError(
            f"{what}: empty axis (S={s}, P={p}, W={w}, C={c})")
    return dev, b, s, p, w, c


def _launch(name: str, layout, ints: tuple[int, ...], tensors, dev) -> None:
    fn = _build.bind(name, _build.pointer_args(len(ints)), layout)
    with torch.cuda.device(dev):
        ptrs = [t.data_ptr() for t in tensors]
        arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
        rc = fn(arr, *ints, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, f"{name}_kernel")


def _empty_like(state: mxk.MatrixState) -> mxk.MatrixState:
    return mxk.MatrixState(
        mtk.MergeState(*(torch.empty_like(t) for t in state.rows)),
        mtk.MergeState(*(torch.empty_like(t) for t in state.cols)),
        *(torch.empty_like(t) for t in state[2:]))


def apply_tick_best(state: mxk.MatrixState, ops: mxk.MatrixOpBatch,
                    variant: str | None = None) -> mxk.MatrixState:
    """Drop-in for :func:`.matrix_kernel.apply_tick`: a new
    :class:`MatrixState`; the inputs are not modified. ``variant``
    ("smem" or "global") overrides the choice by shape (to time one
    against the other); a document that does not fit raises."""
    if state.rows.length.device.type == "cpu":
        return mxk.apply_tick(state, ops)
    what = "matrix op tick"
    dev, b, s, p, w, c = _check_state(state, what)
    k = ops.kind.shape[1]
    for name in mxk.MatrixOpBatch._fields:
        _build.need(getattr(ops, name), f"{what}: op {name}",
                    torch.bool if name == "valid" else torch.int32, (b, k),
                    dev)
    limit = smem_limit(dev)
    if variant is None:
        variant = tick_variant(s, p, w, c, k, limit)
    elif variant not in ("smem", "global"):
        raise _build.KernelInputError(f"{what}: no variant {variant!r}")
    if variant == "smem":
        nbytes = tick_smem_bytes(s, p, w, c, k)
        if nbytes > limit:
            raise _build.KernelInputError(
                f"{what}: a document at (S={s}, P={p}, W={w}, C={c}, K={k}) "
                f"takes {nbytes} bytes of shared memory (the card has "
                f"{limit})")
        name, ints = "matrix_tick_smem", (b, s, p, w, c, k, nbytes)
    else:
        name, ints = "matrix_tick", (b, s, p, w, c, k)
    out = _empty_like(state)
    _launch(name, TICK_LAYOUT, ints,
            (*mxk.leaves(state), *ops, *mxk.leaves(out)), dev)
    tick.add((b, k, s, c, w), variant)
    return out


def apply_tick_steps_best(state: mxk.MatrixState,
                          batch: mxk.MatrixStepBatch,
                          variant: str | None = None) -> mxk.MatrixState:
    """Drop-in for :func:`.matrix_kernel.apply_tick_steps`: a new
    :class:`MatrixState`; the inputs are not modified. ``variant``
    ("smem" or "global") overrides the choice by shape (to time one
    against the other); a document that does not fit raises."""
    if state.rows.length.device.type == "cpu":
        return mxk.apply_tick_steps(state, batch)
    what = "matrix step tick"
    dev, b, s, p, w, c = _check_state(state, what)
    t = batch.kind.shape[1]
    r = batch.r_valid.shape[2]
    for name in mxk.MatrixStepBatch._fields:
        run = name.startswith("r_")
        _build.need(getattr(batch, name), f"{what}: step {name}",
                    torch.bool if name in ("vec_valid", "r_valid")
                    else torch.int32, (b, t, r) if run else (b, t), dev)
    limit = smem_limit(dev)
    if variant is None:
        variant = steps_variant(s, p, w, c, r, limit)
    elif variant not in ("smem", "global"):
        raise _build.KernelInputError(f"{what}: no variant {variant!r}")
    out = _empty_like(state)
    if variant == "smem":
        if steps_variant(s, p, w, c, r, limit) != "smem":
            raise _build.KernelInputError(
                f"{what}: a document at (S={s}, P={p}, W={w}, C={c}, R={r}) "
                f"takes {steps_smem_bytes(s, p, w, c, r)} bytes of shared "
                f"memory (the card has {limit}) or more than "
                f"{SMEM_MAX_RUN} cells a run")
        _launch("matrix_steps_smem", STEPS_SMEM_LAYOUT,
                (b, s, p, w, c, t, r, steps_smem_bytes(s, p, w, c, r)),
                (*mxk.leaves(state), *batch, *mxk.leaves(out)), dev)
    else:
        frame = torch.empty((b, 2, 2, s), dtype=torch.int32, device=dev)
        _launch("matrix_steps", STEPS_LAYOUT, (b, s, p, w, c, t, r),
                (*mxk.leaves(state), *batch, *mxk.leaves(out), frame), dev)
    steps.add((b, t, r, s, c, w), variant)
    return out
