"""Hopper SharedMatrix ticks: the matrix op tick and the matrix step tick.

Replace ``fluidframework_tpu/ops/matrix_pallas.py:_tick_kernel`` (wrapper
``apply_tick_pallas``) and ``:_step_kernel`` (wrapper
``apply_tick_steps_pallas``). Both kernels are CUDA C++ for ``sm_90a``
(``csrc/matrix_tick.cu`` and ``csrc/matrix_steps.cu``, with the shared
device functions in ``csrc/matrix_apply.cuh`` and the merge step in
``csrc/merge_apply.cuh``): one thread block per document copies its two
permutation-vector axes and its cell row to the outputs and applies the
document's ops (or steps) in order, in place. They are bound by the bytes
they move (both axes and the cell table in and out once, the op planes
in).

:func:`apply_tick_best` and :func:`apply_tick_steps_best` launch the
kernels for CUDA tensors and run the plain versions
(:func:`.matrix_kernel.apply_tick`, :func:`.matrix_kernel.
apply_tick_steps`) only for tensors on the CPU. :data:`tick` and
:data:`steps` count each kernel's launches, in all and by shape.
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

    def reset(self) -> None:
        self.launches = 0
        self.shapes.clear()

    def add(self, shape: tuple[int, ...]) -> None:
        self.launches += 1
        self.shapes[shape] = self.shapes.get(shape, 0) + 1


#: The op tick's launches, by (B, K, S, C, W).
tick = Launches()
#: The step tick's launches, by (B, T, R, S, C, W).
steps = Launches()


def _state_names() -> tuple[str, ...]:
    return (*(f"{axis}_{f}" for axis in ("rows", "cols")
              for f in mtk.MergeState._fields),
            *(f for f in mxk.MatrixState._fields if f not in ("rows", "cols")))


#: The order in which each launcher reads its pointer array.
TICK_LAYOUT = (*_state_names(),
               *(f"op_{f}" for f in mxk.MatrixOpBatch._fields),
               *(f"o_{f}" for f in _state_names()))
STEPS_LAYOUT = (*_state_names(),
                *(f"step_{f}" for f in mxk.MatrixStepBatch._fields),
                *(f"o_{f}" for f in _state_names()), "frame")


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


def apply_tick_best(state: mxk.MatrixState, ops: mxk.MatrixOpBatch
                    ) -> mxk.MatrixState:
    """Drop-in for :func:`.matrix_kernel.apply_tick`: a new
    :class:`MatrixState`; the inputs are not modified."""
    if state.rows.length.device.type == "cpu":
        return mxk.apply_tick(state, ops)
    what = "matrix op tick"
    dev, b, s, p, w, c = _check_state(state, what)
    k = ops.kind.shape[1]
    for name in mxk.MatrixOpBatch._fields:
        _build.need(getattr(ops, name), f"{what}: op {name}",
                    torch.bool if name == "valid" else torch.int32, (b, k),
                    dev)
    out = _empty_like(state)
    _launch("matrix_tick", TICK_LAYOUT, (b, s, p, w, c, k),
            (*mxk.leaves(state), *ops, *mxk.leaves(out)), dev)
    tick.add((b, k, s, c, w))
    return out


def apply_tick_steps_best(state: mxk.MatrixState,
                          batch: mxk.MatrixStepBatch) -> mxk.MatrixState:
    """Drop-in for :func:`.matrix_kernel.apply_tick_steps`: a new
    :class:`MatrixState`; the inputs are not modified."""
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
    out = _empty_like(state)
    frame = torch.empty((b, 2, 2, s), dtype=torch.int32, device=dev)
    _launch("matrix_steps", STEPS_LAYOUT, (b, s, p, w, c, t, r),
            (*mxk.leaves(state), *batch, *mxk.leaves(out), frame), dev)
    steps.add((b, t, r, s, c, w))
    return out
