"""Hopper deli kernel: the per-op ticket machine over one tick on the card.

Replaces ``fluidframework_tpu/ops/sequencer_pallas.py:_tick_kernel`` /
``_ticket_step_vec`` (wrapper ``process_batch_pallas``). The kernel is
CUDA C++ for ``sm_90a`` in ``csrc/sequencer_tick.cu``: one thread per
document walks its K ops in order over its C client lanes, out of place.
It is bound by the bytes it moves (11 op planes in, 5 ticket planes out,
the state in and out once).

:func:`process_batch_best` launches the kernel for CUDA tensors and runs
the plain version (:func:`.sequencer.process_batch`) only for tensors on
the CPU. ``launches`` counts kernel launches and ``shapes`` counts them
by (B, K, C).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import sequencer as seqk

#: Kernel launches since the last reset (the plain CPU path never counts).
launches = 0
#: The same launches by (B, K, C).
shapes: dict[tuple[int, int, int], int] = {}

_BOOL_STATE = ("nack_future", "active", "csum", "cnack", "cevict")
_BOOL_OPS = ("valid", "has_contents", "can_summarize", "can_evict",
             "is_nack_future")


#: The order in which the launcher reads its pointer array.
LAYOUT = (*seqk.SequencerState._fields, *seqk.OpBatch._fields,
          *(f"o_{f}" for f in seqk.SequencerState._fields),
          *(f"t_{f}" for f in seqk.TicketBatch._fields))


def _lib():
    lib = _build.load("sequencer_tick")
    fn = lib.sequencer_tick_launch
    if fn.argtypes is None:
        layout = lib.sequencer_tick_layout
        layout.restype = ctypes.c_char_p
        got = tuple(layout().decode().split(","))
        if got != LAYOUT:
            raise RuntimeError(
                "csrc/sequencer_tick.cu reads its pointers in the order "
                f"{got}, the binding passes {LAYOUT}")
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _need(t: torch.Tensor, name: str, dtype, shape, dev) -> None:
    if t.device != dev or t.dtype != dtype \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"deli tick: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {dev}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def process_batch_best(state: seqk.SequencerState, ops: seqk.OpBatch):
    """Drop-in for :func:`.sequencer.process_batch`: (state', tickets)."""
    global launches
    dev = state.seq.device
    if dev.type == "cpu":
        return seqk.process_batch(state, ops)
    if dev.type != "cuda":
        raise ValueError(f"deli tick: tensors on {dev}, not CUDA or CPU")
    b, c = state.active.shape
    k = ops.kind.shape[1]
    for name in seqk.SequencerState._fields:
        shape = (b,) if name in ("seq", "msn", "last_sent_msn",
                                 "nack_future") else (b, c)
        _need(getattr(state, name), name,
              torch.bool if name in _BOOL_STATE else torch.int32, shape, dev)
    for name in seqk.OpBatch._fields:
        _need(getattr(ops, name), name,
              torch.bool if name in _BOOL_OPS else torch.int32, (b, k), dev)
    fn = _lib()
    with torch.cuda.device(dev):
        new_state = seqk.SequencerState(*(torch.empty_like(f)
                                          for f in state))
        tickets = seqk.TicketBatch(*(
            torch.empty((b, k), dtype=torch.int32, device=dev)
            for _ in seqk.TicketBatch._fields))
        ptrs = [t.data_ptr() for t in (*state, *ops, *new_state, *tickets)]
        arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
        rc = fn(arr, b, c, k, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "sequencer_tick_kernel")
    launches += 1
    shapes[(b, k, c)] = shapes.get((b, k, c), 0) + 1
    return new_state, tickets
