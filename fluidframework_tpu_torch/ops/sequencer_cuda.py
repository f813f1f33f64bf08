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
    return _build.bind("sequencer_tick", _build.pointer_args(3), LAYOUT)


def process_batch_best(state: seqk.SequencerState, ops: seqk.OpBatch):
    """Drop-in for :func:`.sequencer.process_batch`: (state', tickets)."""
    global launches
    dev = state.seq.device
    if dev.type == "cpu":
        return seqk.process_batch(state, ops)
    if dev.type != "cuda":
        raise _build.KernelInputError(
            f"deli tick: tensors on {dev}, not CUDA or CPU")
    b, c = state.active.shape
    k = ops.kind.shape[1]
    for name in seqk.SequencerState._fields:
        shape = (b,) if name in ("seq", "msn", "last_sent_msn",
                                 "nack_future") else (b, c)
        _build.need(getattr(state, name), f"deli tick: {name}",
                    torch.bool if name in _BOOL_STATE else torch.int32,
                    shape, dev)
    for name in seqk.OpBatch._fields:
        _build.need(getattr(ops, name), f"deli tick: {name}",
                    torch.bool if name in _BOOL_OPS else torch.int32,
                    (b, k), dev)
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
