"""Hopper deli kernel: the per-op ticket machine over one tick on the card.

Replaces ``fluidframework_tpu/ops/sequencer_pallas.py:_tick_kernel`` /
``_ticket_step_vec`` (wrapper ``process_batch_pallas``). The kernel is
CUDA C++ for ``sm_90a`` in two variants, out of place, both bound by the
bytes they move (11 op planes in, 5 ticket planes out, the state in and
out once):

* ``"warp"``, ``csrc/sequencer_tick_warp.cu``: one warp per document, its
  client lanes in shared memory, the ops loaded 32 at a time, the MSN a
  warp reduction;
* ``"thread"``, ``csrc/sequencer_tick.cu``: one thread per document walks
  its K ops in order over its C client lanes.

:func:`deli_variant` picks one by shape alone, never by failure.
:func:`process_batch_best` launches the kernel for CUDA tensors and runs
the plain version (:func:`.sequencer.process_batch`) only for tensors on
the CPU. ``launches`` counts kernel launches, ``shapes`` counts them by
(B, K, C) and ``variants`` by variant.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from . import sequencer as seqk

#: Kernel launches since the last reset (the plain CPU path never counts).
launches = 0
#: The same launches by (B, K, C).
shapes: dict[tuple[int, int, int], int] = {}
#: The same launches by variant ("warp", "thread").
variants: dict[str, int] = {}
#: Serializes the counters' updates (hosts may launch from threads).
_count_lock = threading.Lock()

_BOOL_STATE = ("nack_future", "active", "csum", "cnack", "cevict")
_BOOL_OPS = ("valid", "has_contents", "can_summarize", "can_evict",
             "is_nack_future")


#: The order in which both launchers read their pointer array.
LAYOUT = (*seqk.SequencerState._fields, *seqk.OpBatch._fields,
          *(f"o_{f}" for f in seqk.SequencerState._fields),
          *(f"t_{f}" for f in seqk.TicketBatch._fields))

#: Documents a block of the warp variant, one warp each (``DELI_WARPS``),
#: and the shared memory a document takes per client
#: (``DELI_CLIENT_BYTES``: three int planes and four byte planes).
WARP_DOCS = 4
WARP_CLIENT_BYTES = 16
#: The fewest client lanes at which the warp variant is picked. On the map
#: path's recorded ticks at (B, K, C) = (10,240, 4, 5) the one-thread
#: kernel took 0.0160 ms and the warp one 0.0205 (many documents with few
#: ops and lanes each: one thread a document keeps more of the card busy);
#: on text path A's (1, 128, 129) the warp one took 0.0786 against 0.326
#: and on matrix path A's (1, 256, 257) 0.162 against 1.04 (chip_smoke.py,
#: device times; NVIDIA H100 80GB HBM3, 700 W). No path launches a C in
#: between, where the threshold is not measured.
WARP_MIN_C = 16


def warp_smem_bytes(c: int) -> int:
    """Dynamic shared memory a block of the warp variant takes: every
    client plane of its :data:`WARP_DOCS` documents (the launcher refuses
    any other number)."""
    return WARP_DOCS * WARP_CLIENT_BYTES * c


def deli_variant(b: int, k: int, c: int, limit: int) -> str:
    """``"warp"`` when a block's client planes fit ``limit`` bytes of
    shared memory (the card's per-block opt-in limit) and the document has
    at least :data:`WARP_MIN_C` client lanes, else ``"thread"``."""
    fits = warp_smem_bytes(c) <= limit
    return "warp" if fits and c >= WARP_MIN_C else "thread"


def smem_limit(dev: torch.device) -> int:
    """The per-block shared-memory opt-in limit of ``dev``."""
    return _build.device_smem_limit(dev, "sequencer_tick_warp")


def process_batch_best(state: seqk.SequencerState, ops: seqk.OpBatch,
                       variant: str | None = None):
    """Drop-in for :func:`.sequencer.process_batch`: (state', tickets).
    ``variant`` ("warp" or "thread") overrides the choice by shape (to
    time one against the other); a C that does not fit raises."""
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
    limit = smem_limit(dev)
    if variant is None:
        variant = deli_variant(b, k, c, limit)
    elif variant not in ("warp", "thread"):
        raise _build.KernelInputError(f"deli tick: no variant {variant!r}")
    if variant == "warp":
        nbytes = warp_smem_bytes(c)
        if nbytes > limit:
            raise _build.KernelInputError(
                f"deli tick: {c} client lanes take {nbytes} bytes of shared "
                f"memory a block (the card has {limit})")
        name, ints = "sequencer_tick_warp", (b, c, k, nbytes)
    else:
        name, ints = "sequencer_tick", (b, c, k)
    fn = _build.bind(name, _build.pointer_args(len(ints)), LAYOUT)
    with torch.cuda.device(dev):
        new_state = seqk.SequencerState(*(torch.empty_like(f)
                                          for f in state))
        tickets = seqk.TicketBatch(*(
            torch.empty((b, k), dtype=torch.int32, device=dev)
            for _ in seqk.TicketBatch._fields))
        ptrs = [t.data_ptr() for t in (*state, *ops, *new_state, *tickets)]
        arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
        rc = fn(arr, *ints, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, f"{name}_kernel")
    with _count_lock:
        launches += 1
        shapes[(b, k, c)] = shapes.get((b, k, c), 0) + 1
        variants[variant] = variants.get(variant, 0) + 1
    return new_state, tickets
