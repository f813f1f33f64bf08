"""Hopper map-fold kernel: the windowed SharedMap LWW fold on the card.

Replaces ``fluidframework_tpu/ops/map_pallas.py:_fold_kernel`` (its
``fold_words`` / ``apply_tick_words_pallas`` wrappers). Two CUDA C++
kernels for ``sm_90a``, bound by the bytes they move (4 bytes per
windowed op plus the [B, S] planes in and out), each taking a slot's last
live op after the last in-window clear:

* ``csrc/map_fold_warp.cu`` (variant ``"warp"``): one warp a document,
  several a block; 16-byte loads of the window, a 64-bit shared-memory
  ``atomicMax`` of (op index, word) per slot, no block barrier;
* ``csrc/map_fold.cu`` (variant ``"block"``): one 256-thread block a
  document, a block max-reduce of the clear and a shared ``atomicMax`` of
  op indices.

:func:`fold_words` picks the variant by shape (:func:`fold_variant`) and
runs the plain version (:func:`.map_kernel.fold_words_plain`) only for
tensors on the CPU. ``launches`` counts kernel launches, ``shapes`` counts
them by (B, K, S) and ``variants`` by variant.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build
from . import map_kernel as mk

#: Kernel launches since the last reset (the plain CPU path never counts).
launches = 0
#: The same launches by (B, K, S).
shapes: dict[tuple[int, int, int], int] = {}
#: The same launches by variant.
variants: dict[str, int] = {"warp": 0, "block": 0}

#: Serializes the counters' updates (hosts may launch from threads).
_count_lock = threading.Lock()
_P = ctypes.c_void_p
_I = ctypes.c_int
#: Each variant's source; both launchers take the same arguments.
_SOURCES = {"warp": "map_fold_warp", "block": "map_fold"}


def _lib(variant: str = "warp"):
    return _build.bind(_SOURCES[variant],
                       [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _P, _I, _P])


def fold_variant(b: int, k: int, s: int) -> str:
    """The variant a fold of shape (B, K, S) launches: ``"warp"`` at every
    shape the kernels take (1 <= S <= 1024)."""
    return "warp"


def fold_words(state: mk.MapState, words: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor, base_seq: torch.Tensor,
               variant: str | None = None) -> mk.MapState:
    """Windowed LWW fold (see :func:`.map_kernel.fold_words_plain`):
    ``words`` i32[B, K]; ``lo``/``hi``/``base_seq`` i32[B]. Returns a new
    :class:`MapState`; the inputs are not modified. ``variant`` ("warp"
    or "block") overrides the choice by shape (to time one against the
    other)."""
    global launches
    dev = words.device
    if dev.type == "cpu":
        return mk.fold_words_plain(state, words, lo, hi, base_seq)
    if dev.type != "cuda":
        raise _build.KernelInputError(
            f"map fold: tensors on {dev}, not CUDA or CPU")
    b, s = state.present.shape
    k = words.shape[1]
    if not 0 < s <= 1024:
        raise _build.KernelInputError(
            f"map fold: {s} key slots (the slot field is 10 bits, "
            "1 <= S <= 1024)")
    _build.need(words, "map fold: words", torch.int32, (b, k), dev)
    for name, t in (("lo", lo), ("hi", hi), ("base_seq", base_seq),
                    ("cleared_seq", state.cleared_seq)):
        _build.need(t, f"map fold: {name}", torch.int32, (b,), dev)
    _build.need(state.present, "map fold: present", torch.bool, (b, s), dev)
    _build.need(state.value, "map fold: value", torch.int32, (b, s), dev)
    _build.need(state.vseq, "map fold: vseq", torch.int32, (b, s), dev)
    if variant is None:
        variant = fold_variant(b, k, s)
    elif variant not in variants:
        raise _build.KernelInputError(f"map fold: no variant {variant!r}")
    fn = _lib(variant)
    with torch.cuda.device(dev):
        out = mk.MapState(*(torch.empty_like(f) for f in state))
        rc = fn(words.data_ptr(), b, k, lo.data_ptr(), hi.data_ptr(),
                base_seq.data_ptr(), state.present.data_ptr(),
                state.value.data_ptr(), state.vseq.data_ptr(),
                state.cleared_seq.data_ptr(), out.present.data_ptr(),
                out.value.data_ptr(), out.vseq.data_ptr(),
                out.cleared_seq.data_ptr(), s,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, f"{_SOURCES[variant]}_kernel")
    with _count_lock:
        launches += 1
        shapes[(b, k, s)] = shapes.get((b, k, s), 0) + 1
        variants[variant] += 1
    return out


def apply_tick_words_best(state: mk.MapState, words: torch.Tensor,
                          counts: torch.Tensor,
                          base_seq: torch.Tensor) -> mk.MapState:
    """Drop-in for :func:`.map_kernel.apply_tick_words` (window
    ``[0, counts)``)."""
    return fold_words(state, words, torch.zeros_like(counts), counts,
                      base_seq)
