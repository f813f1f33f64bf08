"""Hopper map-fold kernel: the windowed SharedMap LWW fold on the card.

Replaces ``fluidframework_tpu/ops/map_pallas.py:_fold_kernel`` (its
``fold_words`` / ``apply_tick_words_pallas`` wrappers). The kernel is
CUDA C++ for ``sm_90a`` in ``csrc/map_fold.cu``: one thread block per
document strides once over the document's op window, takes the last clear
with a block max-reduce and each slot's last live op with a shared-memory
``atomicMax``, then writes each slot once. It is bound by the bytes it
moves (4 bytes per windowed op plus the [B, S] planes in and out).

:func:`fold_words` launches the kernel for CUDA tensors and runs the plain
version (:func:`.map_kernel.fold_words_plain`) only for tensors on the
CPU. ``launches`` counts kernel launches and ``shapes`` counts them by
(B, K, S).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import map_kernel as mk

#: Kernel launches since the last reset (the plain CPU path never counts).
launches = 0
#: The same launches by (B, K, S).
shapes: dict[tuple[int, int, int], int] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("map_fold")
    fn = lib.map_fold_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _P, _I, _P]
        fn.restype = _I
    return fn


def _need(t: torch.Tensor, name: str, dtype, shape, dev) -> None:
    if t.device != dev or t.dtype != dtype \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"map fold: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {dev}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def fold_words(state: mk.MapState, words: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor, base_seq: torch.Tensor) -> mk.MapState:
    """Windowed LWW fold (see :func:`.map_kernel.fold_words_plain`):
    ``words`` i32[B, K]; ``lo``/``hi``/``base_seq`` i32[B]. Returns a new
    :class:`MapState`; the inputs are not modified."""
    global launches
    dev = words.device
    if dev.type == "cpu":
        return mk.fold_words_plain(state, words, lo, hi, base_seq)
    if dev.type != "cuda":
        raise ValueError(f"map fold: tensors on {dev}, not CUDA or CPU")
    b, s = state.present.shape
    k = words.shape[1]
    if not 0 < s <= 1024:
        raise ValueError(f"map fold: {s} key slots (the slot field is 10 "
                         "bits, 1 <= S <= 1024)")
    _need(words, "words", torch.int32, (b, k), dev)
    for name, t in (("lo", lo), ("hi", hi), ("base_seq", base_seq),
                    ("cleared_seq", state.cleared_seq)):
        _need(t, name, torch.int32, (b,), dev)
    _need(state.present, "present", torch.bool, (b, s), dev)
    _need(state.value, "value", torch.int32, (b, s), dev)
    _need(state.vseq, "vseq", torch.int32, (b, s), dev)
    fn = _lib()
    with torch.cuda.device(dev):
        out = mk.MapState(*(torch.empty_like(f) for f in state))
        rc = fn(words.data_ptr(), b, k, lo.data_ptr(), hi.data_ptr(),
                base_seq.data_ptr(), state.present.data_ptr(),
                state.value.data_ptr(), state.vseq.data_ptr(),
                state.cleared_seq.data_ptr(), out.present.data_ptr(),
                out.value.data_ptr(), out.vseq.data_ptr(),
                out.cleared_seq.data_ptr(), s,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "map_fold_kernel")
    launches += 1
    shapes[(b, k, s)] = shapes.get((b, k, s), 0) + 1
    return out


def apply_tick_words_best(state: mk.MapState, words: torch.Tensor,
                          counts: torch.Tensor,
                          base_seq: torch.Tensor) -> mk.MapState:
    """Drop-in for :func:`.map_kernel.apply_tick_words` (window
    ``[0, counts)``)."""
    return fold_words(state, words, torch.zeros_like(counts), counts,
                      base_seq)
