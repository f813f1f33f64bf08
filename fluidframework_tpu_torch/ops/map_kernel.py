"""Batched SharedMap apply — LWW key-value merge across documents, in PyTorch.

Port of ``fluidframework_tpu/ops/map_kernel.py``. Reference parity: the
sequenced-op apply path of SharedMap (packages/dds/map/src/mapKernel.ts:510
tryProcessMessage and its set/delete/clear handlers). On a *converged*
replica the totally-ordered stream reduces to last-writer-wins per key
with clear barriers, so one tick of K ops needs no sequential scan:

  1. find the last CLEAR in the tick (ops before it are dead),
  2. scatter-max the op index per key slot (winner = last key-op),
  3. gather winner kind/value; untouched slots survive unless cleared.

:func:`fold_words_plain` (and :func:`apply_tick_words`, its ``lo = 0``
case) is the plain version of the CUDA map-fold kernel
(``csrc/map_fold.cu`` via :mod:`.map_fold_cuda`).

Keys and values are interned to int32 ids host-side. Out-of-range key
slots (``slot >= S``) are ignored, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device

I32 = torch.int32

# Map op kinds (device encoding of {"set","delete","clear"}).
MAP_SET = 0
MAP_DELETE = 1
MAP_CLEAR = 2


class MapState(NamedTuple):
    """Materialized map state per document. Axes [B, S] (S = key slots)."""

    present: torch.Tensor      # bool[B, S]
    value: torch.Tensor        # i32[B, S] interned value id
    vseq: torch.Tensor         # i32[B, S] seq that set the current value
    cleared_seq: torch.Tensor  # i32[B] seq of the last applied clear (-1 none)


class MapOpBatch(NamedTuple):
    """One tick of sequenced map ops, padded to K per document. Axes [B, K]."""

    valid: torch.Tensor  # bool
    kind: torch.Tensor   # i32 MAP_*
    slot: torch.Tensor   # i32 key slot (ignored for clear)
    value: torch.Tensor  # i32 interned value id (set only)
    seq: torch.Tensor    # i32 sequence number (strictly increasing along K)


def init_state(num_docs: int, num_slots: int,
               device: str | torch.device | None = None) -> MapState:
    dev = resolve_device(device)
    b, s = num_docs, num_slots
    return MapState(
        present=torch.zeros((b, s), dtype=torch.bool, device=dev),
        value=torch.zeros((b, s), dtype=I32, device=dev),
        vseq=torch.full((b, s), -1, dtype=I32, device=dev),
        cleared_seq=torch.full((b,), -1, dtype=I32, device=dev),
    )


def _apply_doc(state: MapState, ops: MapOpBatch) -> MapState:
    """Apply one tick to every document. state fields [B, S] / [B]; ops
    fields [B, K]."""
    b, num_slots = state.present.shape
    k = ops.valid.shape[1]
    dev = state.value.device
    idxs = torch.arange(k, dtype=I32, device=dev)[None, :]

    is_clear = ops.valid & (ops.kind == MAP_CLEAR)
    last_clear = torch.where(is_clear, idxs, -1).amax(dim=1) if k else \
        torch.full((b,), -1, dtype=I32, device=dev)

    # Key ops that survive the clear barrier.
    live = ops.valid & (ops.kind != MAP_CLEAR) & (idxs > last_clear[:, None])
    # Winner per slot as a scatter-max of op indices; slots outside
    # [0, S) land in a spare column that is dropped.
    in_range = (ops.slot >= 0) & (ops.slot < num_slots)
    col = torch.where(in_range, ops.slot, num_slots).long()
    winner = torch.full((b, num_slots + 1), -1, dtype=I32, device=dev)
    winner.scatter_reduce_(1, col, torch.where(live, idxs, -1),
                           reduce="amax", include_self=True)
    winner = winner[:, :num_slots]
    has_winner = winner >= 0
    widx = winner.clamp(min=0).long()
    if k:
        w_is_set = ops.kind.gather(1, widx) == MAP_SET
        w_value = ops.value.gather(1, widx)
        w_seq = ops.seq.gather(1, widx)
        c_seq = ops.seq.gather(1, last_clear.clamp(min=0).long()[:, None])[:, 0]
    else:
        w_is_set = has_winner
        w_value = w_seq = state.value
        c_seq = state.cleared_seq

    cleared = (last_clear >= 0)[:, None]
    present = torch.where(has_winner, w_is_set, state.present & ~cleared)
    value = torch.where(has_winner & w_is_set, w_value, state.value)
    vseq = torch.where(has_winner, w_seq,
                       torch.where(cleared, -1, state.vseq))
    cleared_seq = torch.where(cleared[:, 0], c_seq, state.cleared_seq)
    return MapState(present=present, value=value, vseq=vseq,
                    cleared_seq=cleared_seq)


def apply_tick(state: MapState, ops: MapOpBatch) -> MapState:
    """Apply one tick of sequenced map ops for every document."""
    return _apply_doc(state, ops)


def decode_words(words: torch.Tensor):
    """(kind, slot, value) planes of packed op words. ``words`` holds the
    u32 words reinterpreted as int32: an arithmetic shift then the mask
    gives the same bits as the unsigned shift."""
    return words & 3, (words >> 2) & 0x3FF, (words >> 12) & 0xFFFFF


def fold_words_plain(state: MapState, words: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor, base_seq: torch.Tensor) -> MapState:
    """Windowed LWW fold: op k of row d applies when lo[d] <= k < hi[d],
    with seq = base_seq[d] + 1 + (k - lo[d]). ``words`` i32[B, K] packs
    kind(2) | slot(10) | value(20). The plain version of the CUDA
    map-fold kernel (and of the reference's Pallas ``fold_words``)."""
    k = words.shape[1]
    iota = torch.arange(k, dtype=I32, device=words.device)[None, :]
    kind, slot, value = decode_words(words)
    ops = MapOpBatch(
        valid=(iota >= lo[:, None]) & (iota < hi[:, None]),
        kind=kind, slot=slot, value=value,
        seq=base_seq[:, None] + 1 + iota - lo[:, None],
    )
    return _apply_doc(state, ops)


def apply_tick_words(state: MapState, words: torch.Tensor,
                     counts: torch.Tensor, base_seq: torch.Tensor) -> MapState:
    """Minimum-wire entry: 4 bytes/op. ``words`` i32[B, K] packing
    kind(2) | slot(10) | value(20); seq derives as base_seq + op index + 1."""
    return fold_words_plain(state, words, torch.zeros_like(counts), counts,
                            base_seq)


def make_map_op_batch(ops_per_doc: list[list[dict]], num_docs: int, k: int,
                      device: str | torch.device | None = None) -> MapOpBatch:
    """Encode python op dicts {kind, slot, value, seq} into padded tensors."""
    dev = resolve_device(device)
    valid = np.zeros((num_docs, k), np.bool_)
    kind = np.zeros((num_docs, k), np.int32)
    slot = np.zeros((num_docs, k), np.int32)
    value = np.zeros((num_docs, k), np.int32)
    seq = np.zeros((num_docs, k), np.int32)
    for d, doc_ops in enumerate(ops_per_doc):
        assert len(doc_ops) <= k, f"tick overflow: {len(doc_ops)} > {k}"
        for i, op in enumerate(doc_ops):
            valid[d, i] = True
            kind[d, i] = op["kind"]
            slot[d, i] = op.get("slot", 0)
            value[d, i] = op.get("value", 0)
            seq[d, i] = op["seq"]
    return MapOpBatch(*(torch.from_numpy(a).to(dev)
                        for a in (valid, kind, slot, value, seq)))
