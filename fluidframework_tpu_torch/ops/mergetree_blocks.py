"""Block-structured device merge table — the text serving table.

Port of ``fluidframework_tpu/ops/mergetree_blocks.py``. Layout
``[B, NB, Bk]``: NB blocks of Bk slots per document, document order =
block-major. Valid slots form a PACKED PREFIX of each block
(``blk_count``); per-block summary planes ``[B, NB]`` carry

  * ``blk_count``    — occupied slots (live + in-window tombstones),
  * ``blk_live_len`` — summed length of live (never-removed) slots,
  * ``blk_max_seq``  — newest visibility-affecting seq in the block,
  * ``blk_tomb``     — tombstone count (rebalance pressure signal).

Per op, position resolution is two-level: a block whose
``blk_max_seq <= ref_seq`` is COLD and contributes ``blk_live_len``
verbatim to the block prefix, a hot block its visible-length sum; a slot's
position is its block's prefix plus its within-block prefix. Splits and
placements shift ONE block.

:func:`apply_tick_blocks` is the plain version of the block merge tick
kernel (``csrc/mergetree_blocks.cu`` via :mod:`.mergetree_blocks_cuda`):
a Python loop over the tick's K ops, each op vectorised over documents,
the per-doc block read/write a gather and scatter by each doc's block
index. Semantics are the sequential split/split/place/mark/annotate
composition; an op that overflows its target block reverts entirely,
records its index in the sticky per-doc ``ovf``, and every later op of the
doc is inert (the serving host replays the tail through the flat table).

The rebalance ladder (:func:`maybe_rebalance_stats`: incremental spill of
overfull blocks into their neighbours, or the full zamboni + uniform
redistribution) runs after the tick as plain tensor code, as the reference
runs it as plain XLA outside its kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from . import mergetree_kernel as mtk
from .mergetree_runs import _spread_right

I32 = torch.int32
NONE_SEQ = mtk.NONE_SEQ
MT_INSERT = mtk.MT_INSERT
MT_REMOVE = mtk.MT_REMOVE

#: "no overflow" sentinel for the per-doc first-overflow op index.
OVF_NONE = np.int32(2**31 - 1)

_SLOT_PLANES = ("length", "ins_seq", "ins_client", "rem_seq",
                "rem_client", "pool_start")
_SUMM = ("blk_count", "blk_live_len", "blk_max_seq", "blk_tomb")
_FILL = {"length": 0, "ins_seq": 0, "ins_client": -1,
         "rem_seq": int(NONE_SEQ), "rem_client": -1, "pool_start": 0,
         "rem_overlap": 0, "prop_val": 0}


class BlockMergeState(NamedTuple):
    """Two-level segment table. Slot planes [B, NB, Bk] (+trailing P/W
    axes, matching MergeState field order); summaries [B, NB]."""

    length: torch.Tensor       # i32[B, NB, Bk]
    ins_seq: torch.Tensor
    ins_client: torch.Tensor
    rem_seq: torch.Tensor      # NONE_SEQ = live
    rem_client: torch.Tensor
    rem_overlap: torch.Tensor  # i32[B, NB, Bk, W]
    pool_start: torch.Tensor
    prop_val: torch.Tensor     # i32[B, NB, Bk, P]
    blk_count: torch.Tensor    # i32[B, NB] occupied (packed prefix)
    blk_live_len: torch.Tensor  # i32[B, NB] sum of live slots' length
    blk_max_seq: torch.Tensor  # i32[B, NB] newest ins/rem seq (0 = none)
    blk_tomb: torch.Tensor     # i32[B, NB] tombstone count
    count: torch.Tensor        # i32[B] total occupied slots


def init_state(num_docs: int, num_blocks: int, block_slots: int,
               num_props: int = 4, overlap_words: int = 1,
               device: str | torch.device | None = None) -> BlockMergeState:
    dev = resolve_device(device)
    b, nb, bk = num_docs, num_blocks, block_slots
    shapes = dict(rem_overlap=(b, nb, bk, max(1, overlap_words)),
                  prop_val=(b, nb, bk, num_props), count=(b,),
                  **{f: (b, nb) for f in _SUMM})
    return BlockMergeState(**{
        f: torch.full(shapes.get(f, (b, nb, bk)), _FILL.get(f, 0),
                      dtype=I32, device=dev)
        for f in BlockMergeState._fields})


# -- per-op frame math (per-doc scalars are [B] vectors) ----------------------


def _c3(x: torch.Tensor) -> torch.Tensor:
    return x[:, None, None]


def _excl_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim, dtype=I32) - x


def _overlap_bit(overlap: torch.Tensor, client: torch.Tensor
                 ) -> torch.Tensor:
    """client's remover bit per slot: [B, NB, Bk, W], [B] → [B, NB, Bk]."""
    b, nb, bk, w = overlap.shape
    c = client.clamp(0, mtk.OVERLAP_WORD_BITS * w - 1)
    word = (c >> 5).long()[:, None, None, None].expand(b, nb, bk, 1)
    sel = overlap.gather(3, word)[..., 0]
    return (sel >> _c3(c & 31)) & 1


def _frame(p: dict, overlap, summ: dict, ref, client):
    """(occupied, vis, gcum) for one (ref, client) frame: the block prefix
    of per-block visible lengths (``blk_live_len`` verbatim for cold
    blocks) plus the within-block prefix."""
    bk = p["length"].shape[2]
    iota = torch.arange(bk, dtype=I32, device=ref.device)[None, None, :]
    occ = iota < summ["blk_count"][:, :, None]
    ins_vis = occ & ((p["ins_seq"] <= _c3(ref))
                     | (p["ins_client"] == _c3(client)))
    removed_vis = ((p["rem_seq"] != NONE_SEQ)
                   & ((p["rem_seq"] <= _c3(ref))
                      | (p["rem_client"] == _c3(client))
                      | (_overlap_bit(overlap, client) == 1)))
    vis = torch.where(ins_vis & ~removed_vis, p["length"], 0)
    hot = summ["blk_max_seq"] > ref[:, None]
    bvl = torch.where(hot, vis.sum(dim=2, dtype=I32), summ["blk_live_len"])
    gcum = _excl_cumsum(bvl, 1)[:, :, None] + _excl_cumsum(vis, 2)
    return occ, vis, gcum


def _first_slot(mask: torch.Tensor):
    """(block [B], slot [B], has [B]) of the first True in document order
    (block-major); block = NB and slot = 0 when there is none."""
    _b, nb, bk = mask.shape
    flat = torch.arange(nb * bk, dtype=I32, device=mask.device).view(
        1, nb, bk)
    f = torch.where(mask, flat, nb * bk).amin(dim=(1, 2))
    blk = torch.div(f, bk, rounding_mode="floor")
    return blk, f - blk * bk, f < nb * bk


def _at(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sum of x over the True slots of mask ([B]) — the value at the
    single True when there is one."""
    return torch.where(mask, x, 0).sum(dim=(1, 2), dtype=I32)


def _summ_at(col: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
    nb_i = torch.arange(col.shape[1], device=col.device)[None]
    return torch.where(nb_i == blk[:, None], col, 0).sum(dim=1, dtype=I32)


def _summ_add(col: torch.Tensor, blk: torch.Tensor, delta) -> torch.Tensor:
    nb_i = torch.arange(col.shape[1], device=col.device)[None]
    return torch.where(nb_i == blk[:, None], col + delta, col)


def _block_update(p: dict, prop, overlap, blk: torch.Tensor, edit):
    """Gather block ``blk`` (clamped into range, as a dynamic slice is) of
    every slot plane, run ``edit`` on the [B, Bk(, F)] blocks, scatter
    them back into copies of the planes."""
    nb = prop.shape[1]
    rows = torch.arange(blk.shape[0], device=blk.device)
    bsel = blk.clamp(max=nb - 1).long()
    blocks = ({n: x[rows, bsel] for n, x in p.items()},
              prop[rows, bsel], overlap[rows, bsel])
    new_p, new_prop, new_over = edit(*blocks)

    def put(x, v):
        x = x.clone()
        x[rows, bsel] = v
        return x
    return ({n: put(p[n], v) for n, v in new_p.items()},
            put(prop, new_prop), put(overlap, new_over))


def _shift_right(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Within-block shift by one where ``shift`` [B, Bk] is set."""
    cond = shift if x.ndim == 2 else shift[:, :, None]
    return torch.where(cond, torch.roll(x, 1, 1), x)


def _split_at(p, prop, overlap, summ, count, pos, ref, client, act):
    """Interior split at visible position ``pos``. Returns the updated
    arrays + overflow [B]."""
    bk = p["length"].shape[2]
    _occ, vis, gcum = _frame(p, overlap, summ, ref, client)
    inside = (gcum < _c3(pos)) & (_c3(pos) < gcum + vis)
    blk, i, has = _first_slot(inside)
    off = pos - _at(inside, gcum)
    want = act & has
    room = _summ_at(summ["blk_count"], blk) < bk
    overflow = want & ~room
    do = want & room
    head_removed = _at(inside, (p["rem_seq"] != NONE_SEQ).to(I32))

    def edit(planes, bprop, bover):
        bk_i = torch.arange(bk, dtype=I32, device=pos.device)[None]
        shift = do[:, None] & (bk_i >= (i + 1)[:, None])
        is_head = do[:, None] & (bk_i == i[:, None])
        is_tail = do[:, None] & (bk_i == (i + 1)[:, None])
        out = {n: _shift_right(x, shift) for n, x in planes.items()}
        o = off[:, None]
        out["length"] = torch.where(
            is_head, o, torch.where(is_tail, out["length"] - o,
                                    out["length"]))
        out["pool_start"] = torch.where(is_tail, out["pool_start"] + o,
                                        out["pool_start"])
        return out, _shift_right(bprop, shift), _shift_right(bover, shift)

    p, prop, overlap = _block_update(p, prop, overlap, blk, edit)
    summ = dict(summ)
    summ["blk_count"] = _summ_add(summ["blk_count"], blk, do[:, None].to(I32))
    summ["blk_tomb"] = _summ_add(summ["blk_tomb"], blk,
                                 torch.where(do, head_removed, 0)[:, None])
    # Live length is split-invariant (head off + tail len-off), as is
    # blk_max_seq (both halves copy the parent's seqs).
    return p, prop, overlap, summ, count + do.to(I32), overflow


def _place(p, prop, overlap, summ, count, frame, op, act):
    """Insert placement at an existing boundary: first doc-order slot with
    gcum == pos that is not an acked-dead tombstone; else append at the
    document end (the last occupied block's tail, spilling into the next
    block)."""
    _b, nb, bk = p["length"].shape
    occ, _vis, gcum = frame
    dev = count.device
    dead = (p["rem_seq"] != NONE_SEQ) & (p["rem_seq"] <= _c3(op["ref_seq"]))
    cand = occ & ~dead & (gcum == _c3(op["pos"]))
    b_c, i_c, hasc = _first_slot(cand)
    nb_i = torch.arange(nb, dtype=I32, device=dev)[None]
    last = torch.where(summ["blk_count"] > 0, nb_i, 0).amax(dim=1)
    last_fill = _summ_at(summ["blk_count"], last)
    full = last_fill >= bk
    b_a = torch.where(full, last + 1, last)
    i_a = torch.where(full, 0, last_fill)
    no_spill = full & (last + 1 >= nb)
    blk = torch.where(hasc, b_c, b_a)
    i = torch.where(hasc, i_c, i_a)
    room = (_summ_at(summ["blk_count"], blk) < bk) & (blk < nb)
    overflow = act & (~room | (~hasc & no_spill))
    do = act & ~overflow

    # The fresh segment lands AT slot i: slots >= i+1 read their left
    # neighbour — matching the flat table's placement index.
    def edit(planes, bprop, bover):
        bk_i = torch.arange(bk, dtype=I32, device=dev)[None]
        shift = do[:, None] & (bk_i >= (i + 1)[:, None])
        is_new = do[:, None] & (bk_i == i[:, None])
        fresh = {"length": op["text_len"][:, None],
                 "ins_seq": op["seq"][:, None],
                 "ins_client": op["client"][:, None],
                 "rem_seq": int(NONE_SEQ), "rem_client": -1,
                 "pool_start": op["pool_start"][:, None]}
        out = {n: torch.where(is_new, fresh[n], _shift_right(x, shift))
               for n, x in planes.items()}
        new3 = is_new[:, :, None]
        return (out, torch.where(new3, 0, _shift_right(bprop, shift)),
                torch.where(new3, 0, _shift_right(bover, shift)))

    p, prop, overlap = _block_update(p, prop, overlap, blk, edit)
    summ = dict(summ)
    do1 = do[:, None]
    summ["blk_count"] = _summ_add(summ["blk_count"], blk, do1.to(I32))
    summ["blk_live_len"] = _summ_add(
        summ["blk_live_len"], blk, torch.where(do1, op["text_len"][:, None],
                                               0))
    summ["blk_max_seq"] = torch.where(
        (nb_i == blk[:, None]) & do1,
        torch.maximum(summ["blk_max_seq"], op["seq"][:, None]),
        summ["blk_max_seq"])
    return p, prop, overlap, summ, count + do.to(I32), overflow


def _range(frame, op, act) -> torch.Tensor:
    _occ, vis, gcum = frame
    return (_c3(act) & (vis > 0) & (gcum >= _c3(op["pos"]))
            & (gcum < _c3(op["end"])))


def _mark(p, overlap, summ, frame, op, act):
    """markRangeRemoved over [pos, end): the earliest remove owns rem_seq,
    concurrent removers join the overlap bitmask."""
    in_range = _range(frame, op, act)
    fresh = in_range & (p["rem_seq"] == NONE_SEQ)
    again = in_range & (p["rem_seq"] != NONE_SEQ)
    bits = mtk._overlap_mask(op["client"][:, None], overlap.shape[3])
    p = dict(p)
    p["rem_seq"] = torch.where(fresh, _c3(op["seq"]), p["rem_seq"])
    p["rem_client"] = torch.where(fresh, _c3(op["client"]), p["rem_client"])
    overlap = torch.where(again[..., None], overlap | bits[:, None, None, :],
                          overlap)
    summ = dict(summ)
    n_fresh = fresh.sum(dim=2, dtype=I32)
    summ["blk_live_len"] = summ["blk_live_len"] - torch.where(
        fresh, p["length"], 0).sum(dim=2, dtype=I32)
    summ["blk_tomb"] = summ["blk_tomb"] + n_fresh
    summ["blk_max_seq"] = torch.where(
        n_fresh > 0, torch.maximum(summ["blk_max_seq"], op["seq"][:, None]),
        summ["blk_max_seq"])
    # Overlap joins never touch the summaries: an "again" slot is visible
    # in this frame, so its block is already hot for every frame its
    # overlap bit could matter to.
    return p, overlap, summ


def _annotate(prop, frame, op, act):
    """LWW property write over [pos, end) (seq order ⇒ plain overwrite;
    value 0 deletes). Never changes visibility: no summary edits."""
    in_range = _range(frame, op, act)
    keys = torch.arange(prop.shape[3], dtype=I32,
                        device=prop.device)[None, None, None, :]
    write = in_range[..., None] & (keys == op["prop_key"][:, None, None,
                                                          None])
    return torch.where(write, op["prop_val"][:, None, None, None], prop)


def block_apply_doc(p, prop, overlap, summ, count, ovf, op, op_index):
    """One sequenced op on every document's block table: split, split,
    then place (insert), mark (remove) or annotate. Atomic per doc: an
    op whose target block is full reverts entirely, records
    ``op_index`` in the sticky ``ovf`` and gates every later op."""
    act0 = (op["valid"] != 0) & (ovf == int(OVF_NONE))
    is_ins = op["kind"] == MT_INSERT
    is_rem = op["kind"] == MT_REMOVE
    orig = (p, prop, overlap, summ, count)

    p2 = torch.where(is_ins, -1, op["end"])
    p, prop, overlap, summ, count, of1 = _split_at(
        p, prop, overlap, summ, count, op["pos"], op["ref_seq"],
        op["client"], act0)
    p, prop, overlap, summ, count, of2 = _split_at(
        p, prop, overlap, summ, count, p2, op["ref_seq"], op["client"],
        act0 & ~of1)
    ofs = of1 | of2
    # One shared frame serves place AND mark/annotate: the gates are
    # kind-disjoint, and _place only mutates insert docs' tables.
    frame = _frame(p, overlap, summ, op["ref_seq"], op["client"])
    p, prop, overlap, summ, count, of3 = _place(
        p, prop, overlap, summ, count, frame, op, act0 & ~ofs & is_ins)
    ofs = ofs | of3
    p, overlap, summ = _mark(p, overlap, summ, frame, op,
                             act0 & ~ofs & is_rem)
    prop = _annotate(prop, frame, op, act0 & ~ofs & ~is_ins & ~is_rem)

    failed = act0 & ofs

    def keep(new, old):
        cond = failed.view((-1,) + (1,) * (new.ndim - 1))
        return torch.where(cond, old, new)

    p = {n: keep(x, orig[0][n]) for n, x in p.items()}
    summ = {n: keep(x, orig[3][n]) for n, x in summ.items()}
    ovf = torch.where(failed, op_index, ovf)
    return (p, keep(prop, orig[1]), keep(overlap, orig[2]), summ,
            keep(count, orig[4]), ovf)


def apply_tick_blocks(state: BlockMergeState, ops: mtk.MergeOpBatch
                      ) -> tuple[BlockMergeState, torch.Tensor]:
    """Apply one tick of sequenced ops per document: the plain version of
    the block merge tick kernel. Returns the new state and the per-doc
    first-overflow op index ([B] i32; OVF_NONE when the whole tick
    applied). The inputs are not modified."""
    p = {n: getattr(state, n) for n in _SLOT_PLANES}
    prop, overlap = state.prop_val, state.rem_overlap
    summ = {n: getattr(state, n) for n in _SUMM}
    count = state.count
    ovf = torch.full_like(count, int(OVF_NONE))
    for k in range(mtk.last_valid(ops)):
        op = {f: getattr(ops, f)[:, k] for f in mtk.MergeOpBatch._fields}
        p, prop, overlap, summ, count, ovf = block_apply_doc(
            p, prop, overlap, summ, count, ovf, op, k)
    new = BlockMergeState(prop_val=prop, rem_overlap=overlap, count=count,
                          **p, **summ)
    return BlockMergeState(*(t.clone() if t is u else t
                             for t, u in zip(new, state))), ovf


# -- flat-layout bridge --------------------------------------------------------


def _occupied(state: BlockMergeState) -> torch.Tensor:
    bk = state.length.shape[2]
    iota = torch.arange(bk, dtype=I32, device=state.count.device)
    return iota[None, None, :] < state.blk_count[:, :, None]


def flat_view(state: BlockMergeState) -> mtk.MergeState:
    """The gapped flat [B, S] view (S = NB*Bk, document order preserved;
    block tails appear as invalid slots). ``count`` is total occupied, NOT
    a high-water mark, so don't feed it to the flat apply path."""
    b, nb, bk = state.length.shape
    valid = _occupied(state).reshape(b, nb * bk)

    def rs(f):
        x = getattr(state, f)
        x = x.reshape((b, nb * bk) + x.shape[3:])
        cond = valid if x.ndim == 2 else valid[:, :, None]
        return torch.where(cond, x, _FILL[f])
    return mtk.MergeState(valid=valid, count=state.count,
                          **{f: rs(f) for f in mtk.MergeState._fields
                             if f not in ("valid", "count")})


def recompute_summaries(state: BlockMergeState) -> BlockMergeState:
    """Exact summaries from the slot planes + blk_count (the from-scratch
    rebuild; rebalance ends here)."""
    occ = _occupied(state)
    removed = occ & (state.rem_seq != NONE_SEQ)
    live = occ & ~removed
    mut_seq = torch.where(occ, torch.maximum(
        state.ins_seq, torch.where(removed, state.rem_seq, 0)), 0)
    return state._replace(
        blk_live_len=torch.where(live, state.length, 0).sum(dim=2,
                                                            dtype=I32),
        blk_max_seq=mut_seq.amax(dim=2),
        blk_tomb=removed.sum(dim=2, dtype=I32),
        count=state.blk_count.sum(dim=1, dtype=I32))


def from_flat(flat: mtk.MergeState, num_blocks: int) -> BlockMergeState:
    """Re-block a PACKED flat state (valid = prefix of count — compact
    output) into NB uniformly-filled blocks: slot i lands in block
    i // fill at offset i % fill with fill = ceil(count/NB)."""
    b, s = flat.length.shape
    bk = s // num_blocks
    if num_blocks * bk != s:
        raise ValueError(f"{num_blocks} blocks do not divide {s} slots")
    dev = flat.count.device
    n = flat.count
    fill = torch.clamp(-torch.div(-n, num_blocks, rounding_mode="floor"),
                       min=1)
    iota = torch.arange(s, dtype=I32, device=dev)[None]
    shift = torch.where(
        iota < n[:, None],
        (bk - fill[:, None]) * torch.div(iota, fill[:, None],
                                         rounding_mode="floor"), 0)
    names = [f for f in mtk.MergeState._fields if f not in ("valid",
                                                            "count")]
    moved = dict(zip(names, _spread_right([getattr(flat, f)
                                           for f in names], shift)))
    blk_i = torch.arange(num_blocks, dtype=I32, device=dev)[None]
    blk_count = torch.clamp(n[:, None] - blk_i * fill[:, None],
                            min=torch.zeros_like(fill[:, None]),
                            max=fill[:, None])
    occ = (torch.arange(bk, dtype=I32, device=dev)[None, None]
           < blk_count[:, :, None])

    def blocked(f):
        x = moved[f].reshape((b, num_blocks, bk) + moved[f].shape[2:])
        cond = occ if x.ndim == 3 else occ[..., None]
        return torch.where(cond, x, _FILL[f])
    zeros = torch.zeros((b, num_blocks), dtype=I32, device=dev)
    state = BlockMergeState(
        **{f: blocked(f) for f in names}, blk_count=blk_count,
        blk_live_len=zeros, blk_max_seq=zeros, blk_tomb=zeros, count=n)
    return recompute_summaries(state)


def rebalance(state: BlockMergeState, min_seq: torch.Tensor,
              coalesce: bool = False) -> BlockMergeState:
    """The block zamboni: drop tombstones at/below min_seq[B] (optionally
    coalescing adjacent acked runs), redistribute the survivors uniformly
    so every block regains Bk - ceil(count/NB) headroom, and rebuild the
    summaries from scratch."""
    nb = state.length.shape[1]
    return from_flat(mtk.compact(flat_view(state), min_seq, coalesce), nb)


# -- incremental rebalance ----------------------------------------------------
#
# The conveyor: every overfull block's excess moves one block over,
# simultaneously across all blocks (right step: a block's TAIL prepends to
# its right neighbour; left step: its HEAD appends to its left
# neighbour). The occupied slots' document order is untouched, so the
# spill is a pure re-layout. Summaries are recomputed only for the blocks
# it touched; the others keep their planes bit-identically.

#: blk_tomb pressure denominator: the deferred zamboni fires once
#: tombstones occupy >= 1/4 of a document's total block capacity.
TOMB_PRESSURE_DEN = 4


def _circ_index(amount: torch.Tensor, bk: int, sign: int) -> torch.Tensor:
    """[B, NB, Bk] source offsets of a per-block circular shift by
    ``amount`` [B, NB] (left: sign +1, right: -1) — the reference's
    log2(Bk) masked rolls, which use only the amount's low bits."""
    low = 1
    while low < bk:
        low *= 2
    off = torch.arange(bk, dtype=I32, device=amount.device)[None, None]
    return torch.remainder(off + sign * (amount & (low - 1))[:, :, None],
                           bk)


def _gather_slots(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    idx = idx.long()
    if x.ndim == 4:
        idx = idx[..., None].expand(-1, -1, -1, x.shape[3])
    return x.gather(2, idx)


def _spill_counts(c: torch.Tensor, cap: int):
    """Counts-only conveyor plan along the block axis: (counts after the
    right step, right excess e, left excess h)."""
    nb = c.shape[1]
    nb_i = torch.arange(nb, device=c.device)[None]
    e = torch.where(nb_i == nb - 1, 0, torch.clamp(c - cap, min=0))
    c1 = c - e + torch.roll(e, 1, 1)
    h = torch.where(nb_i == 0, 0, torch.clamp(c1 - cap, min=0))
    return c1, e, h


def _spill(planes: dict, c: torch.Tensor, cap: int, right: bool):
    """One conveyor step on every document. ``planes`` maps every slot
    plane name (prop/overlap included) to its tensor. Returns (planes',
    blk_count', touched [B, NB])."""
    nb, bk = c.shape[1], planes["length"].shape[2]
    nb_i = torch.arange(nb, device=c.device)[None]
    off = torch.arange(bk, dtype=I32, device=c.device)[None, None]
    if right:
        e = torch.where(nb_i == nb - 1, 0, torch.clamp(c - cap, min=0))
        keep = c - e
        a = torch.roll(e, 1, 1)  # arrivals (row 0 gets e[-1] = 0)
        touched = (e > 0) | (a > 0)
        # Arrivals: the left neighbour's tail [keep_prev, keep_prev + a)
        # lands at offsets [0, a); stayers shift right by a.
        src_other = _circ_index(torch.roll(keep, 1, 1), bk, 1)
        src_mine = _circ_index(a, bk, -1)
        first = off < a[:, :, None]
        second = ~first & (off < (a + keep)[:, :, None])
        roll = 1
    else:
        h = torch.where(nb_i == 0, 0, torch.clamp(c - cap, min=0))
        keep = c - h
        a = torch.roll(h, -1, 1)  # arrivals (last row gets h[0] = 0)
        touched = (h > 0) | (a > 0)
        # Stayers shift left by h; arrivals are the right neighbour's
        # head [0, a), landing at offsets [keep, keep + a).
        src_other = _circ_index(keep, bk, -1)
        src_mine = _circ_index(h, bk, 1)
        second = off < keep[:, :, None]
        first = ~second & (off < (keep + a)[:, :, None])
        roll = -1
    out = {}
    for name, x in planes.items():
        other = _gather_slots(torch.roll(x, roll, 1), src_other)
        mine = _gather_slots(x, src_mine)
        f, s, t = first, second, touched[:, :, None]
        if x.ndim == 4:
            f, s, t = f[..., None], s[..., None], t[..., None]
        moved = torch.where(f, other, torch.where(s, mine, _FILL[name]))
        out[name] = torch.where(t, moved, x)
    return out, keep + a, touched


def _refresh_summaries(state: BlockMergeState, touched: torch.Tensor
                       ) -> BlockMergeState:
    """Exact summaries for the touched blocks only."""
    fresh = recompute_summaries(state)
    return state._replace(**{
        f: torch.where(touched, getattr(fresh, f), getattr(state, f))
        for f in ("blk_live_len", "blk_max_seq", "blk_tomb")})


def _incremental_spill(state: BlockMergeState, tick_k: int
                       ) -> tuple[BlockMergeState, int]:
    """Right conveyor step always, left step only when the batch still has
    over-cap blocks. Returns (state', blocks touched)."""
    bk = state.length.shape[2]
    cap = bk - (2 * tick_k + 2)
    names = _SLOT_PLANES + ("prop_val", "rem_overlap")
    planes = {n: getattr(state, n) for n in names}
    planes, counts, touched = _spill(planes, state.blk_count, cap, True)
    if bool((counts > cap).any()):
        planes, counts, t_l = _spill(planes, counts, cap, False)
        touched = touched | t_l
    new = state._replace(blk_count=counts, **planes)
    return _refresh_summaries(new, touched), int(touched.sum())


def rebalance_flags(state: BlockMergeState, tick_k: int) -> torch.Tensor:
    """The maintenance ladder's three batch-wide inputs, on the device:
    i32[3] = [danger (a block above cap = Bk - (2*tick_k + 2)),
    conveyor blocked (the incremental spill cannot restore the cap),
    tombstone pressure]. Each is an any/all over the batch, so shards of
    one batch combine theirs with a max (:func:`rebalance_branch`)."""
    b, nb, bk = state.length.shape
    headroom = 2 * tick_k + 2
    cap = bk - headroom
    c = state.blk_count
    danger = (c.amax(dim=1) + headroom > bk).any()
    c1, _e, h = _spill_counts(c, cap)
    c2 = c1 - h + torch.roll(h, -1, 1)
    blocked = (c2 > cap).any()
    tomb_heavy = (state.blk_tomb.sum(dim=1, dtype=I32)
                  * TOMB_PRESSURE_DEN >= nb * bk).any()
    return torch.stack((danger, blocked, tomb_heavy)).to(I32)


def rebalance_branch(flags) -> int:
    """0 (no-op), 1 (incremental spill) or 2 (full rebalance) from the
    host copy of :func:`rebalance_flags`."""
    danger, blocked, tomb_heavy = (int(v) for v in flags)
    if not danger:
        return 0
    return 2 if blocked or tomb_heavy else 1


def apply_rebalance(state: BlockMergeState, min_seq: torch.Tensor,
                    tick_k: int, branch: int, batch_rows: int | None = None
                    ) -> tuple[BlockMergeState, int]:
    """Run the ladder's ``branch``: (state', blocks touched). A full
    rebalance touches every block of the batch (``batch_rows`` rows, this
    state's by default: a shard passes the whole batch's)."""
    b, nb, _bk = state.length.shape
    if branch == 1:
        return _incremental_spill(state, tick_k)
    if branch == 2:
        return rebalance(state, min_seq), (batch_rows or b) * nb
    return state, 0


def maybe_rebalance_stats(state: BlockMergeState, min_seq: torch.Tensor,
                          tick_k: int
                          ) -> tuple[BlockMergeState, torch.Tensor]:
    """The serving maintenance ladder after a tick, decided for the whole
    batch from the state and the tick width alone (so a replay re-decides
    identically):

      * no block above cap = Bk - (2*tick_k + 2)  → no-op,
      * over-cap blocks, conveyor plan feasible, tombstones light
                                                  → incremental spill,
      * otherwise                                 → full rebalance.

    Returns (state', rstats i32[2] = [rebalance_fired, blocks_touched]).
    The decision reads one i32[3] back to the host."""
    branch = rebalance_branch(rebalance_flags(state, tick_k).tolist())
    state, touched = apply_rebalance(state, min_seq, tick_k, branch)
    rstats = torch.tensor([int(branch > 0), touched], dtype=I32,
                          device=state.count.device)
    return state, rstats


def maybe_rebalance(state: BlockMergeState, min_seq: torch.Tensor,
                    tick_k: int) -> BlockMergeState:
    """:func:`maybe_rebalance_stats` without the stats pair."""
    return maybe_rebalance_stats(state, min_seq, tick_k)[0]


def to_flat(state: BlockMergeState, slots: int | None = None
            ) -> mtk.MergeState:
    """PACKED flat state (gaps squeezed out). ``slots`` pads/truncates the
    slot axis; callers size it to hold every occupied slot."""
    b = state.count.shape[0]
    packed = mtk.compact(flat_view(state),
                         torch.full((b,), -1, dtype=I32,
                                    device=state.count.device))
    s = packed.valid.shape[1]
    if slots is None or slots == s:
        return packed

    def fit(f):
        x = getattr(packed, f)
        if slots < s:
            return x[:, :slots].contiguous()
        pad = torch.full((b, slots - s) + x.shape[2:], mtk.FILL[f],
                         dtype=x.dtype, device=x.device)
        return torch.cat((x, pad), dim=1)
    return mtk.MergeState(count=packed.count,
                          **{f: fit(f) for f in mtk.MergeState._fields
                             if f != "count"})


# -- host helpers --------------------------------------------------------------


def bk_for_locality(tick_k: int, head_fraction: float = 0.0) -> int:
    """Lane-multiple (128) block width for a serving table: grown until a
    WORST-CASE tick (2 slots/op, all ``tick_k`` ops in one block) fits,
    then further so the hot block absorbs 1..4 ticks per spill at the
    observed head-concentration fraction (capped at 4096)."""
    worst = 2 * tick_k + 8
    bk = 128
    while bk < worst + 8:
        bk *= 2
    absorb = 1 + int(round(3 * min(1.0, max(0.0, head_fraction))))
    while bk < worst + 8 + 2 * tick_k * (absorb - 1) and bk < 4096:
        bk *= 2
    return bk


def choose_block_geometry(min_slots: int, tick_k: int = 0,
                          head_fraction: float = 0.0) -> tuple[int, int]:
    """(NB, Bk) for a serving text table admitting ``min_slots`` total
    slots with up to ``tick_k`` ops per tick."""
    worst = 2 * tick_k + 8
    bk = bk_for_locality(tick_k, head_fraction)
    return max(1, -(-min_slots // (bk - worst))), bk


def capacity_margin(state: BlockMergeState) -> np.ndarray:
    """Free slots per document (total across blocks)."""
    _b, nb, bk = state.length.shape
    return nb * bk - state.count.cpu().numpy()


def max_block_fill(state: BlockMergeState) -> np.ndarray:
    """Fullest block per document — the overflow-risk signal."""
    return state.blk_count.amax(dim=1).cpu().numpy()


def materialize(state: BlockMergeState, pool: mtk.TextPool,
                doc: int) -> str:
    """Converged text of one document (acked view)."""
    return mtk.materialize(flat_view(state), pool, doc)


def host_block_row(arrays: dict, num_blocks: int, block_slots: int
                   ) -> dict:
    """Numpy re-block of one row's FLAT plane dict (MergeState fields,
    gaps allowed) into block layout + exact summaries. Returns
    BlockMergeState fields minus the batch axis."""
    nb, bk = num_blocks, block_slots
    valid = np.asarray(arrays["valid"]).astype(bool)
    idxs = np.flatnonzero(valid)
    n = len(idxs)
    if n > nb * bk:
        raise ValueError(f"{n} occupied slots exceed {nb} x {bk} blocks")
    fill = max(1, -(-n // nb))
    out = {}
    shapes = {"prop_val": np.asarray(arrays["prop_val"]).shape[1:],
              "rem_overlap": np.asarray(arrays["rem_overlap"]).shape[1:]}
    dst_b, dst_o = np.arange(n) // fill, np.arange(n) % fill
    for name in _SLOT_PLANES + ("prop_val", "rem_overlap"):
        src = np.asarray(arrays[name])
        dst = np.full((nb, bk) + shapes.get(name, ()), _FILL[name],
                      np.int32)
        dst[dst_b, dst_o] = src[idxs]
        out[name] = dst
    blk_count = np.clip(n - np.arange(nb) * fill, 0, fill).astype(np.int32)
    occ = np.arange(bk)[None, :] < blk_count[:, None]
    removed = occ & (out["rem_seq"] != int(NONE_SEQ))
    live = occ & ~removed
    out["blk_count"] = blk_count
    out["blk_live_len"] = np.sum(np.where(live, out["length"], 0),
                                 axis=1).astype(np.int32)
    out["blk_max_seq"] = np.max(
        np.where(occ, np.maximum(out["ins_seq"],
                                 np.where(removed, out["rem_seq"], 0)),
                 0), axis=1, initial=0).astype(np.int32)
    out["blk_tomb"] = np.sum(removed, axis=1).astype(np.int32)
    out["count"] = np.int32(n)
    return out
