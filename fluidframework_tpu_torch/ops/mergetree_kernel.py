"""Batched merge-tree apply — the sequence CRDT on flat segment tables.

Port of ``fluidframework_tpu/ops/mergetree_kernel.py``. Reference parity:
the *sequenced* apply path of packages/dds/merge-tree/src/mergeTree.ts —
insertingWalk/breakTie:2363/2267, markRangeRemoved:2626,
annotateRange:2584 — over fixed-shape tables:

  * a document = a table of up to S segments in document order (insert
    seq/client, removal seq/client/overlap bitmask, length, text-pool
    reference, interned property slots);
  * visibility to (refSeq, client) = a mask; positions = masked prefix sums;
  * the insert walk's tie-break = the first index of a candidate mask;
  * one op = two splits and a placement, or two splits and a mark or an
    annotate, fused into ONE shift of 0, 1 or 2 slots.

:func:`apply_tick` is the plain version of the flat merge tick kernel
(``csrc/mergetree_flat.cu`` via :mod:`.mergetree_cuda`): a Python loop over
the tick's K ops, each op vectorised over the documents. Text bytes never
touch the device: ops carry (pool_start, length) into a host-side
append-only pool (:class:`TextPool`), and :func:`materialize` gathers the
surviving segments.

All planes are int32 except ``valid`` (bool). Prefix sums and reductions
are taken in int32, so they wrap exactly as the reference's do.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device

I32 = torch.int32
NONE_SEQ = np.int32(2**31 - 1)  # "not removed" sentinel

MT_INSERT = 0
MT_REMOVE = 1
MT_ANNOTATE = 2

# rem_overlap is a multi-word bitmask: W i32 planes give 32*W distinct
# client slots per document on the device path; the host grows W on
# demand and routes documents past its ceiling to the scalar engine.
OVERLAP_WORD_BITS = 32


def client_capacity(state: "MergeState") -> int:
    """Distinct client slots the state's overlap planes can track."""
    return OVERLAP_WORD_BITS * state.rem_overlap.shape[-1]


def overlap_words_for(num_clients: int) -> int:
    """Overlap words needed to track ``num_clients`` distinct writers."""
    return max(1, -(-num_clients // OVERLAP_WORD_BITS))


class MergeState(NamedTuple):
    """Per-document segment table. Axes [B, S] (+[B, S, P|W])."""

    valid: torch.Tensor      # bool — slot holds a segment
    length: torch.Tensor     # i32 character count (0 allowed transiently)
    ins_seq: torch.Tensor    # i32 insert seq
    ins_client: torch.Tensor  # i32 inserting client slot
    rem_seq: torch.Tensor    # i32 removal seq; NONE_SEQ = live
    rem_client: torch.Tensor  # i32 removing client slot (-1 none)
    rem_overlap: torch.Tensor  # i32[B, S, W] bitmask planes of extra removers
    pool_start: torch.Tensor  # i32 offset into the host text pool
    prop_val: torch.Tensor   # i32[B, S, P] interned value ids (0 = unset)
    count: torch.Tensor      # i32[B] live slot high-water mark


class MergeOpBatch(NamedTuple):
    """One tick of sequenced ops, padded to K per document. Axes [B, K]."""

    valid: torch.Tensor    # bool
    kind: torch.Tensor     # i32 MT_*
    pos: torch.Tensor      # i32 insert position / range start
    end: torch.Tensor      # i32 range end (remove/annotate)
    seq: torch.Tensor      # i32
    ref_seq: torch.Tensor  # i32
    client: torch.Tensor   # i32 client slot
    pool_start: torch.Tensor  # i32 (insert)
    text_len: torch.Tensor    # i32 (insert)
    prop_key: torch.Tensor    # i32 key slot (annotate)
    prop_val: torch.Tensor    # i32 interned value id; 0 deletes (annotate)


#: Blank value of each MergeState plane.
FILL = dict(valid=False, length=0, ins_seq=0, ins_client=-1,
            rem_seq=int(NONE_SEQ), rem_client=-1, rem_overlap=0,
            pool_start=0, prop_val=0, count=0)


def init_state(num_docs: int, num_slots: int, num_props: int = 4,
               overlap_words: int = 1,
               device: str | torch.device | None = None) -> MergeState:
    dev = resolve_device(device)
    b, s, p, w = num_docs, num_slots, num_props, max(1, overlap_words)
    shapes = dict(rem_overlap=(b, s, w), prop_val=(b, s, p), count=(b,))
    return MergeState(**{
        f: torch.full(shapes.get(f, (b, s)), FILL[f],
                      dtype=torch.bool if f == "valid" else I32, device=dev)
        for f in MergeState._fields})


# -- per-op math (per-doc scalars are [B, 1] columns) -------------------------


def _excl_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.cumsum(x, dim, dtype=I32) - x


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 when none ([B, 1]) —
    ``jnp.argmax`` of a bool row."""
    n = mask.shape[-1]
    iota = torch.arange(n, dtype=I32, device=mask.device)
    f = torch.where(mask, iota, n).amin(dim=-1, keepdim=True)
    return torch.where(f == n, 0, f)


def _overlap_bit(rem_overlap: torch.Tensor, client: torch.Tensor
                 ) -> torch.Tensor:
    """Whether ``client``'s bit is set, per slot: [B, S, W] → [B, S]. The
    sign bit is a payload bit: ``>>`` is arithmetic but ``& 1`` keeps only
    the selected bit."""
    b, s, w = rem_overlap.shape
    c = client.clamp(0, OVERLAP_WORD_BITS * w - 1)          # [B, 1]
    word = (c >> 5).long()[:, :, None].expand(b, s, 1)
    sel = rem_overlap.gather(2, word)[:, :, 0]
    return (sel >> (c & 31)) & 1


def _overlap_mask(client: torch.Tensor, num_words: int) -> torch.Tensor:
    """[B, W] words with ``client``'s bit set in its word."""
    c = client.clamp(0, OVERLAP_WORD_BITS * num_words - 1)  # [B, 1]
    words = torch.arange(num_words, dtype=I32, device=c.device)[None, :]
    one = torch.ones_like(c)
    return torch.where(words == (c >> 5), one << (c & 31), 0)


def _vis_len(s: MergeState, ref_seq, client) -> torch.Tensor:
    """Visible length per slot for (refSeq, client) — nodeLength."""
    ins_vis = s.valid & ((s.ins_seq <= ref_seq) | (s.ins_client == client))
    removed_vis = ((s.rem_seq != NONE_SEQ)
                   & ((s.rem_seq <= ref_seq) | (s.rem_client == client)
                      | (_overlap_bit(s.rem_overlap, client) == 1)))
    return torch.where(ins_vis & ~removed_vis, s.length, 0)


def _in_range(s: MergeState, op: dict) -> torch.Tensor:
    vis = _vis_len(s, op["ref_seq"], op["client"])
    cum = _excl_cumsum(vis)
    return (vis > 0) & (cum >= op["pos"]) & (cum < op["end"])


def _mark_range(s: MergeState, op: dict) -> MergeState:
    """Mark [pos, end) removed at op.seq (markRangeRemoved): the earliest
    remove owns rem_seq, concurrent removers join the overlap bitmask."""
    in_range = _in_range(s, op)
    fresh = in_range & (s.rem_seq == NONE_SEQ)
    again = in_range & (s.rem_seq != NONE_SEQ)
    bits = _overlap_mask(op["client"], s.rem_overlap.shape[-1])
    return s._replace(
        rem_seq=torch.where(fresh, op["seq"], s.rem_seq),
        rem_client=torch.where(fresh, op["client"], s.rem_client),
        rem_overlap=torch.where(again[:, :, None],
                                s.rem_overlap | bits[:, None, :],
                                s.rem_overlap))


def _annotate_range(s: MergeState, op: dict) -> MergeState:
    """LWW property write over [pos, end): ops arrive in seq order, so a
    plain overwrite is the LWW fold (value 0 deletes)."""
    in_range = _in_range(s, op)
    keys = torch.arange(s.prop_val.shape[-1], dtype=I32,
                        device=s.prop_val.device)[None, None, :]
    write = in_range[:, :, None] & (keys == op["prop_key"][:, :, None])
    return s._replace(prop_val=torch.where(
        write, op["prop_val"][:, :, None], s.prop_val))


def _apply_op(s: MergeState, op: dict) -> MergeState:
    """One sequenced op per document (``op`` fields [B, 1]): the
    reference's fused ``_apply_op`` — one shift in {0, 1, 2} over the
    planes covers both splits and the placement, then the mark or the
    annotate runs over the moved table."""
    num_slots = s.valid.shape[1]
    iota = torch.arange(num_slots, dtype=I32, device=s.length.device)[None]
    is_insert = op["kind"] == MT_INSERT
    is_remove = op["kind"] == MT_REMOVE

    vis = _vis_len(s, op["ref_seq"], op["client"])
    cum = _excl_cumsum(vis)
    p1 = op["pos"]
    p2 = torch.where(is_insert, -1, op["end"])
    in1 = (cum < p1) & (p1 < cum + vis)
    # p2 == p1 would hit the boundary the first split just created.
    in2 = (cum < p2) & (p2 < cum + vis) & (p2 != p1)
    has1 = in1.any(dim=1, keepdim=True)
    has2 = in2.any(dim=1, keepdim=True)
    i1, i2 = _first(in1), _first(in2)
    o1 = p1 - cum.gather(1, i1.long())
    o2 = p2 - cum.gather(1, i2.long())
    same = has1 & has2 & (i1 == i2)
    t1 = i1 + 1
    t2 = i2 + 1 + (has1 & (i1 <= i2)).to(I32)

    # Placement (breakTie candidate scan) on the post-first-split table.
    shift1 = has1 & (iota >= t1)

    def sh1(field):
        return torch.where(shift1, torch.roll(field, 1, 1), field)

    skip = ~s.valid | ((s.rem_seq != NONE_SEQ) & (s.rem_seq <= op["ref_seq"]))
    vis_post = torch.where(
        has1 & (iota == i1), o1,
        torch.where(has1 & (iota == t1), vis.gather(1, i1.long()) - o1,
                    sh1(vis)))
    cum_post = _excl_cumsum(vis_post)
    candidate = (cum_post == p1) & ~sh1(skip)
    has_cand = candidate.any(dim=1, keepdim=True)
    count_post = s.count[:, None] + has1.to(I32)
    tp = torch.where(has_cand, _first(candidate), count_post)

    # Final-coordinate insertion points: with an interior split the tail
    # starts AT p1, so placing at tp <= t1 pushes the tail right by one.
    t1f = torch.where(is_insert & (tp <= t1), t1 + 1, t1)
    point_b = torch.where(is_insert, tp, t2)
    gate_b = is_insert | has2
    shift = ((has1 & (iota >= t1f)).to(I32)
             + (gate_b & (iota >= point_b)).to(I32))

    def shifted(field):
        r1 = torch.roll(field, 1, 1)
        r2 = torch.roll(r1, 1, 1)
        c0, c1 = shift == 0, shift == 1
        if field.ndim == 3:
            c0, c1 = c0[:, :, None], c1[:, :, None]
        return torch.where(c0, field, torch.where(c1, r1, r2))

    is_tail1 = has1 & (iota == t1f)
    is_tail2 = ~is_insert & has2 & (iota == point_b)
    is_head1 = has1 & (iota == i1)
    head2_out = i2 + (has1 & (i1 < i2)).to(I32)
    is_head2 = ~is_insert & has2 & ~same & (iota == head2_out)
    is_placed = is_insert & (iota == tp)
    placed3 = is_placed[:, :, None]

    start_off = torch.where(is_tail2, o2, torch.where(is_tail1, o1, 0))
    end_off = torch.where(
        is_head1, o1,
        torch.where(same & is_tail1, o2,
                    torch.where(is_head2, o2, shifted(s.length))))
    moved = MergeState(
        valid=is_placed | shifted(s.valid),
        length=torch.where(is_placed, op["text_len"], end_off - start_off),
        ins_seq=torch.where(is_placed, op["seq"], shifted(s.ins_seq)),
        ins_client=torch.where(is_placed, op["client"],
                               shifted(s.ins_client)),
        rem_seq=torch.where(is_placed, int(NONE_SEQ), shifted(s.rem_seq)),
        rem_client=torch.where(is_placed, -1, shifted(s.rem_client)),
        rem_overlap=torch.where(placed3, 0, shifted(s.rem_overlap)),
        pool_start=torch.where(is_placed, op["pool_start"],
                               shifted(s.pool_start) + start_off),
        prop_val=torch.where(placed3, 0, shifted(s.prop_val)),
        count=s.count + has1[:, 0].to(I32)
        + torch.where(is_insert, 1, has2.to(I32))[:, 0])

    marked = _mark_range(moved, op)
    annotated = _annotate_range(moved, op)
    out = []
    for f, new, m, a, old in zip(MergeState._fields, moved, marked,
                                 annotated, s):
        ins, rem, valid = is_insert, is_remove, op["valid"]
        if f == "count":
            ins, rem, valid = ins[:, 0], rem[:, 0], valid[:, 0]
        elif new.ndim == 3:
            ins, rem, valid = ins[:, :, None], rem[:, :, None], \
                valid[:, :, None]
        applied = torch.where(ins, new, torch.where(rem, m, a))
        out.append(torch.where(valid, applied, old))
    return MergeState(*out)


def _op_column(ops: MergeOpBatch, k: int) -> dict:
    return {f: getattr(ops, f)[:, k:k + 1] for f in MergeOpBatch._fields}


def last_valid(ops: MergeOpBatch) -> int:
    """One past the last op index any document holds (the tick's trip
    count: later ops are all invalid, hence no-ops)."""
    cols = ops.valid.any(dim=0).nonzero()
    return int(cols.max()) + 1 if cols.numel() else 0


def apply_tick(state: MergeState, ops: MergeOpBatch) -> MergeState:
    """Apply one tick of sequenced merge-tree ops for every document: the
    plain version of the flat merge tick kernel. Returns new tensors; the
    inputs are not modified."""
    s = state
    for k in range(last_valid(ops)):
        s = _apply_op(s, _op_column(ops, k))
    return MergeState(*(t.clone() if t is u else t
                        for t, u in zip(s, state)))


def capacity_margin(state: MergeState) -> np.ndarray:
    """Free slots per document. Each op can consume up to 2 slots (split +
    place); overflow is SILENT (segments drop off the table), so the host
    checks ``capacity_margin(state) >= 2 * ops_in_tick`` first."""
    return state.valid.shape[1] - state.count.cpu().numpy()


def pack_keep(planes: list[torch.Tensor], keep: torch.Tensor
              ) -> list[torch.Tensor]:
    """Stable stream compaction along axis 1: the kept elements of each
    plane move to the front in order. Tail slots (>= kept count) hold
    unspecified values; callers mask them."""
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
    out = []
    for p in planes:
        idx = order if p.ndim == 2 else \
            order[:, :, None].expand(-1, -1, p.shape[2])
        out.append(p.gather(1, idx))
    return out


def _coalesce(s: MergeState, keep: torch.Tensor, min_seq: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The coalescing pack's (length, keep): a kept segment folds into
    its kept predecessor when both are live, inserted at/below the window,
    text-pool contiguous and property-identical; a head absorbs its whole
    chain's length (mergeTree.ts:1412)."""
    num_slots = s.valid.shape[1]
    dev = s.length.device
    iota = torch.arange(num_slots, dtype=I32, device=dev)[None]
    acked_live = (keep & (s.rem_seq == NONE_SEQ) & (s.ins_seq <= min_seq)
                  & (s.length > 0))
    # The immediate KEPT predecessor (tombstones dropped in this same pass
    # don't break adjacency).
    kept_idx = torch.where(keep, iota, -1)
    prev_idx = torch.cummax(kept_idx, dim=1).values
    prev_idx = torch.cat((torch.full_like(prev_idx[:, :1], -1),
                          prev_idx[:, :-1]), dim=1)
    gidx = prev_idx.clamp(min=0).long()
    prev_props = s.prop_val.gather(
        1, gidx[:, :, None].expand(-1, -1, s.prop_val.shape[2]))
    fold = (acked_live & (prev_idx >= 0) & acked_live.gather(1, gidx)
            & (s.pool_start == (s.pool_start + s.length).gather(1, gidx))
            & (s.prop_val == prev_props).all(dim=2))
    is_head = keep & ~fold
    w = torch.where(keep, s.length, 0)
    cum = torch.cumsum(w, 1, dtype=I32)
    excl = cum - w
    head_excl = torch.where(is_head, excl, int(NONE_SEQ))
    next_head = torch.flip(torch.cummin(torch.flip(head_excl, (1,)),
                                        dim=1).values, (1,))
    next_after = torch.cat(
        (next_head[:, 1:], torch.full_like(next_head[:, :1], int(NONE_SEQ))),
        dim=1)
    chain_end = torch.minimum(next_after, cum[:, -1:])
    length = torch.where(is_head, chain_end - excl, s.length)
    return length, is_head


def compact(state: MergeState, min_seq: torch.Tensor,
            coalesce: bool = False) -> MergeState:
    """Zamboni: drop tombstones removed at/below min_seq[B] and pack live
    slots to the front (stable order). With ``coalesce`` the pack also
    merges adjacent fully-acked live runs (see :func:`_coalesce`); run the
    host text repack first so live document order is pool-contiguous."""
    s = state
    ms = min_seq.to(device=s.length.device, dtype=I32)[:, None]
    keep = s.valid & ~((s.rem_seq != NONE_SEQ) & (s.rem_seq <= ms))
    length = s.length
    if coalesce:
        length, keep = _coalesce(s, keep, ms)
    fields = ("length", "ins_seq", "ins_client", "rem_seq", "rem_client",
              "pool_start", "prop_val", "rem_overlap")
    src = dict(s._asdict(), length=length)
    packed = dict(zip(fields, pack_keep([src[f] for f in fields], keep)))
    new_count = keep.sum(dim=1, dtype=I32)
    iota = torch.arange(s.valid.shape[1], dtype=I32, device=s.length.device)
    live = iota[None] < new_count[:, None]
    out = {f: torch.where(live if packed[f].ndim == 2 else live[:, :, None],
                          packed[f], FILL[f]) for f in fields}
    return MergeState(valid=live, count=new_count, **out)


# -- host-side helpers --------------------------------------------------------


class TextPool:
    """Append-only per-document character pool (host side)."""

    def __init__(self, num_docs: int) -> None:
        self.chunks: list[list[str]] = [[] for _ in range(num_docs)]
        self.used = [0] * num_docs

    def append(self, doc: int, text: str) -> int:
        start = self.used[doc]
        self.chunks[doc].append(text)
        self.used[doc] += len(text)
        return start

    def buffer(self, doc: int) -> str:
        return "".join(self.chunks[doc])


_OP_INT_FIELDS = ("kind", "pos", "end", "seq", "ref_seq", "client",
                  "pool_start", "text_len", "prop_key", "prop_val")


def make_merge_op_batch(ops_per_doc: list[list[dict]], num_docs: int,
                        k: int, client_slots: int | None = None,
                        device: str | torch.device | None = None
                        ) -> MergeOpBatch:
    """Encode op dicts into padded [B, K] tensors. ``client_slots`` = the
    target state's overlap-plane capacity; when given, ops referencing
    slots beyond it are rejected here rather than silently aliasing."""
    dev = resolve_device(device)
    fields = {name: np.zeros((num_docs, k), np.int32)
              for name in _OP_INT_FIELDS}
    valid = np.zeros((num_docs, k), np.bool_)
    for d, doc_ops in enumerate(ops_per_doc):
        if len(doc_ops) > k:
            raise ValueError(f"tick overflow: {len(doc_ops)} > {k}")
        for i, op in enumerate(doc_ops):
            if client_slots is not None \
                    and not 0 <= op.get("client", 0) < client_slots:
                raise ValueError(
                    f"client slot {op.get('client')} exceeds device "
                    f"overlap capacity ({client_slots}); grow overlap "
                    "words or route doc to scalar path")
            valid[d, i] = True
            for name in _OP_INT_FIELDS:
                fields[name][d, i] = op.get(name, 0)
    return MergeOpBatch(valid=torch.from_numpy(valid).to(dev),
                        **{n: torch.from_numpy(v).to(dev)
                           for n, v in fields.items()})


def materialize(state: MergeState, pool: TextPool, doc: int) -> str:
    """Final converged text of one document (acked view: everything live)."""
    valid = state.valid[doc].cpu().numpy()
    length = state.length[doc].cpu().numpy()
    rem = state.rem_seq[doc].cpu().numpy()
    start = state.pool_start[doc].cpu().numpy()
    buffer = pool.buffer(doc)
    return "".join(buffer[start[i]:start[i] + length[i]]
                   for i in range(valid.shape[0])
                   if valid[i] and rem[i] == NONE_SEQ and length[i] > 0)
