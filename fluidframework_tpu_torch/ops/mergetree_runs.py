"""Run-batched merge-tree apply — within-tick op parallelism.

Port of ``fluidframework_tpu/ops/mergetree_runs.py``. The per-op tick
(:func:`.mergetree_kernel.apply_tick`, the flat merge tick kernel's plain
version) applies one op per step: the document axis is parallel, the op
axis is serial. :func:`apply_tick_runs` applies a RUN of up to R ops in
ONE composite step. The host packer (:func:`pack_runs`) groups
consecutive sequenced ops that are MUTUALLY INDEPENDENT in the tick-start
frame:

* every op's effect range, transformed back to tick-start coordinates
  (undoing earlier in-run ops' length deltas — plain sequential OT the
  host does with two integers per op), is separated from every other
  op's range by at least one character (no shared boundaries, so no
  breakTie interaction and no adjacency coalescing ambiguity);
* all vector state is acked at/below the run's lowest ref_seq (always
  true on the server-side sequenced stream), so ONE visibility frame
  serves the whole run.

Under those conditions the ops commute, and the composite apply is:

1. ONE visibility scan (vis, cum) of the tick-start table;
2. per-op split/boundary resolution as [R, S] masks;
3. a rightward unit-step SPREAD moves every original slot past the new
   slots it must make room for (:func:`_spread_cascade`);
4. new slots (split tails, placed inserts) fill via [R, S] one-hot
   writes; marks/annotates apply as [R, S] range masks in the shared
   frame, where the new inserts are invisible and coordinates are
   exactly the packer's run-start positions.

The reference is plain XLA (a ``vmap`` of a ``lax.scan``), not a Pallas
kernel, so this port is plain PyTorch over :mod:`.mergetree_kernel`'s
state: every step is vectorised over the documents and the run axis, and
:func:`apply_tick_runs` loops over the tick's steps. It is correct but
not a serving path: the composite's resolution and fill phases are
[R, S] tensors, so its elementwise work still grows with R, and the
reference records it as slower than the per-op tick. Nothing on a
serving path calls it. Differential tests pin the composite against the
per-op tick and against the reference on the same streams.

:func:`_spread_right` is the scatter form of the spread that the block
table needs (:func:`.mergetree_blocks.from_flat`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.tick_spans import host_read
from . import mergetree_kernel as mtk

I32 = torch.int32
NONE_SEQ = mtk.NONE_SEQ


class MergeRunBatch(NamedTuple):
    """One tick as T composite steps of up to R independent ops each.
    Axes [B, T, R]; positions are TICK-START-frame coordinates (the
    host packer transforms them); ``ref`` is per-step [B, T]."""

    valid: torch.Tensor       # bool[B, T, R]
    kind: torch.Tensor        # i32 MT_*
    pos: torch.Tensor         # i32 insert point / range start (frame-0)
    end: torch.Tensor         # i32 range end (frame-0; remove/annotate)
    seq: torch.Tensor         # i32
    client: torch.Tensor      # i32
    pool_start: torch.Tensor  # i32 (insert)
    text_len: torch.Tensor    # i32 (insert)
    prop_key: torch.Tensor    # i32 (annotate)
    prop_val: torch.Tensor    # i32 (annotate)
    ref: torch.Tensor         # i32[B, T] shared frame of the step


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 when none."""
    n = mask.shape[-1]
    iota = torch.arange(n, dtype=I32, device=mask.device)
    f = torch.where(mask, iota, n).amin(dim=-1)
    return torch.where(f == n, 0, f)


def _onehot_matmul(mask: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``mask`` bool[B, M, N] times ``vals`` i32[B, N, P] → i32[B, M, P],
    with the reference's arithmetic: each value splits into unsigned
    16-bit halves, the halves are summed, and the sums are recombined as
    ``(hi << 16) | lo`` in 32 bits. Where a row of ``mask`` holds at most
    one hit this is an exact read of that value (0 where none)."""
    u = vals.to(torch.int64) & 0xFFFFFFFF
    m = mask.to(torch.int64)[..., None]                     # [B, M, N, 1]
    lo = (m * (u & 0xFFFF)[:, None]).sum(dim=2)
    hi = (m * (u >> 16)[:, None]).sum(dim=2)
    out = ((hi << 16) | lo) & 0xFFFFFFFF
    return torch.where(out >= 2**31, out - 2**32, out).to(I32)


def _spread_cascade(mat: torch.Tensor, shift: torch.Tensor,
                    max_shift: int) -> torch.Tensor:
    """Move row j of ``mat`` [B, S, P] to j + shift[:, j] (``shift``
    monotone non-decreasing over the live rows, <= ``max_shift``) with
    log2(max_shift) conditional shifts, HIGH bit last — the reference's
    threshold cascade, kept step for step so that vacated slots and
    content pushed past the end come out as the reference's do.

    At stage b every element with remaining shift >= b moves right by
    exactly b. Entering stage b every remainder equals shift mod 2b, so
    an arrival onto a stationary slot would need shift(src) > shift(dst)
    for src < dst, which monotonicity rules out. The guard iota >= b
    drops content pushed past the end (the silent-overflow contract)."""
    iota = torch.arange(shift.shape[1], device=shift.device)[None, :]
    rem = shift
    b = 1
    while b * 2 <= max_shift:
        b *= 2
    while b >= 1:
        src_rem = torch.roll(rem, b, dims=1)
        arrive = (src_rem >= b) & (iota >= b)
        moved_away = rem >= b
        mat = torch.where(arrive[..., None], torch.roll(mat, b, dims=1),
                          mat)
        rem = torch.where(arrive, src_rem - b,
                          torch.where(moved_away, 0, rem))
        b //= 2
    return mat


def _apply_run(s: mtk.MergeState, step: MergeRunBatch) -> mtk.MergeState:
    """Apply one composite step (R independent ops) to every document.
    ``step`` holds [B, R] op fields and a [B] ``ref``."""
    num_slots = s.valid.shape[1]
    dev = s.valid.device
    iota = torch.arange(num_slots, dtype=I32, device=dev)
    r_axis = step.pos.shape[1]

    def tot(x, dim):
        return x.sum(dim=dim, dtype=I32)

    is_ins = step.valid & (step.kind == mtk.MT_INSERT)
    is_rem = step.valid & (step.kind == mtk.MT_REMOVE)
    is_ann = step.valid & (step.kind == mtk.MT_ANNOTATE)

    # 1. ONE shared frame for the whole run. Client -2 matches no
    # ins/rem client; the overlap-bit read degenerates to bit 0, which
    # is harmless because on the serial sequenced stream every removal
    # in the table is at/below the step ref (pack_runs enforces it), so
    # removed-visibility already resolves via rem_seq <= ref.
    ref = step.ref[:, None]
    frame_client = torch.full_like(ref, -2)
    vis = mtk._vis_len(s, ref, frame_client)                 # [B, S]
    cum = mtk._excl_cumsum(vis)

    # 2. Split events: p1 (pos) for every op, p2 (end) for range ops.
    p1 = step.pos
    p2 = torch.where(is_ins, -1, step.end)

    def interior(p):
        inside = ((cum[:, None, :] < p[:, :, None])
                  & (p[:, :, None] < (cum + vis)[:, None, :])
                  & step.valid[:, :, None])                  # [B, R, S]
        base = tot(torch.where(inside, cum[:, None, :], 0), 2)
        return inside.any(dim=2), _first(inside), p - base

    in1, seg1, off1 = interior(p1)
    in2, seg2, off2 = interior(p2)

    # Flat [2R] split-event list; inactive events park at num_slots.
    ev_on = torch.cat([in1, in2], dim=1)
    ev_seg = torch.where(ev_on, torch.cat([seg1, seg2], dim=1), num_slots)
    ev_off = torch.cat([off1, off2], dim=1)
    # Which events belong to an interior INSERT (their placed segment
    # precedes their tail piece in the layout).
    ins_ev = torch.cat([is_ins & in1, torch.zeros_like(is_ins)], dim=1)

    same = ((ev_seg[:, :, None] == ev_seg[:, None, :])
            & ev_on[:, None, :] & (ev_seg[:, :, None] < num_slots))
    ev_rank = tot(same & (ev_off[:, None, :] < ev_off[:, :, None]), 2)
    placed_leq = tot(same & ins_ev[:, None, :]
                     & (ev_off[:, None, :] <= ev_off[:, :, None]), 2)
    # One-hot of each event's segment — the "read value at parent
    # segment" primitive.
    ev_onehot = ((ev_seg[:, :, None] == iota[None, None, :])
                 & ev_on[:, :, None])                        # [B, 2R, S]

    def parent(plane):
        return tot(torch.where(ev_onehot, plane[:, None, :], 0), 2)

    # Next-higher offset within the segment (else the segment length).
    seg_len = parent(torch.where(s.valid, s.length, 0))
    higher = torch.where(same & (ev_off[:, None, :] > ev_off[:, :, None]),
                         ev_off[:, None, :], NONE_SEQ)
    ev_next = torch.minimum(higher.amin(dim=2), seg_len)

    # 3. Boundary placement (insert at an existing boundary): first
    # candidate slot skipping acked-dead tombstones (breakTie branch 1).
    skip = ~s.valid | ((s.rem_seq != NONE_SEQ) & (s.rem_seq <= ref))
    at_boundary = (cum[:, None, :] == p1[:, :, None]) & ~skip[:, None, :]
    cand = torch.where(at_boundary.any(dim=2), _first(at_boundary),
                       s.count[:, None])
    boundary_ins = is_ins & ~in1

    # 4. Rightward spread: slot s moves by
    #    A(s) = #split tails at segments < s
    #         + #interior-insert placements at segments < s
    #         + #boundary placements with cand <= s.
    tail_before = tot(ev_on[:, :, None]
                      & (ev_seg[:, :, None] < iota[None, None, :]), 1)
    placed_int_before = tot((is_ins & in1)[:, :, None]
                            & (seg1[:, :, None] < iota[None, None, :]), 1)
    placed_bnd_before = tot(boundary_ins[:, :, None]
                            & (cand[:, :, None] <= iota[None, None, :]), 1)
    shift = tail_before + placed_int_before + placed_bnd_before
    # Index math (fin) uses the full conceptual shift; the MOVE cascade
    # gets it zeroed beyond the dense live region — those slots carry no
    # content, and unzeroed they'd hold the maximum shift (being past
    # every event) and spray garbage through the wrap guard.
    shift_move = torch.where(iota[None, :] < s.count[:, None], shift, 0)

    prop_n = s.prop_val.shape[2]
    word_n = s.rem_overlap.shape[2]
    # Plane matrix [B, S, P]: 7 scalar planes + props + overlap words +
    # 2 head-patch scratch columns riding the spread (after the spread,
    # position fin(s) holds slot s, making the head-length patch a plain
    # elementwise select).
    min_off = torch.where(ev_onehot, ev_off[:, :, None],
                          NONE_SEQ).amin(dim=1)
    has_split = tot(ev_onehot, 1) > 0
    mat = torch.stack(
        [s.valid.to(I32), s.length, s.ins_seq, s.ins_client, s.rem_seq,
         s.rem_client, s.pool_start]
        + [s.prop_val[:, :, j] for j in range(prop_n)]
        + [s.rem_overlap[:, :, j] for j in range(word_n)]
        + [has_split.to(I32), min_off], dim=2)
    n_real = 7 + prop_n + word_n
    moved = _spread_cascade(mat, shift_move, 2 * r_axis)
    mat_out = moved[:, :, :n_real].clone()
    mat_out[:, :, 1] = torch.where(moved[:, :, n_real] > 0,
                                   moved[:, :, n_real + 1], moved[:, :, 1])
    fin = iota[None, :] + shift

    # 5a. Tail pieces: event e lands at fin(seg) + rank + placed_leq + 1
    # with its parent's planes (length/pool_start overridden).
    parents = _onehot_matmul(ev_onehot, mat[:, :, :n_real])  # [B, 2R, P]
    ev_fin = parent(fin)
    tail_idx = torch.where(ev_on, ev_fin + ev_rank + placed_leq + 1,
                           num_slots)
    tail_mask = ((torch.clamp(tail_idx, max=num_slots)[:, :, None]
                  == iota[None, None, :]) & ev_on[:, :, None])
    tail_vals = parents.clone()
    tail_vals[:, :, 0] = 1
    tail_vals[:, :, 1] = ev_next - ev_off
    tail_vals[:, :, 6] = parents[:, :, 6] + ev_off
    tail_new = _onehot_matmul(tail_mask.transpose(1, 2), tail_vals)
    mat_out = torch.where(tail_mask.any(dim=1)[:, :, None], tail_new,
                          mat_out)

    # 5b. Placed inserts: interior at fin(seg)+rank+placed_leq (just
    # before their own tail); boundary at fin(cand) - 1.
    placed_int_idx = (ev_fin[:, :r_axis] + ev_rank[:, :r_axis]
                      + placed_leq[:, :r_axis])
    fin_at_cand = tot(torch.where(cand[:, :, None] == iota[None, None, :],
                                  fin[:, None, :], 0), 2)
    placed_idx = torch.where(boundary_ins, fin_at_cand - 1, placed_int_idx)
    placed_idx = torch.where(is_ins, placed_idx, num_slots)
    pmask = ((torch.clamp(placed_idx, max=num_slots)[:, :, None]
              == iota[None, None, :]) & is_ins[:, :, None])
    blank = torch.zeros_like(step.seq)
    placed_vals = torch.stack(
        [blank + 1, step.text_len, step.seq, step.client,
         blank + int(NONE_SEQ), blank - 1, step.pool_start]
        + [blank] * (prop_n + word_n), dim=2)
    placed_new = _onehot_matmul(pmask.transpose(1, 2), placed_vals)
    mat_out = torch.where(pmask.any(dim=1)[:, :, None], placed_new,
                          mat_out)

    new_count = s.count + tot(ev_on, 1) + tot(is_ins, 1)
    state2 = mtk.MergeState(
        valid=mat_out[:, :, 0] > 0, length=mat_out[:, :, 1],
        ins_seq=mat_out[:, :, 2], ins_client=mat_out[:, :, 3],
        rem_seq=mat_out[:, :, 4], rem_client=mat_out[:, :, 5],
        rem_overlap=mat_out[:, :, 7 + prop_n:n_real],
        pool_start=mat_out[:, :, 6],
        prop_val=mat_out[:, :, 7:7 + prop_n], count=new_count)

    # 6. Range ops on the spread table. Placed inserts carry seq > ref,
    # so they are INVISIBLE in this frame — cum2 therefore measures
    # exactly the run-start coordinates the packer emitted; no in-run
    # adjustment applies.
    vis2 = mtk._vis_len(state2, ref, frame_client)
    cum2 = mtk._excl_cumsum(vis2)
    in_range = ((vis2[:, None, :] > 0)
                & (cum2[:, None, :] >= step.pos[:, :, None])
                & (cum2[:, None, :] < step.end[:, :, None]))  # [B, R, S]
    rem_w = in_range & is_rem[:, :, None]

    def write(mask, val, plane):
        return torch.where(mask.any(dim=1),
                           tot(torch.where(mask, val[:, :, None], 0), 1),
                           plane)

    props = [write(in_range & is_ann[:, :, None]
                   & (step.prop_key == j)[:, :, None], step.prop_val,
                   state2.prop_val[:, :, j]) for j in range(prop_n)]
    return state2._replace(
        rem_seq=write(rem_w, step.seq, state2.rem_seq),
        rem_client=write(rem_w, step.client, state2.rem_client),
        prop_val=torch.stack(props, dim=2))


def _spread_right(planes: list[torch.Tensor], shift: torch.Tensor
                  ) -> list[torch.Tensor]:
    """Move element j of each plane to j + shift[:, j] along axis 1
    (``shift`` i32[B, S], monotone non-decreasing per row, so no two
    elements collide). Content pushed past the end is dropped; vacated
    and never-filled slots hold unspecified values — callers mask them."""
    s = shift.shape[1]
    iota = torch.arange(s, device=shift.device)[None, :]
    dst = iota + shift.long()
    inside = (dst < s) & (shift > 0)
    # The one host read: how many elements move, as their coordinates.
    rows, src_j = host_read(inside.nonzero).unbind(1)
    dst_j = dst[rows, src_j]
    out = []
    for p in planes:
        moved = p.clone()
        moved[rows, dst_j] = p[rows, src_j]
        out.append(moved)
    return out


def _step(runs: MergeRunBatch, t: int) -> MergeRunBatch:
    """Step ``t`` of the tick: [B, R] op fields and its [B] frame."""
    return MergeRunBatch(*(f[:, t] for f in runs))


def apply_tick_runs(state: mtk.MergeState,
                    runs: MergeRunBatch) -> mtk.MergeState:
    """Apply one tick of composite run-steps for every document. Steps
    past the last one any document holds are no-ops and are not run.
    Returns new tensors; the inputs are not modified."""
    steps = runs.valid.any(dim=2).any(dim=0).nonzero()
    s = state
    for t in range(int(steps.max()) + 1 if steps.numel() else 0):
        s = _apply_run(s, _step(runs, t))
    return mtk.MergeState(*(t.clone() if t is u else t
                            for t, u in zip(s, state)))


def pack_runs(ops: list[dict], r_max: int = 16) -> list[list[dict]]:
    """Group a document's sequenced tick ops into independent runs.

    Walks the ops in order, transforming each op's coordinates back to
    the RUN-START frame by undoing the in-run edits so far (sequential
    OT over an event list: inserted spans shift later coordinates up and
    conflict when touched; removed spans shift them down and conflict
    when touched). A run closes when the next op cannot be expressed
    independently — its frame-0 range touches (within 1 char of) any
    member's range, its ref does not cover every prior seq (a
    concurrent-ref op needs the exact per-op frame), or r_max is hit.
    Emitted ops carry run-start-frame ``pos``/``end``.
    """
    runs: list[list[dict]] = []
    cur_ops: list[dict] = []
    ranges: list[tuple[int, int]] = []  # frame-0 ranges of members
    # (frame0_pos, +len) for inserts; (frame0_start, frame0_end) removes
    events: list[tuple[int, int, int]] = []  # (a, kind, len/end)
    last_seq = None

    def flush():
        nonlocal cur_ops, ranges, events
        if cur_ops:
            runs.append(cur_ops)
        cur_ops, ranges, events = [], [], []

    def to_frame0(p: int) -> int | None:
        """Run-start coordinate of latest-frame position p; None when p
        touches an in-run edit span (dependent — close the run)."""
        acc = 0  # latest = frame0 + acc, piecewise
        for a, kind, x in sorted(events):
            if kind == mtk.MT_INSERT:
                span_lo = a + acc
                if p < span_lo:
                    break
                if p <= span_lo + x:
                    return None
                acc += x
            else:  # remove [a, x) collapsed to a point
                seam = a + acc
                if p < seam:
                    break
                if p == seam:
                    return None
                acc -= x - a
        return p - acc

    for op in ops:
        kind = op["kind"]
        dependent = (last_seq is not None
                     and op["ref_seq"] < last_seq)
        if kind == mtk.MT_INSERT:
            p0 = to_frame0(op["pos"]) if not dependent else None
            rng = None if p0 is None else (p0, p0)
        else:
            a0 = to_frame0(op["pos"]) if not dependent else None
            b0 = to_frame0(op["end"]) if a0 is not None else None
            # A range spanning an edit seam folds to a shorter span than
            # its visible width; that means it touches the edit.
            if (b0 is not None
                    and b0 - a0 != op["end"] - op["pos"]):
                b0 = None
            rng = None if b0 is None else (a0, b0)
        if rng is not None:
            conflict = any(not (rng[1] + 1 < a or b + 1 < rng[0])
                           for a, b in ranges)
        if rng is None or conflict or len(cur_ops) >= r_max:
            flush()
            if kind == mtk.MT_INSERT:
                rng = (op["pos"], op["pos"])
            else:
                rng = (op["pos"], op["end"])
        new_op = dict(op)
        new_op["pos"] = rng[0]
        if kind != mtk.MT_INSERT:
            new_op["end"] = rng[1]
        cur_ops.append(new_op)
        ranges.append(rng)
        if kind == mtk.MT_INSERT:
            events.append((rng[0], mtk.MT_INSERT, op["text_len"]))
        elif kind == mtk.MT_REMOVE:
            events.append((rng[0], mtk.MT_REMOVE, rng[1]))
        last_seq = op["seq"]
    flush()
    return runs


def make_run_batch(runs_per_doc: list[list[list[dict]]], num_docs: int,
                   t: int, r: int,
                   device: str | torch.device | None = None
                   ) -> MergeRunBatch:
    """Encode per-doc run lists (pack_runs output) into a MergeRunBatch.
    Each step's frame ref is the minimum ref_seq of its ops."""
    dev = resolve_device(device)
    fields = {name: np.zeros((num_docs, t, r), np.int32)
              for name in ("kind", "pos", "end", "seq", "client",
                           "pool_start", "text_len", "prop_key",
                           "prop_val")}
    valid = np.zeros((num_docs, t, r), np.bool_)
    ref = np.zeros((num_docs, t), np.int32)
    for d, runs in enumerate(runs_per_doc):
        if len(runs) > t:
            raise ValueError(f"tick overflow: {len(runs)} runs > {t}")
        for j, run in enumerate(runs):
            if len(run) > r:
                raise ValueError(f"run overflow: {len(run)} ops > {r}")
            ref[d, j] = min(op["ref_seq"] for op in run)
            for i, op in enumerate(run):
                valid[d, j, i] = True
                for name in fields:
                    fields[name][d, j, i] = op.get(name, 0)
    return MergeRunBatch(
        valid=torch.from_numpy(valid).to(dev),
        ref=torch.from_numpy(ref).to(dev),
        **{n: torch.from_numpy(v).to(dev) for n, v in fields.items()})
