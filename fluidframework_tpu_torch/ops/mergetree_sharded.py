"""Sequence-parallel merge-tree — the SEGMENT axis split over shards.

Port of ``fluidframework_tpu/ops/mergetree_sharded.py``. The docs-axis
sharding (``parallel/mesh.py``) scales document COUNT with no collectives;
this module scales document SIZE: one huge document's segment table is
split across shards and the merge walk runs as a cooperative program:

  * position transforms = DISTRIBUTED exclusive prefix sums: a local scan
    plus the exclusive sum of the preceding shards' totals;
  * the insert walk's first-candidate select = a local masked min of
    global indices, then a min across shards;
  * per-op scalars (offsets, placement index, counts) = sum/min/max
    reductions across shards, the same on every shard;
  * the split/place data movement = local shifts plus the previous
    shard's tail (one hop of a ring).

Semantics come from ONE :func:`merge_apply_vec`, written against a
primitives interface; only the segment-axis primitives change:

  * :class:`StackedPrims` — n shards of ONE device held as a
    ``[D, n, S/n]`` view of the planes (a virtual mesh: the counterpart of
    the reference suite's virtual CPU devices, and how one card runs an
    n-shard program);
  * :class:`DistPrims` — one shard per process, over a
    ``torch.distributed`` process group (``all_gather``, ``all_reduce``
    MIN/MAX/SUM and a ring of ``isend``/``irecv`` for the roll).

A one-shard mesh holds the whole segment axis on one device: it runs the
flat tick (``mergetree_cuda.apply_tick_best``, kernel 4 on the card). A
mesh of distinct devices in one process is refused until per-device
shards exist.

Pools keep the FLAT layout this module shards; block tables convert at
the pool boundary (:func:`from_block_state`, ``mergetree_blocks.from_flat``).
No kernel: the reference's sharded tick is a ``shard_map`` program, not
Pallas.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import SEGS_AXIS, Mesh, mesh_kind
from . import mergetree_cuda as mtc
from .mergetree_kernel import (
    MT_INSERT,
    MT_REMOVE,
    NONE_SEQ,
    MergeOpBatch,
    MergeState,
)

I32 = torch.int32

# rem_overlap is not here: its word planes ride a [W, D, ...] operand beside
# the prop planes.
_PLANES = ("valid", "length", "ins_seq", "ins_client", "rem_seq",
           "rem_client", "pool_start")
_OPS = ("valid", "kind", "pos", "end", "seq", "ref_seq", "client",
        "pool_start", "text_len", "prop_key", "prop_val")


def make_seg_mesh(devices=None, rank: int = 0, world: int = 1,
                  group=None) -> Mesh:
    """1-D mesh over the SEGMENT axis (long-document scale-out). A device
    may repeat: n entries of one device form a virtual n-shard mesh."""
    from ..parallel.mesh import make_mesh
    return make_mesh(devices, axis_name=SEGS_AXIS, rank=rank, world=world,
                     group=group)


class StackedPrims:
    """n shards of one device, stacked: planes ``[D, n, L]`` (shard i holds
    global lanes ``[i*L, (i+1)*L)``), per-doc scalars ``[D, 1, 1]``. Each
    reduction runs locally over the lane axis, then across the shard axis
    (dim -2) — the two levels of the distributed primitives."""

    def __init__(self, num_shards: int, local_lanes: int) -> None:
        self.n = num_shards
        self.local = local_lanes
        self.global_lanes = num_shards * local_lanes

    def lane_iota(self, like: torch.Tensor) -> torch.Tensor:
        return torch.arange(self.global_lanes, dtype=I32,
                            device=like.device).view(
            self.n, self.local).expand(like.shape)

    def excl_cumsum(self, x: torch.Tensor) -> torch.Tensor:
        local_inc = torch.cumsum(x, -1, dtype=I32)
        total = local_inc[..., -1:]                     # [D, n, 1]
        offset = torch.cumsum(total, -2, dtype=I32) - total
        return local_inc - x + offset

    def first_true(self, mask: torch.Tensor) -> torch.Tensor:
        lane = self.lane_iota(mask)
        local = torch.where(mask, lane, self.global_lanes).amin(
            dim=-1, keepdim=True)
        return local.amin(dim=-2, keepdim=True)

    def any_(self, mask: torch.Tensor) -> torch.Tensor:
        return mask.any(dim=-1, keepdim=True).any(dim=-2, keepdim=True)

    def gather(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        lane = self.lane_iota(x)
        local = torch.where(lane == idx, x, 0).sum(dim=-1, keepdim=True,
                                                   dtype=I32)
        return local.sum(dim=-2, keepdim=True, dtype=I32)

    def roll(self, field: torch.Tensor, shift: int) -> torch.Tensor:
        # Global circular roll: local roll + the previous shard's tail.
        edge = field[..., -shift:]
        received = torch.roll(edge, 1, dims=-2)
        rolled = torch.roll(field, shift, dims=-1)
        return torch.cat((received, rolled[..., shift:]), dim=-1)


class DistPrims:
    """One shard per process of ``group``: planes ``[D, L]`` (this rank's
    lanes ``[rank*L, (rank+1)*L)``), per-doc scalars ``[D, 1]``."""

    def __init__(self, num_shards: int, local_lanes: int, rank: int,
                 group=None) -> None:
        self.n = num_shards
        self.local = local_lanes
        self.global_lanes = num_shards * local_lanes
        self.rank = rank
        self.group = group
        self.offset = rank * local_lanes

    def lane_iota(self, like: torch.Tensor) -> torch.Tensor:
        return (torch.arange(self.local, dtype=I32, device=like.device)
                + self.offset).expand(like.shape)

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        import torch.distributed as dist
        x = x.contiguous()
        dist.all_reduce(x, op=op, group=self.group)
        return x

    def excl_cumsum(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        local_inc = torch.cumsum(x, -1, dtype=I32)
        total = local_inc[..., -1:].contiguous()
        gathered = [torch.empty_like(total) for _ in range(self.n)]
        dist.all_gather(gathered, total, group=self.group)
        offset = torch.zeros_like(total)
        for i in range(self.rank):
            offset = offset + gathered[i]
        return local_inc - x + offset

    def first_true(self, mask: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        lane = self.lane_iota(mask)
        local = torch.where(mask, lane, self.global_lanes).amin(
            dim=-1, keepdim=True)
        return self._reduce(local, dist.ReduceOp.MIN)

    def any_(self, mask: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        local = mask.any(dim=-1, keepdim=True).to(I32)
        return self._reduce(local, dist.ReduceOp.MAX) != 0

    def gather(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        lane = self.lane_iota(x)
        local = torch.where(lane == idx, x, 0).sum(dim=-1, keepdim=True,
                                                   dtype=I32)
        return self._reduce(local, dist.ReduceOp.SUM)

    def roll(self, field: torch.Tensor, shift: int) -> torch.Tensor:
        # The tail goes one hop round the ring: rank r sends to r+1 and
        # receives from r-1.
        import torch.distributed as dist
        edge = field[..., -shift:].contiguous()
        received = torch.empty_like(edge)
        dst = dist.get_global_rank(self.group, (self.rank + 1) % self.n) \
            if self.group is not None else (self.rank + 1) % self.n
        src = dist.get_global_rank(self.group, (self.rank - 1) % self.n) \
            if self.group is not None else (self.rank - 1) % self.n
        reqs = [dist.isend(edge, dst, group=self.group),
                dist.irecv(received, src, group=self.group)]
        for req in reqs:
            req.wait()
        rolled = torch.roll(field, shift, dims=-1)
        return torch.cat((received, rolled[..., shift:]), dim=-1)


def _overlap_bit_vec(overlap: torch.Tensor, client: torch.Tensor
                     ) -> torch.Tensor:
    """Per-slot bit of each doc's client. ``overlap`` [W, D, ...], ``client``
    per-doc scalars → [D, ...]. ``>>`` is arithmetic; ``& 1`` keeps one
    bit."""
    w = overlap.shape[0]
    c = client.clamp(0, 32 * w - 1)
    word_ids = torch.arange(w, dtype=I32, device=overlap.device).view(
        (w,) + (1,) * (overlap.ndim - 1))
    sel = torch.where(word_ids == (c >> 5)[None], overlap, 0).sum(
        dim=0, dtype=I32)
    return (sel >> (c & 31)) & 1


def _overlap_mask_vec(overlap: torch.Tensor, client: torch.Tensor
                      ) -> torch.Tensor:
    """Planes shaped like ``overlap`` with each doc's client bit set in its
    word."""
    w = overlap.shape[0]
    c = client.clamp(0, 32 * w - 1)
    word_ids = torch.arange(w, dtype=I32, device=overlap.device).view(
        (w,) + (1,) * (overlap.ndim - 1))
    bit = torch.ones_like(c) << (c & 31)
    return torch.where(word_ids == (c >> 5)[None], bit[None], 0)


def _vis_len(p: dict, overlap: torch.Tensor, ref_seq, client):
    validb = p["valid"] != 0
    ins_vis = validb & ((p["ins_seq"] <= ref_seq)
                        | (p["ins_client"] == client))
    overlap_bit = _overlap_bit_vec(overlap, client)
    removed_vis = ((p["rem_seq"] != NONE_SEQ)
                   & ((p["rem_client"] == client) | (p["rem_seq"] <= ref_seq)
                      | (overlap_bit == 1)))
    return torch.where(ins_vis & ~removed_vis, p["length"], 0)


def merge_apply_vec(p: dict, prop: torch.Tensor, overlap: torch.Tensor,
                    count: torch.Tensor, op: dict, prims):
    """One sequenced op per doc, vectorized over the doc axis.

    ``p`` maps plane name → i32 planes (``[D, S]``, or ``[D, n, L]``
    stacked); ``prop`` is ``[P, D, ...]``; ``overlap`` is ``[W, D, ...]``
    remover-bitmask words; ``count`` and the op fields are per-doc scalars
    shaped to broadcast against the planes. Mirrors
    ``mergetree_kernel._apply_op``. Returns (planes', prop', overlap',
    count'). ``prims`` supplies the segment-axis primitives."""
    lane = prims.lane_iota(p["length"])
    plane_ndim = p["length"].ndim
    opvalid = op["valid"] != 0
    is_insert = op["kind"] == MT_INSERT
    is_remove = op["kind"] == MT_REMOVE

    vis = _vis_len(p, overlap, op["ref_seq"], op["client"])
    cum = prims.excl_cumsum(vis)

    p1 = op["pos"]
    p2 = torch.where(is_insert, -1, op["end"])
    in1 = (cum < p1) & (p1 < cum + vis)
    in2 = (cum < p2) & (p2 < cum + vis) & (p2 != p1)
    i1 = prims.first_true(in1)
    i2 = prims.first_true(in2)
    has1 = prims.any_(in1)
    has2 = prims.any_(in2)
    o1 = p1 - prims.gather(cum, i1)
    o2 = p2 - prims.gather(cum, i2)
    same = has1 & has2 & (i1 == i2)
    t1 = i1 + 1
    t2 = i2 + 1 + torch.where(has1 & (i1 <= i2), 1, 0)

    # Post-split visibility frame, derived without re-scanning: the split
    # keeps cum for lanes <= i1, lands the tail boundary exactly at p1,
    # and shifts the rest right by one.
    shift1 = has1 & (lane >= t1)

    def sh1(field):
        return torch.where(shift1, prims.roll(field, 1), field)

    skip = ((p["valid"] == 0) | ((p["rem_seq"] != NONE_SEQ)
                                 & (p["rem_seq"] <= op["ref_seq"])))
    cum_post = torch.where(has1 & (lane == t1), p1, sh1(cum))
    candidate = (cum_post == p1) & (sh1(skip.to(I32)) == 0)
    has_cand = prims.any_(candidate)
    count_post = count + has1.to(I32)
    tp = torch.where(has_cand, prims.first_true(candidate), count_post)

    placedf = tp
    t1f = torch.where(is_insert & (tp <= t1), t1 + 1, t1)
    point_b = torch.where(is_insert, placedf, t2)
    gate_b = is_insert | has2
    shift = ((has1 & (lane >= t1f)).to(I32)
             + (gate_b & (lane >= point_b)).to(I32))

    def shifted(field):
        r1 = prims.roll(field, 1)
        r2 = prims.roll(field, 2)
        cond0 = shift == 0
        cond1 = shift == 1
        if field.ndim > plane_ndim:  # [P|W, D, ...] feature planes
            cond0, cond1 = cond0[None], cond1[None]
        return torch.where(cond0, field, torch.where(cond1, r1, r2))

    is_tail1 = has1 & (lane == t1f)
    is_tail2 = ~is_insert & has2 & (lane == point_b)
    is_head1 = has1 & (lane == i1)
    head2_out = i2 + torch.where(has1 & (i1 < i2), 1, 0)
    is_head2 = ~is_insert & has2 & ~same & (lane == head2_out)
    is_placed = is_insert & (lane == placedf)

    start_off = torch.where(is_tail2, o2, torch.where(is_tail1, o1, 0))
    full_len = shifted(p["length"])
    end_off = torch.where(
        is_head1, o1,
        torch.where(same & is_tail1, o2,
                    torch.where(is_head2, o2, full_len)))

    moved = {
        "valid": torch.where(is_placed, 1, shifted(p["valid"])),
        "length": torch.where(is_placed, op["text_len"],
                              end_off - start_off),
        "ins_seq": torch.where(is_placed, op["seq"], shifted(p["ins_seq"])),
        "ins_client": torch.where(is_placed, op["client"],
                                  shifted(p["ins_client"])),
        "rem_seq": torch.where(is_placed, int(NONE_SEQ),
                               shifted(p["rem_seq"])),
        "rem_client": torch.where(is_placed, -1, shifted(p["rem_client"])),
        "pool_start": torch.where(is_placed, op["pool_start"],
                                  shifted(p["pool_start"]) + start_off),
    }
    moved_prop = torch.where(is_placed[None], 0, shifted(prop))
    moved_overlap = torch.where(is_placed[None], 0, shifted(overlap))
    moved_count = (count + has1.to(I32)
                   + torch.where(is_insert, 1, has2.to(I32)))

    # Mark / annotate over the moved table (the writes below are
    # ~is_insert-gated, so the moved table is the doubly-split original:
    # per-slot visibility flags shift with the planes and the post-split
    # start table composes from cum with the tail boundaries at p1/p2).
    vis2 = torch.where(shifted((vis > 0).to(I32)) != 0, moved["length"], 0)
    cum2 = torch.where(is_tail1, p1, torch.where(is_tail2, p2,
                                                 shifted(cum)))
    in_range = (vis2 > 0) & (cum2 >= op["pos"]) & (cum2 < op["end"])
    fresh = in_range & (moved["rem_seq"] == NONE_SEQ)
    again = in_range & (moved["rem_seq"] != NONE_SEQ)
    bit_planes = _overlap_mask_vec(moved_overlap, op["client"])

    do_rem = ~is_insert & is_remove
    moved["rem_seq"] = torch.where(do_rem & fresh, op["seq"],
                                   moved["rem_seq"])
    moved["rem_client"] = torch.where(do_rem & fresh, op["client"],
                                      moved["rem_client"])
    moved_overlap = torch.where((do_rem & again)[None],
                                moved_overlap | bit_planes, moved_overlap)
    is_annot = ~is_insert & ~is_remove
    plane_ids = torch.arange(moved_prop.shape[0], dtype=I32,
                             device=moved_prop.device).view(
        (-1,) + (1,) * (moved_prop.ndim - 1))
    annot_write = (is_annot & in_range)[None] & (plane_ids
                                                 == op["prop_key"][None])
    moved_prop = torch.where(annot_write, op["prop_val"][None], moved_prop)

    # An insert never marks/annotates: moved IS the final table.
    out = {name: torch.where(opvalid, moved[name], p[name])
           for name in _PLANES}
    out_prop = torch.where(opvalid[None], moved_prop, prop)
    out_overlap = torch.where(opvalid[None], moved_overlap, overlap)
    out_count = torch.where(opvalid, moved_count, count)
    return out, out_prop, out_overlap, out_count


def _run(planes: dict, prop, overlap, count, ops: MergeOpBatch, scalar,
         prims):
    """The tick's op loop: one :func:`merge_apply_vec` per op index, op
    fields shaped by ``scalar`` ([B] → the prims' per-doc scalar shape)."""
    k = ops.kind.shape[1]
    for i in range(k):
        op = {name: scalar(getattr(ops, name)[:, i].to(I32))
              for name in _OPS}
        planes, prop, overlap, count = merge_apply_vec(
            planes, prop, overlap, count, op, prims=prims)
    return planes, prop, overlap, count


def _refuse_devices(mesh: Mesh) -> str:
    kind = mesh_kind(mesh)
    if kind == "devices":
        raise ValueError(
            f"{mesh}: a segment mesh over distinct devices of one process "
            "is not supported; use a virtual mesh (every shard on one "
            "device) or one shard per process")
    return kind


def apply_tick_sharded(state: MergeState, ops: MergeOpBatch,
                       mesh: Mesh) -> MergeState:
    """apply_tick with the SEGMENT axis split over ``mesh``.

    A virtual mesh (every shard on one device) runs the stacked
    primitives over the whole ``[B, S]`` state; a process-group mesh (one
    shard per process) takes this rank's ``[B, S/n]`` slice of the segment
    axis and runs the distributed ones; a one-shard mesh runs the flat
    tick. Ops and per-doc scalars are the same on every shard.
    Bit-identical to ``mergetree_kernel.apply_tick``. The inputs are not
    modified."""
    num_shards = mesh.size
    kind = _refuse_devices(mesh)
    b, s_local = state.length.shape
    s = s_local * (mesh.world if kind == "dist" else 1)
    assert s % num_shards == 0, (
        f"segment capacity {s} must divide over {num_shards} shards")
    local = s // num_shards
    # The roll exchanges at most one neighbour hop of `shift` lanes
    # (merge_apply_vec shifts by <= 2).
    assert local >= 2, (
        f"need >= 2 segment slots per shard, have {local}")
    dev = state.length.device
    ops = MergeOpBatch(*(t.to(dev) for t in ops))
    if num_shards == 1:
        return mtc.apply_tick_best(state, ops)

    if kind == "dist":
        prims = DistPrims(num_shards, local, mesh.rank, mesh.group)
        view = lambda x: x                          # noqa: E731
        scalar = lambda x: x[:, None]               # noqa: E731
        unview = lambda x: x                        # noqa: E731
    else:
        prims = StackedPrims(num_shards, local)
        view = lambda x: x.reshape(b, num_shards, local)  # noqa: E731
        scalar = lambda x: x[:, None, None]         # noqa: E731
        unview = lambda x: x.reshape(b, s)          # noqa: E731

    planes = {name: view(getattr(state, name).to(I32)) for name in _PLANES}
    # [B, S, F] feature planes → [F, B, ...].
    prop = torch.stack([view(state.prop_val[..., f])
                        for f in range(state.prop_val.shape[-1])])
    overlap = torch.stack([view(state.rem_overlap[..., w])
                           for w in range(state.rem_overlap.shape[-1])])
    count = scalar(state.count.to(I32))
    planes, prop, overlap, count = _run(planes, prop, overlap, count, ops,
                                        scalar, prims)
    return MergeState(
        valid=unview(planes["valid"]) != 0,
        length=unview(planes["length"]),
        ins_seq=unview(planes["ins_seq"]),
        ins_client=unview(planes["ins_client"]),
        rem_seq=unview(planes["rem_seq"]),
        rem_client=unview(planes["rem_client"]),
        rem_overlap=torch.stack([unview(x) for x in overlap], dim=-1),
        pool_start=unview(planes["pool_start"]),
        prop_val=torch.stack([unview(x) for x in prop], dim=-1),
        count=count.reshape(b),
    )


def from_block_state(block_state, slots: int | None = None) -> MergeState:
    """Pack a block-structured table into the flat layout this module
    shards (the doc-outgrew-one-device migration source). ``slots`` pads
    to the target sharded pool's segment capacity."""
    from .mergetree_blocks import to_flat
    return to_flat(block_state, slots)


def shard_merge_state(state: MergeState, mesh: Mesh) -> MergeState:
    """Place a MergeState for ``mesh``: on a virtual mesh the whole state
    lives on the mesh's device (its shards are column ranges of the
    segment axis, viewed ``[B, n, S/n]`` by the tick); on a process-group
    mesh each rank keeps its own ``[B, S/n]`` slice. ``count`` is a
    per-doc scalar and stays whole."""
    kind = _refuse_devices(mesh)
    dev = mesh.devices[0]
    if kind != "dist":
        return MergeState(*(t.to(dev) for t in state))
    s = state.length.shape[1]
    assert s % mesh.size == 0, (
        f"segment capacity {s} must divide over {mesh.size} shards")
    local = s // mesh.size
    lo = mesh.rank * local
    return MergeState(**{
        f: (getattr(state, f).to(dev) if f == "count"
            else getattr(state, f)[:, lo:lo + local].contiguous().to(dev))
        for f in MergeState._fields})
