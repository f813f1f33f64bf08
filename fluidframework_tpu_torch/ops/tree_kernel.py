"""Batched SharedTree rebase tick — edit apply + validity across documents,
in PyTorch.

Port of ``fluidframework_tpu/ops/tree_kernel.py``. Reference parity: the
rebase hot loop of experimental/dds/tree (Transaction apply over
snapshots, re-validating anchors — Transaction.ts:40, Checkout.ts:172)
batched across documents (BASELINE config 5: 1k docs batched rebase).

Device encoding: a document's tree = a fixed-capacity node table (SoA over
[B, N]): exists mask, parent slot, trait id, sibling order key (rank),
payload id. :func:`apply_tick` walks the K ops of one tick in order (a
document's edits are sequential) and each step is vectorised over the
document axis:

  * set_value(node, payload)      — valid iff the node exists;
  * detach(node)                  — removes the whole subtree;
  * insert(slot, parent, trait)   — append at the END of a trait;
  * insert_start(slot, parent, trait) — prepend at trait START;
  * insert_before/after(slot, sibling) — sibling-relative placement, the
                                    StablePlace referenceSibling semantics;
  * constraint_exists(node)       — TreeConstraint: anchor still resolves;
  * constraint_count(parent, trait, n) — TreeConstraint: trait child count;
  * move*(node, ...)              — detach + insert of a subtree, fused.

Sibling order: each node carries an i32 ``rank``; order within a (parent,
trait) pair is rank-ascending. Append = max + GAP, prepend = min - GAP,
before/after = the midpoint between the sibling and its neighbour. A
midpoint that collides (gap exhausted after ~16 splits between a pair) or
an append past the i32 safe range does NOT apply; it raises the op's
``overflow`` flag so the serving host re-routes the channel to its exact
scalar path. Every plane and intermediate stays int32, so the midpoint
sum wraps exactly where the reference's does.

The subtree mask of a detach or move grows one level a pass: a slot is
marked when its parent was marked by the previous pass (a Jacobi sweep
over every slot, stale detached slots included, as the reference's
one-hot parent product does), for at most :data:`MAX_DEPTH_PASSES`
passes. The reference stops as soon as a pass adds nothing; this runs
every pass (a pass past the fixed point changes nothing) and reads
"still growing" off the last two, so the tick never waits on the host.
Steps where no document holds a detach or move skip the sweep: their
seed, and so their mask, is empty.

The reference function is XLA, not a Pallas kernel; this is its plain
PyTorch version and runs on either device.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..device import resolve_device

I32 = torch.int32

TREE_SET_VALUE = 0
TREE_DETACH = 1
TREE_INSERT = 2          # append at trait end (op.parent, op.trait)
TREE_INSERT_BEFORE = 3   # op.parent = reference sibling slot
TREE_INSERT_AFTER = 4    # op.parent = reference sibling slot
TREE_INSERT_START = 5    # prepend at trait start (op.parent, op.trait)
TREE_CONSTRAINT_EXISTS = 6  # valid iff op.node exists; no mutation
TREE_CONSTRAINT_COUNT = 7   # valid iff |children(op.parent, op.trait)| == op.payload
# Subtree move: the scalar detach(destination)+insert(source) pair fused
# into ONE atomic op — the whole subtree keeps its internal structure and
# only the root's (parent, trait, rank) changes. Validity additionally
# requires the destination NOT be inside the moved subtree (the scalar's
# detached-anchor rejection, tree_core.py:_resolve_place).
TREE_MOVE = 8            # move to trait end (op.parent, op.trait)
TREE_MOVE_BEFORE = 9     # op.parent = reference sibling slot
TREE_MOVE_AFTER = 10     # op.parent = reference sibling slot
TREE_MOVE_START = 11     # move to trait start (op.parent, op.trait)

# Kinds whose op grows a subtree mask (see subtree_steps).
SUBTREE_KINDS = frozenset({TREE_DETACH, TREE_MOVE, TREE_MOVE_BEFORE,
                           TREE_MOVE_AFTER, TREE_MOVE_START})

# Rank spacing for appends/prepends; midpoint inserts between two adjacent
# ranks survive log2(GAP)=16 splits before the host must re-rank.
RANK_GAP = 1 << 16
# Appends past this magnitude flag overflow instead of risking i32 wrap.
RANK_LIMIT = 1 << 30

# Detach/move propagate the subtree mask down one level per pass, so trees
# up to this depth converge; a mask still growing at the cap raises the
# op's ``overflow`` flag (op not applied) so the serving host reroutes the
# channel to the scalar path.
MAX_DEPTH_PASSES = 32


class TreeState(NamedTuple):
    exists: torch.Tensor   # bool[B, N] (slot 0 = root, always exists)
    parent: torch.Tensor   # i32[B, N] parent slot (-1 for root)
    trait: torch.Tensor    # i32[B, N] interned trait label under the parent
    rank: torch.Tensor     # i32[B, N] sibling order key within (parent, trait)
    payload: torch.Tensor  # i32[B, N] interned payload id


class TreeOpBatch(NamedTuple):
    valid: torch.Tensor    # bool[B, K]
    kind: torch.Tensor     # i32[B, K]
    node: torch.Tensor     # i32[B, K] target slot
    parent: torch.Tensor   # i32[B, K] parent slot, or reference sibling slot
    trait: torch.Tensor    # i32[B, K] trait label id
    payload: torch.Tensor  # i32[B, K] payload id / expected count


class TreeOpOut(NamedTuple):
    applied: torch.Tensor   # bool[B, K]
    overflow: torch.Tensor  # bool[B, K] — rank space exhausted or too deep


def init_state(num_docs: int, num_slots: int,
               device: str | torch.device | None = None) -> TreeState:
    dev = resolve_device(device)
    shape = (num_docs, num_slots)
    exists = torch.zeros(shape, dtype=torch.bool, device=dev)
    exists[:, 0] = True
    return TreeState(
        exists=exists,
        parent=torch.full(shape, -1, dtype=I32, device=dev),
        trait=torch.zeros(shape, dtype=I32, device=dev),
        rank=torch.zeros(shape, dtype=I32, device=dev),
        payload=torch.zeros(shape, dtype=I32, device=dev),
    )


def _at(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """plane[b, idx[b]] for every document b (idx int64, in range)."""
    return plane.gather(1, idx[:, None])[:, 0]


def _subtree_mask(seed: torch.Tensor, parent: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mask, still growing) of the subtrees under ``seed``: every pass
    marks each slot whose parent the previous pass had marked."""
    n = parent.shape[1]
    pidx = parent.clamp(0, n - 1).long()
    linked = (parent >= 0) & (parent < n)
    marked = prev = seed
    for _ in range(MAX_DEPTH_PASSES):
        prev = marked
        marked = marked | (marked.gather(1, pidx) & linked)
    return marked, (marked != prev).any(dim=1)


class _OpMasks(NamedTuple):
    """What the tick reads of its ops that no state changes: [B, K]."""

    valid: torch.Tensor
    node_slot: torch.Tensor    # i64 clipped to [0, n)
    anchor: torch.Tensor       # i64 op.parent clipped to [0, n)
    op_parent: torch.Tensor    # i32 raw parent / reference sibling
    trait: torch.Tensor
    payload: torch.Tensor
    is_set: torch.Tensor
    is_detach: torch.Tensor
    is_insert: torch.Tensor
    is_move: torch.Tensor
    is_cexists: torch.Tensor
    is_ccount: torch.Tensor
    place_end: torch.Tensor
    place_start: torch.Tensor
    place_before: torch.Tensor
    place_after: torch.Tensor
    sibling_rel: torch.Tensor
    node_in_range: torch.Tensor  # 0 <= op.node < n
    node_nonroot: torch.Tensor   # op.node != 0
    sib_in_range: torch.Tensor   # 0 < op.parent < n


def _op_masks(ops: TreeOpBatch, n: int) -> _OpMasks:
    kind = ops.kind
    is_move_end = kind == TREE_MOVE
    is_move_before = kind == TREE_MOVE_BEFORE
    is_move_after = kind == TREE_MOVE_AFTER
    is_move_start = kind == TREE_MOVE_START
    is_end = kind == TREE_INSERT
    is_before = kind == TREE_INSERT_BEFORE
    is_after = kind == TREE_INSERT_AFTER
    is_start = kind == TREE_INSERT_START
    place_before = is_before | is_move_before
    place_after = is_after | is_move_after
    return _OpMasks(
        valid=ops.valid,
        node_slot=ops.node.clamp(0, n - 1).long(),
        anchor=ops.parent.clamp(0, n - 1).long(),
        op_parent=ops.parent, trait=ops.trait, payload=ops.payload,
        is_set=kind == TREE_SET_VALUE, is_detach=kind == TREE_DETACH,
        is_insert=is_end | is_before | is_after | is_start,
        is_move=is_move_end | is_move_before | is_move_after
        | is_move_start,
        is_cexists=kind == TREE_CONSTRAINT_EXISTS,
        is_ccount=kind == TREE_CONSTRAINT_COUNT,
        place_end=is_end | is_move_end, place_start=is_start | is_move_start,
        place_before=place_before, place_after=place_after,
        sibling_rel=place_before | place_after,
        node_in_range=(ops.node >= 0) & (ops.node < n),
        node_nonroot=ops.node != 0,
        sib_in_range=(ops.parent > 0) & (ops.parent < n))


def apply_tick(state: TreeState, ops: TreeOpBatch,
               steps: Sequence[bool] | None = None
               ) -> tuple[TreeState, TreeOpOut]:
    """(state', TreeOpOut[B, K]) for one tick of tree edits.

    ``steps[k]`` says whether any document's op k is a valid detach or
    move (:func:`subtree_steps`, from the host's copy of the batch);
    steps marked False skip the subtree sweep. None sweeps at every
    step. The input state is not modified."""
    exists, parent, trait, rank, payload = state
    b, n = exists.shape
    k = ops.valid.shape[1]
    dev = exists.device
    if steps is None:
        steps = [True] * k
    lanes = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    masks = _op_masks(ops, n)
    applied, overflowed = [], []
    for i in range(k):
        op = _OpMasks(*(m[:, i] for m in masks))
        node_exists = _at(exists, op.node_slot)

        # Destination (parent, trait): sibling-relative placements inherit
        # the sibling's, the rest name it directly.
        ins_parent = torch.where(op.sibling_rel, _at(parent, op.anchor),
                                 op.op_parent)
        ins_trait = torch.where(op.sibling_rel, _at(trait, op.anchor),
                                op.trait)
        ins_parent_slot = ins_parent.clamp(0, n - 1).long()
        parent_exists = _at(exists, ins_parent_slot) & (ins_parent >= 0) \
            & (ins_parent < n)

        # Sibling set of the destination trait (also CONSTRAINT_COUNT's).
        sibs = exists & (parent == ins_parent[:, None]) \
            & (trait == ins_trait[:, None])
        sib_count = sibs.sum(dim=1, dtype=I32)
        has_sibs = sib_count > 0
        max_r = torch.where(sibs, rank, -RANK_LIMIT).amax(dim=1)
        min_r = torch.where(sibs, rank, RANK_LIMIT).amin(dim=1)

        # Rank for each placement flavour + its gap/overflow check.
        r_s = _at(rank, op.anchor)
        prev_r = torch.where(sibs & (rank < r_s[:, None]), rank,
                             (r_s - 2 * RANK_GAP)[:, None]).amax(dim=1)
        next_r = torch.where(sibs & (rank > r_s[:, None]), rank,
                             (r_s + 2 * RANK_GAP)[:, None]).amin(dim=1)
        end_rank = torch.where(has_sibs, max_r + RANK_GAP, 0)
        start_rank = torch.where(has_sibs, min_r - RANK_GAP, 0)
        before_rank = torch.div(prev_r + r_s, 2, rounding_mode="floor")
        after_rank = torch.div(r_s + next_r, 2, rounding_mode="floor")
        new_rank = torch.where(
            op.place_end, end_rank,
            torch.where(op.place_start, start_rank,
                        torch.where(op.place_before, before_rank,
                                    after_rank)))
        before_ok = (before_rank > prev_r) & (before_rank < r_s)
        after_ok = (after_rank > r_s) & (after_rank < next_r)
        gap_ok = (new_rank.abs() < RANK_LIMIT) & torch.where(
            op.place_before, before_ok, ~op.place_after | after_ok)

        sib_exists = _at(exists, op.anchor) & op.sib_in_range
        anchor_ok = torch.where(op.sibling_rel, sib_exists, parent_exists)
        insert_would = op.valid & op.is_insert & anchor_ok & ~node_exists \
            & op.node_nonroot & op.node_in_range
        insert_ok = insert_would & gap_ok

        # Unknown slots must be rejected, not clip-aliased onto slot n-1;
        # the root is not a valid constraint anchor.
        node_ok = node_exists & op.node_in_range
        target = lanes == op.node_slot[:, None]

        # Subtree mask of op.node (detach removal set / move cycle check).
        seeded = op.valid & node_ok & op.node_nonroot \
            & (op.is_detach | op.is_move)
        seed = target & seeded[:, None]
        if steps[i]:
            marked, depth_blown = _subtree_mask(seed, parent)
        else:
            marked, depth_blown = seed, torch.zeros_like(seeded)

        # Move validity: destination anchored OUTSIDE the moved subtree.
        dest_in_sub = torch.where(op.sibling_rel, _at(marked, op.anchor),
                                  _at(marked, ins_parent_slot))
        move_would = op.valid & op.is_move & node_ok & op.node_nonroot \
            & anchor_ok & ~dest_in_sub
        move_ok = move_would & gap_ok & ~depth_blown
        detach_would = op.valid & op.is_detach & node_ok & op.node_nonroot
        overflow = ((insert_would | move_would) & ~gap_ok) \
            | ((detach_would | move_would) & depth_blown)

        ccount_ok = parent_exists & (sib_count == op.payload)
        other_ok = node_ok & (~op.is_detach
                              | (op.node_nonroot & ~depth_blown))
        ok = op.valid & torch.where(
            op.is_insert, insert_ok,
            torch.where(op.is_move, move_ok,
                        torch.where(op.is_cexists,
                                    node_ok & op.node_nonroot,
                                    torch.where(op.is_ccount, ccount_ok,
                                                other_ok))))

        # set_value
        payload = torch.where(target & (ok & op.is_set)[:, None],
                              op.payload[:, None], payload)
        # detach: drop node + all descendants (the subtree mask).
        exists = exists & ~(marked & (ok & op.is_detach)[:, None])
        # insert (any flavour) / move (re-parent the subtree root only)
        do_insert = target & (ok & op.is_insert)[:, None]
        do_place = do_insert | (target & (ok & op.is_move)[:, None])
        exists = exists | do_insert
        parent = torch.where(do_place, ins_parent[:, None], parent)
        trait = torch.where(do_place, ins_trait[:, None], trait)
        rank = torch.where(do_place, new_rank[:, None], rank)
        payload = torch.where(do_insert, op.payload[:, None], payload)
        applied.append(ok)
        overflowed.append(overflow)

    def stacked(flags):
        return (torch.stack(flags, dim=1) if flags
                else torch.zeros((b, 0), dtype=torch.bool, device=dev))
    return (TreeState(exists=exists, parent=parent, trait=trait, rank=rank,
                      payload=payload),
            TreeOpOut(applied=stacked(applied), overflow=stacked(overflowed)))


def subtree_steps(ops_per_doc: list[list[dict]], k: int) -> list[bool]:
    """[K] flags for :func:`apply_tick`'s ``steps``: True where some
    document's op at that index is a detach or move."""
    steps = [False] * k
    for doc_ops in ops_per_doc:
        for i, op in enumerate(doc_ops):
            if op.get("kind", 0) in SUBTREE_KINDS:
                steps[i] = True
    return steps


def trait_order(state: TreeState, doc: int, parent: int,
                trait: int) -> list[int]:
    """Host-side read-back: the sibling order of one trait (rank-ascending,
    slot index breaks exact-rank ties deterministically)."""
    exists = state.exists[doc].cpu().numpy()
    parents = state.parent[doc].cpu().numpy()
    traits = state.trait[doc].cpu().numpy()
    ranks = state.rank[doc].cpu().numpy()
    slots = [i for i in range(exists.shape[0])
             if exists[i] and parents[i] == parent and traits[i] == trait]
    return sorted(slots, key=lambda i: (int(ranks[i]), i))


def make_tree_op_batch(ops_per_doc: list[list[dict]], num_docs: int, k: int,
                       device: str | torch.device | None = None
                       ) -> TreeOpBatch:
    dev = resolve_device(device)
    fields = {name: np.zeros((num_docs, k), np.int32)
              for name in ("kind", "node", "parent", "trait", "payload")}
    valid = np.zeros((num_docs, k), np.bool_)
    for d, doc_ops in enumerate(ops_per_doc):
        if len(doc_ops) > k:
            raise ValueError(f"doc {d} has {len(doc_ops)} ops, more than "
                             f"k={k}")
        for i, op in enumerate(doc_ops):
            valid[d, i] = True
            for name in fields:
                fields[name][d, i] = op.get(name, 0)
    return TreeOpBatch(
        valid=torch.from_numpy(valid).to(dev),
        **{n: torch.from_numpy(v).to(dev) for n, v in fields.items()})
