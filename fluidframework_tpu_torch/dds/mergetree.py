"""Scalar merge-tree engine — the sequence CRDT merge rules on a flat table.

Reference parity: packages/dds/merge-tree/src/mergeTree.ts. The reference
stores segments in a B-tree with per-block partial lengths for O(log n)
position transforms; this engine keeps the *semantics* on a flat segment
list (order of the list = document order), because (a) it is the oracle the
batched TPU kernel is differentially tested against, and (b) the flat table
IS the device representation (ops/mergetree_kernel.py vectorizes exactly
this walk with prefix sums).

Core rules mirrored exactly:

* Visibility (mergeTree.ts nodeLength): a segment is visible to
  (refSeq, client) iff inserted (seq <= refSeq or by that client) and not
  removed (removed_seq <= refSeq, or removed by that client, or that client
  is in the overlap-remove set).
* Insert walk (insertingWalk:2363 + breakTie:2267): skip whole visible
  segments; at a zero-visible-length boundary: skip segments removed at
  removedSeq <= refSeq; a local edit goes before everything else; remote
  edits go before acked segments ("newer merges left", so concurrent
  same-position inserts order by descending seq) but after OUR unacked
  segments (which will sequence later — i.e. newer still).
* Remove (markRangeRemoved:2626): earliest sequenced remove owns
  removed_seq; later concurrent removers join the overlap set; a pending
  local remove is overwritten by a remote remove ("comes later").
* Annotate (PropertiesManager): per-key LWW with pending-local shadowing.
* Ack (ackPendingSegment:1883): FIFO pending groups get the sequenced seq.
* Zamboni (mergeTree.ts:1412): on minSeq advance, drop segments removed at
  or below minSeq and coalesce adjacent out-of-window segments —
  deterministic, so replicas stay structurally identical. Large documents
  amortize the pass over a fixed number of minSeq advances; every
  OBSERVABLE view (text, positions, snapshots) is identical either way
  because snapshot() performs the same normalization itself.

Position transforms are sublinear on large documents via a block index —
the flat-table analog of the reference's B-tree partial lengths
(mergeTree.ts:350, partialLengths.ts:63). The flat list is partitioned
into blocks of ~64 segments; each block caches the summed length of its
SETTLED members (seq <= minSeq, never removed) plus a count of unsettled
ones. A settled segment is visible in EVERY valid view (the sequencer
NACKs refSeq < MSN, so every walk's refSeq >= minSeq >= its seq), so a
fully-settled block contributes a view-independent length and the insert
walk / boundary split / range scan skip it in O(1) instead of touching
its 64 segments. Blocks with any unsettled member are scanned segment by
segment — exactness is only required when the unsettled count is zero,
and that count never decreases between full rebuilds (zamboni), so
interior stat drift is harmless by construction.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Iterable

UNASSIGNED = -1  # reference UnassignedSequenceNumber (pending local op)
# Segments per snapshot chunk (snapshotChunks.ts parity): documents above
# this split their segment table into chunks; loaders stream them.
SNAPSHOT_CHUNK_SEGMENTS = 256

# Non-text segment content: a marker (reference Marker, refType + optional id
# + props). Markers have visible length 1 in position space.
@dataclass(frozen=True, slots=True)
class Marker:
    ref_type: str = "simple"
    id: str | None = None


@dataclass(slots=True, eq=False)  # identity eq: groups↔segments is cyclic
class Segment:
    content: str | tuple | Marker  # text, handle run, or marker
    seq: int                      # UNASSIGNED while pending
    client: str | None            # inserting client (None = loaded baseline)
    local_seq: int | None = None
    removed_seq: int | None = None  # None = live; UNASSIGNED = pending local
    removed_client: str | None = None
    removed_local_seq: int | None = None
    removed_overlap: set[str] = field(default_factory=set)
    props: dict | None = None
    # key -> [count of unacked local annotate ops shadowing that key,
    #         acked base value (the LWW value on the acked timeline, shown
    #         in canonical snapshots while the local value shadows the view)]
    pending_props: dict[str, list] = field(default_factory=dict)
    # pending-op groups this segment belongs to (split halves share groups)
    groups: list["SegmentGroup"] = field(default_factory=list)
    # Block-index classification bit (see MergeEngine block index): True
    # while this segment is counted in its block's settled length. Owned
    # by the engine; kept exact so block stats never drift.
    settled_cached: bool = False

    @property
    def length(self) -> int:
        if isinstance(self.content, Marker):
            return 1
        return len(self.content)

    @property
    def is_marker(self) -> bool:
        return isinstance(self.content, Marker)

    def clone_tail(self, offset: int) -> "Segment":
        """Split: return the tail half at item offset, sharing state/groups."""
        assert not isinstance(self.content, Marker)
        assert 0 < offset < len(self.content)
        tail = Segment(
            content=self.content[offset:],
            seq=self.seq,
            client=self.client,
            local_seq=self.local_seq,
            removed_seq=self.removed_seq,
            removed_client=self.removed_client,
            removed_local_seq=self.removed_local_seq,
            removed_overlap=set(self.removed_overlap),
            props=dict(self.props) if self.props is not None else None,
            pending_props={k: list(v) for k, v in self.pending_props.items()},
            groups=list(self.groups),
            settled_cached=self.settled_cached,
        )
        self.content = self.content[:offset]
        for group in tail.groups:
            group.segments.append(tail)
        return tail


@dataclass(slots=True, eq=False)  # identity eq: groups↔segments is cyclic
class SegmentGroup:
    """One submitted-but-unacked local op and the segments it touched."""

    op_kind: str  # "insert" | "remove" | "annotate"
    segments: list[Segment]
    local_seq: int
    props_keys: tuple[str, ...] = ()


class TrackingGroup:
    """Follows a set of segments across splits (the reference merge-tree's
    TrackingGroup, used by undo-redo): membership rides ``Segment.groups``
    so ``clone_tail`` adds split tails automatically, and zamboni keeps
    tracked segments alive until :meth:`unlink_all`."""

    def __init__(self) -> None:
        self.segments: list[Segment] = []

    def link(self, seg: Segment) -> None:
        seg.groups.append(self)
        self.segments.append(seg)

    def unlink_all(self) -> None:
        """Release every segment (re-enabling compaction)."""
        for seg in self.segments:
            if self in seg.groups:  # normalize_detached may have cleared it
                seg.groups.remove(self)
        self.segments.clear()


class MergeEngine:
    """Merge rules for one sequence (one replica)."""

    def __init__(self, local_client: str | None = None) -> None:
        self.local_client = local_client
        self.segments: list[Segment] = []
        self.current_seq = 0
        self.min_seq = 0
        self._local_seq_counter = 0
        self.pending_groups: deque[SegmentGroup] = deque()
        # (head, tail, offset) hooks fired on every segment split — local
        # reference holders (interval collections) re-anchor here.
        self.on_split: list = []
        # {old_segment_id: (replacement_segment_or_None, offset_delta)}
        # fired after zamboni compaction drops/coalesces segments.
        self.on_compact: list = []
        # While True, visibility excludes local unacked state even when the
        # op author equals the local client: set during apply_remote of a
        # VOIDED_LOCAL_ECHO (own op re-applied as remote after a lost
        # concurrent-create race) — no other replica has our pending
        # segments, so positions must resolve without them.
        self._foreign_self = False
        # Set by a reconnect identity change; the first regeneration pass
        # consumes it (normalize once per rejoin, not per pending message).
        self._rejoin_normalize_pending = False
        # Block index (see module docstring): parallel arrays, one entry
        # per ~_BLK_TARGET-segment block of self.segments. _blk_settled =
        # summed length of settled members; _blk_unsettled = count of
        # members NOT known settled (monotone non-decreasing between
        # rebuilds); _blk_text = local-view text cache for fully-settled
        # blocks. Rebuilt wholesale by the zamboni; patched incrementally
        # by every structural/visibility mutation in between.
        self._blk_counts: list[int] = []
        self._blk_settled: list[int] = []
        self._blk_unsettled: list[int] = []
        self._blk_text: list[str | None] = []
        self._blk_refresh_min: list[int] = []
        self._zamboni_debt = 0

    # -- block index -----------------------------------------------------------

    _BLK_TARGET = 64

    def _is_settled(self, seg: Segment) -> bool:
        """View-independent visibility. Settled-LIVE: inserted at/below the
        window and never removed (every valid walk's refSeq >= minSeq, so
        it is visible everywhere; contributes its length). Settled-DEAD: a
        tombstone removed at/below the window (removed_seq <= minSeq <=
        every refSeq, so it is invisible everywhere; contributes zero) —
        it may linger between deferred zamboni passes or while pinned by a
        pending group, without blocking whole-block skips."""
        rs = seg.removed_seq
        if rs is None:
            return seg.seq != UNASSIGNED and seg.seq <= self.min_seq
        return rs != UNASSIGNED and rs <= self.min_seq

    @staticmethod
    def _settled_contrib(seg: Segment) -> int:
        """Length a settled segment adds to its block (0 for tombstones)."""
        return seg.length if seg.removed_seq is None else 0

    def _rebuild_index(self) -> None:
        t = self._BLK_TARGET
        segs = self.segments
        counts, settled, unsettled = [], [], []
        for i in range(0, len(segs), t):
            chunk = segs[i:i + t]
            s_len = 0
            uns = 0
            for seg in chunk:
                if self._is_settled(seg):
                    seg.settled_cached = True
                    s_len += self._settled_contrib(seg)
                else:
                    seg.settled_cached = False
                    uns += 1
            counts.append(len(chunk))
            settled.append(s_len)
            unsettled.append(uns)
        self._blk_counts = counts
        self._blk_settled = settled
        self._blk_unsettled = unsettled
        self._blk_text = [None] * len(counts)
        self._blk_refresh_min = [self.min_seq] * len(counts)

    def _scan_ready(self, b: int, base: int) -> bool:
        """True if block ``b`` (starting at element ``base``) is fully
        settled and its stats are exact — i.e. the walk may skip it using
        the cached length. A block with unsettled members is first
        RECLASSIFIED once per minSeq value (segments settle as the window
        advances; removal is the only unsettle path and is patched
        eagerly), so skipping recovers right after the window moves
        instead of waiting for the next full zamboni."""
        if self._blk_unsettled[b] == 0:
            return True
        if self._blk_refresh_min[b] == self.min_seq:
            return False
        self._blk_refresh_min[b] = self.min_seq
        s_len = self._blk_settled[b]
        uns = self._blk_unsettled[b]
        for i in range(base, base + self._blk_counts[b]):
            seg = self.segments[i]
            if not seg.settled_cached and self._is_settled(seg):
                seg.settled_cached = True
                s_len += self._settled_contrib(seg)
                uns -= 1
        self._blk_settled[b] = s_len
        self._blk_unsettled[b] = uns
        if uns == 0:
            self._blk_text[b] = None  # membership changed; rebuild lazily
        return uns == 0

    def _check_index(self) -> None:
        """Lazy validation at every walk entry: external code (merge-host
        state reconstruction) appends to ``segments`` directly; a length
        mismatch forces a rebuild. O(#blocks) — noise next to the walk."""
        if sum(self._blk_counts) != len(self.segments):
            self._rebuild_index()

    def _block_of_elem(self, index: int) -> int:
        """Block containing existing element ``index``."""
        cum = 0
        for b, c in enumerate(self._blk_counts):
            cum += c
            if index < cum:
                return b
        return len(self._blk_counts) - 1

    def _index_inserted_at(self, index: int) -> None:
        """A brand-new segment entered ``segments`` at ``index`` (always
        unsettled: pending, or sequenced above the window)."""
        if not self._blk_counts:
            self._blk_counts = [1]
            self._blk_settled = [0]
            self._blk_unsettled = [1]
            self._blk_text = [None]
            self._blk_refresh_min = [self.min_seq]
            return
        cum = 0
        b = len(self._blk_counts) - 1
        for j, c in enumerate(self._blk_counts):
            cum += c
            if index <= cum:
                b = j
                break
        self._blk_counts[b] += 1
        self._blk_unsettled[b] += 1
        self._blk_text[b] = None
        self._maybe_split_block(b)

    def _index_unsettle(self, b: int, seg: Segment) -> None:
        """``seg`` (classified settled, in block ``b``) is about to gain a
        removal mark: move it out of the settled sum. Call BEFORE mutating
        removed_seq."""
        seg.settled_cached = False
        self._blk_settled[b] -= seg.length
        self._blk_unsettled[b] += 1
        self._blk_text[b] = None

    def _maybe_split_block(self, b: int) -> None:
        if self._blk_counts[b] <= 2 * self._BLK_TARGET:
            return
        start = sum(self._blk_counts[:b])
        cnt = self._blk_counts[b]
        half = cnt // 2
        stats = []
        for lo, hi in ((start, start + half), (start + half, start + cnt)):
            s_len = 0
            uns = 0
            for seg in self.segments[lo:hi]:
                if seg.settled_cached:
                    s_len += self._settled_contrib(seg)
                else:
                    uns += 1
            stats.append((hi - lo, s_len, uns))
        self._blk_counts[b:b + 1] = [stats[0][0], stats[1][0]]
        self._blk_settled[b:b + 1] = [stats[0][1], stats[1][1]]
        self._blk_unsettled[b:b + 1] = [stats[0][2], stats[1][2]]
        self._blk_text[b:b + 1] = [None, None]
        self._blk_refresh_min[b:b + 1] = [-1, -1]  # force reclassification

    # -- views ----------------------------------------------------------------

    def _vis_len(self, seg: Segment, ref_seq: int, client: str | None) -> int:
        if seg.seq == UNASSIGNED:
            if self._foreign_self or seg.client != client:
                return 0
        elif seg.seq > ref_seq and seg.client != client:
            return 0
        if seg.removed_seq is not None:
            if seg.removed_seq == UNASSIGNED:
                if seg.removed_client == client and not self._foreign_self:
                    return 0
            elif (seg.removed_seq <= ref_seq or seg.removed_client == client
                  or client in seg.removed_overlap):
                return 0
        return seg.length

    def get_text(self, ref_seq: int | None = None,
                 client: str | None = "__local__") -> str:
        """Text of the (refSeq, client) view; defaults to the local view."""
        if ref_seq is None:
            ref_seq = self.current_seq
        if client == "__local__":
            client = self.local_client
        self._check_index()
        # Settled segments are visible in every view with refSeq >= minSeq,
        # so fully-settled blocks serve their cached concatenation.
        cacheable = ref_seq >= self.min_seq
        parts = []
        base = 0
        for b, cnt in enumerate(self._blk_counts):
            if cacheable and self._scan_ready(b, base):
                cached = self._blk_text[b]
                if cached is None:
                    cached = "".join(
                        s.content for s in self.segments[base:base + cnt]
                        if not s.is_marker and s.removed_seq is None)
                    self._blk_text[b] = cached
                parts.append(cached)
            else:
                for i in range(base, base + cnt):
                    seg = self.segments[i]
                    if (self._vis_len(seg, ref_seq, client)
                            and not seg.is_marker):
                        parts.append(seg.content)
            base += cnt
        return "".join(parts)

    def local_length(self) -> int:
        self._check_index()
        total = 0
        base = 0
        for b, cnt in enumerate(self._blk_counts):
            if self._scan_ready(b, base):
                total += self._blk_settled[b]
            else:
                total += sum(
                    self._vis_len(self.segments[i], self.current_seq,
                                  self.local_client)
                    for i in range(base, base + cnt))
            base += cnt
        return total

    def get_position(self, target: Segment, ref_seq: int | None = None,
                     client: str | None = "__local__") -> int:
        """Character position of a segment in a view (mergeTree.ts:1578)."""
        if ref_seq is None:
            ref_seq = self.current_seq
        if client == "__local__":
            client = self.local_client
        pos = 0
        for seg in self.segments:
            if seg is target:
                return pos
            pos += self._vis_len(seg, ref_seq, client)
        raise ValueError("segment not in engine")

    # -- resolution ------------------------------------------------------------

    def _split(self, index: int, offset: int) -> None:
        head = self.segments[index]
        tail = head.clone_tail(offset)
        self.segments.insert(index + 1, tail)
        b = self._block_of_elem(index)
        self._blk_counts[b] += 1
        if not head.settled_cached:
            # Unclassified head -> unclassified tail (clone_tail copies the
            # bit). A settled head splits into two settled halves whose
            # lengths sum unchanged — no stat edit either way.
            self._blk_unsettled[b] += 1
        self._blk_text[b] = None
        self._maybe_split_block(b)
        for cb in self.on_split:
            cb(head, tail, offset)

    def _break_tie(self, seg: Segment, ref_seq: int, is_local: bool) -> bool:
        rs = seg.removed_seq
        if rs is not None and rs != UNASSIGNED and rs <= ref_seq:
            return False
        if is_local:
            return True  # local change sees everything (breakTie:2283)
        return seg.seq != UNASSIGNED  # newer merges left; skip our pending

    def _resolve_insert(self, pos: int, ref_seq: int, client: str | None,
                        is_local: bool) -> int:
        """Index at which an insert at `pos` lands (splitting if needed).
        Fully-settled blocks strictly before the target position are
        skipped whole (a settled segment is visible in every valid view,
        and its _break_tie is True, so the walk never stops inside one
        while remaining > 0)."""
        self._check_index()
        remaining = pos
        base = 0
        for b, cnt in enumerate(self._blk_counts):
            if remaining > 0 and self._scan_ready(b, base):
                blk_len = self._blk_settled[b]
                if remaining > blk_len:
                    remaining -= blk_len
                    base += cnt
                    continue
            for i in range(base, base + cnt):
                seg = self.segments[i]
                vis = self._vis_len(seg, ref_seq, client)
                if remaining < vis:
                    if remaining == 0:
                        return i
                    self._split(i, remaining)
                    return i + 1
                if remaining == 0 and self._break_tie(seg, ref_seq,
                                                      is_local):
                    return i
                remaining -= vis
            base += cnt
        if remaining > 0:
            raise IndexError(f"insert position {pos} beyond sequence end")
        return len(self.segments)

    def _ensure_boundary(self, pos: int, ref_seq: int,
                         client: str | None) -> None:
        """Split so that a segment boundary exists at visible position pos."""
        self._check_index()
        remaining = pos
        base = 0
        for b, cnt in enumerate(self._blk_counts):
            if self._scan_ready(b, base) and remaining >= self._blk_settled[b]:
                # Boundary at or past the block's end: no interior split
                # possible here.
                remaining -= self._blk_settled[b]
                base += cnt
                continue
            for i in range(base, base + cnt):
                seg = self.segments[i]
                vis = self._vis_len(seg, ref_seq, client)
                if remaining < vis:
                    if remaining > 0:
                        self._split(i, remaining)
                    return
                remaining -= vis
            base += cnt

    def _range_blocks(self, start: int, end: int, ref_seq: int,
                      client: str | None) -> Iterable[tuple[int, Segment]]:
        """(block, segment) pairs of visible segments covering [start, end)
        in the (refSeq, client) view, after boundary splits. The block index
        lets callers patch block stats when they mutate visibility; it stays
        valid during iteration because visibility mutations never move
        segments between blocks."""
        self._ensure_boundary(start, ref_seq, client)
        self._ensure_boundary(end, ref_seq, client)
        pos = 0
        base = 0
        for b, cnt in enumerate(self._blk_counts):
            if pos >= end:
                break
            if (self._scan_ready(b, base)
                    and pos + self._blk_settled[b] <= start):
                pos += self._blk_settled[b]
                base += cnt
                continue
            for i in range(base, base + cnt):
                if pos >= end:
                    break
                seg = self.segments[i]
                vis = self._vis_len(seg, ref_seq, client)
                if vis and pos >= start:
                    yield b, seg
                pos += vis
            base += cnt

    def _range_segments(self, start: int, end: int, ref_seq: int,
                        client: str | None) -> Iterable[Segment]:
        """Visible segments covering [start, end) in the (refSeq, client)
        view, after boundary splits."""
        for _b, seg in self._range_blocks(start, end, ref_seq, client):
            yield seg

    # -- local edits -----------------------------------------------------------

    def _next_local_seq(self) -> int:
        self._local_seq_counter += 1
        return self._local_seq_counter

    def insert_local(self, pos: int, content: str | Marker,
                     props: dict | None = None) -> dict:
        """Apply a local insert; returns the op payload to submit."""
        local_seq = self._next_local_seq()
        index = self._resolve_insert(pos, self.current_seq, self.local_client,
                                     is_local=True)
        seg = Segment(content=content, seq=UNASSIGNED, client=self.local_client,
                      local_seq=local_seq,
                      props=dict(props) if props else None)
        group = SegmentGroup(op_kind="insert", segments=[seg],
                             local_seq=local_seq)
        seg.groups.append(group)
        self.pending_groups.append(group)
        self.segments.insert(index, seg)
        self._index_inserted_at(index)
        op: dict = {"type": "insert", "pos": pos}
        if isinstance(content, str):
            op["text"] = content
        elif isinstance(content, tuple):
            op["items"] = list(content)
        else:
            op["marker"] = {"ref_type": content.ref_type, "id": content.id}
        if props:
            op["props"] = dict(props)
        return op

    def remove_local(self, start: int, end: int) -> dict:
        local_seq = self._next_local_seq()
        group = SegmentGroup(op_kind="remove", segments=[], local_seq=local_seq)
        for b, seg in self._range_blocks(start, end, self.current_seq,
                                         self.local_client):
            if seg.removed_seq is None:
                if seg.settled_cached:
                    self._index_unsettle(b, seg)
                seg.removed_seq = UNASSIGNED
                seg.removed_client = self.local_client
                seg.removed_local_seq = local_seq
                seg.groups.append(group)
                group.segments.append(seg)
        self.pending_groups.append(group)
        return {"type": "remove", "start": start, "end": end}

    def annotate_local(self, start: int, end: int, props: dict) -> dict:
        local_seq = self._next_local_seq()
        group = SegmentGroup(op_kind="annotate", segments=[],
                             local_seq=local_seq,
                             props_keys=tuple(sorted(props)))
        for seg in self._range_segments(start, end, self.current_seq,
                                        self.local_client):
            for key in props:
                pending = seg.pending_props.get(key)
                if pending is None:
                    base = (seg.props or {}).get(key)
                    seg.pending_props[key] = [1, base]
                else:
                    pending[0] += 1
            self._apply_props(seg, props)
            seg.groups.append(group)
            group.segments.append(seg)
        self.pending_groups.append(group)
        return {"type": "annotate", "start": start, "end": end,
                "props": dict(props)}

    @staticmethod
    def _apply_props(seg: Segment, props: dict) -> None:
        merged = dict(seg.props or {})
        for key, value in props.items():
            if value is None:
                merged.pop(key, None)
            else:
                merged[key] = value
        seg.props = merged or None

    # -- remote apply ----------------------------------------------------------

    def apply_remote(self, op: dict, seq: int, ref_seq: int,
                     client: str, foreign_self: bool = False) -> None:
        """Apply a sequenced op from another client (client.ts applyRemoteOp).
        foreign_self: the op's author is the local client but it must apply
        as remotes do — excluding local unacked state from visibility (a
        VOIDED_LOCAL_ECHO after a lost concurrent-create race)."""
        if foreign_self:
            self._foreign_self = True
            try:
                self.apply_remote(op, seq, ref_seq, client)
            finally:
                self._foreign_self = False
            return
        kind = op["type"]
        if kind == "insert":
            index = self._resolve_insert(op["pos"], ref_seq, client,
                                         is_local=False)
            content: str | tuple | Marker
            if "text" in op:
                content = op["text"]
            elif "items" in op:
                content = tuple(op["items"])  # permutation-vector handles
            else:
                content = Marker(ref_type=op["marker"]["ref_type"],
                                 id=op["marker"]["id"])
            self.segments.insert(index, Segment(
                content=content, seq=seq, client=client,
                props=dict(op["props"]) if op.get("props") else None))
            self._index_inserted_at(index)
        elif kind == "remove":
            for b, seg in self._range_blocks(op["start"], op["end"], ref_seq,
                                             client):
                if seg.removed_seq is None:
                    if seg.settled_cached:
                        self._index_unsettle(b, seg)
                    seg.removed_seq = seq
                    seg.removed_client = client
                elif seg.removed_seq == UNASSIGNED:
                    # Overwrites our pending remove: the remote remove is the
                    # earlier sequenced one (markRangeRemoved:2644-2649).
                    seg.removed_seq = seq
                    seg.removed_client = client
                    seg.removed_local_seq = None
                else:
                    seg.removed_overlap.add(client)
        elif kind == "annotate":
            for seg in self._range_segments(op["start"], op["end"], ref_seq,
                                            client):
                live = {}
                for key, value in op["props"].items():
                    pending = seg.pending_props.get(key)
                    if pending is None:
                        live[key] = value
                    else:
                        # Shadowed in the view, but it IS the latest value on
                        # the acked timeline until our annotate acks.
                        pending[1] = value
                if live:
                    self._apply_props(seg, live)
        else:
            raise ValueError(f"unknown merge-tree op {kind!r}")
        self._advance_seq(seq)

    # -- ack of own ops --------------------------------------------------------

    def ack(self, seq: int) -> None:
        """Our oldest pending op got sequenced (ackPendingSegment:1883)."""
        group = self.pending_groups.popleft()
        for seg in group.segments:
            seg.groups.remove(group)
            if group.op_kind == "insert":
                assert seg.seq == UNASSIGNED
                seg.seq = seq
                seg.local_seq = None
            elif group.op_kind == "remove":
                if seg.removed_seq == UNASSIGNED:
                    seg.removed_seq = seq
                    seg.removed_client = self.local_client
                    seg.removed_local_seq = None
                # else: a remote remove already owns it (overwrite case)
            else:  # annotate
                for key in group.props_keys:
                    pending = seg.pending_props.get(key)
                    if pending is None:
                        continue
                    pending[0] -= 1
                    if pending[0] <= 0:
                        del seg.pending_props[key]
        self._advance_seq(seq)

    def _advance_seq(self, seq: int) -> None:
        assert seq >= self.current_seq
        self.current_seq = seq

    def observe_seq(self, seq: int) -> None:
        """Record a sequenced message that carried no applicable ops (e.g.
        an empty regenerated group) so current_seq — and therefore
        snapshots — stay identical across replicas."""
        self._advance_seq(seq)

    def update_local_client(self, new_client: str) -> None:
        """Reconnect gave us a new client id (reference: collabWindow.clientId
        updated by startOrUpdateCollaboration). Pending segments re-stamp to
        the new identity — their resubmitted ops will sequence under it —
        while acked segments keep the id they sequenced under."""
        old = self.local_client
        self.local_client = new_client
        if old == new_client:
            return
        self._rejoin_normalize_pending = True
        # old may be None: edits made while never-yet-connected stamp
        # client=None and must adopt the first real identity, or their
        # acked segments diverge from what remotes recorded.
        for seg in self.segments:
            if seg.seq == UNASSIGNED and seg.client == old:
                seg.client = new_client
            if seg.removed_seq == UNASSIGNED and seg.removed_client == old:
                seg.removed_client = new_client

    # -- reconnect regeneration (client.ts regeneratePendingOp) ---------------

    def _vis_len_at_local_seq(self, seg: Segment, limit: int) -> int:
        """Visible length in the view 'acked state + my pending ops with
        localSeq < limit' — the state the op with localSeq=limit was
        originally submitted against (reference getPosition w/ localSeq)."""
        if seg.seq == UNASSIGNED:
            if seg.client != self.local_client or (seg.local_seq or 0) > limit:
                return 0
        if seg.removed_seq is not None:
            if seg.removed_seq == UNASSIGNED:
                # <= limit: segments removed by the SAME group count as gone —
                # the applier processes the group's subops sequentially, so an
                # earlier subop's removal is already invisible (same client,
                # same seq) when a later subop's range resolves.
                if (seg.removed_client == self.local_client
                        and (seg.removed_local_seq or 0) <= limit):
                    return 0
            else:
                return 0
        return seg.length

    def get_position_at_local_seq(self, target: Segment, limit: int) -> int:
        pos = 0
        for seg in self.segments:
            if seg is target:
                return pos
            pos += self._vis_len_at_local_seq(seg, limit)
        raise ValueError("segment not in engine")

    def document_order(self, segments: list["Segment"]) -> list["Segment"]:
        """Sort a group's segments by their position in the document —
        the one canonical order for regeneration/ack fragment emission
        (split order is NOT document order). Segments no longer in the
        table sort last."""
        position = {id(s): i for i, s in enumerate(self.segments)}
        return sorted(segments,
                      key=lambda s: position.get(id(s), len(position)))

    def normalize_pending_for_reconnect(self) -> None:
        """Reorder pending (unacked) segments to the canonical side of
        adjacent ACKED-removed tombstones before regenerating their ops
        (the reference's rejoin segment normalization): a remote applier
        of the regenerated insert walks at the reconnect refSeq, where
        those tombstones are invisible holes it skips — landing the text
        AFTER them — while the local segment was physically placed when
        the tombstone was still live (BEFORE it). Bubble pending segments
        rightward past acked tombstones so both layouts agree; visible
        text is unaffected (tombstones have zero visible length), but
        summaries and future tie-breaks see one canonical order."""
        if not self._rejoin_normalize_pending:
            return  # already normalized since the last identity change
        self._rejoin_normalize_pending = False
        segs = self.segments
        changed = True
        while changed:
            changed = False
            for i in range(len(segs) - 1):
                left, right = segs[i], segs[i + 1]
                if (left.seq == UNASSIGNED
                        and right.removed_seq is not None
                        and right.removed_seq != UNASSIGNED):
                    segs[i], segs[i + 1] = right, left
                    changed = True
        self._rebuild_index()  # swaps may have crossed block boundaries

    def normalize_detached(self) -> None:
        """Detached → attached: local-only segments become baseline (seq 0),
        so they serialize into the attach snapshot."""
        for seg in self.segments:
            if seg.seq == UNASSIGNED:
                seg.seq = 0
                seg.local_seq = None
                seg.groups.clear()
            if seg.removed_seq == UNASSIGNED:
                # A detached local remove is simply gone from the baseline.
                seg.removed_seq = 0
                seg.removed_client = None
                seg.removed_local_seq = None
        self.segments = [s for s in self.segments if s.removed_seq is None]
        self.pending_groups.clear()
        self._local_seq_counter = 0
        self._rebuild_index()

    # -- collab window / zamboni ----------------------------------------------

    # Large documents amortize the O(S) zamboni pass over this many minSeq
    # advances; small documents (below _ZAMBONI_EAGER_SEGMENTS) compact on
    # every advance exactly as before. Deferral changes only the in-memory
    # table's compaction timing — text, positions, and snapshot() output
    # are identical (snapshot performs the same normalization itself).
    _ZAMBONI_EVERY = 32
    _ZAMBONI_EAGER_SEGMENTS = 512

    def update_min_seq(self, min_seq: int) -> None:
        """Advance the collab window floor; compact (zamboni, mergeTree:1412).
        Deterministic given the op stream, so replicas stay identical."""
        if min_seq <= self.min_seq:
            return
        self.min_seq = min_seq
        self._zamboni_debt += 1
        if (len(self.segments) > self._ZAMBONI_EAGER_SEGMENTS
                and self._zamboni_debt < self._ZAMBONI_EVERY):
            return
        self._zamboni_debt = 0
        kept: list[Segment] = []
        # Anchor rebinding for compaction: id(old_seg) -> (replacement,
        # delta). delta None = slide to the replacement's start (offset 0);
        # otherwise new_offset = old_offset + delta (coalesce).
        rebind: dict[int, tuple[Segment | None, int | None]] = {}
        pending_drops: list[Segment] = []
        for seg in self.segments:
            if (seg.removed_seq is not None and seg.removed_seq != UNASSIGNED
                    and seg.removed_seq <= min_seq and not seg.groups):
                # Removed outside the window: gone forever. Segments still
                # referenced by a pending local group survive (reconnect
                # regeneration must be able to find them); their groups
                # clear at ack and a later advance collects them.
                pending_drops.append(seg)
                continue
            if seg.seq != UNASSIGNED and seg.seq <= min_seq:
                # Below the window: no in-flight op can reference this seq
                # (the sequencer NACKs refSeq < MSN), so normalize identity.
                seg.seq = 0
                seg.client = None
            prev = kept[-1] if kept else None
            if (
                prev is not None
                and not prev.is_marker and not seg.is_marker
                and isinstance(prev.content, type(seg.content))
                and prev.removed_seq is None and seg.removed_seq is None
                and prev.seq == 0 and seg.seq == 0
                and prev.client is None and seg.client is None
                and prev.props == seg.props
                and not prev.pending_props and not seg.pending_props
                and not prev.groups and not seg.groups
            ):
                rebind[id(seg)] = (prev, len(prev.content))
                prev.content = prev.content + seg.content  # coalesce
            else:
                kept.append(seg)
            # Dropped tombstones slide anchors to the next survivor's start.
            for dropped in pending_drops:
                rebind[id(dropped)] = (kept[-1], None)
            pending_drops = []
        for dropped in pending_drops:
            rebind[id(dropped)] = (None, None)  # end of sequence
        self.segments = kept
        self._rebuild_index()
        if rebind:
            # Chase chains (dropped -> coalesced target -> ...).
            for cb in self.on_compact:
                cb(rebind)

    # -- snapshot (snapshotV1.ts equivalent; canonical acked state) ------------

    def snapshot(self) -> dict:
        """Canonical snapshot: pure acked state, structure-normalized so ALL
        converged replicas emit byte-identical summaries regardless of how
        their local edit history happened to split segments.

        Normalization rules: pending inserts excluded; pending removes appear
        live; pending annotate values replaced by their acked base; segments
        removed at or below min_seq dropped; below-window identity erased
        (seq→0, client→None); adjacent entries with identical metadata
        coalesced."""
        segs: list[dict] = []
        for seg in self.segments:
            if seg.seq == UNASSIGNED:
                continue  # pending local insert is never summarized
            removed = (seg.removed_seq is not None
                       and seg.removed_seq != UNASSIGNED)
            if removed and seg.removed_seq <= self.min_seq:
                continue  # tombstone below the window: gone
            below = seg.seq <= self.min_seq
            props = dict(seg.props or {})
            for key, (_count, base) in seg.pending_props.items():
                if base is None:
                    props.pop(key, None)
                else:
                    props[key] = base
            entry: dict[str, Any] = {
                "seq": 0 if below else seg.seq,
                "client": None if below else seg.client,
            }
            if seg.is_marker:
                entry["marker"] = {"ref_type": seg.content.ref_type,
                                   "id": seg.content.id}
            elif isinstance(seg.content, tuple):
                entry["items"] = list(seg.content)
            else:
                entry["text"] = seg.content
            if props:
                entry["props"] = dict(sorted(props.items()))
            if removed:
                entry["removed_seq"] = seg.removed_seq
                entry["removed_client"] = seg.removed_client
                if seg.removed_overlap:
                    entry["removed_overlap"] = sorted(seg.removed_overlap)
            prev = segs[-1] if segs else None
            mergeable_key = "text" if "text" in entry else (
                "items" if "items" in entry else None)
            if (
                prev is not None and mergeable_key is not None
                and mergeable_key in prev
                and all(prev.get(k) == entry.get(k) for k in
                        ("seq", "client", "props", "removed_seq",
                         "removed_client", "removed_overlap"))
            ):
                prev[mergeable_key] += entry[mergeable_key]
                continue
            segs.append(entry)
        if len(segs) <= SNAPSHOT_CHUNK_SEGMENTS:
            return {"seq": self.current_seq, "min_seq": self.min_seq,
                    "segments": segs}
        # Chunked form (snapshotChunks.ts / snapshotV1 header+body parity):
        # big documents split the segment table so loaders can process one
        # chunk at a time (bounded peak memory) and blob-level storage
        # dedups unchanged chunks across summaries. Small documents keep
        # the flat form — formats are distinguished by the "header" key.
        chunks = [segs[i:i + SNAPSHOT_CHUNK_SEGMENTS]
                  for i in range(0, len(segs), SNAPSHOT_CHUNK_SEGMENTS)]
        return {"seq": self.current_seq, "min_seq": self.min_seq,
                "header": {"total_segments": len(segs),
                           "chunk_count": len(chunks)},
                "segments": chunks[0],
                "extra_chunks": chunks[1:]}

    @classmethod
    def load(cls, snapshot: dict, local_client: str | None = None
             ) -> "MergeEngine":
        engine = cls(local_client)
        engine.current_seq = snapshot["seq"]
        engine.min_seq = snapshot["min_seq"]
        entries = snapshot["segments"]
        if "header" in snapshot:
            # Chunked form: consume chunk-by-chunk (itertools.chain keeps
            # peak memory at one chunk beyond the segment list itself).
            entries = itertools.chain(
                entries, *snapshot.get("extra_chunks", ()))
        for entry in entries:
            content: str | tuple | Marker
            if "marker" in entry:
                content = Marker(ref_type=entry["marker"]["ref_type"],
                                 id=entry["marker"]["id"])
            elif "items" in entry:
                content = tuple(entry["items"])
            else:
                content = entry["text"]
            engine.segments.append(Segment(
                content=content,
                seq=entry["seq"],
                client=entry["client"],
                removed_seq=entry.get("removed_seq"),
                removed_client=entry.get("removed_client"),
                removed_overlap=set(entry.get("removed_overlap", ())),
                props=dict(entry["props"]) if entry.get("props") else None,
            ))
        engine._rebuild_index()
        return engine
