"""Interval collections — annotated ranges that survive concurrent edits.

Reference parity: packages/dds/sequence/src/intervalCollection.ts:673
(``IntervalCollection``) + SequenceInterval (:107): named collections of
intervals whose endpoints are *local references* into the merge-tree —
anchored to (segment, offset) so they follow the text through inserts and
slide forward past removed segments (LocalReferenceCollection semantics).

Conflict model (matching the reference's interval value-type ops):
add/change/delete per interval id, last-writer-wins under the total order,
with pending-local shadowing per id. Endpoints in ops are positions in the
sender's (refSeq, client) view, re-anchored at apply.
"""

from __future__ import annotations

import bisect
import itertools
from dataclasses import dataclass, field
from typing import Any, Iterator

from .mergetree import MergeEngine, Segment, UNASSIGNED


@dataclass(slots=True)
class LocalRef:
    """A position anchor: (segment, offset). Slides forward on removal."""

    segment: Segment | None  # None = end of sequence
    offset: int = 0


@dataclass(slots=True)
class SequenceInterval:
    id: str
    start: LocalRef
    end: LocalRef
    props: dict = field(default_factory=dict)


_INDEX_BLOCK = 64  # entries per max-end pruning block of the query index


class IntervalCollection:
    """One labeled collection of intervals over a merge engine."""

    def __init__(self, label: str, engine: MergeEngine, submit) -> None:
        self.label = label
        self._engine = engine
        self._submit = submit  # (op_dict, metadata) -> None
        self.intervals: dict[str, SequenceInterval] = {}
        # id -> latest pending local message id (shadowing, map-style).
        self._pending: dict[str, int] = {}
        self._next_id = itertools.count(1)
        self._next_pending = itertools.count(1)
        engine.on_split.append(self._on_split)
        engine.on_compact.append(self._on_compact)
        # Overlap-query index (intervalCollection.ts:265 IntervalTree +
        # endIntervalTree). Anchor DOCUMENT order is edit-stable, so the
        # index holds intervals sorted by resolved start and is rebuilt
        # lazily: one O(S + n log n) pass the first query after any edit
        # (engine fingerprint + explicit dirty marks), O(log n + k)
        # afterwards — edits don't pay unless somebody queries.
        self._index_dirty = True
        self._index_fp: tuple | None = None
        self._index_entries: list[tuple[int, int, SequenceInterval]] = []
        self._index_starts: list[int] = []
        self._index_block_max_end: list[int] = []

    def _on_split(self, head: Segment, tail: Segment, offset: int) -> None:
        self._index_dirty = True
        for interval in self.intervals.values():
            for ref in (interval.start, interval.end):
                if ref.segment is head and ref.offset >= offset:
                    ref.segment = tail
                    ref.offset -= offset

    def _on_compact(self, rebind: dict) -> None:
        """Zamboni dropped/coalesced segments: chase anchors to survivors.
        rebind: {id(old_seg): (replacement | None, delta | None)} — delta
        None slides to the replacement's start; otherwise offset += delta."""
        self._index_dirty = True
        for interval in self.intervals.values():
            for ref in (interval.start, interval.end):
                while ref.segment is not None and id(ref.segment) in rebind:
                    replacement, delta = rebind[id(ref.segment)]
                    if delta is None:
                        ref.segment = replacement
                        ref.offset = 0
                    else:
                        ref.segment = replacement
                        ref.offset += delta

    # -- anchoring -------------------------------------------------------------

    def _anchor(self, pos: int, ref_seq: int, client: str | None) -> LocalRef:
        """Resolve a view position to a (segment, offset) anchor."""
        remaining = pos
        for seg in self._engine.segments:
            vis = self._engine._vis_len(seg, ref_seq, client)
            if remaining < vis:
                return LocalRef(seg, remaining)
            remaining -= vis
        return LocalRef(None, 0)

    def _resolve(self, ref: LocalRef) -> int:
        """Current local position of an anchor; slides past removed text."""
        engine = self._engine
        return self._resolve_with(
            ref, lambda seg: engine._vis_len(seg, engine.current_seq,
                                             engine.local_client))

    def _resolve_at(self, ref: LocalRef, limit: int) -> int:
        """Position in the frame 'acked + my pending ops with localSeq <=
        limit' — what a pending interval op submitted at that horizon
        addresses (reconnect regeneration)."""
        engine = self._engine
        return self._resolve_with(
            ref, lambda seg: engine._vis_len_at_local_seq(seg, limit))

    def _resolve_with(self, ref: LocalRef, vis_fn) -> int:
        if ref.segment is None:
            return sum(vis_fn(seg) for seg in self._engine.segments)
        pos = 0
        for seg in self._engine.segments:
            vis = vis_fn(seg)
            if seg is ref.segment:
                return pos + min(ref.offset, max(vis - 1, 0)) if vis else pos
            pos += vis
        return pos  # anchor's segment was compacted away: slid to here

    # -- public API ------------------------------------------------------------

    def add(self, start: int, end: int, props: dict | None = None,
            interval_id: str | None = None) -> SequenceInterval:
        interval_id = interval_id or f"{self.label}-{next(self._next_id)}"
        client = self._engine.local_client
        interval = SequenceInterval(
            id=interval_id,
            start=self._anchor(start, self._engine.current_seq, client),
            end=self._anchor(end, self._engine.current_seq, client),
            props=dict(props or {}),
        )
        self.intervals[interval_id] = interval
        self._index_dirty = True
        pending_id = next(self._next_pending)
        self._pending[interval_id] = pending_id
        self._submit({"type": "intervalAdd", "label": self.label,
                      "id": interval_id, "start": start, "end": end,
                      "props": dict(props or {})},
                     ("interval", self.label, interval_id, pending_id,
                      self._engine._local_seq_counter))
        return interval

    def change(self, interval_id: str, start: int | None = None,
               end: int | None = None, props: dict | None = None) -> None:
        interval = self.intervals[interval_id]
        client = self._engine.local_client
        if start is not None:
            interval.start = self._anchor(start, self._engine.current_seq,
                                          client)
        if end is not None:
            interval.end = self._anchor(end, self._engine.current_seq, client)
        self._index_dirty = True
        if props:
            interval.props.update(props)
            interval.props = {k: v for k, v in interval.props.items()
                              if v is not None}
        pending_id = next(self._next_pending)
        self._pending[interval_id] = pending_id
        self._submit({"type": "intervalChange", "label": self.label,
                      "id": interval_id, "start": start, "end": end,
                      "props": dict(props or {})},
                     ("interval", self.label, interval_id, pending_id,
                      self._engine._local_seq_counter))

    def delete(self, interval_id: str) -> None:
        self.intervals.pop(interval_id, None)
        self._index_dirty = True
        pending_id = next(self._next_pending)
        self._pending[interval_id] = pending_id
        self._submit({"type": "intervalDelete", "label": self.label,
                      "id": interval_id},
                     ("interval", self.label, interval_id, pending_id,
                      self._engine._local_seq_counter))

    def get(self, interval_id: str) -> SequenceInterval | None:
        return self.intervals.get(interval_id)

    def resolved(self) -> dict[str, tuple[int, int, dict]]:
        """{id: (start, end, props)} in the current local view."""
        return {
            interval_id: (self._resolve(i.start), self._resolve(i.end),
                          dict(i.props))
            for interval_id, i in sorted(self.intervals.items())
        }

    # -- overlap queries (intervalCollection.ts:265-334) -----------------------

    def _rebuild_index(self) -> None:
        engine = self._engine
        fp = (engine.current_seq, engine._local_seq_counter,
              len(self.intervals))
        if not self._index_dirty and fp == self._index_fp:
            return
        # One visibility sweep resolves EVERY anchor in O(S) — per-anchor
        # _resolve would make the rebuild O(n*S).
        prefix: dict[int, tuple[int, int]] = {}
        pos = 0
        for seg in engine.segments:
            vis = engine._vis_len(seg, engine.current_seq,
                                  engine.local_client)
            prefix[id(seg)] = (pos, vis)
            pos += vis
        total = pos

        def resolve(ref: LocalRef) -> int:
            if ref.segment is None:
                return total
            entry = prefix.get(id(ref.segment))
            if entry is None:
                return total  # compacted away mid-flight; slid to end
            base, vis = entry
            return base + min(ref.offset, max(vis - 1, 0)) if vis else base

        entries = sorted(
            ((resolve(i.start), resolve(i.end), i)
             for i in self.intervals.values()),
            key=lambda e: (e[0], e[1], e[2].id))
        self._index_entries = entries
        self._index_starts = [e[0] for e in entries]
        # Block-max over ends: skip a whole block when nothing in it can
        # reach back to the query start (the augmented-tree pruning).
        self._index_block_max_end = [
            max(e[1] for e in entries[b:b + _INDEX_BLOCK])
            for b in range(0, len(entries), _INDEX_BLOCK)]
        self._index_dirty = False
        self._index_fp = fp

    def find_overlapping_intervals(self, start: int, end: int
                                   ) -> list[SequenceInterval]:
        """Intervals [s, e] with s <= end and e >= start, in start order —
        findOverlappingIntervals (intervalCollection.ts:295; inclusive
        endpoints match the reference's IntervalTree.match semantics)."""
        if end < start:
            return []
        self._rebuild_index()
        hi = bisect.bisect_right(self._index_starts, end)
        out: list[SequenceInterval] = []
        b = 0
        while b * _INDEX_BLOCK < hi:
            lo = b * _INDEX_BLOCK
            if self._index_block_max_end[b] < start:
                b += 1  # nothing in this block reaches the query
                continue
            for s, e, interval in self._index_entries[
                    lo:min(lo + _INDEX_BLOCK, hi)]:
                if e >= start:
                    out.append(interval)
            b += 1
        return out

    def previous_interval(self, pos: int) -> SequenceInterval | None:
        """Interval with the greatest start <= pos (ties: greatest end) —
        previousInterval, intervalCollection.ts:313."""
        self._rebuild_index()
        idx = bisect.bisect_right(self._index_starts, pos) - 1
        if idx < 0:
            return None
        # Entries sort by (start, end, id), so the last entry with
        # start <= pos already has the greatest (end, id) among ties.
        return self._index_entries[idx][2]

    def next_interval(self, pos: int) -> SequenceInterval | None:
        """Interval with the smallest start >= pos (ties: smallest end) —
        nextInterval, intervalCollection.ts:321."""
        self._rebuild_index()
        idx = bisect.bisect_left(self._index_starts, pos)
        if idx >= len(self._index_entries):
            return None
        return self._index_entries[idx][2]

    def iterate(self, reverse: bool = False,
                start_position: int | None = None
                ) -> Iterator[SequenceInterval]:
        """Start-ordered iteration, optionally from a given start
        position (CreateForwardIteratorWithStartPosition family,
        intervalCollection.ts:689-727)."""
        self._rebuild_index()
        if start_position is None:
            entries = self._index_entries
        else:
            lo = bisect.bisect_left(self._index_starts, start_position)
            hi = bisect.bisect_right(self._index_starts, start_position)
            entries = self._index_entries[lo:hi]
        for _, _, interval in (reversed(entries) if reverse else entries):
            yield interval

    # -- sequenced apply -------------------------------------------------------

    def process(self, op: dict, local: bool, metadata, message) -> None:
        interval_id = op["id"]
        self._index_dirty = True
        if local:
            pending_id = metadata[3]
            if self._pending.get(interval_id) == pending_id:
                del self._pending[interval_id]
            return
        kind = op["type"]
        if kind == "intervalDelete":
            # Delete wins even over pending local ops on the id: the pending
            # change becomes a no-op everywhere (interval gone), so replicas
            # converge on deletion rather than diverging on existence.
            self.intervals.pop(interval_id, None)
            self._pending.pop(interval_id, None)
            return
        if interval_id in self._pending:
            return  # shadowed by a pending local op on this interval
        ref_seq = message.reference_sequence_number
        client = message.client_id
        if kind == "intervalAdd":
            self.intervals[interval_id] = SequenceInterval(
                id=interval_id,
                start=self._anchor(op["start"], ref_seq, client),
                end=self._anchor(op["end"], ref_seq, client),
                props=dict(op.get("props") or {}),
            )
        else:  # intervalChange
            interval = self.intervals.get(interval_id)
            if interval is None:
                return
            if op.get("start") is not None:
                interval.start = self._anchor(op["start"], ref_seq, client)
            if op.get("end") is not None:
                interval.end = self._anchor(op["end"], ref_seq, client)
            for key, value in (op.get("props") or {}).items():
                if value is None:
                    interval.props.pop(key, None)
                else:
                    interval.props[key] = value

    # -- summary ---------------------------------------------------------------

    def _vis_acked(self, seg: Segment) -> int:
        """Visible length in the pure acked view — what the engine's own
        snapshot serializes (pending inserts absent, pending removes live)."""
        if seg.seq == UNASSIGNED:
            return 0
        if seg.removed_seq is not None and seg.removed_seq != UNASSIGNED:
            return 0
        return seg.length

    def snapshot(self) -> dict:
        """Canonical: positions resolved in the ACKED view, matching the
        acked text the engine snapshot carries (pending ids excluded)."""
        out = []
        for interval_id, interval in sorted(self.intervals.items()):
            if interval_id in self._pending:
                continue  # unacked local interval state is not summarized
            out.append({
                "id": interval_id,
                "start": self._resolve_with(interval.start, self._vis_acked),
                "end": self._resolve_with(interval.end, self._vis_acked),
                "props": dict(sorted(interval.props.items())),
            })
        return {"label": self.label, "intervals": out}

    def load(self, snap: dict) -> None:
        self._index_dirty = True
        client = self._engine.local_client
        for entry in snap["intervals"]:
            self.intervals[entry["id"]] = SequenceInterval(
                id=entry["id"],
                start=self._anchor(entry["start"], self._engine.current_seq,
                                   client),
                end=self._anchor(entry["end"], self._engine.current_seq,
                                 client),
                props=dict(entry["props"]),
            )
