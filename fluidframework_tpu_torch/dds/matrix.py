"""SharedMatrix DDS — 2-D sparse grid with merge-tree row/col OT.

Reference parity: packages/dds/matrix/src/matrix.ts:75 (``SharedMatrix``):
rows and cols are each a *permutation vector* — a merge-tree whose segments
carry runs of storage handles (permutationvector.ts:38) — so row/col
insert/remove gets the full sequence-CRDT treatment for free; cells are an
LWW table keyed (rowHandle, colHandle) with pending-local-write shadowing
(matrix.ts:547-593 processCore, isLatestPendingWrite).

Deviation for byte-identical summaries (stronger than the reference, which
only guarantees per-replica-consistent handles): storage handles are
allocated DETERMINISTICALLY in sequence order — local inserts use negative
temp handles remapped at ack, remote inserts allocate in apply order — so
every replica keys every cell identically and full summaries compare equal.

The permutation vectors reuse :class:`fluidframework_tpu_torch.dds.
mergetree.MergeEngine` with tuple-of-handle segment content (slicing/
visibility/tie-break semantics are content-agnostic). The merge host also
uses ``PermutationVector`` as the scalar twin of a device matrix row (the
route past ``max_client_slots``).
"""

from __future__ import annotations

from typing import Any

from ..protocol.messages import SequencedDocumentMessage
from .mergetree import MergeEngine, UNASSIGNED
from .shared_object import ChannelFactory, SharedObject

_MISSING = object()  # "cell had no acked value before the pending write"


class PermutationVector:
    """A merge-tree of handle runs + deterministic handle allocation."""

    def __init__(self, local_client: str | None = None) -> None:
        self.engine = MergeEngine(local_client)
        self.next_handle = 0      # final handles, allocated in seq order
        self.next_temp = -1       # local pending handles (negative)

    # -- local ops ------------------------------------------------------------

    def insert_local(self, pos: int, count: int) -> tuple[dict, int, tuple]:
        temps = tuple(range(self.next_temp, self.next_temp - count, -1))
        self.next_temp -= count
        op = self.engine.insert_local(pos, temps)
        group = self.engine.pending_groups[-1]
        return ({"type": "insert", "pos": op["pos"], "count": count},
                group.local_seq, temps)

    def remove_local(self, pos: int, count: int) -> tuple[dict, int]:
        self.engine.remove_local(pos, pos + count)
        group = self.engine.pending_groups[-1]
        return ({"type": "remove", "start": pos, "end": pos + count},
                group.local_seq)

    # -- sequenced apply ------------------------------------------------------

    def ack(self, seq: int) -> dict[int, int]:
        """Ack our front pending op. For inserts, remap temp handles to
        final handles allocated in DOCUMENT order (a remote applier of the
        same op lays handles left-to-right in one run — assignment must
        match even if our copy was split). Returns the temp→final map."""
        group = self.engine.pending_groups[0]
        remap: dict[int, int] = {}
        if group.op_kind == "insert":
            for seg in self.engine.document_order(group.segments):
                finals = []
                for temp in seg.content:
                    final = self.next_handle
                    self.next_handle += 1
                    remap[temp] = final
                    finals.append(final)
                seg.content = tuple(finals)
        self.engine.ack(seq)
        return remap

    def apply_remote(self, op: dict, seq: int, ref_seq: int,
                     client: str) -> None:
        if op["type"] == "insert":
            handles = range(self.next_handle, self.next_handle + op["count"])
            self.next_handle += op["count"]
            self.engine.apply_remote(
                {"type": "insert", "pos": op["pos"], "items": list(handles)},
                seq, ref_seq, client)
        elif op["type"] == "insertGroup":
            # Regenerated multi-fragment insert (a pending run split by an
            # interleaving insert): fragments apply sequentially at one
            # seq in DOCUMENT order, handles allocated in that order —
            # matching the submitter's document-order ack assignment.
            for pos, count in op["ranges"]:
                handles = range(self.next_handle, self.next_handle + count)
                self.next_handle += count
                self.engine.apply_remote(
                    {"type": "insert", "pos": pos,
                     "items": list(handles)}, seq, ref_seq, client)
        elif op["type"] == "removeGroup":
            # Regenerated multi-segment remove: ranges apply sequentially at
            # one seq (earlier ranges' removals are invisible to later walks,
            # same client+seq — mirrors the sequence group op).
            for start, end in op["ranges"]:
                self.engine.apply_remote(
                    {"type": "remove", "start": start, "end": end},
                    seq, ref_seq, client)
        else:
            self.engine.apply_remote(
                {"type": "remove", "start": op["start"], "end": op["end"]},
                seq, ref_seq, client)

    # -- resolution -----------------------------------------------------------

    def handle_at(self, pos: int, ref_seq: int | None = None,
                  client: str | None = "__local__") -> int | None:
        """Storage handle at a logical position in a view (adjustPosition)."""
        engine = self.engine
        if ref_seq is None:
            ref_seq = engine.current_seq
        if client == "__local__":
            client = engine.local_client
        remaining = pos
        for seg in engine.segments:
            vis = engine._vis_len(seg, ref_seq, client)
            if remaining < vis:
                return seg.content[remaining]
            remaining -= vis
        return None

    def position_of_handle(self, handle: int) -> int | None:
        """Current local position of a handle, or None if its row is gone."""
        engine = self.engine
        pos = 0
        for seg in engine.segments:
            vis = engine._vis_len(seg, engine.current_seq, engine.local_client)
            if vis and handle in seg.content:
                return pos + seg.content.index(handle)
            pos += vis
        return None

    def position_of_handle_at(self, handle: int, limit: int) -> int | None:
        """Position of a handle in the view 'acked + my pending vector ops
        with localSeq <= limit' — the frame a pending cell op submitted at
        that point addresses (reconnect regeneration)."""
        engine = self.engine
        pos = 0
        for seg in engine.segments:
            vis = engine._vis_len_at_local_seq(seg, limit)
            if vis and handle in seg.content:
                return pos + seg.content.index(handle)
            pos += vis
        return None

    def local_seq_horizon(self) -> int:
        return engine._local_seq_counter if (engine := self.engine) else 0

    def length(self) -> int:
        return self.engine.local_length()

    def live_handles(self) -> set[int]:
        engine = self.engine
        out: set[int] = set()
        for seg in engine.segments:
            if engine._vis_len(seg, engine.current_seq, engine.local_client):
                out.update(seg.content)
        return out

    def all_known_handles(self) -> set[int]:
        out: set[int] = set()
        for seg in self.engine.segments:
            out.update(seg.content)
        return out

    # -- snapshot -------------------------------------------------------------

    def snapshot(self) -> dict:
        snap = self.engine.snapshot()
        snap["next_handle"] = self.next_handle
        return snap

    @classmethod
    def load(cls, snap: dict, local_client: str | None = None
             ) -> "PermutationVector":
        vector = cls(local_client)
        vector.engine = MergeEngine.load(snap, local_client)
        vector.next_handle = snap["next_handle"]
        return vector


class SharedMatrix(SharedObject):
    channel_type = "https://graph.microsoft.com/types/sharedmatrix"

    def __init__(self, channel_id: str, runtime=None, attributes=None) -> None:
        super().__init__(channel_id, runtime, attributes)
        self.rows = PermutationVector()
        self.cols = PermutationVector()
        # (row_handle, col_handle) -> value; LWW under the total order.
        self.cells: dict[tuple[int, int], Any] = {}
        # (row_handle, col_handle) -> [latest pending localSeq, acked base
        # value] — the base is what summaries must show while the local
        # write shadows the view (same model as map/merge-tree pending).
        self._pending_cells: dict[tuple[int, int], list] = {}
        self._local_seq = 0
        # Per-AXIS temp→final handle remaps: rows and cols allocate temp
        # handles from separate -1,-2,... sequences, so one shared table
        # would let a rows remap clobber a cols remap for the same temp id
        # (found by the matrix reconnect farm: a pending cell's column
        # resolved through the ROWS remap and landed in the wrong column).
        self._remap_log: dict[str, dict[int, int]] = {"rows": {},
                                                      "cols": {}}

    # -- identity -------------------------------------------------------------

    def _bind_client(self) -> None:
        if self.runtime is None:
            return
        container = self.runtime.parent.container
        cid = container.client_id
        if cid is not None:
            if cid != self.rows.engine.local_client:
                self.rows.engine.update_local_client(cid)
                self.cols.engine.update_local_client(cid)

    # -- dimensions -----------------------------------------------------------

    @property
    def row_count(self) -> int:
        return self.rows.length()

    @property
    def col_count(self) -> int:
        return self.cols.length()

    # -- public API -----------------------------------------------------------

    def insert_rows(self, pos: int, count: int) -> None:
        self._bind_client()
        op, local_seq, _temps = self.rows.insert_local(pos, count)
        self.submit_local_message({"target": "rows", **op},
                                  ("vector", "rows", local_seq))

    def remove_rows(self, pos: int, count: int) -> None:
        self._bind_client()
        op, local_seq = self.rows.remove_local(pos, count)
        self.submit_local_message({"target": "rows", **op},
                                  ("vector", "rows", local_seq))

    def insert_cols(self, pos: int, count: int) -> None:
        self._bind_client()
        op, local_seq, _temps = self.cols.insert_local(pos, count)
        self.submit_local_message({"target": "cols", **op},
                                  ("vector", "cols", local_seq))

    def remove_cols(self, pos: int, count: int) -> None:
        self._bind_client()
        op, local_seq = self.cols.remove_local(pos, count)
        self.submit_local_message({"target": "cols", **op},
                                  ("vector", "cols", local_seq))

    def set_cell(self, row: int, col: int, value: Any) -> None:
        self._bind_client()
        row_handle = self.rows.handle_at(row)
        col_handle = self.cols.handle_at(col)
        if row_handle is None or col_handle is None:
            raise IndexError(f"cell ({row}, {col}) out of bounds")
        key = (row_handle, col_handle)
        self._local_seq += 1
        pending = self._pending_cells.get(key)
        if pending is None:
            self._pending_cells[key] = [self._local_seq,
                                        self.cells.get(key, _MISSING)]
        else:
            pending[0] = self._local_seq
        self.cells[key] = value
        self.submit_local_message(
            {"target": "cell", "type": "set", "row": row, "col": col,
             "value": value},
            ("cell", row_handle, col_handle, self._local_seq,
             self.rows.local_seq_horizon(), self.cols.local_seq_horizon()),
        )

    def get_cell(self, row: int, col: int) -> Any:
        row_handle = self.rows.handle_at(row)
        col_handle = self.cols.handle_at(col)
        if row_handle is None or col_handle is None:
            return None
        return self.cells.get((row_handle, col_handle))

    # -- SharedObject contract ------------------------------------------------

    def process_core(self, message: SequencedDocumentMessage, local: bool,
                     local_op_metadata: Any) -> None:
        self._bind_client()
        contents = message.contents
        target = contents["target"]
        seq = message.sequence_number

        if target in ("rows", "cols"):
            vector = self.rows if target == "rows" else self.cols
            if local:
                # A stashed multi-range op spans several engine groups;
                # all ack at this message's seq (sequence.py's
                # stashed_group shape).
                acks = (len(local_op_metadata[2])
                        if isinstance(local_op_metadata, tuple)
                        and local_op_metadata
                        and local_op_metadata[0] == "vector_multi" else 1)
                remap: dict[int, int] = {}
                for _ in range(acks):
                    remap.update(vector.ack(seq))
                if remap:
                    self._remap_handles(remap, axis=target)
            else:
                vector.apply_remote(
                    {k: v for k, v in contents.items() if k != "target"},
                    seq, message.reference_sequence_number, message.client_id)
            for v in (self.rows, self.cols):
                v.engine.observe_seq(seq)
                v.engine.update_min_seq(message.minimum_sequence_number)
            self._prune_dead_cells()
            return

        # Cell set.
        if local:
            _tag, row_handle, col_handle, local_seq = local_op_metadata[:4]
            # Temp handles may have been remapped by a row/col ack.
            row_handle = self._current_handle(row_handle, "rows")
            col_handle = self._current_handle(col_handle, "cols")
            key = (row_handle, col_handle)
            pending = self._pending_cells.get(key)
            if pending is not None and pending[0] == local_seq:
                del self._pending_cells[key]
        else:
            row_handle = self.rows.handle_at(
                contents["row"], message.reference_sequence_number,
                message.client_id)
            col_handle = self.cols.handle_at(
                contents["col"], message.reference_sequence_number,
                message.client_id)
            if row_handle is not None and col_handle is not None:
                key = (row_handle, col_handle)
                pending = self._pending_cells.get(key)
                if pending is None:
                    self.cells[key] = contents["value"]
                else:
                    # Shadowed in the view, but it IS the acked value until
                    # our pending write sequences.
                    pending[1] = contents["value"]
        for v in (self.rows, self.cols):
            v.engine.observe_seq(seq)
            v.engine.update_min_seq(message.minimum_sequence_number)
        self._prune_dead_cells()

    @staticmethod
    def _regen_vector_ranges(vector: PermutationVector,
                             local_seq) -> tuple[str | None, list[list[int]]]:
        """(op kind, regenerated ranges) of one pending vector group, its
        fragments in document order; (None, []) when already acked."""
        group = next((g for g in vector.engine.pending_groups
                      if g.local_seq == local_seq), None)
        if group is None:
            return None, []
        ranges: list[list[int]] = []
        for seg in vector.engine.document_order(group.segments):
            if group.op_kind == "insert":
                if seg.seq != UNASSIGNED:
                    continue
                pos = vector.engine.get_position_at_local_seq(seg, local_seq)
                ranges.append([pos, len(seg.content)])
            else:
                if seg.removed_seq != UNASSIGNED:
                    continue  # a remote remove won; nothing to resubmit
                pos = vector.engine.get_position_at_local_seq(seg, local_seq)
                ranges.append([pos, pos + seg.length])
        return group.op_kind, ranges

    def _remap_handles(self, remap: dict[int, int], axis: str) -> None:
        """A local row/col insert acked: temp handles became final."""
        self._remap_log[axis].update(remap)
        for table in (self.cells, self._pending_cells):
            for (rh, ch) in list(table):
                new_rh = remap.get(rh, rh) if axis == "rows" else rh
                new_ch = remap.get(ch, ch) if axis == "cols" else ch
                if (new_rh, new_ch) != (rh, ch):
                    table[(new_rh, new_ch)] = table.pop((rh, ch))

    def _current_handle(self, handle: int, axis: str) -> int:
        if handle >= 0:
            return handle
        return self._remap_log[axis].get(handle, handle)

    def _prune_dead_cells(self) -> None:
        """Drop cells whose row/col handle no longer exists in ANY segment
        (zamboni collected it) — deterministic across replicas."""
        known_rows = self.rows.all_known_handles()
        known_cols = self.cols.all_known_handles()
        for table in (self.cells, self._pending_cells):
            for (rh, ch) in list(table):
                if (rh >= 0 and rh not in known_rows) or (
                        ch >= 0 and ch not in known_cols):
                    del table[(rh, ch)]

    # -- resubmit (reconnect) -------------------------------------------------

    def resubmit_core(self, contents: Any, metadata: Any) -> None:
        self._bind_client()
        if metadata is None:
            return
        if metadata[0] in ("vector", "vector_multi"):
            if metadata[0] == "vector":
                _tag, axis, local_seqs = metadata[0], metadata[1], \
                    [metadata[2]]
            else:
                _tag, axis, local_seqs = metadata
            vector = self.rows if axis == "rows" else self.cols
            # Rejoin normalization + document-order fragment emission:
            # the same two reconnect rules the sequence path applies (see
            # MergeEngine.normalize_pending_for_reconnect and
            # sequence._regenerate_group_subops).
            vector.engine.normalize_pending_for_reconnect()
            kind = None
            ranges: list[list[int]] = []
            for local_seq in local_seqs:
                group_kind, group_ranges = self._regen_vector_ranges(
                    vector, local_seq)
                if group_kind is not None:
                    kind = group_kind
                ranges.extend(group_ranges)
            if kind is None:
                return  # every group already acked
            if kind == "insert":
                if len(ranges) == 1:
                    self.submit_local_message(
                        {"target": axis, "type": "insert",
                         "pos": ranges[0][0], "count": ranges[0][1]},
                        metadata)
                else:
                    # Split pending run: per-fragment inserts in document
                    # order at one seq (a contiguous re-insert would
                    # re-assemble differently on remotes).
                    self.submit_local_message(
                        {"target": axis, "type": "insertGroup",
                         "ranges": ranges}, metadata)
            else:
                self.submit_local_message(
                    {"target": axis, "type": "removeGroup",
                     "ranges": ranges}, metadata)
            return
        # Cell set: recompute the handles' logical position in the frame of
        # this op's submission point — pending vector ops submitted LATER
        # must not shift it (they replay after us and re-shift remotely).
        _tag, row_handle, col_handle, local_seq, rows_limit, cols_limit = \
            metadata
        row_handle = self._current_handle(row_handle, "rows")
        col_handle = self._current_handle(col_handle, "cols")
        pending = self._pending_cells.get((row_handle, col_handle))
        if pending is None or pending[0] != local_seq:
            return  # superseded by a newer local write
        row = self.rows.position_of_handle_at(row_handle, rows_limit)
        col = self.cols.position_of_handle_at(col_handle, cols_limit)
        if row is None or col is None:
            del self._pending_cells[(row_handle, col_handle)]
            return  # the row/col died while we were away
        self.submit_local_message(
            {"target": "cell", "type": "set", "row": row, "col": col,
             "value": self.cells[(row_handle, col_handle)]},
            ("cell", row_handle, col_handle, local_seq, rows_limit,
             cols_limit),
        )

    # -- summary --------------------------------------------------------------

    def on_attach(self) -> None:
        for vector in (self.rows, self.cols):
            # Finalize temp handles deterministically (document order).
            for seg in vector.engine.segments:
                if seg.seq == UNASSIGNED and any(
                        h < 0 for h in seg.content):
                    finals = []
                    for _ in seg.content:
                        finals.append(vector.next_handle)
                        vector.next_handle += 1
                    remap = dict(zip(seg.content, finals))
                    seg.content = tuple(finals)
                    self._remap_handles(
                        remap,
                        axis="rows" if vector is self.rows else "cols")
            vector.engine.normalize_detached()
        self._pending_cells.clear()

    def summarize_core(self) -> dict:
        known_rows = self.rows.all_known_handles()
        known_cols = self.cols.all_known_handles()
        acked: dict[tuple[int, int], Any] = {}
        for key, value in self.cells.items():
            pending = self._pending_cells.get(key)
            if pending is not None:
                if pending[1] is _MISSING:
                    continue  # no acked value yet at this cell
                value = pending[1]
            acked[key] = value
        return {
            "rows": self.rows.snapshot(),
            "cols": self.cols.snapshot(),
            "cells": [
                [list(key), value]
                for key, value in sorted(acked.items())
                if key[0] in known_rows and key[1] in known_cols
            ],
        }

    def load_core(self, content: dict) -> None:
        self.rows = PermutationVector.load(content["rows"])
        self.cols = PermutationVector.load(content["cols"])
        self.cells = {tuple(key): value for key, value in content["cells"]}

    def apply_stashed_op(self, contents: Any) -> Any:
        """Re-apply a stashed local op (offline resume — the reference's
        SharedMatrix applyStashedOp path, matrix.ts). Mutates local state
        exactly as the original submit did and returns the metadata the
        ack/resubmit paths expect; no message is sent (the pending-state
        loader owns submission)."""
        self._bind_client()
        target = contents["target"]
        if target in ("rows", "cols"):
            vector = self.rows if target == "rows" else self.cols
            if contents["type"] == "insert":
                _op, local_seq, _temps = vector.insert_local(
                    contents["pos"], contents["count"])
            elif contents["type"] == "insertGroup":
                # One stashed message, several engine groups: the ack path
                # pops one group per local_seq listed (vector_multi).
                seqs = []
                for pos, count in contents["ranges"]:
                    _op, ls, _temps = vector.insert_local(pos, count)
                    seqs.append(ls)
                return ("vector_multi", target, seqs)
            elif contents["type"] == "removeGroup":
                seqs = []
                for start, end in contents["ranges"]:
                    _op, ls = vector.remove_local(start, end - start)
                    seqs.append(ls)
                return ("vector_multi", target, seqs)
            else:
                _op, local_seq = vector.remove_local(
                    contents["start"], contents["end"] - contents["start"])
            return ("vector", target, local_seq)
        # Cell set: the local mutation of set_cell without the submit.
        row_handle = self.rows.handle_at(contents["row"])
        col_handle = self.cols.handle_at(contents["col"])
        if row_handle is None or col_handle is None:
            return None  # the row/col died before the stash resumed
        key = (row_handle, col_handle)
        self._local_seq += 1
        pending = self._pending_cells.get(key)
        if pending is None:
            self._pending_cells[key] = [self._local_seq,
                                        self.cells.get(key, _MISSING)]
        else:
            pending[0] = self._local_seq
        self.cells[key] = contents["value"]
        return ("cell", row_handle, col_handle, self._local_seq,
                self.rows.local_seq_horizon(), self.cols.local_seq_horizon())


class SharedMatrixFactory(ChannelFactory):
    channel_type = SharedMatrix.channel_type
    shared_object_cls = SharedMatrix
