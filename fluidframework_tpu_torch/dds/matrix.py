"""SharedMatrix permutation vectors — the server side's scalar matrix axis.

Port of ``PermutationVector`` from ``fluidframework_tpu/dds/matrix.py``
(verbatim, imports pointed at the port). Reference parity:
packages/dds/matrix/src/permutationvector.ts:38 — rows and cols of a
SharedMatrix are each a merge-tree whose segments carry runs of storage
handles, so row/col insert/remove gets the full sequence-CRDT treatment.

Storage handles are allocated DETERMINISTICALLY in sequence order — local
inserts use negative temp handles remapped at ack, remote inserts allocate
in apply order — so every replica keys every cell identically.

The merge host uses it as the scalar twin of a device matrix row (the
route past ``max_client_slots``), and ``chip_smoke.py`` replays sequenced
streams through it as the oracle. ``SharedMatrix`` itself (the client DDS)
is not needed on the server path and is not ported.
"""

from __future__ import annotations

from .mergetree import MergeEngine


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
