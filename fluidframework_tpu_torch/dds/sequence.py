"""SharedString DDS — collaborative text + markers over the merge engine.

Reference parity: packages/dds/sequence/src/sharedString.ts:36 (SharedString:
insertText:141, removeText, annotateRange, markers) and sequence.ts:51
(SharedSegmentSequence.processCore:552, reSubmitCore:484) over merge-tree's
Client (client.ts:44 — applyMsg:819, applyRemoteOp:790, ack:610,
regeneratePendingOp:877).
"""

from __future__ import annotations

from typing import Any

from ..protocol.messages import SequencedDocumentMessage
from .mergetree import Marker, MergeEngine, UNASSIGNED
from .shared_object import VOIDED_LOCAL_ECHO, ChannelFactory, SharedObject


class SharedString(SharedObject):
    channel_type = "https://graph.microsoft.com/types/mergeTree"

    def __init__(self, channel_id: str, runtime=None, attributes=None) -> None:
        super().__init__(channel_id, runtime, attributes)
        # The engine needs the local client id to stamp pending segments; we
        # bind it lazily at first submit/process via the container.
        self.engine = MergeEngine(local_client=None)
        self._interval_collections: dict[str, "IntervalCollection"] = {}
        # Local-edit notifications (undo-redo, attribution): fired after a
        # local public-API edit submits, with enough info to invert it
        # (the reference's sequenceDelta event on local ops).
        self.on_local_edit: list = []

    # -- identity ------------------------------------------------------------

    def _bind_client(self) -> None:
        if self.runtime is None:
            return
        container = self.runtime.parent.container
        if (container.client_id is not None
                and container.client_id != self.engine.local_client):
            self.engine.update_local_client(container.client_id)

    # -- public API (sharedString.ts) ----------------------------------------

    def insert_text(self, pos: int, text: str,
                    props: dict | None = None) -> None:
        self._bind_client()
        op = self.engine.insert_local(pos, text, props)
        group = self.engine.pending_groups[-1]
        self.submit_local_message(op, group.local_seq)
        for cb in self.on_local_edit:
            cb({"kind": "insert", "pos": pos, "length": len(text),
                "segments": list(group.segments)})

    def insert_marker(self, pos: int, ref_type: str = "simple",
                      marker_id: str | None = None,
                      props: dict | None = None) -> None:
        self._bind_client()
        op = self.engine.insert_local(
            pos, Marker(ref_type=ref_type, id=marker_id), props)
        group = self.engine.pending_groups[-1]
        self.submit_local_message(op, group.local_seq)
        for cb in self.on_local_edit:
            cb({"kind": "insert", "pos": pos, "length": 1,
                "segments": list(group.segments)})

    def remove_text(self, start: int, end: int) -> None:
        self._bind_client()
        op = self.engine.remove_local(start, end)
        group = self.engine.pending_groups[-1]
        self.submit_local_message(op, group.local_seq)
        if self.on_local_edit:
            # The removed content comes from the segments this local remove
            # actually hit (positions in get_text() would miscount markers).
            items = [
                {**({"marker": {"ref_type": seg.content.ref_type,
                                "id": seg.content.id}}
                    if seg.is_marker else {"text": seg.content}),
                 **({"props": dict(seg.props)} if seg.props else {})}
                for seg in group.segments
            ]
            for cb in self.on_local_edit:
                cb({"kind": "remove", "start": start, "items": items,
                    "segments": list(group.segments)})

    def annotate_range(self, start: int, end: int, props: dict) -> None:
        self._bind_client()
        prior = None
        if self.on_local_edit:
            # Per-segment prior values for the annotated keys, captured
            # BEFORE the apply so undo can re-annotate them back (the
            # reference's merge-tree revertibles invert annotate via
            # propertyChanged deltas). _range_segments splits at the range
            # boundaries, so the same call inside annotate_local sees the
            # identical segment list.
            prior = [
                (seg, {k: (seg.props or {}).get(k) for k in props})
                for seg in self.engine._range_segments(
                    start, end, self.engine.current_seq,
                    self.engine.local_client)
            ]
        op = self.engine.annotate_local(start, end, props)
        self.submit_local_message(op, self.engine.pending_groups[-1].local_seq)
        if prior is not None:
            for cb in self.on_local_edit:
                cb({"kind": "annotate", "start": start, "end": end,
                    "props": dict(props), "prior": prior})

    def get_interval_collection(self, label: str) -> "IntervalCollection":
        """Named interval collection over this string (sequence.ts
        getIntervalCollection)."""
        from .intervals import IntervalCollection
        if label not in self._interval_collections:
            self._interval_collections[label] = IntervalCollection(
                label, self.engine, self.submit_local_message)
        return self._interval_collections[label]

    def get_text(self) -> str:
        return self.engine.get_text()

    def __len__(self) -> int:
        return self.engine.local_length()

    # -- SharedObject contract ------------------------------------------------

    def process_core(self, message: SequencedDocumentMessage, local: bool,
                     local_op_metadata: Any) -> None:
        self._bind_client()
        contents = message.contents
        if isinstance(contents, dict) and str(
                contents.get("type", "")).startswith("interval"):
            collection = self.get_interval_collection(contents["label"])
            collection.process(contents, local, local_op_metadata, message)
            self.engine.observe_seq(message.sequence_number)
            self.engine.update_min_seq(message.minimum_sequence_number)
            return
        if local:
            # A stashed "group" op spans several engine groups; all ack at
            # this message's seq (the same frame a remote applier uses).
            acks = (len(local_op_metadata[1])
                    if isinstance(local_op_metadata, tuple)
                    and local_op_metadata
                    and local_op_metadata[0] == "stashed_group" else 1)
            for _ in range(acks):
                self.engine.ack(message.sequence_number)
        else:
            contents = message.contents
            ops = (contents["ops"] if contents["type"] == "group"
                   else [contents])
            for op in ops:
                self.engine.apply_remote(
                    op,
                    message.sequence_number,
                    message.reference_sequence_number,
                    message.client_id,
                    foreign_self=local_op_metadata is VOIDED_LOCAL_ECHO,
                )
            # An empty regenerated group still advances the seq horizon, or
            # replica snapshots would disagree on "seq".
            self.engine.observe_seq(message.sequence_number)
        self.engine.update_min_seq(message.minimum_sequence_number)

    def resubmit_core(self, contents: Any, metadata: Any) -> None:
        """Reconnect: regenerate every pending op against current state
        (client.ts regeneratePendingOp). Called once per pending message in
        FIFO order; each call regenerates the oldest *unregenerated* group."""
        self._bind_client()
        # Rejoin normalization (idempotent; see MergeEngine docstring).
        self.engine.normalize_pending_for_reconnect()
        if isinstance(metadata, tuple) and metadata and metadata[0] == "interval":
            _tag, label, interval_id, pending_id, horizon = metadata
            collection = self.get_interval_collection(label)
            if collection._pending.get(interval_id) != pending_id:
                return  # superseded by a newer local op on this interval
            interval = collection.intervals.get(interval_id)
            if interval is None:
                self.submit_local_message(
                    {"type": "intervalDelete", "label": label,
                     "id": interval_id}, metadata)
                return
            # Positions in the frame at this op's submission horizon — later
            # pending text ops replay after us and re-shift remotely.
            self.submit_local_message(
                {"type": "intervalAdd", "label": label, "id": interval_id,
                 "start": collection._resolve_at(interval.start, horizon),
                 "end": collection._resolve_at(interval.end, horizon),
                 "props": dict(interval.props)}, metadata)
            return
        if isinstance(metadata, tuple) and metadata \
                and metadata[0] == "stashed_group":
            # A stashed group op: regenerate every surviving engine group
            # into one combined group message (same metadata, re-entrant).
            subops = []
            for local_seq in metadata[1]:
                subops.extend(self._regenerate_group_subops(local_seq))
            self.submit_local_message({"type": "group", "ops": subops},
                                      metadata)
            return
        # metadata = the original op's localSeq; re-entrant acks may have
        # already popped earlier groups, so look the group up, not index it.
        if next((g for g in self.engine.pending_groups
                 if g.local_seq == metadata), None) is None:
            return  # already acked through an earlier replay round
        self.submit_local_message(
            {"type": "group",
             "ops": self._regenerate_group_subops(metadata)}, metadata)

    def _regenerate_group_subops(self, local_seq) -> list[dict]:
        group = next((g for g in self.engine.pending_groups
                      if g.local_seq == local_seq), None)
        if group is None:
            return []  # already acked through an earlier replay round
        # Positions are computed in the view as of this op's localSeq —
        # later local pending ops must not shift them (the remote applier
        # won't have seen those yet when this op sequences).
        #
        # Fragments MUST emit in DOCUMENT order (group.segments is split
        # order, not document order): each fragment's position counts the
        # group's earlier-in-document fragments as present, and the remote
        # applier processes subops sequentially — an out-of-order emission
        # re-assembles a split insert differently on remotes than the
        # fragments sit locally (found by the reference-intensity
        # reconnect farm). Same ordering rule as PermutationVector.ack's
        # document-order handle assignment.
        ordered = self.engine.document_order(group.segments)
        limit = group.local_seq
        subops = []
        if group.op_kind == "insert":
            for seg in ordered:
                if seg.seq != UNASSIGNED:
                    continue
                pos = self.engine.get_position_at_local_seq(seg, limit)
                op: dict = {"type": "insert", "pos": pos}
                if seg.is_marker:
                    op["marker"] = {"ref_type": seg.content.ref_type,
                                    "id": seg.content.id}
                else:
                    op["text"] = seg.content
                if seg.props:
                    op["props"] = dict(seg.props)
                subops.append(op)
        elif group.op_kind == "remove":
            for seg in ordered:
                if seg.removed_seq != UNASSIGNED:
                    continue  # a remote remove won; nothing to resubmit
                pos = self.engine.get_position_at_local_seq(seg, limit)
                subops.append({"type": "remove", "start": pos,
                               "end": pos + seg.length})
        else:  # annotate
            for seg in ordered:
                if not any(k in seg.pending_props for k in group.props_keys):
                    continue
                if seg.removed_seq is not None:
                    # A removed segment can never become visible again; a
                    # regenerated range op would land on live neighbors.
                    # The optimistic local annotation must REVERT to the
                    # acked base — the op carrying it will never sequence,
                    # so replicas that never saw it keep the tombstone
                    # unannotated (summaries must match byte-for-byte).
                    for key in group.props_keys:
                        pending = seg.pending_props.get(key)
                        if pending is None:
                            continue
                        pending[0] -= 1
                        if pending[0] <= 0:
                            base = pending[1]
                            del seg.pending_props[key]
                            if seg.props is not None:
                                if base is None:
                                    seg.props.pop(key, None)
                                    if not seg.props:
                                        seg.props = None
                                else:
                                    seg.props[key] = base
                    continue
                pos = self.engine.get_position_at_local_seq(seg, limit)
                props = {k: (seg.props or {}).get(k)
                         for k in group.props_keys}
                subops.append({"type": "annotate", "start": pos,
                               "end": pos + seg.length, "props": props})
        return subops

    def on_attach(self) -> None:
        self.engine.normalize_detached()

    def summarize_core(self) -> dict:
        content = self.engine.snapshot()
        collections = [c.snapshot()
                       for _l, c in sorted(self._interval_collections.items())]
        collections = [c for c in collections if c["intervals"]]
        if collections:
            content["interval_collections"] = collections
        return content

    def load_core(self, content: dict) -> None:
        self.engine = MergeEngine.load(content,
                                       local_client=self.engine.local_client)
        self._interval_collections = {}
        for snap in content.get("interval_collections", ()):
            self.get_interval_collection(snap["label"]).load(snap)

    def apply_stashed_op(self, contents: Any) -> Any:
        if str(contents.get("type", "")).startswith("interval"):
            collection = self.get_interval_collection(contents["label"])
            interval_id = contents["id"]
            pending_id = next(collection._next_pending)
            collection._pending[interval_id] = pending_id
            if contents["type"] == "intervalDelete":
                collection.intervals.pop(interval_id, None)
            elif contents["type"] == "intervalAdd":
                from .intervals import LocalRef, SequenceInterval
                collection.intervals[interval_id] = SequenceInterval(
                    id=interval_id,
                    start=collection._anchor(contents["start"],
                                             self.engine.current_seq,
                                             self.engine.local_client),
                    end=collection._anchor(contents["end"],
                                           self.engine.current_seq,
                                           self.engine.local_client),
                    props=dict(contents.get("props") or {}),
                )
            else:  # intervalChange
                interval = collection.intervals.get(interval_id)
                if interval is not None:
                    for key, value in (contents.get("props") or {}).items():
                        if value is None:
                            interval.props.pop(key, None)
                        else:
                            interval.props[key] = value
            return ("interval", contents["label"], interval_id, pending_id,
                    self.engine._local_seq_counter)
        ops = (contents["ops"] if contents["type"] == "group" else [contents])
        local_seqs = []
        for op in ops:
            if op["type"] == "insert":
                content = (op["text"] if "text" in op
                           else Marker(ref_type=op["marker"]["ref_type"],
                                       id=op["marker"]["id"]))
                self.engine.insert_local(op["pos"], content, op.get("props"))
            elif op["type"] == "remove":
                self.engine.remove_local(op["start"], op["end"])
            else:
                self.engine.annotate_local(op["start"], op["end"],
                                           op["props"])
            local_seqs.append(self.engine.pending_groups[-1].local_seq)
        # The metadata the ack/resubmit paths expect: the created group's
        # localSeq (a stashed "group" op spans several engine groups that
        # must regenerate together into one message).
        if len(local_seqs) == 1:
            return local_seqs[0]
        return ("stashed_group", local_seqs)


class SharedStringFactory(ChannelFactory):
    channel_type = SharedString.channel_type
    shared_object_cls = SharedString
