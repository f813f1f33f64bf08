"""Undo/redo stacks driven by DDS local-edit events.

Reference parity: packages/framework/undo-redo — ``UndoRedoStackManager``
(operation grouping, undo/redo stacks) with a SharedMap handler (revert via
the valueChanged previousValue) and a SharedSegmentSequence handler (invert
insert/remove). Like the reference, reverts are submitted as ordinary local
ops — they merge like any other edit.

Limitation (v1, as in the reference's simple map handler): positions in
sequence revertibles are the positions at edit time; a revert races
concurrent remote edits like any op would.
"""

from __future__ import annotations

from typing import Callable

from ..dds.cell import SharedCell
from ..dds.counter import SharedCounter
from ..dds.map import SharedMap
from ..dds.sequence import SharedString


class Revertible:
    def __init__(self, revert: Callable[[], None],
                 discard: Callable[[], None] | None = None) -> None:
        self.revert = revert
        # Called when the revertible is dropped without reverting (redo
        # stack invalidation, stack cap) — releases tracked segments.
        self.discard = discard or (lambda: None)


class UndoRedoStackManager:
    """Groups revertibles into operations; undoing an operation records the
    inverse ops it generates as the matching redo group
    (undoRedoStackManager.ts)."""

    MAX_DEPTH = 100  # oldest operations are discarded beyond this

    def __init__(self) -> None:
        self._undo: list[list[Revertible]] = []
        self._redo: list[list[Revertible]] = []
        self._open = False  # an operation group is accumulating
        # Where newly-recorded revertibles go: the undo stack normally, the
        # in-flight inverse group while a revert is running.
        self._capture: list[Revertible] | None = None

    # -- recording -------------------------------------------------------------

    def _deliver(self, revertible: Revertible) -> None:
        if self._capture is not None:
            self._capture.append(revertible)
            return
        if not self._open or not self._undo:
            self._undo.append([])
            self._open = True
        self._undo[-1].append(revertible)
        self._drop_all(self._redo)  # a fresh edit invalidates redo
        while len(self._undo) > self.MAX_DEPTH:
            self._drop_group(self._undo.pop(0))

    @staticmethod
    def _drop_group(group: list[Revertible]) -> None:
        for revertible in group:
            revertible.discard()

    @classmethod
    def _drop_all(cls, stack: list[list[Revertible]]) -> None:
        for group in stack:
            cls._drop_group(group)
        stack.clear()

    def close_current_operation(self) -> None:
        """End the current group; the next edit starts a new undoable op."""
        self._open = False

    # -- undo/redo -------------------------------------------------------------

    @property
    def can_undo(self) -> bool:
        return bool(self._undo)

    @property
    def can_redo(self) -> bool:
        return bool(self._redo)

    def undo(self) -> None:
        self.close_current_operation()
        if self._undo:
            self._redo.append(self._revert_group(self._undo.pop()))

    def redo(self) -> None:
        if self._redo:
            self._undo.append(self._revert_group(self._redo.pop()))
            self._open = False

    def _revert_group(self, group: list[Revertible]) -> list[Revertible]:
        """Revert newest-first while capturing the inverse ops the reverts
        generate; the captured group goes on the opposite stack."""
        inverse: list[Revertible] = []
        self._capture = inverse
        try:
            for revertible in reversed(group):
                revertible.revert()
        finally:
            self._capture = None
        return inverse

    # -- DDS subscriptions -----------------------------------------------------

    def subscribe_map(self, shared_map: SharedMap) -> None:
        """Record local set/delete with the previous value
        (sharedMapUndoRedoHandler.ts)."""
        def on_value_changed(key: str, local: bool, previous,
                             existed: bool) -> None:
            if not local:
                return
            if not existed:
                self._deliver(Revertible(lambda: shared_map.delete(key)))
            else:
                self._deliver(Revertible(lambda: shared_map.set(key, previous)))

        def on_clear(local: bool, previous: dict) -> None:
            if not local:
                return

            def restore() -> None:
                for key, value in previous.items():
                    shared_map.set(key, value)
            self._deliver(Revertible(restore))
        shared_map.data.on_value_changed.append(on_value_changed)
        shared_map.data.on_clear.append(on_clear)

    def subscribe_counter(self, counter: SharedCounter) -> None:
        original = counter.increment

        def increment(delta: int = 1):
            result = original(delta)
            # Reverting calls this wrapper again, so the inverse records
            # its own inverse while a revert-capture is active.
            self._deliver(Revertible(lambda: increment(-delta)))
            return result
        counter.increment = increment  # type: ignore[method-assign]

    def subscribe_cell(self, cell: SharedCell) -> None:
        original_set, original_delete = cell.set, cell.delete

        def record_inverse(previous, was_empty: bool) -> None:
            if was_empty:
                self._deliver(Revertible(lambda: delete_()))
            else:
                self._deliver(Revertible(lambda: set_(previous)))

        def set_(value):
            previous, was_empty = cell.get(), cell.empty
            original_set(value)
            record_inverse(previous, was_empty)

        def delete_():
            previous, was_empty = cell.get(), cell.empty
            original_delete()
            if not was_empty:
                record_inverse(previous, was_empty)
        cell.set = set_        # type: ignore[method-assign]
        cell.delete = delete_  # type: ignore[method-assign]

    def subscribe_string(self, shared_string: SharedString) -> None:
        """Invert local insert/remove position-robustly: the edited segments
        ride a TrackingGroup (split tails join automatically), so the revert
        targets wherever those segments live NOW — concurrent remote edits
        shift them and the undo still hits the right content (the
        reference's merge-tree revertibles over tracking groups)."""
        from ..dds.mergetree import TrackingGroup
        engine = shared_string.engine

        def track(segments) -> TrackingGroup:
            group = TrackingGroup()
            for seg in segments:
                group.link(seg)
            return group

        def revert_insert(group: TrackingGroup) -> None:
            # Remove each tracked segment still visible, one at a time
            # (positions recomputed per call as earlier removes shift them).
            segments = list(group.segments)
            group.unlink_all()
            for seg in segments:
                if engine._vis_len(seg, engine.current_seq,
                                   engine.local_client) == 0:
                    continue  # already removed (e.g. by a remote edit)
                pos = engine.get_position(seg)
                shared_string.remove_text(pos, pos + seg.length)

        def revert_remove(group: TrackingGroup, items: list[dict],
                          fallback_start: int) -> None:
            # Reinsert at the tombstones' current position: removed segments
            # persist in the tree with zero visible length, so get_position
            # gives exactly where the gap sits after concurrent edits.
            anchor = group.segments[0] if group.segments else None
            in_tree = anchor is not None and any(
                s is anchor for s in engine.segments)
            pos = engine.get_position(anchor) if in_tree else fallback_start
            # items[i] was built from group.segments[i]; the tombstones'
            # OTHER tracking groups must adopt the restored segments (the
            # reference transfers trackingCollection on restore) so e.g.
            # undoing the original insert later also removes restored text.
            old_segments = list(group.segments)
            group.unlink_all()
            pos = min(pos, len(shared_string))
            # One-shot listener grabs each insert's new segment (the pending
            # group may already be acked re-entrantly by an in-proc server).
            captured: list = []
            hook = lambda e: captured.append(e["segments"])  # noqa: E731
            shared_string.on_local_edit.append(hook)
            try:
                for i, item in enumerate(items):
                    captured.clear()
                    props = item.get("props")
                    if "marker" in item:
                        shared_string.insert_marker(
                            pos, item["marker"]["ref_type"],
                            item["marker"]["id"], props)
                        pos += 1
                    else:
                        shared_string.insert_text(pos, item["text"], props)
                        pos += len(item["text"])
                    if i < len(old_segments) and captured:
                        new_seg = captured[-1][0]
                        for g in old_segments[i].groups:
                            if isinstance(g, TrackingGroup):
                                g.link(new_seg)
            finally:
                shared_string.on_local_edit.remove(hook)

        def revert_annotate(entries: list) -> None:
            # One tracking group per original segment keeps its prior values
            # attached across splits: every segment in a group (split tails
            # auto-join) re-annotates back to that original's prior props.
            for group, prior in entries:
                segments = list(group.segments)
                group.unlink_all()
                for seg in segments:
                    if engine._vis_len(seg, engine.current_seq,
                                       engine.local_client) == 0:
                        continue  # removed meanwhile; nothing to restore
                    pos = engine.get_position(seg)
                    shared_string.annotate_range(pos, pos + seg.length,
                                                 dict(prior))

        def on_local_edit(edit: dict) -> None:
            if edit["kind"] == "annotate":
                entries = [(track([seg]), prior)
                           for seg, prior in edit["prior"]]

                def discard_annotate() -> None:
                    for group, _prior in entries:
                        group.unlink_all()
                self._deliver(Revertible(
                    lambda: revert_annotate(entries), discard_annotate))
                return
            group = track(edit["segments"])
            if edit["kind"] == "insert":
                self._deliver(Revertible(
                    lambda: revert_insert(group), group.unlink_all))
            elif edit["kind"] == "remove":
                items, start = edit["items"], edit["start"]
                self._deliver(Revertible(
                    lambda: revert_remove(group, items, start),
                    group.unlink_all))
        shared_string.on_local_edit.append(on_local_edit)
