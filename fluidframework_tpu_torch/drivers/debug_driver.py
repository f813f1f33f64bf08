"""Debugger driver — single-step a recorded document through the stack.

Reference parity: packages/drivers/debugger (FluidDebugger: a document
service wrapper that pauses op delivery and replays under user control —
debuggerUi "play to", "step") layered on the replay-driver shape
(replayController's replayTo). The container loads its snapshot and then
receives recorded sequenced ops ONLY when the controller's ``step`` /
``play_to`` / ``play`` advance the cursor, so document state can be
inspected at any historical sequence number.

Usage::

    messages = [...]                    # recorded sequenced log
    service = DebuggerDocumentService(messages)
    container = Container.load(service)   # state at start_seq
    service.step(5)                       # deliver the next 5 ops
    service.play_to(120)                  # deliver through seq 120
    service.play()                        # run to the end

The tools/debug_tool.py CLI drives this from a recorded directory.
"""

from __future__ import annotations

from typing import Any, Callable

from ..protocol.messages import NackMessage, SequencedDocumentMessage
from .base import IncomingHandler
from .replay_driver import (
    _ReplayConnection,
    _ReplayDeltaStorage,
    _ReplaySnapshotStorage,
)


class DebuggerDocumentService:
    """Replay service with a movable cursor (the debugger's transport)."""

    def __init__(self, messages: list[SequencedDocumentMessage],
                 snapshot: dict | None = None, start_seq: int = 0) -> None:
        self.messages = sorted(messages, key=lambda m: m.sequence_number)
        self.storage = _ReplaySnapshotStorage(snapshot)
        # Catch-up reads are clamped to the cursor so a DeltaManager gap
        # fetch can never run ahead of the debugger.
        self.delta_storage = _ReplayDeltaStorage(self.messages, start_seq)
        self.cursor = start_seq
        self._handlers: list[IncomingHandler] = []

    # -- DocumentService ------------------------------------------------------

    def connect(self, handler: IncomingHandler,
                on_nack: Callable[[NackMessage], None] | None = None,
                on_signal: Callable[[Any], None] | None = None,
                mode: str = "read") -> _ReplayConnection:
        self._handlers.append(handler)
        return _ReplayConnection()

    # -- debugger controls ----------------------------------------------------

    @property
    def end_seq(self) -> int:
        return (self.messages[-1].sequence_number if self.messages else 0)

    def play_to(self, seq: int) -> list[SequencedDocumentMessage]:
        """Deliver recorded ops with cursor < sequence_number <= seq."""
        batch = [m for m in self.messages
                 if self.cursor < m.sequence_number <= seq]
        if seq > self.cursor:
            self.cursor = seq
            self.delta_storage._up_to = seq
        if batch:
            for handler in self._handlers:
                handler(list(batch))
        return batch

    def step(self, count: int = 1) -> list[SequencedDocumentMessage]:
        """Deliver the next ``count`` recorded ops."""
        if count <= 0:
            return []
        upcoming = [m.sequence_number for m in self.messages
                    if m.sequence_number > self.cursor]
        if not upcoming:
            return []
        return self.play_to(upcoming[min(count, len(upcoming)) - 1])

    def play(self) -> list[SequencedDocumentMessage]:
        """Run to the end of the recording."""
        return self.play_to(self.end_seq)
