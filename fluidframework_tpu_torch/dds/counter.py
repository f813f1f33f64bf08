"""SharedCounter DDS — shared integer with commutative increments.

Reference parity: packages/dds/counter/src/counter.ts:73 (``SharedCounter``):
local increments apply eagerly; remote increments add on arrival; the local
op's ack is a no-op because addition commutes — no pending tracking needed.
"""

from __future__ import annotations

from typing import Any, Callable

from ..protocol.messages import SequencedDocumentMessage
from .shared_object import ChannelFactory, SharedObject


class SharedCounter(SharedObject):
    channel_type = "https://graph.microsoft.com/types/counter"

    def __init__(self, channel_id: str, runtime=None, attributes=None) -> None:
        super().__init__(channel_id, runtime, attributes)
        self.value: int = 0
        self.on_incremented: list[Callable[[int, int], None]] = []

    def increment(self, delta: int = 1) -> None:
        if not isinstance(delta, int):
            raise TypeError("SharedCounter increments must be integers")
        self._apply(delta)
        self.submit_local_message({"type": "increment", "delta": delta})

    def _apply(self, delta: int) -> None:
        self.value += delta
        for cb in self.on_incremented:
            cb(delta, self.value)

    def process_core(self, message: SequencedDocumentMessage, local: bool,
                     local_op_metadata: Any) -> None:
        if local:
            return  # already applied eagerly; addition commutes
        self._apply(message.contents["delta"])

    def summarize_core(self) -> dict:
        return {"value": self.value}

    def load_core(self, content: dict) -> None:
        self.value = content["value"]

    def apply_stashed_op(self, contents: Any) -> Any:
        self._apply(contents["delta"])
        return None


class SharedCounterFactory(ChannelFactory):
    channel_type = SharedCounter.channel_type
    shared_object_cls = SharedCounter
