"""SharedCell DDS — a single LWW register.

Reference parity: packages/dds/cell/src/cell.ts:99 (``SharedCell``): set and
delete ops with pending-message-id shadowing — a one-key SharedMap.
"""

from __future__ import annotations

from typing import Any

from ..protocol.messages import SequencedDocumentMessage
from ..runtime.handles import decode_value, encode_value
from .shared_object import ChannelFactory, SharedObject

_EMPTY = object()


class SharedCell(SharedObject):
    channel_type = "https://graph.microsoft.com/types/cell"

    def __init__(self, channel_id: str, runtime=None, attributes=None) -> None:
        super().__init__(channel_id, runtime, attributes)
        self._value: Any = _EMPTY
        self._pending_message_id = -1
        self._next_message_id = 0

    # -- public API -----------------------------------------------------------

    def set(self, value: Any) -> None:
        value = encode_value(value)
        self._value = value
        self.submit_local_message({"type": "setCell", "value": value},
                                  self._pend())

    def delete(self) -> None:
        self._value = _EMPTY
        self.submit_local_message({"type": "deleteCell"}, self._pend())

    def get(self) -> Any:
        return None if self._value is _EMPTY else \
            decode_value(self._value, self._handle_resolver())

    @property
    def empty(self) -> bool:
        return self._value is _EMPTY

    def _pend(self) -> int:
        self._next_message_id += 1
        self._pending_message_id = self._next_message_id
        return self._pending_message_id

    # -- SharedObject contract ------------------------------------------------

    def process_core(self, message: SequencedDocumentMessage, local: bool,
                     local_op_metadata: Any) -> None:
        if local:
            if self._pending_message_id == local_op_metadata:
                self._pending_message_id = -1
            return
        if self._pending_message_id != -1:
            return  # local pending write shadows remote ops
        op = message.contents
        if op["type"] == "setCell":
            self._value = op["value"]
        else:
            self._value = _EMPTY

    def on_attach(self) -> None:
        # Detached writes never submitted → never acked; drop the pending id
        # so remote ops are not shadowed forever.
        self._pending_message_id = -1

    def summarize_core(self) -> dict:
        if self._value is _EMPTY:
            return {"empty": True}
        return {"empty": False, "value": self._value}

    def load_core(self, content: dict) -> None:
        self._value = _EMPTY if content["empty"] else content["value"]

    def resubmit_core(self, contents: Any, metadata: Any) -> None:
        self.submit_local_message(contents, self._pend())

    def apply_stashed_op(self, contents: Any) -> Any:
        if contents["type"] == "setCell":
            self._value = contents["value"]
        else:
            self._value = _EMPTY
        return self._pend()


class SharedCellFactory(ChannelFactory):
    channel_type = SharedCell.channel_type
    shared_object_cls = SharedCell
