"""SharedMap DDS — LWW key-value store channel.

Reference parity: packages/dds/map/src/map.ts:103 (``SharedMap``) over the
kernel in :mod:`fluidframework_tpu_torch.dds.map_data` (mapKernel.ts).
"""

from __future__ import annotations

from typing import Any

from ..protocol.messages import SequencedDocumentMessage
from ..runtime.handles import decode_value, encode_value
from .map_data import MapData
from .shared_object import ChannelFactory, SharedObject


class SharedMap(SharedObject):
    channel_type = "https://graph.microsoft.com/types/map"

    def __init__(self, channel_id: str, runtime=None, attributes=None) -> None:
        super().__init__(channel_id, runtime, attributes)
        self.data = MapData()

    # -- public API (map.ts set/get/delete/clear) ----------------------------

    def set(self, key: str, value: Any) -> "SharedMap":
        op, metadata = self.data.local_set(key, encode_value(value))
        self.submit_local_message(op, metadata)
        return self

    def get(self, key: str, default: Any = None) -> Any:
        if not self.data.has(key):
            return default  # caller's default returned untouched
        return decode_value(self.data.get(key), self._handle_resolver())

    def has(self, key: str) -> bool:
        return self.data.has(key)

    def delete(self, key: str) -> None:
        op, metadata = self.data.local_delete(key)
        self.submit_local_message(op, metadata)

    def clear(self) -> None:
        op, metadata = self.data.local_clear()
        self.submit_local_message(op, metadata)

    def keys(self):
        return self.data.keys()

    def items(self):
        resolver = self._handle_resolver()
        return ((k, decode_value(v, resolver)) for k, v in self.data.items())

    def __len__(self) -> int:
        return len(self.data)

    # -- SharedObject contract ------------------------------------------------

    def process_core(self, message: SequencedDocumentMessage, local: bool,
                     local_op_metadata: Any) -> None:
        self.data.process(message.contents, local, local_op_metadata)

    def on_attach(self) -> None:
        self.data.normalize_detached()

    def summarize_core(self) -> dict:
        return self.data.snapshot()

    def load_core(self, content: dict) -> None:
        self.data = MapData.load(content)

    def resubmit_core(self, contents: Any, metadata: Any) -> None:
        op, new_metadata = self.data.resubmit(contents, metadata)
        self.submit_local_message(op, new_metadata)

    def apply_stashed_op(self, contents: Any) -> Any:
        op = contents
        if op["type"] == "set":
            _, metadata = self.data.local_set(op["key"], op["value"])
        elif op["type"] == "delete":
            _, metadata = self.data.local_delete(op["key"])
        else:
            _, metadata = self.data.local_clear()
        return metadata


class SharedMapFactory(ChannelFactory):
    channel_type = SharedMap.channel_type
    shared_object_cls = SharedMap
