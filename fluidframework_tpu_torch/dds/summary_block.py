"""SharedSummaryBlock DDS — summary-only state, no ops.

Reference parity: packages/dds/shared-summary-block/src/
sharedSummaryBlock.ts:42: data written locally, persisted only through
summaries; it never submits ops (used for state that only the summarizer
produces).
"""

from __future__ import annotations

from typing import Any

from ..protocol.messages import SequencedDocumentMessage
from .shared_object import ChannelFactory, SharedObject


class SharedSummaryBlock(SharedObject):
    channel_type = "https://graph.microsoft.com/types/shared-summary-block"

    def __init__(self, channel_id: str, runtime=None, attributes=None) -> None:
        super().__init__(channel_id, runtime, attributes)
        self._data: dict[str, Any] = {}

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def set(self, key: str, value: Any) -> None:
        # No op is submitted: the value rides the next summary only.
        self._data[key] = value

    def process_core(self, message: SequencedDocumentMessage, local: bool,
                     local_op_metadata: Any) -> None:
        raise AssertionError("SharedSummaryBlock never receives ops")

    def summarize_core(self) -> dict:
        return {"data": dict(sorted(self._data.items()))}

    def load_core(self, content: dict) -> None:
        self._data = dict(content["data"])

    def apply_stashed_op(self, contents: Any) -> Any:
        raise AssertionError("SharedSummaryBlock never submits ops")


class SharedSummaryBlockFactory(ChannelFactory):
    channel_type = SharedSummaryBlock.channel_type
    shared_object_cls = SharedSummaryBlock
