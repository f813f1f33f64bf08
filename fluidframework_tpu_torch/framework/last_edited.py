"""LastEditedTracker — who touched the document last, durable via summary.

Reference parity: packages/framework/last-edited — watches every sequenced
runtime op and records {clientId, timestamp} into a SharedSummaryBlock
(summary-only state: updated locally on each op, persisted at summary time,
never itself an op — exactly why the reference uses a summary block here).
"""

from __future__ import annotations

from ..dds.summary_block import SharedSummaryBlock
from ..protocol.messages import MessageType, SequencedDocumentMessage
from ..runtime.container import Container

LAST_EDITED_KEY = "lastEdited"


class LastEditedTracker:
    def __init__(self, container: Container,
                 summary_block: SharedSummaryBlock) -> None:
        self._block = summary_block
        container.on_op_processed.append(self._on_op)

    def _on_op(self, message: SequencedDocumentMessage) -> None:
        if message.type != MessageType.OPERATION:
            return  # only real edits count (lastEditedTracker.ts filter)
        self._block.set(LAST_EDITED_KEY, {
            "client_id": message.client_id,
            "sequence_number": message.sequence_number,
            "timestamp": message.timestamp,
        })

    @property
    def last_edited(self) -> dict | None:
        return self._block.get(LAST_EDITED_KEY)
