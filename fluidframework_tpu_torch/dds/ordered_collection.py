"""ConsensusQueue DDS — exactly-once distributed work queue.

Reference parity: packages/dds/ordered-collection/src/
consensusOrderedCollection.ts:98: add/acquire/complete/release ops take
effect only when sequenced, giving exactly-once work distribution: an
acquire hands the front item to exactly the first sequenced acquirer;
complete finishes it; release returns it to the queue (crash recovery).
The service also auto-releases items held by clients that leave.
"""

from __future__ import annotations

import itertools
from typing import Any

from ..protocol.messages import SequencedDocumentMessage
from .shared_object import ChannelFactory, SharedObject


class ConsensusQueue(SharedObject):
    channel_type = "https://graph.microsoft.com/types/consensus-queue"

    def __init__(self, channel_id: str, runtime=None, attributes=None) -> None:
        super().__init__(channel_id, runtime, attributes)
        self.items: list[list] = []  # [item_id, value] FIFO
        # item_id -> (client_id, value) currently leased.
        self.jobs: dict[str, tuple[str, Any]] = {}
        self._acquired_local: dict[str, Any] = {}  # our leases
        self._next_op = itertools.count(1)

    # -- public API -----------------------------------------------------------

    def add(self, value: Any) -> None:
        self.submit_local_message(
            {"type": "add", "value": value}, next(self._next_op))

    def acquire(self) -> None:
        """Request the front item; if granted (sequenced first), it appears
        in acquired_items() until complete()/release()."""
        self.submit_local_message({"type": "acquire"}, next(self._next_op))

    def complete(self, item_id: str) -> None:
        self.submit_local_message(
            {"type": "complete", "id": item_id}, next(self._next_op))

    def release(self, item_id: str) -> None:
        self.submit_local_message(
            {"type": "release", "id": item_id}, next(self._next_op))

    def acquired_items(self) -> dict[str, Any]:
        return dict(self._acquired_local)

    def __len__(self) -> int:
        return len(self.items)

    # -- sequenced apply -------------------------------------------------------

    def process_core(self, message: SequencedDocumentMessage, local: bool,
                     local_op_metadata: Any) -> None:
        op = message.contents
        kind = op["type"]
        if kind == "add":
            # Deterministic id from the sequence number.
            self.items.append([f"item-{message.sequence_number}",
                               op["value"]])
        elif kind == "acquire":
            if self.items:
                item_id, value = self.items.pop(0)
                self.jobs[item_id] = (message.client_id, value)
                if local:
                    self._acquired_local[item_id] = value
        elif kind == "complete":
            self.jobs.pop(op["id"], None)
            self._acquired_local.pop(op["id"], None)
        elif kind == "release":
            job = self.jobs.pop(op["id"], None)
            self._acquired_local.pop(op["id"], None)
            if job is not None:
                self.items.insert(0, [op["id"], job[1]])

    def on_client_leave(self, client_id: str) -> None:
        """Auto-release leases of a departed client (the runtime calls this
        on quorum removeMember — reference releases on client leave)."""
        for item_id, (owner, value) in list(self.jobs.items()):
            if owner == client_id:
                del self.jobs[item_id]
                self.items.insert(0, [item_id, value])

    def summarize_core(self) -> dict:
        return {
            "items": [list(entry) for entry in self.items],
            "jobs": {item_id: [owner, value]
                     for item_id, (owner, value) in sorted(self.jobs.items())},
        }

    def load_core(self, content: dict) -> None:
        self.items = [list(entry) for entry in content["items"]]
        self.jobs = {item_id: (owner, value)
                     for item_id, (owner, value) in content["jobs"].items()}

    def apply_stashed_op(self, contents: Any) -> Any:
        return next(self._next_op)


class ConsensusQueueFactory(ChannelFactory):
    channel_type = ConsensusQueue.channel_type
    shared_object_cls = ConsensusQueue
