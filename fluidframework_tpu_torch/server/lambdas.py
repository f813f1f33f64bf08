"""Lambda hosting framework — partition pumps + per-document demux.

Reference parity: server/routerlicious/packages/lambdas-driver —
``KafkaRunner`` → ``PartitionManager`` (one pump per partition,
partitionManager.ts:24) → ``DocumentLambda`` router (document-router/*)
demuxing each partition's stream into per-document lambda instances, with
offset checkpointing after each processed batch (restart-safe:
kafka-service/checkpointManager.ts:24). The ``IPartitionLambdaFactory``
seam here is where the batched TPU deli kernel plugs in (BASELINE.json).
"""

from __future__ import annotations

from typing import Protocol

from .bus import BusMessage, Consumer, MessageBus


class DocumentLambda(Protocol):
    """Per-document stream processor (IPartitionLambda, per-doc demuxed)."""

    def handler(self, message: BusMessage) -> None:
        """Process one message (value carries the doc-scoped payload)."""
        ...

    def checkpoint(self, next_offset: int) -> None:
        """Persist state keyed to the partition offset (crash replay lands
        at-or-before this point; handler must dedup)."""
        ...


class DocumentLambdaFactory(Protocol):
    def create(self, doc_id: str) -> DocumentLambda:
        ...


class PartitionManager:
    """Pumps every partition of one topic through per-document lambdas.

    Restart safety: committed offsets + per-doc lambda checkpoints are
    durable; a new PartitionManager over the same bus/store resumes where
    the last one crashed, re-delivering only uncommitted messages.
    """

    def __init__(self, bus: MessageBus, topic: str, group: str,
                 factory: DocumentLambdaFactory,
                 batch_size: int = 256) -> None:
        self._consumer = Consumer(bus, topic, group)
        self._factory = factory
        self._batch_size = batch_size
        self._docs: dict[str, DocumentLambda] = {}

    def _lambda_for(self, doc_id: str) -> DocumentLambda:
        if doc_id not in self._docs:
            self._docs[doc_id] = self._factory.create(doc_id)
        return self._docs[doc_id]

    def pump(self) -> int:
        """Drain every partition; returns messages processed.

        Each round polls ONE batch from EVERY partition and runs all
        handlers before any checkpoint, so a lambda factory that batches
        across documents (the device deli) sees one global tick per round
        instead of one per partition. Documents are partition-sticky, so
        per-document ordering is unaffected by the interleaving.
        """
        processed = 0
        while True:
            round_batches = []
            for partition in range(self._consumer.num_partitions):
                batch = self._consumer.poll(partition, self._batch_size)
                if batch:
                    round_batches.append((partition, batch))
            if not round_batches:
                return processed
            touched: dict[str, int] = {}
            for _, batch in round_batches:
                next_offset = batch[-1].offset + 1
                for message in batch:
                    self._lambda_for(message.key).handler(message)
                    touched[message.key] = next_offset
                processed += len(batch)
            # Checkpoint order matters: lambda state FIRST, offset commit
            # SECOND — a crash between them replays messages the state
            # already saw (dedup guards), never skips unseen ones.
            for doc_id, next_offset in touched.items():
                self._docs[doc_id].checkpoint(next_offset)
            for partition, batch in round_batches:
                self._consumer.commit(partition, batch[-1].offset + 1)
