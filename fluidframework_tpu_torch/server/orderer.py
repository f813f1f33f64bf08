"""Orderer seam — the producer boundary between the front door and deli.

Reference parity: server/routerlicious/packages/kafka-orderer
(kafkaOrderer.ts:17 ``KafkaOrderer``/``KafkaOrdererConnection``: a per-
(document, client) connection whose ``order(messages)`` produces raw ops
into the ordering topic) and services-core's IOrderer/IOrdererConnection
seam. The bus behind it is pluggable — the in-memory Python bus, the
durable file bus, or the C++ shuttle (native_bus) — which is exactly the
point of the seam: alfred orders ops without knowing the transport.
"""

from __future__ import annotations

from .bus import MessageBus
from .sequencer import RawOperation

RAWDELTAS = "rawdeltas"


class OrdererConnection:
    """One (document, client) ordering lane (KafkaOrdererConnection)."""

    def __init__(self, orderer: "BusOrderer", doc_id: str,
                 client_id: str | None) -> None:
        self._orderer = orderer
        self.doc_id = doc_id
        self.client_id = client_id

    def order(self, raws: list[RawOperation]) -> None:
        """Produce raw operations into the ordering topic; per-document
        FIFO holds because the topic partitions by doc id."""
        for raw in raws:
            self._orderer.bus.produce(self._orderer.topic, self.doc_id, raw)


class BusOrderer:
    """IOrderer over any MessageBus-shaped transport (KafkaOrderer)."""

    def __init__(self, bus: MessageBus, topic: str = RAWDELTAS) -> None:
        self.bus = bus
        self.topic = topic

    def connect(self, doc_id: str,
                client_id: str | None = None) -> OrdererConnection:
        return OrdererConnection(self, doc_id, client_id)

    def order_system(self, doc_id: str, raw: RawOperation) -> None:
        """Service-originated control ops (join/leave) — no client lane."""
        self.bus.produce(self.topic, doc_id, raw)
