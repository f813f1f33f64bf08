"""MessageBus over the C++ shuttle — the native ordering transport.

Reference parity: services-ordering-rdkafka — the one place the reference
server runs native code on the op hot path (librdkafka brokering every
raw/sequenced delta). NativeMessageBus implements the exact MessageBus
object model (topics, crc32 key partitioning, consumer-group offsets)
over ``native/shuttle.py``'s C++ partition logs; values ride
as wire-codec bytes. The pure-Python MessageBus stays the fallback —
``make_message_bus`` picks per toolchain availability.
"""

from __future__ import annotations

from typing import Any

from ..native.shuttle import Shuttle, shuttle_available
from .bus import BusMessage, MessageBus
# _dump/_load are the wire-codec byte serializers the durable bus journals
# with — importing them also registers the RawOperation codec.
from .durable_store import _dump, _load


class NativeTopic:
    def __init__(self, name: str, num_partitions: int) -> None:
        self.name = name
        self._shuttle = Shuttle(num_partitions)

    @property
    def num_partitions(self) -> int:
        return self._shuttle.num_partitions

    def produce(self, key: str, value: Any) -> tuple[int, int]:
        return self._shuttle.produce(key.encode(), _dump(value))

    def read(self, partition: int, from_offset: int,
             max_messages: int | None = None) -> list[BusMessage]:
        records = self._shuttle.read(partition, from_offset, max_messages)
        return [BusMessage(from_offset + i, key.decode(), _load(payload))
                for i, (key, payload) in enumerate(records)]


class NativeMessageBus:
    """Drop-in MessageBus: same surface, C++ partition logs underneath."""

    def __init__(self) -> None:
        self._topics: dict[str, NativeTopic] = {}

    def create_topic(self, name: str, num_partitions: int = 4) -> NativeTopic:
        if name not in self._topics:
            self._topics[name] = NativeTopic(name, num_partitions)
        return self._topics[name]

    def topic(self, name: str) -> NativeTopic:
        return self._topics[name]

    def produce(self, topic: str, key: str, value: Any) -> tuple[int, int]:
        return self._topics[topic].produce(key, value)

    def committed(self, topic: str, group: str, partition: int) -> int:
        return self._topics[topic]._shuttle.committed(group, partition)

    def commit(self, topic: str, group: str, partition: int,
               next_offset: int) -> None:
        self._topics[topic]._shuttle.commit(group, partition, next_offset)

    def close(self) -> None:
        for topic in self._topics.values():
            topic._shuttle.close()


def make_message_bus(prefer_native: bool = True):
    """The native bus when the toolchain allows, else the Python one."""
    if prefer_native and shuttle_available():
        return NativeMessageBus()
    return MessageBus()
