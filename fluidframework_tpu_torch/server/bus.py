"""In-process partitioned message bus — the ordering transport seam.

Reference parity: the Kafka layer of server/routerlicious
(services-ordering-*: topics ``rawdeltas``/``deltas``, partitioned by
document, consumer groups with committed offsets —
routerlicious/config/config.json:26-38). This object model is the seam a
native transport implements: partition-FIFO ordered, durable append-only
logs, at-least-once delivery with consumer-committed offsets (replay from
the last commit after a crash — kafka-service/checkpointManager.ts:24).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True, slots=True)
class BusMessage:
    offset: int
    key: str
    value: Any


def partition_for(key: str, num_partitions: int) -> int:
    """Stable partitioner (crc32, not Python's randomized hash)."""
    return zlib.crc32(key.encode()) % num_partitions


@dataclass
class _Partition:
    log: list[BusMessage] = field(default_factory=list)
    #: Offset of ``log[0]`` — retention trims the in-memory prefix below
    #: the slowest registered group's commit; offsets stay stable.
    base: int = 0

    def append(self, key: str, value: Any) -> int:
        offset = self.base + len(self.log)
        self.log.append(BusMessage(offset, key, value))
        return offset

    def trim(self, upto: int) -> int:
        """Drop messages below offset ``upto`` from memory (they remain
        in any durable backend's on-disk log). Returns messages freed."""
        cut = min(max(0, upto - self.base), len(self.log))
        if cut:
            del self.log[:cut]
            self.base += cut
        return cut


class Topic:
    def __init__(self, name: str, num_partitions: int) -> None:
        self.name = name
        self.partitions = [_Partition() for _ in range(num_partitions)]

    @property
    def num_partitions(self) -> int:
        return len(self.partitions)

    def produce(self, key: str, value: Any) -> tuple[int, int]:
        """Append; returns (partition, offset). Per-key FIFO holds because a
        key always maps to the same partition."""
        pid = partition_for(key, self.num_partitions)
        return pid, self.partitions[pid].append(key, value)

    def read(self, partition: int, from_offset: int,
             max_messages: int | None = None) -> list[BusMessage]:
        part = self.partitions[partition]
        start = from_offset - part.base
        if start < 0:
            # A REAL error, not an assert (python -O must not turn this
            # into silently serving the newest messages misattributed to
            # trimmed offsets): the group attached after retention
            # passed its position — register every group before
            # enabling a horizon.
            raise LookupError(
                f"{self.name}/{partition}: read from offset "
                f"{from_offset} below the retention base {part.base} — "
                "a consumer group must register before the horizon "
                "passes its position")
        out = part.log[start:]
        return out if max_messages is None else out[:max_messages]


class MessageBus:
    """Topics + durable consumer-group offsets.

    ``retention_messages`` (opt-in) bounds each partition's IN-MEMORY
    log: once every registered consumer group has committed past a
    message AND the partition holds more than the horizon, the consumed
    prefix is trimmed (the Kafka ``log.retention`` analog — the service
    tier's message history stops scaling with total history; the
    residual cold-doc RAM slope lives exactly here). Nothing uncommitted
    is ever trimmed: one lagging group pins the log, exactly like a slow
    Kafka consumer pins its segment."""

    def __init__(self, retention_messages: int | None = None) -> None:
        self._topics: dict[str, Topic] = {}
        # (topic, group, partition) -> next offset to read
        self._offsets: dict[tuple[str, str, int], int] = {}
        self.retention_messages = retention_messages
        # Groups that ever attached a Consumer, per topic: the retention
        # floor is the MIN committed offset across them (a group that
        # registered but never committed pins at 0 — safe by default).
        self._groups: dict[str, set[str]] = {}

    def create_topic(self, name: str, num_partitions: int = 4) -> Topic:
        if name not in self._topics:
            self._topics[name] = Topic(name, num_partitions)
        return self._topics[name]

    def topic(self, name: str) -> Topic:
        return self._topics[name]

    def register_group(self, topic: str, group: str) -> None:
        """Record a consumer group against the retention floor (Consumer
        does this on attach)."""
        self._groups.setdefault(topic, set()).add(group)

    def produce(self, topic: str, key: str, value: Any) -> tuple[int, int]:
        return self._topics[topic].produce(key, value)

    # -- consumer-group offsets (commit = checkpoint) -------------------------

    def committed(self, topic: str, group: str, partition: int) -> int:
        return self._offsets.get((topic, group, partition), 0)

    def commit(self, topic: str, group: str, partition: int,
               next_offset: int) -> None:
        self._offsets[(topic, group, partition)] = next_offset
        if self.retention_messages is not None:
            self._maybe_trim(topic, partition)

    def _maybe_trim(self, topic: str, partition: int) -> None:
        t = self._topics.get(topic)
        if t is None or partition >= len(t.partitions):
            return
        part = t.partitions[partition]
        if len(part.log) <= self.retention_messages:
            return
        floor = min((self.committed(topic, g, partition)
                     for g in self._groups.get(topic, ())), default=0)
        # Keep the horizon's worth of tail even below the floor so a
        # replay/debug read has recent context; trim the rest.
        end = part.base + len(part.log)
        part.trim(min(floor, end - self.retention_messages))


class Consumer:
    """One consumer group member over every partition of a topic.

    ``poll`` returns uncommitted messages; the caller processes them and
    ``commit``s — a crash before commit replays them (at-least-once), so
    lambdas carry their own dedup guard (deli log_offset, scriptorium seq).
    """

    def __init__(self, bus: MessageBus, topic: str, group: str) -> None:
        self._bus = bus
        self._topic = bus.topic(topic)
        self._topic_name = topic
        self.group = group
        # Register against the retention floor BEFORE the first poll: a
        # group the bus does not know about cannot pin the log, so it
        # must be visible before any trim could pass its position.
        # Duck-typed buses without retention (the native shuttle bus)
        # simply have no registry to join.
        register = getattr(bus, "register_group", None)
        if register is not None:
            register(topic, group)

    @property
    def num_partitions(self) -> int:
        return self._topic.num_partitions

    def poll(self, partition: int,
             max_messages: int | None = None) -> list[BusMessage]:
        start = self._bus.committed(self._topic_name, self.group, partition)
        return self._topic.read(partition, start, max_messages)

    def commit(self, partition: int, next_offset: int) -> None:
        self._bus.commit(self._topic_name, self.group, partition, next_offset)


class StateStore:
    """Durable key→document store (the reference's MongoDB for lambda
    checkpoints and the scriptorium op log)."""

    def __init__(self) -> None:
        self._data: dict[str, Any] = {}

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def put(self, key: str, value: Any) -> None:
        self._data[key] = value

    def append(self, key: str, items: list) -> None:
        self._data.setdefault(key, []).extend(items)

    def keys(self, prefix: str = "") -> list[str]:
        return sorted(k for k in self._data if k.startswith(prefix))
