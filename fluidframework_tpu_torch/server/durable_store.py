"""Durable storage: file-backed bus, state store and snapshot store.

Reference parity — the three durability legs of the reference server:
  * Kafka partition logs (services-ordering-*, config.json:26-38)
    → :class:`DurableMessageBus` — one CRC-framed C++ op log per
    topic-partition (native/oplog.cpp), offsets journaled.
  * MongoDB lambda checkpoints + scriptorium op log
    (scriptorium/lambda.ts:95, deli/checkpointContext.ts)
    → :class:`FileStateStore` — a journaled key→document store.
  * gitrest content-addressed snapshot storage over libgit2
    (server/gitrest/src/utils.ts:9)
    → :class:`GitSnapshotStore` — sha256-addressed chunked blobs with a
    per-document head ref.

All three survive process death: a service rebuilt over the same directory
resumes from checkpoints exactly as a routerlicious pod restart does.
Values serialize through the protocol wire codec (tagged dataclasses);
``RawOperation`` registers itself as an extension tag below.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable

from ..native import OpLog
from ..protocol.codec import from_wire, register_codec, to_wire
from ..protocol.messages import MessageType
from ..utils import faults
from ..utils.tick_spans import profiler_range
from .bus import BusMessage, MessageBus, Topic
from .sequencer import RawOperation

# -- RawOperation over the wire/journal ---------------------------------------

register_codec(
    "raw", RawOperation,
    lambda op: {f.name: getattr(op, f.name)
                for f in dataclasses.fields(RawOperation)},
    lambda body: RawOperation(**{
        **body,
        "type": MessageType(body["type"]),
        "traces": tuple(body.get("traces", ())),
    }))


def _dump(value: Any) -> bytes:
    return json.dumps(to_wire(value), separators=(",", ":")).encode()


def _load(data: bytes) -> Any:
    return from_wire(json.loads(data.decode()))


# -- group-commit WAL writer --------------------------------------------------


class WalDegradedError(RuntimeError):
    """A durability barrier was requested while the WAL's circuit breaker
    is open (sustained fsync failure) — the caller must degrade to
    read-only serving instead of blocking on a disk that is not coming
    back this instant."""


class CircuitBreaker:
    """Closed → open → half-open breaker for the WAL writer (the pattern
    every storage-backed service front: shed fast while the disk is sick,
    probe periodically, heal without a restart).

    * **closed** — healthy; failures count toward ``failure_threshold``.
    * **open** — shedding; for ``cooldown_s`` after the last failure all
      probes are refused, then ONE probe is allowed (half-open).
    * **half-open** — the single in-flight probe decides: success closes
      the breaker (and resets the count), failure re-opens it for another
      cooldown.

    Thread-safe via a single mutex; every method is O(1).
    """

    def __init__(self, failure_threshold: int = 1,
                 cooldown_s: float = 0.25,
                 clock: Callable[[], float] = None) -> None:
        import time as _time
        self.failure_threshold = max(1, failure_threshold)
        self.cooldown_s = cooldown_s
        self._clock = clock if clock is not None else _time.monotonic
        self._mutex = threading.Lock()
        self._failures = 0
        self._opened_at: float | None = None
        self._probing = False
        self.stats = {"opens": 0, "probes": 0, "closes": 0}

    @property
    def state(self) -> str:
        with self._mutex:
            if self._opened_at is None:
                return "closed"
            return "half-open" if self._probing else "open"

    @property
    def is_open(self) -> bool:
        with self._mutex:
            return self._opened_at is not None

    def record_failure(self) -> None:
        with self._mutex:
            self._failures += 1
            self._probing = False
            if self._failures >= self.failure_threshold:
                if self._opened_at is None:
                    self.stats["opens"] += 1
                self._opened_at = self._clock()

    def record_success(self) -> None:
        with self._mutex:
            if self._opened_at is not None:
                self.stats["closes"] += 1
            self._failures = 0
            self._opened_at = None
            self._probing = False

    def allow(self) -> bool:
        """May the protected operation run now? True while closed; while
        open, True exactly once per elapsed cooldown (the half-open
        probe)."""
        with self._mutex:
            if self._opened_at is None:
                return True
            if self._probing:
                return False
            if self._clock() - self._opened_at >= self.cooldown_s:
                self._probing = True
                self.stats["probes"] += 1
                return True
            return False


def rewrite_oplog_records(log, path, transform):
    """Rewrite an :class:`OpLog` record by record — ``transform(idx,
    length)`` decides from a record's index and payload length alone and
    returns replacement bytes, or None to keep the record — preserving
    record count and indices, published atomically (tmp file + rename,
    so a kill mid-rewrite keeps the original). Only kept records are
    read, so the cost follows the bytes that stay, not the log's size.
    Returns ``(fresh_log, changed)``; the caller owns locking and adopts
    the fresh handle. Shared by :meth:`GroupCommitLog.rewrite_records`,
    the storm controller's plain-OpLog spill trim and the replica WAL's
    retention — one copy of the crash-safety-critical publish
    sequence."""
    path = Path(path)
    tmp = path.with_suffix(".compact")
    tmp.unlink(missing_ok=True)
    fresh = OpLog(tmp)
    changed = 0
    for i in range(len(log)):
        new = transform(i, log.record_len(i))
        if new is None:
            new = bytes(log.read(i))
        else:
            changed += 1
        fresh.append(new)
    fresh.sync()
    fresh.close()
    log.close()
    tmp.replace(path)
    return OpLog(path), changed


#: The group-commit writer's counters (:meth:`GroupCommitLog.counters`).
WAL_COUNTERS = ("batches", "records", "bytes", "write_ns", "fsync_ns",
                "append_wait_ns")
#: Completed batches :meth:`GroupCommitLog.batches` keeps, newest last.
BATCH_RING = 1024


class GroupCommitLog:
    """Async group-commit writer over a CRC-framed :class:`OpLog`.

    The WAL durability shape of every real ordering service (Kafka's
    ``log.flush`` batching, Mongo's journal group commit): ``append``
    enqueues on a bounded queue and returns the record index immediately;
    a background writer drains the WHOLE queue, appends every queued
    record to the CRC-framed log, fsyncs ONCE, then advances the durable
    watermark and fires the completion callbacks. The caller's hot path
    pays a queue put — never a serialize-join, never an fsync.

    Crash contract (what the chaos harness proves):

    * records below :attr:`durable_len` survive a kill at ANY point —
      the file format is the OpLog's ``[u32 len][u32 crc32][payload]``
      framing, so a torn batch truncates to the last intact record on
      reopen exactly like every other log in the tier;
    * records at-or-above the watermark may be lost — which is why the
      storm path withholds acks until the watermark passes the tick.

    Reads are index-transparent: a record still queued serves from the
    in-flight buffer, so catch-up readers never block on the fsync
    cadence. Payloads may be passed as a list of buffers; the writer
    thread writes them as one record (``OpLog.append_parts``: the native
    log never joins them, and runs the CRC and the writes without the
    interpreter lock, so the ~MB-per-tick record costs the serving
    thread no copy and no wait).
    Completion callbacks run ON THE WRITER THREAD — keep them tiny and
    thread-safe (the storm controller only polls the watermark).

    The writer counts its completed batches (:meth:`counters`, totals of
    :data:`WAL_COUNTERS`; :meth:`batches`, the newest :data:`BATCH_RING`
    batches one by one) and, while a profiler records, marks each
    batch's write to the file and its fsync as the ranges ``wal.write``
    and ``wal.fsync`` (argument: the batch's first record index).
    """

    def __init__(self, path: str | os.PathLike, max_queue: int = 256,
                 fsync: bool = True,
                 breaker: CircuitBreaker | None = None,
                 commit_latency_s: float = 0.0) -> None:
        self._log = OpLog(path)
        self._path = Path(path)  # rewrite_records replace target
        self._fsync = fsync
        # Modeled additional commit latency per fsync BATCH (writer
        # thread only, after the real fsync): benches use it to put the
        # WAL in the replicated-log regime (quorum append / networked
        # disk) where a host's commit round trip — not its CPU — bounds
        # its serving rate. 0 (default, production) = local disk only.
        self._commit_latency_s = max(0.0, commit_latency_s)
        # Serializes ALL OpLog access: neither backend is thread-safe
        # (the Python one shares a single seek position between read and
        # append; the native one grows its index vector unsynchronized),
        # so reads from the serving thread must never interleave with the
        # writer thread's append/fsync batch. Separate from _lock so
        # append() callers never block behind an in-flight fsync.
        self._io = threading.Lock()
        self._lock = threading.Condition()
        self._queued: dict[int, list[bytes]] = {}
        self._callbacks: dict[int, Callable[[int], None]] = {}
        self._next = len(self._log)
        self._durable = self._next  # reopened records are durable history
        # Records written to the OS file but not yet fsynced: a retry
        # after a failed fsync must never re-append them (duplicate
        # records would shift every later index).
        self._appended_next = self._next
        self._max_queue = max(1, max_queue)
        self._error: BaseException | None = None
        # Under _lock: the totals of the completed batches, and the newest
        # batches as (first index, records, bytes, write ns, fsync ns).
        self._counters = dict.fromkeys(WAL_COUNTERS, 0)
        self._batches: deque = deque(maxlen=BATCH_RING)
        # Fsync-failure circuit breaker: a failed batch stays queued and
        # the writer RETRIES on the breaker's half-open cadence instead
        # of dying — the WAL degrades and heals, it does not brick.
        # Callers poll `breaker.is_open` to enter/leave read-only mode.
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        #: TERMINAL writer death (non-I/O failure; the breaker stays
        #: open and will never heal) — callers distinguish this from a
        #: sick-disk outage and stop telling clients to retry.
        self.failed = False
        #: Log-shipping seam (server/replication.py): called ON THE
        #: WRITER THREAD after the local fsync with the batch's
        #: ``[(index, record_bytes), ...]`` — the exact bytes that just
        #: became locally durable, in index order. A replication plane
        #: hooks this to ship the batch to followers before the durable
        #: watermark advances; shipping failures must never kill the
        #: writer (the plane resyncs lagging followers from the log), so
        #: exceptions are swallowed here and surfaced by the plane's own
        #: health gauges.
        self.on_batch_durable: Callable[[list], None] | None = None
        self._stop = False
        self._thread = threading.Thread(target=self._writer_loop,
                                        name="group-commit-wal", daemon=True)
        self._thread.start()

    def __len__(self) -> int:
        with self._lock:
            return self._next

    @property
    def durable_len(self) -> int:
        """Records fsynced to disk — the acknowledged-durability
        watermark (everything below survives a crash)."""
        with self._lock:
            return self._durable

    def counters(self) -> dict:
        """Totals over the completed (fsynced) batches: ``batches``, the
        ``records`` and payload ``bytes`` they carried, the ns of their
        writes to the file (``write_ns``: CRC and write) and of
        their fsyncs (``fsync_ns``), and the ns :meth:`append` waited on
        a full queue (``append_wait_ns``). Records reopened from the file
        are not counted."""
        with self._lock:
            return dict(self._counters)

    def batches(self) -> list[tuple[int, int, int, int, int]]:
        """The newest completed batches, oldest first: (first record
        index, records, bytes, write ns, fsync ns) each."""
        with self._lock:
            return list(self._batches)

    def append(self, data: bytes | bytearray | memoryview | list,
               on_durable: Callable[[int], None] | None = None) -> int:
        """Enqueue one record; returns its index immediately. Blocks only
        when the bounded queue is full (backpressure, not unbounded RAM).
        With the breaker OPEN a full queue raises WalDegradedError
        instead of waiting — the writer is in its probe cycle and space
        is not freeing on any bounded schedule; the caller must shed."""
        parts = list(data) if isinstance(data, list) else [data]
        with self._lock:
            t_wait = None
            while len(self._queued) >= self._max_queue:
                if self.breaker.is_open:
                    raise WalDegradedError(
                        "WAL queue full while the fsync breaker is open"
                    ) from self._error
                if t_wait is None:
                    t_wait = time.perf_counter_ns()
                self._lock.wait(timeout=1.0)
            if t_wait is not None:
                self._counters["append_wait_ns"] += (time.perf_counter_ns()
                                                     - t_wait)
            idx = self._next
            self._next += 1
            self._queued[idx] = parts
            if on_durable is not None:
                self._callbacks[idx] = on_durable
            self._lock.notify_all()
        return idx

    def read(self, index: int) -> bytes:
        with self._lock:
            parts = self._queued.get(index)
            if parts is not None:
                return b"".join(bytes(p) for p in parts)
        with self._io:
            return self._log.read(index)

    def sync(self) -> None:
        """Barrier: returns once every record appended so far is durable.
        Raises :class:`WalDegradedError` (without waiting out the outage)
        when the breaker is open — durability is not coming on a bounded
        schedule, and callers holding the serving thread must degrade to
        read-only rather than block on it."""
        with self._lock:
            target = self._next
            while self._durable < target:
                if self.breaker.is_open:
                    raise WalDegradedError(
                        "WAL fsync breaker is open; durability barrier "
                        "unavailable") from self._error
                self._lock.wait(timeout=1.0)

    def rewrite_records(self, transform: Callable[[int, int],
                                                  bytes | None]) -> int:
        """Rewrite the log in place, record by record: ``transform(idx,
        length)`` returns replacement bytes or None to keep (see
        :func:`rewrite_oplog_records`). Record COUNT and indices are
        preserved — this exists for the history plane's tail trim, which
        shrinks superseded tick blobs to fillers without moving any WAL
        position. Barriers on full durability first, requires an empty
        queue (call between serving rounds, never on the hot path), and
        publishes atomically (tmp file + rename), so a kill mid-rewrite
        keeps the original log intact. Returns the number of records
        replaced."""
        self.sync()
        with self._lock:
            assert not self._queued, \
                "rewrite_records with queued (unfsynced) appends"
        with self._io:
            self._log, changed = rewrite_oplog_records(
                self._log, self._path, transform)
        return changed

    def close(self) -> None:
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        self._thread.join(timeout=10)
        self._log.close()

    def _writer_loop(self) -> None:
        while True:
            with self._lock:
                while not self._queued and not self._stop:
                    self._lock.wait(timeout=1.0)
                if self._stop and not self._queued:
                    return
                batch = sorted(self._queued)
                parts_of = {i: self._queued[i] for i in batch}
            if not self.breaker.allow():
                # Open breaker, cooldown not yet elapsed: hold the batch
                # (records stay queued and readable) and poll again.
                with self._lock:
                    if self._stop:
                        return  # close() during an outage abandons the tail
                    self._lock.wait(timeout=min(0.05,
                                                self.breaker.cooldown_s))
                continue
            try:
                with self._io:
                    t_write = time.perf_counter_ns()
                    with profiler_range("wal.write", batch[0]):
                        for idx in batch:
                            if idx < self._appended_next:
                                continue  # appended before a failed fsync
                            got = self._log.append_parts(parts_of[idx])
                            # Advance BEFORE asserting: the record is on
                            # the file either way, and a retry after the
                            # assert must never append it twice.
                            self._appended_next = max(self._appended_next,
                                                      got + 1)
                            assert got == idx, (got, idx)
                    t_fsync = time.perf_counter_ns()
                    faults.crashpoint("wal.pre_fsync")
                    if self._fsync:
                        with profiler_range("wal.fsync", batch[0]):
                            faults.failpoint("wal.fsync")
                            self._log.sync()
                    t_synced = time.perf_counter_ns()
                if self._fsync and self._commit_latency_s:
                    # Modeled commit round trip OUTSIDE the io lock:
                    # it delays the durable watermark (as a replicated
                    # log's quorum ack would), never reads of records
                    # already appended to the local file.
                    time.sleep(self._commit_latency_s)
                faults.crashpoint("wal.post_fsync")
                ship = self.on_batch_durable
                if ship is not None:
                    # Ship the locally-durable batch BEFORE the watermark
                    # advances: a synchronous plane returns only once its
                    # quorum acked, so durable_len then implies
                    # replicated too. An async/failed ship leaves the
                    # follower behind; the plane's resync path re-ships
                    # the tail from the log — never from here.
                    try:
                        ship([(idx,
                               b"".join(bytes(p) for p in parts_of[idx]))
                              for idx in batch
                              if idx in parts_of])
                    except Exception:
                        pass  # plane reports its own health; writer lives
            except OSError as err:
                # Transient I/O (the breaker's whole domain): keep the
                # records queued and retry on the half-open cadence.
                # Callers observe breaker.is_open and shed.
                with self._lock:
                    self._error = err
                    self._lock.notify_all()
                self.breaker.record_failure()
                continue
            except BaseException as err:
                # Deterministic / non-I/O failure (index skew, bad
                # payload types): retrying would loop forever or
                # duplicate records. The writer exits; the breaker is
                # forced open permanently so sync()/append() surface
                # WalDegradedError instead of hanging.
                with self._lock:
                    self._error = err
                    self._lock.notify_all()
                self.failed = True
                while not self.breaker.is_open:
                    self.breaker.record_failure()
                return
            self.breaker.record_success()
            n_bytes = sum(memoryview(p).nbytes for idx in batch
                          for p in parts_of[idx])
            with self._lock:
                self._error = None
                for idx in batch:
                    del self._queued[idx]
                self._durable = batch[-1] + 1
                c = self._counters
                c["batches"] += 1
                c["records"] += len(batch)
                c["bytes"] += n_bytes
                c["write_ns"] += t_fsync - t_write
                c["fsync_ns"] += t_synced - t_fsync
                self._batches.append((batch[0], len(batch), n_bytes,
                                      t_fsync - t_write,
                                      t_synced - t_fsync))
                callbacks = [(i, self._callbacks.pop(i))
                             for i in batch if i in self._callbacks]
                self._lock.notify_all()
            for idx, cb in callbacks:
                cb(idx)


# -- durable bus --------------------------------------------------------------


class _DurablePartition:
    """In-memory view append-through to an op log file."""

    def __init__(self, path: Path) -> None:
        self._oplog = OpLog(path)
        self.log: list[BusMessage] = []
        #: Offset of ``log[0]`` (bus retention trims the consumed
        #: in-memory prefix; the on-disk oplog keeps full history).
        self.base = 0
        # Appends since the last fsync: the offset journal must never
        # claim a message consumed that the data log could still lose, so
        # commit() group-syncs dirty partitions first (one fsync covers
        # every append of the batch — Kafka's log.flush-before-offsets).
        self.dirty = False
        for i in range(len(self._oplog)):
            key, value = _load(self._oplog.read(i))
            self.log.append(BusMessage(i, key, value))

    def append(self, key: str, value: Any) -> int:
        offset = self.base + len(self.log)
        data = _dump([key, value])
        self._oplog.append(data)
        self.dirty = True
        # Keep the codec-decoded copy in memory so consumers see identical
        # shapes (tuples→lists etc.) before and after a restart replay.
        self.log.append(BusMessage(offset, key, _load(data)[1]))
        return offset

    def trim(self, upto: int) -> int:
        """In-memory retention trim (bus.MessageBus contract): the
        durable oplog is untouched — a restart replays full history and
        re-trims as groups re-commit."""
        cut = min(max(0, upto - self.base), len(self.log))
        if cut:
            del self.log[:cut]
            self.base += cut
        return cut

    def sync_if_dirty(self) -> None:
        if self.dirty:
            self._oplog.sync()
            self.dirty = False

    def close(self) -> None:
        self._oplog.close()


class _DurableTopic(Topic):
    def __init__(self, name: str, num_partitions: int, root: Path) -> None:
        self.name = name
        self.partitions = [
            _DurablePartition(root / f"{name}-{p}.log")
            for p in range(num_partitions)]


class DurableMessageBus(MessageBus):
    """MessageBus whose partitions and consumer offsets live on disk.

    Reopening the same directory restores every topic log and committed
    offset — the consumer-group replay semantics lambdas rely on
    (kafka-service/checkpointManager.ts:24).
    """

    OFFSET_COMPACT_THRESHOLD = 4096

    def __init__(self, root: str | os.PathLike,
                 retention_messages: int | None = None) -> None:
        super().__init__(retention_messages=retention_messages)
        self._root = Path(root)
        self._root.mkdir(parents=True, exist_ok=True)
        # Topic metadata journal: partition counts are fixed at creation
        # (the Kafka rule) — reopening always uses the recorded count, so a
        # caller passing a different num_partitions can never orphan logs
        # or remap keys.
        self._meta_log = OpLog(self._root / "topics.log")
        self._topic_partitions: dict[str, int] = {}
        for i in range(len(self._meta_log)):
            name, count = _load(self._meta_log.read(i))
            self._topic_partitions[name] = count
        self._offset_path = self._root / "offsets.log"
        self._offset_log = OpLog(self._offset_path)
        for i in range(len(self._offset_log)):
            topic, group, partition, nxt = _load(self._offset_log.read(i))
            self._offsets[(topic, group, partition)] = nxt
            # Groups with durable offsets pin the retention floor from
            # the moment the bus reopens — a group whose Consumer
            # re-attaches LATE must not find its position trimmed out
            # from under it by an earlier group's commits.
            self.register_group(topic, group)
        self._offset_records = len(self._offset_log)

    def create_topic(self, name: str, num_partitions: int = 4) -> Topic:
        if name not in self._topics:
            recorded = self._topic_partitions.get(name)
            if recorded is None:
                self._meta_log.append(_dump([name, num_partitions]))
                self._topic_partitions[name] = num_partitions
                recorded = num_partitions
            self._topics[name] = _DurableTopic(name, recorded, self._root)
        return self._topics[name]

    def commit(self, topic: str, group: str, partition: int,
               next_offset: int) -> None:
        if self._offsets.get((topic, group, partition)) == next_offset:
            return
        # Durability ordering: data BEFORE offsets. A committed offset is
        # a claim that everything below it was consumed; if the partition
        # log lost those records to a crash, replay-from-offset would skip
        # ops no lambda ever saw. Group commit: the whole batch of appends
        # since the last commit shares this one fsync.
        t = self._topics.get(topic)
        if t is not None and partition < len(t.partitions):
            t.partitions[partition].sync_if_dirty()
        super().commit(topic, group, partition, next_offset)
        self._offset_log.append(_dump([topic, group, partition, next_offset]))
        self._offset_records += 1
        if self._offset_records > max(self.OFFSET_COMPACT_THRESHOLD,
                                      4 * len(self._offsets)):
            self._compact_offsets()

    def _compact_offsets(self) -> None:
        self._offset_log.close()
        tmp = self._offset_path.with_suffix(".compact")
        tmp.unlink(missing_ok=True)
        fresh = OpLog(tmp)
        for (topic, group, partition), nxt in sorted(self._offsets.items()):
            fresh.append(_dump([topic, group, partition, nxt]))
        fresh.sync()
        fresh.close()
        tmp.replace(self._offset_path)
        self._offset_log = OpLog(self._offset_path)
        self._offset_records = len(self._offset_log)

    def close(self) -> None:
        self._meta_log.close()
        self._offset_log.close()
        for topic in self._topics.values():
            for part in topic.partitions:
                part.close()


# -- durable state store ------------------------------------------------------


class FileStateStore:
    """Journaled key→document store (same duck-typed surface as the
    in-memory StateStore). Every put/append is one journal record; open
    replays the journal into memory. ``compact()`` rewrites the journal as
    one snapshot record per key (the Mongo-compaction analog)."""

    COMPACT_THRESHOLD = 8192

    def __init__(self, root: str | os.PathLike) -> None:
        self._root = Path(root)
        self._root.mkdir(parents=True, exist_ok=True)
        self._path = self._root / "state.log"
        self._journal = OpLog(self._path)
        self._dirty = False  # appends since the last sync (group commit)
        self._data: dict[str, Any] = {}
        for i in range(len(self._journal)):
            kind, key, value = _load(self._journal.read(i))
            if kind == "put":
                self._data[key] = value
            else:
                self._data.setdefault(key, []).extend(value)
        self._records = len(self._journal)

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def put(self, key: str, value: Any) -> None:
        data = _dump(["put", key, value])
        self._journal.append(data)
        # Keep the codec-decoded copy so in-memory state is identical to a
        # post-restart replay (tuples become lists etc.) — no dual-shape
        # bugs between first run and recovery. One serialization pass: the
        # journal bytes are the source.
        self._data[key] = _load(data)[2]
        self._bump()

    def append(self, key: str, items: list) -> None:
        data = _dump(["append", key, items])
        self._journal.append(data)
        self._data.setdefault(key, []).extend(_load(data)[2])
        self._bump()

    def _bump(self) -> None:
        self._records += 1
        self._dirty = True
        if self._records > max(self.COMPACT_THRESHOLD, 8 * len(self._data)):
            self.compact()

    def keys(self, prefix: str = "") -> list[str]:
        return sorted(k for k in self._data if k.startswith(prefix))

    def sync(self) -> None:
        """Group commit: one fsync covers every record since the last
        (no-op when nothing was written — callers sync per checkpoint)."""
        if self._dirty:
            self._journal.sync()
            self._dirty = False

    def compact(self) -> None:
        self._journal.close()
        tmp = self._path.with_suffix(".compact")
        tmp.unlink(missing_ok=True)
        fresh = OpLog(tmp)
        for key in self.keys():
            fresh.append(_dump(["put", key, self._data[key]]))
        fresh.sync()
        fresh.close()
        tmp.replace(self._path)
        self._journal = OpLog(self._path)
        self._records = len(self._journal)
        self._dirty = False  # the compacted journal was synced pre-publish

    def close(self) -> None:
        self._journal.close()


# -- content-addressed snapshot store -----------------------------------------

CHUNK_BYTES = 64 * 1024


class GitSnapshotStore:
    """gitrest analog: snapshots as sha256-addressed chunked blobs.

    A snapshot serializes to canonical JSON, splits into CHUNK_BYTES
    blobs (each stored once under its content hash — structural sharing
    across summaries for free, like git blobs), and a tree object lists
    the chunk hashes. Heads are per-document ref files. Implements the
    snapshot-backend surface RouterliciousService uses (upload / get /
    head / set_head).

    GC: every upload journals a refcount increment for its tree + chunk
    objects (``refcounts.log``, fsynced before the handle is returned —
    an object can never be reachable without its count being durable);
    :meth:`release` decrements a superseded snapshot's references and
    deletes objects whose count reaches zero. Content sharing stays safe
    across documents (a chunk two cold docs dedup into survives until
    BOTH release), and objects that predate the journal (legacy stores)
    are never deleted — an untracked sha is pinned, not collectable.
    The residency manager releases each cold doc's superseded head on
    eviction (head flip), closing the round-12 leftover: a churned cold
    doc's disk cost stays one snapshot, not one per eviction.
    """

    def __init__(self, root: str | os.PathLike) -> None:
        self._root = Path(root)
        (self._root / "objects").mkdir(parents=True, exist_ok=True)
        (self._root / "refs").mkdir(parents=True, exist_ok=True)
        # sha -> reference count, rebuilt from the journal ("+"/"-"
        # records of sha lists). Missing shas are LEGACY (pre-journal)
        # objects: pinned forever rather than risk deleting a blob an
        # untracked head still needs.
        self._rc_path = self._root / "refcounts.log"
        self._rc_log = OpLog(self._rc_path)
        self._rc: dict[str, int] = {}
        for i in range(len(self._rc_log)):
            sign, shas = _load(self._rc_log.read(i))
            delta = 1 if sign == "+" else -1
            for sha in shas:
                self._rc[sha] = self._rc.get(sha, 0) + delta
        self._rc_records = len(self._rc_log)

    RC_COMPACT_THRESHOLD = 8192

    def _journal_refs(self, sign: str, shas: list[str]) -> None:
        self._rc_log.append(_dump([sign, shas]))
        self._rc_log.sync()
        delta = 1 if sign == "+" else -1
        for sha in shas:
            self._rc[sha] = self._rc.get(sha, 0) + delta
        self._rc_records += 1
        if self._rc_records > max(self.RC_COMPACT_THRESHOLD,
                                  8 * len(self._rc)):
            self._compact_refs()

    def _compact_refs(self) -> None:
        self._rc_log.close()
        tmp = self._rc_path.with_suffix(".compact")
        tmp.unlink(missing_ok=True)
        fresh = OpLog(tmp)
        live = sorted(sha for sha, n in self._rc.items() if n > 0)
        for sha in live:
            fresh.append(_dump(["+", [sha] * self._rc[sha]]))
        fresh.sync()
        fresh.close()
        tmp.replace(self._rc_path)
        self._rc = {sha: self._rc[sha] for sha in live}
        self._rc_log = OpLog(self._rc_path)
        self._rc_records = len(self._rc_log)

    # -- object plumbing ------------------------------------------------------

    _SHA_RE = re.compile(r"[0-9a-f]{64}")

    def _object_path(self, sha: str) -> Path:
        # Handles arrive from clients (SUMMARIZE op contents) — a malformed
        # one must never touch the filesystem (path traversal).
        if not isinstance(sha, str) or not self._SHA_RE.fullmatch(sha):
            raise KeyError(f"invalid object id {sha!r}")
        return self._root / "objects" / sha[:2] / sha[2:]

    def put_object(self, data: bytes) -> str:
        sha = hashlib.sha256(data).hexdigest()
        path = self._object_path(sha)
        if not path.exists():
            path.parent.mkdir(exist_ok=True)
            tmp = path.with_suffix(".tmp")
            tmp.write_bytes(data)
            tmp.replace(path)  # atomic publish; dedup by content
        return sha

    def get_object(self, sha: str) -> bytes:
        return self._object_path(sha).read_bytes()

    # -- snapshot surface -----------------------------------------------------

    def upload(self, doc_id: str, snapshot: dict, put_object=None) -> str:
        """``put_object`` lets a caching front (historian) write through
        itself so freshly-uploaded chunks are served hot."""
        put = put_object if put_object is not None else self.put_object
        body = json.dumps(to_wire(snapshot), sort_keys=True,
                          separators=(",", ":")).encode()
        chunks = []
        for i in range(0, max(len(body), 1), CHUNK_BYTES):
            chunks.append(put(body[i:i + CHUNK_BYTES]))
            # A kill here leaves orphan chunk objects but no reachable
            # tree — the head ref still points at the previous snapshot.
            faults.crashpoint("snapshot.mid_upload")
        tree = json.dumps({"chunks": chunks, "doc": doc_id}).encode()
        handle = put(tree)
        # Refcounts durable BEFORE the handle escapes: a reachable
        # snapshot always has tracked references (a kill between journal
        # and caller leaves a +1 orphan — a leak, never an over-delete).
        # IDEMPOTENT re-upload of the doc's CURRENT head claims nothing
        # new (callers skip the matching release when the head doesn't
        # move) — journaling it would inflate the count one-sidedly and
        # make the snapshot undeletable forever.
        if self.head(doc_id) != handle:
            self._journal_refs("+", chunks + [handle])
        return handle

    def release(self, doc_id: str, handle: str) -> list[str]:
        """Release one SUPERSEDED snapshot's references (the caller just
        flipped ``doc_id``'s head ref off ``handle``); deletes objects
        whose refcount reaches zero. Refuses to release the current
        head. Returns the deleted object shas (caching fronts invalidate
        exactly these). Legacy (untracked) objects and chunks still
        shared by other snapshots survive."""
        if handle is None or self.head(doc_id) == handle:
            return []
        try:
            tree = json.loads(self.get_object(handle).decode())
            shas = list(tree.get("chunks", ())) + [handle]
        except (OSError, ValueError, KeyError):
            return []  # already gone / unreadable: nothing to release
        # Decide deletability from the PRE-decrement counts (the journal
        # append below may trigger a compaction that drops zeroed shas
        # from the map — reading counts afterwards would mistake them
        # for legacy-pinned objects and leak forever): a sha whose whole
        # remaining tracked count is the occurrences THIS release drops
        # reaches zero. Legacy objects (absent from the journal) and
        # over-released shas (count would go negative) stay pinned.
        occurrences: dict[str, int] = {}
        for sha in shas:
            occurrences[sha] = occurrences.get(sha, 0) + 1
        deletable = [sha for sha, occ in occurrences.items()
                     if self._rc.get(sha) == occ]
        # Journal the decrement BEFORE deleting files: a kill in between
        # orphans files (a leak the next release of the same sha cannot
        # double-free — its count is already zero and it skips).
        self._journal_refs("-", shas)
        deleted: list[str] = []
        for sha in deletable:
            try:
                self._object_path(sha).unlink(missing_ok=True)
                deleted.append(sha)
            except (OSError, KeyError):
                pass
            self._rc.pop(sha, None)
        return deleted

    def get(self, doc_id: str, handle: str | None,
            read_object=None) -> dict | None:
        """``read_object`` lets a caching front substitute its cached
        reader; the tree/chunk format is parsed in exactly one place."""
        read = read_object if read_object is not None else self.get_object
        if handle is None:
            return None
        try:
            tree = json.loads(read(handle).decode())
            body = b"".join(read(c) for c in tree["chunks"])
        except (OSError, ValueError, KeyError, TypeError):
            return None
        return from_wire(json.loads(body.decode()))

    def _ref_path(self, doc_id: str) -> Path:
        safe = hashlib.sha256(doc_id.encode()).hexdigest()[:32]
        return self._root / "refs" / safe

    def head(self, doc_id: str) -> str | None:
        path = self._ref_path(doc_id)
        return path.read_text() if path.exists() else None

    def set_head(self, doc_id: str, handle: str) -> None:
        path = self._ref_path(doc_id)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(handle)
        tmp.replace(path)
