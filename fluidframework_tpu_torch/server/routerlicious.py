"""Routerlicious-equivalent service assembly over the partitioned bus.

Reference parity: server/routerlicious — alfred front door (connect /
submitOp → produce to ``rawdeltas``: alfred/index.ts:367), deli sequencer
lambda (rawdeltas → ticket → ``deltas``: deli/lambda.ts:82), scriptorium
(durable op log: scriptorium/lambda.ts:16), broadcaster (fan-out:
broadcaster/lambda.ts:42) and scribe (summary ack flow:
scribe/lambda.ts:40), each an independently checkpointed consumer of the
same ``deltas`` stream — restartable from its own offsets.

The assembly exposes the same duck-typed surface as ``LocalCollabServer``
(connect/submit/signal/get_deltas/upload_snapshot/...), so the whole
client stack runs over it unchanged via ``LocalDocumentService``. Pumping
is synchronous after every produce (deterministic for tests); a real
deployment pumps each lambda on its own cadence.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable

from ..ops import opcodes as oc
from ..protocol.messages import (
    ClientDetail,
    DocumentMessage,
    MessageType,
    NackMessage,
    ScopeType,
    SequencedDocumentMessage,
    Trace,
)
from ..utils import MetricsRegistry, NullLogger, TelemetryLogger
from .bus import BusMessage, MessageBus, StateStore
from .lambdas import PartitionManager
from .sequencer import DocumentSequencer, RawOperation, SequencerCheckpoint

from .orderer import RAWDELTAS  # single source of the topic name
DELTAS = "deltas"


class StoreSnapshotBackend:
    """Default snapshot backend over the StateStore (in-memory historian).
    The durable content-addressed alternative is
    server.durable_store.GitSnapshotStore — same four-method surface."""

    def __init__(self, store: StateStore) -> None:
        self._store = store

    def upload(self, doc_id: str, snapshot: dict) -> str:
        snapshots: dict = self._store.get(f"snapshots/{doc_id}", {})
        handle = f"{doc_id}/snapshots/{len(snapshots)}"
        snapshots[handle] = snapshot
        self._store.put(f"snapshots/{doc_id}", snapshots)
        return handle

    def get(self, doc_id: str, handle: str | None) -> dict | None:
        if handle is None:
            return None
        return self._store.get(f"snapshots/{doc_id}", {}).get(handle)

    def head(self, doc_id: str) -> str | None:
        return self._store.get(f"summary_head/{doc_id}")

    def set_head(self, doc_id: str, handle: str) -> None:
        self._store.put(f"summary_head/{doc_id}", handle)


# -- deli ---------------------------------------------------------------------


class DeliDocumentLambda:
    """Per-document sequencer lambda (deli/lambda.ts ticket loop)."""

    def __init__(self, doc_id: str, store: StateStore, bus: MessageBus,
                 sequencer_factory: Callable[[], DocumentSequencer],
                 metrics: MetricsRegistry | None = None) -> None:
        self.doc_id = doc_id
        self._store = store
        self._bus = bus
        self._sequencer_factory = sequencer_factory
        self._metrics = metrics if metrics is not None else MetricsRegistry()
        cp = store.get(f"deli/{doc_id}")
        if cp is not None:
            cp = dict(cp)
            self._summary_responded = cp.pop("summary_responded", 0)
            self._last_offset = cp["log_offset"]
            self.sequencer = self._make_sequencer(SequencerCheckpoint(**cp))
        else:
            self._summary_responded = 0
            self._last_offset = -1
            self.sequencer = self._make_sequencer(None)

    def _make_sequencer(self, cp: SequencerCheckpoint | None):
        """Build the document sequencer, from a checkpoint if one exists.
        Subclasses override to route state into a shared device host."""
        if cp is not None:
            return DocumentSequencer.restore(cp)
        return self._sequencer_factory()

    def handler(self, message: BusMessage) -> None:
        raw = self._admit(message)
        if raw is None:
            return
        trace_start = Trace("deli", "start")  # stamped at receipt, pre-ticket
        ticket = self.sequencer.ticket(raw)
        self._emit(raw, ticket, trace_start)

    def _admit(self, message: BusMessage) -> RawOperation | None:
        """Offset + summary-response dedup; None = silently dropped."""
        if message.offset <= self._last_offset:
            return None  # replayed below our checkpoint (lambda.ts:148-151)
        self._last_offset = message.offset
        raw: RawOperation = message.value
        if raw.client_id is None and raw.type in (MessageType.SUMMARY_ACK,
                                                  MessageType.SUMMARY_NACK):
            # Scribe crash-replay can re-produce its response to the same
            # SUMMARIZE op as a NEW raw message (fresh offset, so the offset
            # guard above can't catch it). Proposal seqs are unique and
            # monotonic — dedupe here, where the checkpoint is atomic with
            # the consumed offset, so the drop survives our own replay too.
            # Service-produced only (client_id None): a client-forged ack is
            # NACKed by the sequencer and must not poison the watermark.
            sseq = (raw.contents or {}).get(
                "summary_proposal", {}).get("summary_sequence_number", 0)
            if sseq <= self._summary_responded:
                return None
            self._summary_responded = sseq
        return raw

    def _emit(self, raw: RawOperation, ticket,
              trace_start: Trace) -> None:
        if ticket.kind == oc.OUT_NACK:
            self._metrics.counter("deli.nacks").inc()
            self._bus.produce(DELTAS, self.doc_id, {
                "kind": "nack",
                "target": raw.client_id,
                "operation": raw,
                "seq": ticket.seq,
                "code": ticket.nack_code,
            })
        elif ticket.kind == oc.OUT_SEQUENCED:
            self._metrics.counter("deli.sequenced_ops").inc()
            self._bus.produce(DELTAS, self.doc_id, {
                "kind": "op",
                "message": SequencedDocumentMessage(
                    client_id=raw.client_id,
                    sequence_number=ticket.seq,
                    minimum_sequence_number=ticket.msn,
                    client_sequence_number=raw.client_seq,
                    reference_sequence_number=raw.ref_seq,
                    type=raw.type,
                    contents=raw.contents,
                    timestamp=raw.timestamp,
                    data=raw.data,
                    traces=tuple(raw.traces) + (trace_start,
                                                Trace("deli", "end")),
                ),
            })

    def checkpoint(self, next_offset: int) -> None:
        cp = self.sequencer.checkpoint(self._last_offset)
        self._store.put(f"deli/{self.doc_id}", {
            "sequence_number": cp.sequence_number,
            "minimum_sequence_number": cp.minimum_sequence_number,
            "last_sent_msn": cp.last_sent_msn,
            "no_active_clients": cp.no_active_clients,
            "clients": cp.clients,
            "nack_future": cp.nack_future,
            "client_timeout_ms": cp.client_timeout_ms,
            "log_offset": cp.log_offset,
            "summary_responded": self._summary_responded,
        })


class _DeliFactory:
    def __init__(self, store: StateStore, bus: MessageBus,
                 sequencer_factory: Callable[[], DocumentSequencer],
                 metrics: MetricsRegistry | None = None) -> None:
        self._store, self._bus = store, bus
        self._sequencer_factory = sequencer_factory
        self._metrics = metrics

    def create(self, doc_id: str) -> DeliDocumentLambda:
        return DeliDocumentLambda(doc_id, self._store, self._bus,
                                  self._sequencer_factory, self._metrics)


class BatchedDeliDocumentLambda(DeliDocumentLambda):
    """Deli over the device sequencer's BATCH path: admitted raw ops buffer
    in the KernelSequencerHost during the pump and sequence in ONE device
    call at checkpoint — the lambda batch is the device tick (the
    throughput shape of BASELINE.json; contrast the base class's
    per-op ticket()). Cross-document batching happens in the host: every
    document's lambda shares one flush."""

    def __init__(self, doc_id: str, store: StateStore, bus: MessageBus,
                 factory: "_BatchedDeliFactory",
                 metrics: MetricsRegistry | None = None) -> None:
        self._factory = factory
        self._inflight: list[tuple[RawOperation, Trace]] = []
        super().__init__(doc_id, store, bus, sequencer_factory=None,
                         metrics=metrics)

    def _make_sequencer(self, cp: SequencerCheckpoint | None):
        from .kernel_host import KernelDocumentSequencer
        if cp is not None:
            # Route checkpointed state into the device host. restore()
            # overwrites any live row — the checkpoint + committed offset
            # are the consistent pair; a stale row from a prior service
            # life must not survive (its post-checkpoint ops replay from
            # the bus).
            self._factory.host.restore(self.doc_id, cp)
        return KernelDocumentSequencer(self._factory.host, self.doc_id)

    def handler(self, message: BusMessage) -> None:
        raw = self._admit(message)
        if raw is None:
            return
        self._inflight.append((raw, Trace("deli", "start")))
        self._factory.host.submit(self.doc_id, raw)

    def checkpoint(self, next_offset: int) -> None:
        self._factory.flush_ready()
        tickets = self._factory.take_ready(self.doc_id)
        if len(tickets) != len(self._inflight):
            raise RuntimeError(
                f"deli/{self.doc_id}: {len(self._inflight)} inflight ops but "
                f"{len(tickets)} tickets — the shared sequencer host was "
                "flushed outside the lambda pump")
        for (raw, trace_start), ticket in zip(self._inflight, tickets):
            self._emit(raw, ticket, trace_start)
        self._inflight = []
        super().checkpoint(next_offset)


class _BatchedDeliFactory:
    def __init__(self, store: StateStore, bus: MessageBus, host,
                 metrics: MetricsRegistry | None = None) -> None:
        self._store, self._bus = store, bus
        self.host = host
        self._metrics = metrics
        self._ready: dict[str, list] = {}

    def create(self, doc_id: str) -> BatchedDeliDocumentLambda:
        return BatchedDeliDocumentLambda(doc_id, self._store, self._bus,
                                         self, self._metrics)

    def flush_ready(self) -> None:
        """One host flush distributes tickets to every document's lambda
        (first checkpointing lambda pays; the rest just collect)."""
        for doc_id, tickets in self.host.flush().items():
            self._ready.setdefault(doc_id, []).extend(tickets)

    def take_ready(self, doc_id: str) -> list:
        return self._ready.pop(doc_id, [])


# -- scriptorium --------------------------------------------------------------


class ScriptoriumDocumentLambda:
    """Durable op log writer (scriptorium/lambda.ts insertOp). Idempotent on
    replay: ops at-or-below the stored tail sequence number drop.

    ``retention_ops`` (opt-in) bounds the per-doc ops store: past 2x the
    horizon the head trims back to the horizon (amortized — one rewrite
    per horizon's worth of appends). Catch-up reads older than the
    horizon become impossible (clients that far behind reload from a
    snapshot) — the same trade the storm tier's
    ``doc_index_retention_ticks`` makes, and the rest of the
    service plane's RAM slope."""

    def __init__(self, doc_id: str, store: StateStore,
                 retention_ops: int | None = None) -> None:
        self.doc_id = doc_id
        self._store = store
        self._retention_ops = retention_ops

    def handler(self, message: BusMessage) -> None:
        if message.value["kind"] != "op":
            return
        op: SequencedDocumentMessage = message.value["message"]
        log: list = self._store.get(f"ops/{self.doc_id}", [])
        if log and op.sequence_number <= log[-1].sequence_number:
            return  # replay after crash-before-commit
        retention = self._retention_ops
        if retention is not None and len(log) >= 2 * retention:
            # Amortized horizon trim: ONE put per retention-window of
            # appends rewrites the key to its newest `retention` ops.
            self._store.put(f"ops/{self.doc_id}", log[-retention:])
        self._store.append(f"ops/{self.doc_id}", [op])

    def checkpoint(self, next_offset: int) -> None:
        # The op log IS the durable state; group-commit it here: the whole
        # batch's appends share one fsync, BEFORE the pump commits the
        # consumer offset (a committed offset must never claim an op the
        # journal could still lose). The in-memory StateStore has no sync.
        sync = getattr(self._store, "sync", None)
        if sync is not None:
            sync()


class _ScriptoriumFactory:
    def __init__(self, store: StateStore,
                 retention_ops: int | None = None) -> None:
        self._store = store
        self._retention_ops = retention_ops

    def create(self, doc_id: str) -> ScriptoriumDocumentLambda:
        return ScriptoriumDocumentLambda(doc_id, self._store,
                                         self._retention_ops)


# -- broadcaster --------------------------------------------------------------


@dataclass
class _LiveConnection:
    client_id: str
    doc_id: str
    service: "RouterliciousService"
    handler: Callable[[list[SequencedDocumentMessage]], None]
    on_nack: Callable[[NackMessage], None] | None = None
    on_signal: Callable[[Any], None] | None = None
    open: bool = True
    mode: str = "write"
    #: Transport hook set by the owning front-door session: invoked when
    #: the SERVICE closes the connection (e.g. slow-consumer eviction) so
    #: the client's socket actually drops and its reconnect path runs.
    on_closed: Callable[[], None] | None = None

    def submit(self, messages: list[DocumentMessage]) -> None:
        assert self.open, "submit on closed connection"
        self.service.submit(self.doc_id, self.client_id, messages)

    def signal(self, content: Any) -> None:
        assert self.open, "signal on closed connection"
        self.service.signal(self.doc_id, self.client_id, content)

    def close(self) -> None:
        if self.open:
            self.open = False
            self.service.disconnect(self.doc_id, self.client_id)


class BroadcasterDocumentLambda:
    """Fan-out to live connections (broadcaster/lambda.ts emit). Delivery is
    per-connection resumable: each connection tracks the last seq it saw, so
    replayed messages after a crash dedupe naturally."""

    def __init__(self, doc_id: str,
                 connections: dict[str, _LiveConnection],
                 viewers=None) -> None:
        self.doc_id = doc_id
        self._connections = connections
        # Zero-arg callable resolving the service's viewer plane at
        # delivery time (the plane may attach after this lambda exists).
        self._viewers = viewers
        self._delivered_seq: dict[str, int] = {}

    def handler(self, message: BusMessage) -> None:
        value = message.value
        if value["kind"] == "nack":
            # Nacks are targeted (socket.io emits to ONE socket, never a
            # room), so they bypass any pub/sub hop in every mode.
            conn = self._connections.get(value["target"])
            if conn is not None and conn.on_nack is not None:
                raw: RawOperation = value["operation"]
                conn.on_nack(NackMessage(
                    operation=DocumentMessage(
                        type=raw.type,
                        contents=raw.contents,
                        client_sequence_number=raw.client_seq,
                        reference_sequence_number=raw.ref_seq,
                    ),
                    sequence_number=value["seq"],
                    code=403 if value["code"] == oc.NACK_NO_SUMMARY_SCOPE
                    else 400,
                    error_type=value["code"],
                    message=f"nack:{value['code']}",
                ))
            return
        self._deliver_op(value["message"])
        # Viewer plane (read-only audience): the sequenced op fans out
        # to the doc's viewer room, encoded once per batch (the plane
        # dedupes crash-replay by sequence number).
        viewers = self._viewers() if self._viewers is not None else None
        if viewers is not None and viewers.has_viewers(self.doc_id):
            viewers.publish_ops(self.doc_id, [value["message"]])

    def _deliver_op(self, op: SequencedDocumentMessage) -> None:
        # ONE shared batch for every subscriber: sessions serialize the
        # broadcast body once per doc (codec.BroadcastBatch caches the
        # encoded frame), not once per connection.
        from ..protocol.codec import BroadcastBatch
        batch = None
        for client_id, conn in list(self._connections.items()):
            if not conn.open:
                continue
            if op.sequence_number <= self._delivered_seq.get(client_id, 0):
                continue
            self._delivered_seq[client_id] = op.sequence_number
            if batch is None:
                batch = BroadcastBatch((op,))
            conn.handler(batch)

    def checkpoint(self, next_offset: int) -> None:
        pass  # live fan-out has no durable state


class FanoutBroadcasterDocumentLambda(BroadcasterDocumentLambda):
    """Broadcaster over the native fan-out service: ops publish ONCE to
    the document's room (services-shared redisSocketIoAdapter shape); the
    service's frontend drain delivers each subscriber queue to its
    connection. Per-connection crash-replay dedup moves to the drain."""

    def __init__(self, doc_id: str, connections: dict[str, _LiveConnection],
                 fanout, viewers=None) -> None:
        super().__init__(doc_id, connections, viewers)
        self._fanout = fanout

    def _deliver_op(self, op: SequencedDocumentMessage) -> None:
        import json as _json

        from ..protocol.codec import to_wire
        self._fanout.publish(self.doc_id,
                             _json.dumps(to_wire(op)).encode())


class _BroadcasterFactory:
    def __init__(self, service: "RouterliciousService") -> None:
        self._service = service

    def create(self, doc_id: str) -> BroadcasterDocumentLambda:
        viewers = lambda: self._service.viewers  # noqa: E731
        if self._service.fanout is not None:
            return FanoutBroadcasterDocumentLambda(
                doc_id, self._service._connections_for(doc_id),
                self._service.fanout, viewers)
        return BroadcasterDocumentLambda(
            doc_id, self._service._connections_for(doc_id), viewers)


# -- merger (device merge host consumer) --------------------------------------


class MergerDocumentLambda:
    """Feeds the sequenced stream into the device-resident KernelMergeHost
    (server/merge_host.py). The analogue of hosting the merge kernels
    behind the IPartitionLambdaFactory seam (BASELINE.json): ops buffer in
    the host during the batch and hit the device once per checkpoint — the
    lambda batch IS the device tick. Replayed messages dedupe inside the
    host (per-channel last_seq guards).

    Restart recovery: the host's device state is memory-only, but the
    consumer group's offsets are durable — so a fresh lambda (fresh host
    after a crash) first replays the scriptorium durable op log into the
    host, then consumes from the committed offset. Overlap dedupes in the
    host."""

    def __init__(self, doc_id: str, host, store: StateStore) -> None:
        self.doc_id = doc_id
        self._host = host
        for op in store.get(f"ops/{doc_id}", []):
            host.ingest(doc_id, op)

    def handler(self, message: BusMessage) -> None:
        if message.value["kind"] != "op":
            return
        self._host.ingest(self.doc_id, message.value["message"])

    def checkpoint(self, next_offset: int) -> None:
        self._host.flush()


class _MergerFactory:
    def __init__(self, host, store: StateStore) -> None:
        self._host = host
        self._store = store

    def create(self, doc_id: str) -> MergerDocumentLambda:
        return MergerDocumentLambda(doc_id, self._host, self._store)


# -- copier -------------------------------------------------------------------


class CopierDocumentLambda:
    """Raw-op archival (copier/lambda.ts): every RAWDELTAS message lands in
    a durable per-document raw log before sequencing touches it — the
    forensic/replay trail for debugging sequencer behavior. Idempotent on
    replay via the stored high-water offset."""

    def __init__(self, doc_id: str, store: StateStore) -> None:
        self.doc_id = doc_id
        self._store = store
        self._archived_offset = int(
            self._store.get(f"copier_offset/{doc_id}", -1))

    def handler(self, message: BusMessage) -> None:
        if message.offset <= self._archived_offset:
            return
        self._archived_offset = message.offset
        self._store.append(f"rawops/{self.doc_id}", [message.value])

    def checkpoint(self, next_offset: int) -> None:
        self._store.put(f"copier_offset/{self.doc_id}",
                        self._archived_offset)


class _CopierFactory:
    def __init__(self, store: StateStore) -> None:
        self._store = store

    def create(self, doc_id: str) -> CopierDocumentLambda:
        return CopierDocumentLambda(doc_id, self._store)


# -- foreman ------------------------------------------------------------------


class ForemanDocumentLambda:
    """Background help-task assignment (foreman/lambda.ts): REMOTE_HELP
    ops request agent work (spellcheck, intelligence...); the foreman
    assigns each task to a registered agent pool round-robin and records
    the assignment durably. Idempotent per sequence number."""

    def __init__(self, doc_id: str, store: StateStore,
                 agents: list[str]) -> None:
        self.doc_id = doc_id
        self._store = store
        self._agents = agents or ["default-agent"]
        self._assigned_seq = int(
            self._store.get(f"foreman_seq/{doc_id}", 0))

    def handler(self, message: BusMessage) -> None:
        if message.value.get("kind") != "op":
            return
        op: SequencedDocumentMessage = message.value["message"]
        if op.type != MessageType.REMOTE_HELP:
            return
        if op.sequence_number <= self._assigned_seq:
            return
        self._assigned_seq = op.sequence_number
        tasks = (op.contents or {}).get("tasks", [])
        assignments = self._store.get(f"help/{self.doc_id}", [])
        for i, task in enumerate(tasks):
            agent = self._agents[(len(assignments) + i) % len(self._agents)]
            self._store.append(f"help/{self.doc_id}", [{
                "task": task, "agent": agent,
                "client_id": op.client_id,
                "sequence_number": op.sequence_number}])

    def checkpoint(self, next_offset: int) -> None:
        self._store.put(f"foreman_seq/{self.doc_id}", self._assigned_seq)


class _ForemanFactory:
    def __init__(self, store: StateStore, agents: list[str]) -> None:
        self._store, self._agents = store, agents

    def create(self, doc_id: str) -> ForemanDocumentLambda:
        return ForemanDocumentLambda(doc_id, self._store, self._agents)


# -- scribe -------------------------------------------------------------------


class ScribeDocumentLambda:
    """Summary validation + durable head + ack (scribe/lambda.ts:190-250).
    The ack/nack is produced into RAWDELTAS so deli sequences it — the same
    loop the reference uses (scribe → deli → deltas)."""

    def __init__(self, doc_id: str, store: StateStore, bus: MessageBus,
                 clock: Callable[[], int], snapshots) -> None:
        self.doc_id = doc_id
        self._store = store
        self._bus = bus
        self._clock = clock
        self._snapshots = snapshots
        self._handled_seq = int(
            self._store.get(f"scribe/{self.doc_id}", {}).get("seq", 0))

    def handler(self, message: BusMessage) -> None:
        value = message.value
        if value["kind"] != "op":
            return
        op: SequencedDocumentMessage = value["message"]
        if op.sequence_number <= self._handled_seq:
            return  # replayed
        self._handled_seq = op.sequence_number
        if op.type != MessageType.SUMMARIZE:
            return
        handle = (op.contents or {}).get("handle")
        proposal = {"summary_proposal": {
            "summary_sequence_number": op.sequence_number}}
        offered = self._snapshots.get(self.doc_id, handle)
        current = self._snapshots.get(self.doc_id,
                                      self._snapshots.head(self.doc_id))
        offered_seq = (offered or {}).get("sequence_number")

        def produce_raw(mtype: MessageType, contents: dict) -> None:
            self._bus.produce(RAWDELTAS, self.doc_id, RawOperation(
                client_id=None, type=mtype, contents=contents,
                timestamp=self._clock()))

        if offered is None:
            produce_raw(MessageType.SUMMARY_NACK, {
                "message": f"unknown summary handle {handle!r}",
                "handle": handle, **proposal})
        elif not isinstance(offered_seq, int):
            produce_raw(MessageType.SUMMARY_NACK, {
                "message": "summary content missing sequence_number",
                "handle": handle, **proposal})
        elif current is not None and \
                offered_seq < current["sequence_number"]:
            produce_raw(MessageType.SUMMARY_NACK, {
                "message": f"stale summary at seq {offered_seq} < "
                           f"current {current['sequence_number']}",
                "handle": handle, **proposal})
        else:
            self._snapshots.set_head(self.doc_id, handle)
            produce_raw(MessageType.SUMMARY_ACK,
                        {"handle": handle, **proposal})

    def checkpoint(self, next_offset: int) -> None:
        self._store.put(f"scribe/{self.doc_id}", {"seq": self._handled_seq})


class _ScribeFactory:
    def __init__(self, store: StateStore, bus: MessageBus,
                 clock: Callable[[], int], snapshots) -> None:
        self._store, self._bus, self._clock = store, bus, clock
        self._snapshots = snapshots

    def create(self, doc_id: str) -> ScribeDocumentLambda:
        return ScribeDocumentLambda(doc_id, self._store, self._bus,
                                    self._clock, self._snapshots)


# -- service assembly ---------------------------------------------------------


class RouterliciousService:
    """The assembled ordering service. Same duck-typed surface as
    LocalCollabServer, so drivers/containers run over it unchanged.

    Durability boundary: ``bus`` + ``store`` survive a service restart
    (pass them to a new instance = recover from checkpoints); connections
    and lambda instances do not.
    """

    def __init__(self, bus: MessageBus | None = None,
                 store: StateStore | None = None,
                 num_partitions: int = 4,
                 sequencer_factory: Callable[[], DocumentSequencer]
                 = DocumentSequencer, merge_host=None,
                 logger: TelemetryLogger | None = None,
                 metrics: MetricsRegistry | None = None,
                 snapshots=None,
                 help_agents: list[str] | None = None,
                 batched_deli_host=None,
                 auto_pump: bool = True,
                 fanout=None,
                 idle_check_interval: int = 64,
                 ops_retention: int | None = None) -> None:
        self.bus = bus if bus is not None else MessageBus()
        self.merge_host = merge_host
        # Optional columnar fast path (server/storm.py attaches itself).
        self.storm = None
        # Broadcast viewer plane (server/broadcaster.py attaches itself;
        # connect(mode="viewer") lazily builds a default one): read-only
        # audiences ride fan-out rooms, never the merge/ack path.
        self.viewers = None
        # Optional native pub/sub broadcast hop (native/fanout.py — the
        # Redis + socket.io-adapter analog). None = direct callbacks.
        self.fanout = fanout
        self._fanout_subs: dict[tuple[str, str], int] = {}
        self._fanout_last_seq: dict[tuple[str, str], int] = {}
        self.logger = logger if logger is not None else NullLogger()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        if merge_host is not None:
            # One registry per service: hosted components report into it so
            # a single snapshot covers the whole assembly (and the per-mesh
            # psum aggregation sees merge-host counters too).
            merge_host.metrics = self.metrics
        self.store = store if store is not None else StateStore()
        self.snapshots = snapshots if snapshots is not None \
            else StoreSnapshotBackend(self.store)
        self.bus.create_topic(RAWDELTAS, num_partitions)
        self.bus.create_topic(DELTAS, num_partitions)
        # The producer boundary (kafka-orderer seam): front-door writes
        # reach deli only through the orderer, never the bus directly.
        from .orderer import BusOrderer
        self.orderer = BusOrderer(self.bus, RAWDELTAS)
        self._connections: dict[str, dict[str, _LiveConnection]] = {}
        # Client ids must never repeat across service restarts (a reused id
        # would make old ops look local to a new client), so the counter is
        # durable like the reference's UUID ids are globally unique.
        self._client_counter = itertools.count(
            int(self.store.get("client_counter", 0)) + 1)
        clock_start = int(self.store.get("clock", 0))
        self._clock_iter = itertools.count(clock_start + 1)
        self._pumping = False
        # deli checkIdleClients cadence: every Nth pump crafts leaves for
        # clients idle past their timeout (a stuck client must not pin the
        # MSN forever — zamboni would starve).
        self.idle_check_interval = max(1, idle_check_interval)
        self._pumps_since_idle_check = 0
        self._batched_deli_host = batched_deli_host

        # auto_pump=False is the batched-cadence mode: submits only produce
        # to the bus; the operator (or load harness) pumps on its own tick,
        # so lambda batches — and the device sequencer tick, when
        # batched_deli_host is given — span many ops/documents.
        self._auto_pump = auto_pump
        deli_factory = (_BatchedDeliFactory(self.store, self.bus,
                                            batched_deli_host, self.metrics)
                        if batched_deli_host is not None else
                        _DeliFactory(self.store, self.bus,
                                     sequencer_factory, self.metrics))
        self._deli = PartitionManager(self.bus, RAWDELTAS, "deli",
                                      deli_factory)
        self._scriptorium = PartitionManager(
            self.bus, DELTAS, "scriptorium",
            _ScriptoriumFactory(self.store, ops_retention))
        self._broadcaster = PartitionManager(
            self.bus, DELTAS, "broadcaster", _BroadcasterFactory(self))
        self._scribe = PartitionManager(
            self.bus, DELTAS, "scribe",
            _ScribeFactory(self.store, self.bus, self._clock,
                           self.snapshots))
        self._merger = (PartitionManager(
            self.bus, DELTAS, "merger",
            _MergerFactory(merge_host, self.store))
            if merge_host is not None else None)
        self._copier = PartitionManager(
            self.bus, RAWDELTAS, "copier", _CopierFactory(self.store))
        self._foreman = PartitionManager(
            self.bus, DELTAS, "foreman",
            _ForemanFactory(self.store, list(help_agents or [])))

    # -- internals -------------------------------------------------------------

    def _clock(self) -> int:
        tick = next(self._clock_iter)
        self.store.put("clock", tick)  # restarts keep timestamps monotonic
        return tick

    def _connections_for(self, doc_id: str) -> dict[str, _LiveConnection]:
        return self._connections.setdefault(doc_id, {})

    def _order_membership(self, doc_id: str, raw: RawOperation) -> None:
        """Order one CLIENT_JOIN/LEAVE system op — through the mega-doc
        membership seam when the doc is promoted (the frozen doc row's
        head is stale; the mirror fast-forwards it, the op sequences at
        the TRUE doc head through the normal deli path below, and the
        mirror absorbs + journals the outcome), straight to the orderer
        otherwise. Promoted-doc membership forces an immediate pump:
        the mirror must see the sequenced outcome before any later lane
        frame combines against it."""
        mega = getattr(self.storm, "megadoc", None)
        if mega is not None:
            verdict = mega.intercept_membership(doc_id, raw)
            if verdict == "deferred":
                # Arrived inside a storm round (idle-eject fired during
                # the round's pump): parked on the deferred-membership
                # queue; the flush maintenance cadence orders it through
                # the FULL mirror path right after the round — never
                # the legacy adopt-at-decide fallback.
                return
            if verdict:
                self.orderer.order_system(doc_id, raw)
                self.pump()
                mega.complete_membership(doc_id, raw)
                return
        self.orderer.order_system(doc_id, raw)

    def _maybe_pump(self) -> None:
        """Front-door writes pump inline only in auto mode; batched-cadence
        deployments pump on their own tick (the load harness / operator)."""
        if self._auto_pump:
            self.pump()

    def pump(self) -> None:
        """Drain every lambda until quiescent (scribe may feed deli)."""
        if self._pumping:
            return  # re-entrant submit during broadcast; outer loop drains
        self._pumping = True
        try:
            while True:
                moved = self._deli.pump()
                moved += self._scriptorium.pump()
                moved += self._scribe.pump()
                moved += self._broadcaster.pump()
                moved += self._copier.pump()
                moved += self._foreman.pump()
                if self._merger is not None:
                    moved += self._merger.pump()
                if self.fanout is not None:
                    moved += self._drain_fanout()
                if moved == 0:
                    break
        finally:
            self._pumping = False
        self._pumps_since_idle_check += 1
        if self._pumps_since_idle_check >= self.idle_check_interval:
            self._pumps_since_idle_check = 0
            self.eject_idle_clients()

    def eject_idle_clients(self,
                           timeout_ms: int | None = None
                           ) -> list[tuple[str, str]]:
        """Craft CLIENT_LEAVE for every client idle past its timeout
        (deli/lambda.ts:171 checkIdleClients): the leave sequences through
        the normal path, freeing the MSN so zamboni proceeds. Returns the
        (doc_id, client_id) pairs ejected."""
        now = self._clock()
        ejected: list[tuple[str, str]] = []
        if self._batched_deli_host is not None:
            ejected = self._batched_deli_host.idle_clients(now, timeout_ms)
        else:
            for doc_id, doc_lambda in self._deli._docs.items():
                sequencer = getattr(doc_lambda, "sequencer", None)
                if sequencer is None:
                    continue
                # One ejection per doc per check (the reference's
                # getIdleClient shape); the next check catches the rest.
                client_id = sequencer.get_idle_client(now, timeout_ms)
                if client_id is not None:
                    ejected.append((doc_id, client_id))
        for doc_id, client_id in ejected:
            self.logger.send_event("IdleClientEjected", docId=doc_id,
                                   clientId=client_id)
            self._order_membership(doc_id, RawOperation(
                client_id=None,
                type=MessageType.CLIENT_LEAVE,
                data=client_id,
                timestamp=now,
            ))
        if ejected:
            self._maybe_pump()
        # Doc-granularity idle ejection rides the same cadence: resident
        # docs idle past the residency timeout demote to the cold tier
        # (snapshot + WAL tail), freeing their device pool slots for the
        # next hydration. Refusals (quarantined, degraded WAL) skip.
        # Bounded per pass: each eviction pays a flush + fsync barrier +
        # snapshot upload on the serving thread, so a lull that idles
        # thousands of docs at once must drain over several passes, not
        # stall serving for one giant sweep.
        residency = getattr(self.storm, "residency", None)
        if residency is not None:
            residency.evict_idle(max_evictions=32)
        return ejected

    def _drain_fanout(self) -> int:
        """Frontend drain: deliver each subscriber's queued room payloads
        to its connection (the socket-server side of the pub/sub hop)."""
        import json as _json

        from ..protocol.codec import from_wire
        delivered = 0
        for (doc_id, client_id), sub in list(self._fanout_subs.items()):
            if self.fanout.was_evicted(sub):
                # Slow-consumer drop in the fan-out: the sub will never
                # receive again, so close the connection (the client's
                # reconnect path resyncs from the durable log) instead of
                # leaving it silently deaf.
                self.logger.send_event("FanoutSubscriberEvicted",
                                       docId=doc_id, clientId=client_id)
                self.disconnect(doc_id, client_id)
                continue
            batch: list[SequencedDocumentMessage] = []
            last_key = (doc_id, client_id)
            while (payload := self.fanout.poll(sub)) is not None:
                if payload[:1] == b"\x00":
                    # Compact storm tick frame (server/storm.py): consumed
                    # by storm-aware frontends; the per-op connections here
                    # catch up via get_deltas materialization instead.
                    continue
                op = from_wire(_json.loads(payload.decode()))
                if op.sequence_number <= self._fanout_last_seq.get(
                        last_key, 0):
                    continue  # crash-replay dedup, as in direct mode
                self._fanout_last_seq[last_key] = op.sequence_number
                batch.append(op)
            if not batch:
                continue
            conn = self._connections_for(doc_id).get(client_id)
            if conn is not None and conn.open:
                delivered += len(batch)
                conn.handler(batch)
        return delivered

    # -- alfred front door -----------------------------------------------------

    def connect(
        self,
        doc_id: str,
        handler: Callable[[list[SequencedDocumentMessage]], None],
        on_nack: Callable[[NackMessage], None] | None = None,
        on_signal: Callable[[Any], None] | None = None,
        mode: str = "write",
        scopes: tuple[str, ...] = ScopeType.ALL,
    ) -> _LiveConnection:
        if mode == "viewer":
            # Viewer-plane connect needs server/broadcaster.py and its
            # native fan-out, which this package does not port yet.
            raise NotImplementedError(
                "viewer connections need the viewer plane "
                "(server/broadcaster.py), which this package does not "
                "port yet (ROADMAP Queue A 5)")
        residency = getattr(self.storm, "residency", None)
        if residency is not None:
            # Tiered residency: the first connect against a cold doc
            # hydrates it (PAPER §2.6: routerlicious loads the document
            # on connect). In-process connects bypass the hydration
            # bucket — the front doors (alfred/bridge) gate BEFORE
            # calling here and nack with retry_after_s.
            residency.ensure_resident(doc_id, gate=False)
        client_number = next(self._client_counter)
        self.store.put("client_counter", client_number)
        client_id = f"client-{client_number}"
        connection = _LiveConnection(client_id, doc_id, self, handler,
                                     on_nack, on_signal, mode=mode)
        self._connections_for(doc_id)[client_id] = connection
        if self.fanout is not None:
            sub = self.fanout.connect()
            self.fanout.join(sub, doc_id)
            self._fanout_subs[(doc_id, client_id)] = sub
        self.logger.send_event("ClientConnect", docId=doc_id,
                               clientId=client_id, mode=mode)
        self._announce_audience(doc_id, connection)
        if mode != "read":
            self._order_membership(doc_id, RawOperation(
                client_id=None,
                type=MessageType.CLIENT_JOIN,
                data=ClientDetail(client_id=client_id, mode=mode,
                                  scopes=scopes),
                timestamp=self._clock(),
                can_summarize=ScopeType.SUMMARY_WRITE in scopes,
            ))
            self._maybe_pump()
        return connection

    def _announce_audience(self, doc_id: str, connection) -> None:
        from .audience import MAX_ROSTER, announce_connect
        # Interest-sampled presence: a pathological writer/reader fan-in
        # on one doc gets a bounded roster sample + exact total instead
        # of a join event per member (read-only VIEWERS never reach this
        # map at all — server/broadcaster.py).
        announce_connect(self._connections_for(doc_id), connection,
                         max_roster=MAX_ROSTER)

    def disconnect(self, doc_id: str, client_id: str) -> None:
        residency = getattr(self.storm, "residency", None)
        if residency is not None:
            # The CLIENT_LEAVE below sequences through the deli row — a
            # cold doc must hydrate into a TRACKED pool slot first, or
            # the leave would lazily allocate a row residency never sees
            # (an untracked slot leak past max_resident). The doc goes
            # idle (no clients) and re-evicts on the next sweep.
            residency.ensure_resident(doc_id, gate=False)
        if self.fanout is not None:
            sub = self._fanout_subs.pop((doc_id, client_id), None)
            if sub is not None:
                self.fanout.disconnect(sub)
            self._fanout_last_seq.pop((doc_id, client_id), None)
        connection = self._connections_for(doc_id).pop(client_id, None)
        if connection is not None:
            from .audience import MAX_ROSTER, announce_leave
            announce_leave(self._connections_for(doc_id), client_id,
                           max_roster=MAX_ROSTER)
        if connection is not None and connection.open:
            # Service-initiated close (the client-initiated path flips
            # `open` before calling us): mark it dead so further submits
            # fail fast, and drop the owning transport so the client sees
            # a real disconnect instead of going silently deaf.
            connection.open = False
            if connection.on_closed is not None:
                try:
                    connection.on_closed()
                except Exception as err:
                    self.logger.send_error("ConnectionDropFailed", err)
        self.logger.send_event("ClientDisconnect", docId=doc_id,
                               clientId=client_id)
        if connection is not None and connection.mode == "read":
            return
        self._order_membership(doc_id, RawOperation(
            client_id=None,
            type=MessageType.CLIENT_LEAVE,
            data=client_id,
            timestamp=self._clock(),
        ))
        self._maybe_pump()

    def submit(self, doc_id: str, client_id: str,
               messages: list[DocumentMessage]) -> None:
        residency = getattr(self.storm, "residency", None)
        if residency is not None:
            # Per-op traffic must refresh the doc's idle clock (or an
            # ACTIVE doc could idle-evict mid-session) and a cold doc
            # must hydrate into a TRACKED row before the orderer's deli
            # submit lazily allocates one residency never sees — the
            # same contract as connect()/disconnect(). Resident docs pay
            # one dict re-insert (touch); only genuinely cold docs pay a
            # restore.
            residency.ensure_resident(doc_id, gate=False)
        self.metrics.counter("alfred.submitted_ops").inc(len(messages))
        self.orderer.connect(doc_id, client_id).order([
            RawOperation(
                client_id=client_id,
                type=message.type,
                client_seq=message.client_sequence_number,
                ref_seq=message.reference_sequence_number,
                timestamp=self._clock(),
                contents=message.contents,
                traces=tuple(message.traces) + (Trace("alfred", "submit"),),
            ) for message in messages])
        self._maybe_pump()

    def signal(self, doc_id: str, client_id: str, content: Any) -> None:
        for connection in list(self._connections_for(doc_id).values()):
            if connection.on_signal is not None:
                connection.on_signal({"client_id": client_id,
                                      "content": content})

    # -- storage (historian/gitrest + scriptorium reads) -----------------------

    def get_deltas(self, doc_id: str, from_seq: int,
                   to_seq: int | None = None) -> list[SequencedDocumentMessage]:
        # Batched-cadence mode must not let readers force a device tick
        # out of cadence; a reader that misses in-flight ops catches up on
        # the next broadcast (gap fetch retries).
        self._maybe_pump()
        log: list[SequencedDocumentMessage] = self.store.get(
            f"ops/{doc_id}", [])
        storm = self.storm
        wanted = (storm.records_overlapping(doc_id, from_seq, to_seq)
                  if storm is not None else [])
        if wanted:
            # Columnar scriptorium records (storm fast path) materialize
            # per-op messages lazily — only the catch-up read path pays,
            # and only for records overlapping the requested range (a
            # tip reader must not rebuild the whole history).
            from .storm import materialize_storm_records
            log = sorted(
                log + materialize_storm_records(
                    wanted, storm.datastore, storm.channel,
                    blob_reader=storm.read_tick_words),
                key=lambda m: m.sequence_number)
        return [m for m in log
                if m.sequence_number > from_seq
                and (to_seq is None or m.sequence_number <= to_seq)]

    # -- history plane (time travel / branches, server/history.py) -------------

    def _history(self):
        history = getattr(self.storm, "history", None)
        if history is None:
            raise RuntimeError(
                "history plane not enabled (attach a HistoryPlane to "
                "the storm controller)")
        return history

    def read_at(self, doc_id: str, seq: int) -> dict:
        """Materialize ``doc_id``'s converged state at historical
        ``seq`` — served entirely from summaries + durable records (a
        cold doc stays cold; no device row hydrates)."""
        self._maybe_pump()
        return self._history().read_at(doc_id, seq)

    def fork_doc(self, doc_id: str, seq: int,
                 name: str | None = None) -> str:
        """Fork ``doc_id`` at ``seq`` into a named branch doc (a full
        citizen: residency/QoS/viewers serve it like any doc)."""
        self._maybe_pump()
        return self._history().fork(doc_id, seq, name)

    def merge_back(self, branch: str) -> dict:
        """Re-submit a branch's delta ops into its parent through the
        ordinary sequencer."""
        self._maybe_pump()
        return self._history().merge_back(branch)

    def upload_snapshot(self, doc_id: str, snapshot: dict,
                        parent: str | None = None) -> str:
        if parent is not None:
            # Incremental summary (summary.ts:53): the client uploaded
            # handle stubs for unchanged subtrees; resolve them against
            # the stored parent so every reader sees a full tree (the
            # content-addressed store dedups the unchanged subtrees).
            from ..protocol.summary import resolve_handles
            parent_tree = self.snapshots.get(doc_id, parent)
            if parent_tree is None:
                raise KeyError(f"unknown parent summary {parent!r}")
            snapshot = resolve_handles(snapshot, parent_tree)
        handle = self.snapshots.upload(doc_id, snapshot)
        if self.snapshots.head(doc_id) is None:
            self.snapshots.set_head(doc_id, handle)
        return handle

    def get_latest_snapshot(self, doc_id: str) -> dict | None:
        return self.snapshots.get(doc_id, self.snapshots.head(doc_id))

    def create_blob(self, doc_id: str, blob_id: str, data: bytes) -> str:
        """Attachment-blob storage (blobManager.ts upload; stored base64 so
        the durable journal stays JSON)."""
        import base64
        blobs: dict = self.store.get(f"blobs/{doc_id}", {})
        blobs[blob_id] = base64.b64encode(bytes(data)).decode()
        self.store.put(f"blobs/{doc_id}", blobs)
        return blob_id

    def read_blob(self, doc_id: str, blob_id: str) -> bytes:
        import base64
        return base64.b64decode(self.store.get(f"blobs/{doc_id}", {})[blob_id])

    # -- agent control surface (headless-agent ↔ foreman) ----------------------

    def help_tasks(self, doc_id: str | None = None) -> list[dict]:
        """Pending foreman assignments with stable claim keys;
        doc_id None = across all documents (agent-pool discovery)."""
        keys = ([f"help/{doc_id}"] if doc_id is not None
                else self.store.keys("help/"))
        out = []
        for key in keys:
            doc = key[len("help/"):]
            done = set(self.store.get(f"help_done/{doc}", []))
            for index, assignment in enumerate(self.store.get(key, [])):
                task_key = f"{doc}#{index}"
                if task_key not in done:
                    out.append({**assignment, "doc_id": doc,
                                "key": task_key})
        return out

    def complete_help(self, task_key: str) -> None:
        """Durably mark one assignment done (idempotent)."""
        doc = task_key.rsplit("#", 1)[0]
        done = self.store.get(f"help_done/{doc}", [])
        if task_key not in done:
            self.store.put(f"help_done/{doc}", done + [task_key])
