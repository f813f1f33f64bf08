"""Container — a client's connection to one collaborative document.

Reference parity: packages/loader/container-loader/src/container.ts
(``Container``: load:277/1115, processRemoteMessage:1700, connection state)
over a :class:`fluidframework_tpu_torch.runtime.delta_manager.DeltaManager`
(deltaManager.ts:147 — inbound/outbound queues, gap fetch, readonly) —
transport is a driver-provided delta connection; storage is a
driver-provided snapshot/delta reader.

The container owns the protocol handler (quorum) and the ContainerRuntime;
protocol messages route to the former, OPERATION envelopes to the latter.
"""

from __future__ import annotations

from typing import Any, Callable

from ..drivers.base import DocumentService
from ..protocol.handler import ProtocolOpHandler
from ..protocol.messages import (
    MessageType,
    SequencedDocumentMessage,
)
from .container_runtime import ContainerRuntime
from .delta_manager import DeltaManager


class Audience:
    """Every connected client of the document — INCLUDING read-only
    connections, which never enter the quorum (container.ts:1700 region's
    audience wiring; the quorum tracks write clients only). Fed by
    service-emitted ``__audience__`` signals."""

    def __init__(self) -> None:
        self.members: dict[str, dict] = {}
        # Exact audience size from the service (interest-sampled presence:
        # a snapshot past the roster bound lists a member SAMPLE but
        # always carries the true total — server/audience.py).
        self.total = 0
        self.on_add_member: list[Callable[[str, dict], None]] = []
        self.on_remove_member: list[Callable[[str, dict], None]] = []

    def get_members(self) -> dict[str, dict]:
        return dict(self.members)

    def get_member(self, client_id: str) -> dict | None:
        return self.members.get(client_id)

    def _apply(self, payload: dict) -> None:
        event = payload.get("event")
        if event == "snapshot":
            self.members = {m["client_id"]: dict(m)
                            for m in payload.get("members", [])}
            self.total = payload.get("total", len(self.members))
        elif event == "join":
            member = dict(payload["member"])
            if member["client_id"] not in self.members:
                self.total += 1
            self.members[member["client_id"]] = member
            for cb in self.on_add_member:
                cb(member["client_id"], member)
        elif event == "leave":
            member = self.members.pop(payload.get("client_id"), None)
            self.total = max(0, self.total - 1)
            if member is not None:
                for cb in self.on_remove_member:
                    cb(payload["client_id"], member)
        elif event == "count":
            # Sampled-presence count update (server/audience.py past the
            # roster bound): the exact total, optionally naming a leaver
            # a peer's SAMPLE may still hold.
            self.total = payload.get("total", self.total)
            left = payload.get("left")
            if left is not None:
                member = self.members.pop(left, None)
                if member is not None:
                    for cb in self.on_remove_member:
                        cb(left, member)


class Container:
    def __init__(self, document_service: DocumentService,
                 registry=None) -> None:
        self._service = document_service
        self.protocol = ProtocolOpHandler()
        self.runtime = ContainerRuntime(self, registry)
        self._wire_quorum()
        self.attached = False
        self.delta_manager = DeltaManager(
            document_service,
            process_message=self._process_remote_message,
            process_signal=self._process_signal,
            on_nack=self._on_nack,
        )
        self._mode = "write"
        # Set by load() when the driver virtualizes channel snapshots.
        self.snapshot_resolver: Callable[[dict], dict] | None = None
        self.audience = Audience()
        self.on_connected: list[Callable[[str], None]] = []
        self.on_disconnected: list[Callable[[], None]] = []
        self.on_signal: list[Callable[[Any], None]] = []
        # Fired after every sequenced message is applied (summary manager,
        # telemetry, tests). Receives the SequencedDocumentMessage.
        self.on_op_processed: list[Callable[[SequencedDocumentMessage],
                                            None]] = []
        # Service rejections of our ops (never silent — tests assert empty).
        self.nacks: list[Any] = []
        self.on_nack: list[Callable[[Any], None]] = []
        # Offline resume: the previous session's client id while its
        # stashed ops may still arrive sequenced (cleared after catch-up).
        self._stashed_client_id: str | None = None
        # Transport-loss surfacing: drivers with an
        # event emitter (network driver "disconnect" on socket death)
        # degrade the container to disconnected/readonly instead of
        # leaving it hung on a dead socket.
        events = getattr(document_service, "events", None)
        if events is not None:
            events.on("disconnect", self._on_transport_lost)

    def _on_transport_lost(self) -> None:
        """The driver's transport died underneath us: drop the connection
        WITHOUT the disconnect RPC (no socket to carry it) and fire the
        disconnected callbacks. The container keeps serving local reads
        (readonly degradation); connect()/reconnect() — or an
        AutoReconnector — restores write mode."""
        if not self.connected:
            return
        self.delta_manager.handle_connection_lost()
        for cb in self.on_disconnected:
            cb()

    # -- load -----------------------------------------------------------------

    @classmethod
    def load(cls, document_service: DocumentService, registry=None,
             mode: str = "write", pending_state: dict | None = None,
             code_loader=None) -> "Container":
        """Open an existing document: snapshot + trailing deltas + connect.

        ``pending_state`` (from :meth:`close_and_get_pending_state`)
        resumes an offline session: stashed unacked ops re-apply locally
        via each channel's ``apply_stashed_op`` before catch-up; ops the
        old connection DID get sequenced ack against the stash during
        catch-up (matched by the stashed client id + clientSeq, the
        pendingStateManager.ts stashed-ops flow), and the remainder
        resubmits after connect."""
        container = cls(document_service, registry)
        # Virtualizing drivers resolve stubbed channel snapshots lazily at
        # realization (drivers/virtualized_driver.py); plain drivers have
        # no resolver and never produce stubs.
        container.snapshot_resolver = getattr(
            document_service.storage, "resolve_blob", None)
        snapshot = document_service.storage.get_latest_snapshot()
        if snapshot is not None:
            container.protocol = ProtocolOpHandler.load(snapshot["protocol"])
            container._wire_quorum()
            if code_loader is not None:
                # The quorum's committed "code" value picks the runtime
                # factory BEFORE any channel instantiates
                # (container.ts:1700-1835 instantiateRuntime).
                factory = code_loader.load(
                    container.protocol.quorum.get("code"))
                factory.instantiate(container)
            container.runtime.load(snapshot["runtime"])
            container.delta_manager.last_processed_seq = \
                snapshot["sequence_number"]
            container.delta_manager.last_queued_seq = \
                snapshot["sequence_number"]
        container.attached = True
        if pending_state is not None:
            # Stashed ops re-apply against the exact state the dead session
            # last saw: catch up to its refSeq first, then apply, then go
            # live (the rest of catch-up delivers any sequenced stashed ops
            # as acks against the stash).
            ref = pending_state["reference_sequence_number"]
            if snapshot is not None and snapshot["sequence_number"] > ref:
                raise ValueError(
                    "stash predates the latest snapshot; resume requires "
                    "deltas from the stash's reference point")
            container.delta_manager.catch_up_to(ref)
            container._apply_stashed_state(pending_state)
        container.connect(mode)
        if pending_state is not None:
            container._stashed_client_id = None
            container.runtime.replay_pending()
        return container

    @classmethod
    def create_detached(cls, document_service: DocumentService, registry=None
                        ) -> "Container":
        """Create a new (empty) document; call attach() to go live. Edits made
        while detached apply locally and ship via the attach-time snapshot."""
        return cls(document_service, registry)

    def attach(self) -> None:
        """Publish the detached state as the document's base snapshot and go
        live (container.ts attach: detached → attached lifecycle)."""
        assert not self.attached, "already attached"
        self.runtime.on_attach()
        self._service.storage.upload_snapshot(self.summarize())
        self.attached = True
        self.connect()

    def _wire_quorum(self) -> None:
        """Membership events fan out to interested channels (e.g. consensus
        queues auto-release a departed client's leases)."""
        self.protocol.quorum.on_remove_member.append(self._on_member_removed)

    def _on_member_removed(self, client_id: str) -> None:
        for datastore in self.runtime.datastores.values():
            # Lazy consensus channels must see the leave (lease release);
            # other lazy channels stay lazy.
            datastore.realize_membership_sensitive()
            for channel in datastore.channels.values():
                on_leave = getattr(channel, "on_client_leave", None)
                if on_leave is not None:
                    on_leave(client_id)

    # -- connection state machine --------------------------------------------

    @property
    def connected(self) -> bool:
        return self.delta_manager.connected

    @property
    def client_id(self) -> str | None:
        return self.delta_manager.client_id

    @property
    def last_processed_seq(self) -> int:
        return self.delta_manager.last_processed_seq

    @property
    def inbound(self):
        return self.delta_manager.inbound

    @property
    def outbound(self):
        return self.delta_manager.outbound

    def connect(self, mode: str | None = None) -> None:
        """Connect in the given mode; omitted = keep the container's mode
        (so reconnect of a read-only container stays read-only)."""
        if mode is not None:
            self._mode = mode
        client_id = self.delta_manager.connect(self._mode)
        for cb in self.on_connected:
            cb(client_id)

    def disconnect(self) -> None:
        if not self.connected:
            return
        self.delta_manager.disconnect()
        for cb in self.on_disconnected:
            cb()

    def reconnect(self) -> None:
        """Drop + re-establish the connection, replaying pending local ops
        (deltaManager.ts:566-692 + containerRuntime replayPendingStates)."""
        self.disconnect()
        self.connect()
        self.runtime.replay_pending()

    # -- outbound -------------------------------------------------------------

    def allocate_client_seq(self) -> int | None:
        return self.delta_manager.allocate_client_seq()

    def send_message(self, mtype: MessageType, contents: Any,
                     client_seq: int) -> None:
        self.delta_manager.submit(mtype, contents, client_seq)

    def submit_message(self, mtype: MessageType, contents: Any) -> int | None:
        """Stamp + send a message with no pending tracking (protocol msgs).
        Returns clientSequenceNumber, or None when not connected."""
        client_seq = self.allocate_client_seq()
        if client_seq is not None:
            self.send_message(mtype, contents, client_seq)
        return client_seq

    def propose(self, key: str, value: Any) -> None:
        self.submit_message(MessageType.PROPOSE, {"key": key, "value": value})

    def submit_signal(self, content: Any) -> None:
        """Transient broadcast: never sequenced, never durable (presence,
        cursors — container.ts submitSignal)."""
        self.delta_manager.submit_signal(content)

    # -- inbound --------------------------------------------------------------

    def _on_nack(self, nack: Any) -> None:
        self.nacks.append(nack)
        for cb in self.on_nack:
            cb(nack)

    def _process_signal(self, signal: Any) -> None:
        content = signal.get("content") if isinstance(signal, dict) else None
        # Only SERVICE-crafted audience signals (client_id None) may touch
        # the roster — a client echoing the payload shape must not spoof
        # membership, and falls through to the app like any signal.
        if (isinstance(content, dict)
                and content.get("type") == "__audience__"  # audience.py
                and signal.get("client_id") is None):
            self.audience._apply(content)
            return  # system signal, not app-visible
        for cb in self.on_signal:
            cb(signal)

    def _apply_stashed_state(self, pending_state: dict) -> None:
        """Re-apply stashed unacked ops locally and re-register them as
        pending under their ORIGINAL clientSeqNumbers."""
        self._stashed_client_id = pending_state.get("client_id")
        for item in pending_state.get("pending", []):
            envelope = item["contents"]
            if envelope.get("type") == "attach":
                if envelope["id"] not in self.runtime.datastores:
                    from .datastore import DataStoreRuntime
                    datastore = DataStoreRuntime(
                        envelope["id"], self.runtime, self.runtime.registry)
                    self.runtime.datastores[envelope["id"]] = datastore
                    datastore.load(envelope["snapshot"])
                    if envelope.get("root"):
                        self.runtime.root_datastores.add(envelope["id"])
                self.runtime.pending.on_submit(item["client_seq"],
                                               envelope, None)
                continue
            datastore = self.runtime.datastores[envelope["address"]]
            channel = datastore.get_channel(envelope["contents"]["address"])
            metadata = channel.apply_stashed_op(
                envelope["contents"]["contents"])
            self.runtime.pending.on_submit(item["client_seq"], envelope,
                                           metadata)

    def close_and_get_pending_state(self) -> dict:
        """Serialize unacked local ops for offline resume
        (container.ts closeAndGetPendingLocalState): pass the result to
        :meth:`load` as ``pending_state``. Closes the container."""
        state = {
            "client_id": self.client_id,
            "reference_sequence_number": self.last_processed_seq,
            "pending": [{"client_seq": item.client_seq,
                         "contents": item.contents}
                        for item in self.runtime.pending.drain_for_replay()],
        }
        self.close()
        return state

    def _process_remote_message(self, message: SequencedDocumentMessage) -> None:
        local = (
            self.client_id is not None and message.client_id == self.client_id
        )
        if (not local and self._stashed_client_id is not None
                and message.client_id == self._stashed_client_id
                and self.runtime.pending.has_pending):
            # An op our PREVIOUS session got sequenced before dying: ack it
            # against the re-applied stash (sequenced stashed ops are a
            # FIFO prefix of the stash — the server orders clientSeqs).
            local = True
        result = self.protocol.process_message(message, local)
        if message.type == MessageType.OPERATION:
            self.runtime.process(message, local)
        elif message.type == MessageType.ATTACH:
            self.runtime.process_attach(message, local)
        elif message.type == MessageType.CHUNKED_OP:
            self.runtime.process_chunk(message, local)
        for cb in self.on_op_processed:
            cb(message)
        if result["immediate_noop"] and self.connected:
            # Expedite proposal commit (quorum.ts:326): a contentful noop revs
            # and carries our advanced refSeq to the sequencer.
            self.submit_message(MessageType.NOOP, "")

    # -- summary --------------------------------------------------------------

    def summarize(self, unchanged_before: int | None = None) -> dict:
        """Summary of protocol + runtime state at the current seq. With
        ``unchanged_before`` (the last ACKED summary's seq), unchanged
        channels serialize as handle stubs into that summary — the
        incremental form (summary.ts:53); callers must then upload with
        the parent handle so the service can resolve the stubs."""
        return {
            "sequence_number": self.last_processed_seq,
            "protocol": self.protocol.snapshot(),
            "runtime": self.runtime.summarize(unchanged_before),
        }

    def close(self) -> None:
        self.disconnect()
