"""LocalCollabServer — full in-process ordering service for tests/dev.

Reference parity: server/routerlicious/packages/local-server/src/
localDeltaConnectionServer.ts (``LocalDeltaConnectionServer``) + tinylicious:
the alfred front-door, deli sequencer, scriptorium op log, broadcaster
fan-out and snapshot store collapsed into one deterministic in-proc service.

The sequencer is pluggable: the default scalar ``DocumentSequencer`` per
document, or the batched device kernel via
:class:`fluidframework_tpu_torch.server.kernel_host.KernelSequencerHost` — both
produce identical tickets (differentially tested), so the e2e stack runs
unchanged on either.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable

from ..protocol.messages import (
    ClientDetail,
    DocumentMessage,
    MessageType,
    NackMessage,
    ScopeType,
    SequencedDocumentMessage,
)
from ..ops import opcodes as oc
from .sequencer import DocumentSequencer, RawOperation, Ticket


@dataclass
class _Connection:
    client_id: str
    document: "_Document"
    handler: Callable[[list[SequencedDocumentMessage]], None]
    on_nack: Callable[[NackMessage], None] | None = None
    on_signal: Callable[[Any], None] | None = None
    open: bool = True
    mode: str = "write"

    def submit(self, messages: list[DocumentMessage]) -> None:
        assert self.open, "submit on closed connection"
        self.document.server.submit(self.document.doc_id, self.client_id,
                                    messages)

    def signal(self, content: Any) -> None:
        assert self.open, "signal on closed connection"
        self.document.server.signal(self.document.doc_id, self.client_id,
                                    content)

    def close(self) -> None:
        if self.open:
            self.open = False
            self.document.server.disconnect(self.document.doc_id,
                                            self.client_id)


@dataclass
class _Document:
    doc_id: str
    server: "LocalCollabServer"
    sequencer: DocumentSequencer = field(default_factory=DocumentSequencer)
    log: list[SequencedDocumentMessage] = field(default_factory=list)
    connections: dict[str, _Connection] = field(default_factory=dict)
    snapshots: dict[str, dict] = field(default_factory=dict)
    blobs: dict[str, bytes] = field(default_factory=dict)
    # Only ACKED summaries are load-visible (scribe writes the git commit
    # before emitting summaryAck); the attach-time base upload is implicitly
    # acked as the document's root.
    acked_snapshot: str | None = None
    last_broadcast_seq: int = 0
    # Broadcast queue: a client handler may re-entrantly submit (in-proc),
    # sequencing new messages mid-fan-out; they must not overtake the
    # message currently being delivered for connections not yet visited.
    delivery: list[SequencedDocumentMessage] = field(default_factory=list)
    delivering: bool = False


class LocalCollabServer:
    """In-memory multi-document ordering + storage service."""

    def __init__(self, sequencer_factory: Callable[[], DocumentSequencer]
                 = DocumentSequencer, merge_host=None) -> None:
        self._sequencer_factory = sequencer_factory
        self._documents: dict[str, _Document] = {}
        self._client_counter = itertools.count(1)
        self._clock = itertools.count(1)  # deterministic timestamps
        # Optional KernelMergeHost: every sequenced message also feeds the
        # device-resident server replica (server/merge_host.py).
        self.merge_host = merge_host

    def _document(self, doc_id: str) -> _Document:
        if doc_id not in self._documents:
            self._documents[doc_id] = _Document(
                doc_id, self, sequencer=self._sequencer_factory())
        return self._documents[doc_id]

    # -- connection lifecycle (alfred connect_document) -----------------------

    def connect(
        self,
        doc_id: str,
        handler: Callable[[list[SequencedDocumentMessage]], None],
        on_nack: Callable[[NackMessage], None] | None = None,
        on_signal: Callable[[Any], None] | None = None,
        mode: str = "write",
        scopes: tuple[str, ...] = ScopeType.ALL,
    ) -> _Connection:
        document = self._document(doc_id)
        client_id = f"client-{next(self._client_counter)}"
        connection = _Connection(client_id, document, handler, on_nack,
                                 on_signal)
        connection.mode = mode
        document.connections[client_id] = connection
        # Audience wiring (container.ts:1700): announce EVERY connection
        # (read-only ones included — they never reach the quorum).
        from .audience import MAX_ROSTER, announce_connect
        announce_connect(document.connections, connection,
                         max_roster=MAX_ROSTER)
        # Read clients receive the broadcast stream but never enter the
        # quorum or the MSN calculation (the reference sequences joins only
        # for write connections — a reader must not pin minSeq).
        if mode != "read":
            detail = ClientDetail(client_id=client_id, mode=mode,
                                  scopes=scopes)
            self._sequence_raw(document, RawOperation(
                client_id=None,
                type=MessageType.CLIENT_JOIN,
                data=detail,
                timestamp=next(self._clock),
                can_summarize=ScopeType.SUMMARY_WRITE in scopes,
            ))
        return connection

    def disconnect(self, doc_id: str, client_id: str) -> None:
        document = self._document(doc_id)
        connection = document.connections.pop(client_id, None)
        if connection is not None:
            from .audience import MAX_ROSTER, announce_leave
            announce_leave(document.connections, client_id,
                           max_roster=MAX_ROSTER)
        if connection is not None and connection.mode == "read":
            return
        self._sequence_raw(document, RawOperation(
            client_id=None,
            type=MessageType.CLIENT_LEAVE,
            data=client_id,
            timestamp=next(self._clock),
        ))

    # -- op path (alfred submitOp → deli → scriptorium/broadcaster) -----------

    def submit(self, doc_id: str, client_id: str,
               messages: list[DocumentMessage]) -> None:
        document = self._document(doc_id)
        for message in messages:
            raw = RawOperation(
                client_id=client_id,
                type=message.type,
                client_seq=message.client_sequence_number,
                ref_seq=message.reference_sequence_number,
                timestamp=next(self._clock),
                contents=message.contents,
            )
            ticket = document.sequencer.ticket(raw)
            if ticket.kind == oc.OUT_NACK:
                connection = document.connections.get(client_id)
                if connection is not None and connection.on_nack is not None:
                    connection.on_nack(NackMessage(
                        operation=message,
                        sequence_number=ticket.seq,
                        code=403 if ticket.nack_code == oc.NACK_NO_SUMMARY_SCOPE
                        else 400,
                        error_type=ticket.nack_code,
                        message=f"nack:{ticket.nack_code}",
                    ))
                continue
            if ticket.kind == oc.OUT_SEQUENCED:
                self._emit(document, raw, ticket)
                if message.type == MessageType.SUMMARIZE:
                    self._scribe_handle_summary(document, message, ticket)

    def _scribe_handle_summary(self, document: _Document,
                               message: DocumentMessage,
                               ticket: Ticket) -> None:
        """Scribe lambda analog: validate the client summary offer, make it
        durable/load-visible, and sequence the ack into the op stream
        (scribe/lambda.ts:190-250 + summaryWriter.writeClientSummary)."""
        handle = (message.contents or {}).get("handle")
        proposal = {"summary_proposal": {
            "summary_sequence_number": ticket.seq}}

        def nack(reason: str) -> None:
            self._sequence_raw(document, RawOperation(
                client_id=None,
                type=MessageType.SUMMARY_NACK,
                contents={"message": reason, "handle": handle, **proposal},
                timestamp=next(self._clock),
            ))

        offered = document.snapshots.get(handle)
        if offered is None:
            nack(f"unknown summary handle {handle!r}")
            return
        # Ancestry check (scribe validates the proposal against the current
        # summary head): a stale or replayed offer must not roll the acked
        # snapshot back to an older sequence number.
        current = document.snapshots.get(document.acked_snapshot or "")
        offered_seq = (offered or {}).get("sequence_number")
        if not isinstance(offered_seq, int):
            nack("summary content missing sequence_number")
            return
        if current is not None and offered_seq < current["sequence_number"]:
            nack(f"stale summary at seq {offered_seq} < "
                 f"current {current['sequence_number']}")
            return
        document.acked_snapshot = handle
        self._sequence_raw(document, RawOperation(
            client_id=None,
            type=MessageType.SUMMARY_ACK,
            contents={"handle": handle, **proposal},
            timestamp=next(self._clock),
        ))

    def signal(self, doc_id: str, client_id: str, content: Any) -> None:
        """Transient broadcast, never sequenced (alfred submitSignal)."""
        document = self._document(doc_id)
        for connection in list(document.connections.values()):
            if connection.on_signal is not None:
                connection.on_signal({"client_id": client_id,
                                      "content": content})

    def _sequence_raw(self, document: _Document, raw: RawOperation) -> None:
        ticket = document.sequencer.ticket(raw)
        if ticket.kind == oc.OUT_SEQUENCED:
            self._emit(document, raw, ticket)

    def _emit(self, document: _Document, raw: RawOperation,
              ticket: Ticket) -> None:
        # Un-revved carriers (delayed no-ops) are consolidated away: only
        # messages that advanced the sequence number broadcast.
        if ticket.seq <= document.last_broadcast_seq:
            return
        document.last_broadcast_seq = ticket.seq
        sequenced = SequencedDocumentMessage(
            client_id=raw.client_id,
            sequence_number=ticket.seq,
            minimum_sequence_number=ticket.msn,
            client_sequence_number=raw.client_seq,
            reference_sequence_number=raw.ref_seq,
            type=raw.type,
            contents=raw.contents,
            timestamp=raw.timestamp,
            data=raw.data,
        )
        document.log.append(sequenced)
        if self.merge_host is not None:
            self.merge_host.ingest(document.doc_id, sequenced)
        document.delivery.append(sequenced)
        if document.delivering:
            return
        document.delivering = True
        try:
            while document.delivery:
                message = document.delivery.pop(0)
                for connection in list(document.connections.values()):
                    connection.handler([message])
        finally:
            document.delivering = False

    # -- storage (scriptorium/historian equivalents) --------------------------

    def get_deltas(self, doc_id: str, from_seq: int,
                   to_seq: int | None = None) -> list[SequencedDocumentMessage]:
        log = self._document(doc_id).log
        return [m for m in log
                if m.sequence_number > from_seq
                and (to_seq is None or m.sequence_number <= to_seq)]

    def upload_snapshot(self, doc_id: str, snapshot: dict,
                        parent: str | None = None) -> str:
        """Store a summary blob; returns its handle. The first upload of a
        document is its attach-time base and becomes load-visible at once;
        later uploads become visible only via a sequenced summarize→ack.
        With ``parent``, handle stubs (incremental summaries) resolve
        against that stored summary before the blob is stored."""
        document = self._document(doc_id)
        if parent is not None:
            from ..protocol.summary import resolve_handles
            parent_tree = document.snapshots.get(parent)
            if parent_tree is None:
                raise KeyError(f"unknown parent summary {parent!r}")
            snapshot = resolve_handles(snapshot, parent_tree)
        handle = f"{doc_id}/snapshots/{len(document.snapshots)}"
        document.snapshots[handle] = snapshot
        if document.acked_snapshot is None:
            document.acked_snapshot = handle
        return handle

    def get_latest_snapshot(self, doc_id: str) -> dict | None:
        document = self._document(doc_id)
        if document.acked_snapshot is None:
            return None
        return document.snapshots[document.acked_snapshot]

    def create_blob(self, doc_id: str, blob_id: str, data: bytes) -> str:
        """Attachment-blob storage (blobManager.ts:51 upload path)."""
        self._document(doc_id).blobs[blob_id] = bytes(data)
        return blob_id

    def read_blob(self, doc_id: str, blob_id: str) -> bytes:
        return self._document(doc_id).blobs[blob_id]
