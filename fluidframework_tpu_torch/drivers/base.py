"""Driver contract — how a client reaches a document service.

Reference parity: packages/loader/driver-definitions/src/storage.ts:59-262
(``IDocumentService`` → storage / delta storage / delta connection). Every
backend (in-proc local server, replay, remote gRPC front-door) implements
this seam; the loader/runtime stack above is backend-agnostic.
"""

from __future__ import annotations

from typing import Any, Callable, Protocol

from ..protocol.messages import DocumentMessage, NackMessage, SequencedDocumentMessage

IncomingHandler = Callable[[list[SequencedDocumentMessage]], None]


class DeltaConnection(Protocol):
    """Live ordered-op connection (IDocumentDeltaConnection)."""

    client_id: str

    def submit(self, messages: list[DocumentMessage]) -> None: ...

    def signal(self, content: Any) -> None: ...

    def close(self) -> None: ...


class SnapshotStorage(Protocol):
    """Snapshot read/write (IDocumentStorageService)."""

    def get_latest_snapshot(self) -> dict | None: ...

    def upload_snapshot(self, snapshot: dict,
                        parent: str | None = None) -> str: ...


class DeltaStorage(Protocol):
    """Historical sequenced-op reads for catch-up (IDocumentDeltaStorageService)."""

    def get_deltas(self, from_seq: int, to_seq: int | None = None
                   ) -> list[SequencedDocumentMessage]: ...


class DocumentService(Protocol):
    storage: SnapshotStorage
    delta_storage: DeltaStorage

    def connect(self, handler: IncomingHandler,
                on_nack: Callable[[NackMessage], None] | None = None,
                on_signal: Callable[[Any], None] | None = None,
                mode: str = "write") -> DeltaConnection: ...
