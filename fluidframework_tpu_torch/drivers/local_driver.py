"""Local driver — in-proc connection to a LocalCollabServer.

Reference parity: packages/drivers/local-driver (straight into
LocalDeltaConnectionServer, for tests and examples).
"""

from __future__ import annotations

from typing import Any, Callable

from ..protocol.messages import NackMessage, SequencedDocumentMessage
from ..server.local_server import LocalCollabServer
from .base import IncomingHandler


class _LocalSnapshotStorage:
    def __init__(self, server: LocalCollabServer, doc_id: str) -> None:
        self._server = server
        self._doc_id = doc_id

    def get_latest_snapshot(self) -> dict | None:
        return self._server.get_latest_snapshot(self._doc_id)

    def upload_snapshot(self, snapshot: dict,
                        parent: str | None = None) -> str:
        return self._server.upload_snapshot(self._doc_id, snapshot,
                                            parent)

    def create_blob(self, blob_id: str, data: bytes) -> str:
        return self._server.create_blob(self._doc_id, blob_id, data)

    def read_blob(self, blob_id: str) -> bytes:
        return self._server.read_blob(self._doc_id, blob_id)


class _LocalDeltaStorage:
    def __init__(self, server: LocalCollabServer, doc_id: str) -> None:
        self._server = server
        self._doc_id = doc_id

    def get_deltas(self, from_seq: int, to_seq: int | None = None
                   ) -> list[SequencedDocumentMessage]:
        return self._server.get_deltas(self._doc_id, from_seq, to_seq)


class LocalDocumentService:
    """IDocumentService over an in-proc server."""

    def __init__(self, server: LocalCollabServer, doc_id: str,
                 scopes=None) -> None:
        self.server = server
        self.doc_id = doc_id
        self.storage = _LocalSnapshotStorage(server, doc_id)
        self.delta_storage = _LocalDeltaStorage(server, doc_id)
        self._scopes = scopes

    def connect(self, handler: IncomingHandler,
                on_nack: Callable[[NackMessage], None] | None = None,
                on_signal: Callable[[Any], None] | None = None,
                mode: str = "write"):
        kwargs = {"mode": mode}
        if self._scopes is not None:
            kwargs["scopes"] = self._scopes
        return self.server.connect(self.doc_id, handler, on_nack, on_signal,
                                   **kwargs)
