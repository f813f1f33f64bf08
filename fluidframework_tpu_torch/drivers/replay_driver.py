"""Replay / file drivers — run the real client stack from recorded logs.

Reference parity: packages/drivers/replay-driver (replayController.ts —
a fake document service that feeds recorded ops) and file-driver (reads
ops/snapshots from disk). These power the golden-snapshot regression
harness (tools/replay.py), the analog of
packages/test/snapshots/src/replayMultipleFiles.ts:83-92.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable

from ..protocol.codec import from_wire, to_wire
from ..protocol.messages import DocumentMessage, NackMessage, SequencedDocumentMessage
from .base import IncomingHandler

OPS_FILE = "ops.json"
SNAPSHOT_FILE = "snapshot.json"


class _ReplayConnection:
    """Read-only live connection: recorded documents accept no new ops."""

    client_id = "replay-client"

    def submit(self, messages: list[DocumentMessage]) -> None:
        raise RuntimeError("replay documents are read-only")

    def signal(self, content: Any) -> None:
        raise RuntimeError("replay documents are read-only")

    def close(self) -> None:
        pass


class _ReplaySnapshotStorage:
    def __init__(self, snapshot: dict | None,
                 blobs: dict[str, bytes] | None = None) -> None:
        self._snapshot = snapshot
        self._blobs = blobs or {}

    def get_latest_snapshot(self) -> dict | None:
        return self._snapshot

    def read_blob(self, blob_id: str) -> bytes:
        return self._blobs[blob_id]

    def resolve_blob(self, stub: dict) -> dict:
        """Virtualized channel stubs in a recorded snapshot resolve from
        the recording's blobs/ directory (content-verified), so goldens
        anchor the virtualized wire format too."""
        import hashlib

        from .virtualized_driver import VIRTUAL_KEY
        blob_id = stub[VIRTUAL_KEY]["id"]
        data = self._blobs[blob_id]
        assert hashlib.sha256(data).hexdigest() == blob_id, \
            f"recorded blob {blob_id} content mismatch"
        return json.loads(data.decode())

    def upload_snapshot(self, snapshot: dict,
                        parent: str | None = None) -> str:
        raise RuntimeError("replay documents are read-only")


class _ReplayDeltaStorage:
    def __init__(self, messages: list[SequencedDocumentMessage],
                 up_to_seq: int | None) -> None:
        self._messages = messages
        self._up_to = up_to_seq

    def get_deltas(self, from_seq: int, to_seq: int | None = None
                   ) -> list[SequencedDocumentMessage]:
        return [m for m in self._messages
                if m.sequence_number > from_seq
                and (to_seq is None or m.sequence_number <= to_seq)
                and (self._up_to is None
                     or m.sequence_number <= self._up_to)]


class ReplayDocumentService:
    """IDocumentService over a recorded op log (+ optional base snapshot).

    ``up_to_seq`` truncates the stream — the replay tool's step-through
    mode (replayController's replayTo)."""

    def __init__(self, messages: list[SequencedDocumentMessage],
                 snapshot: dict | None = None,
                 up_to_seq: int | None = None,
                 blobs: dict[str, bytes] | None = None) -> None:
        self.blobs = blobs
        self.storage = _ReplaySnapshotStorage(snapshot, blobs)
        self.delta_storage = _ReplayDeltaStorage(messages, up_to_seq)

    def connect(self, handler: IncomingHandler,
                on_nack: Callable[[NackMessage], None] | None = None,
                on_signal: Callable[[Any], None] | None = None,
                mode: str = "read") -> _ReplayConnection:
        return _ReplayConnection()


def load_recorded(directory: str | Path
                  ) -> tuple[list[SequencedDocumentMessage], dict | None]:
    """Parse a recorded directory (ops.json [+ snapshot.json], wire-codec
    JSON) — the ONE place that knows the on-disk format, shared by the
    file driver, the golden harness, and the debug tool."""
    directory = Path(directory)
    messages = [from_wire(m) for m in json.loads(
        (directory / OPS_FILE).read_text())]
    snapshot_path = directory / SNAPSHOT_FILE
    snapshot = from_wire(json.loads(snapshot_path.read_text())) \
        if snapshot_path.exists() else None
    return messages, snapshot


class FileDocumentService(ReplayDocumentService):
    """Replay service reading ``ops.json`` (+ optional ``snapshot.json``)
    from a directory — the file-driver analog. Files are wire-codec JSON
    (see tools/replay.py for the recorder)."""

    def __init__(self, directory: str | Path,
                 up_to_seq: int | None = None) -> None:
        blobs_dir = Path(directory) / "blobs"
        blobs = ({p.name: p.read_bytes() for p in blobs_dir.iterdir()}
                 if blobs_dir.is_dir() else None)
        super().__init__(*load_recorded(directory), up_to_seq, blobs=blobs)


def record_document(server, doc_id: str, directory: str | Path,
                    snapshot: dict | None = None,
                    blobs: dict[str, bytes] | None = None) -> int:
    """Write a document's full sequenced log (and optional base snapshot
    + virtualized blobs) as a replayable directory. Returns the number
    of recorded ops."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    messages = server.get_deltas(doc_id, 0)
    (directory / OPS_FILE).write_text(json.dumps(
        [to_wire(m) for m in messages], indent=1, sort_keys=True))
    if snapshot is not None:
        (directory / SNAPSHOT_FILE).write_text(json.dumps(
            to_wire(snapshot), indent=1, sort_keys=True))
    if blobs:
        blobs_dir = directory / "blobs"
        blobs_dir.mkdir(exist_ok=True)
        for blob_id, data in blobs.items():
            (blobs_dir / blob_id).write_bytes(data)
    return len(messages)
