"""BlobManager — out-of-band attachment blobs referenced by handle.

Reference parity: packages/runtime/container-runtime/src/blobManager.ts:51
— large binary payloads (images, file attachments) never ride the op
stream; they upload straight to storage and DDS values carry only the
handle path (``/_blobs/<id>``). The redirect table of known blob ids
rides the summary so GC and late joiners see them.
"""

from __future__ import annotations

import hashlib
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from .container_runtime import ContainerRuntime

BLOB_PATH_PREFIX = "/_blobs/"


class BlobHandle:
    """Handle to an uploaded blob; serializes as its absolute path (the
    shared-object handle rule, handles.py)."""

    def __init__(self, runtime: "ContainerRuntime", blob_id: str) -> None:
        self._runtime = runtime
        self.blob_id = blob_id
        self.absolute_path = BLOB_PATH_PREFIX + blob_id

    def get(self) -> bytes:
        return self._runtime.blobs.read(self.blob_id)

    def __eq__(self, other) -> bool:
        return isinstance(other, BlobHandle) and \
            other.absolute_path == self.absolute_path

    def __hash__(self) -> int:
        return hash(self.absolute_path)


class BlobManager:
    def __init__(self, runtime: "ContainerRuntime") -> None:
        self._runtime = runtime
        # Detached-phase blobs buffer locally and upload at attach
        # (blobManager.ts offline/detached flow).
        self._detached: dict[str, bytes] = {}
        # Ids we know exist in storage (uploaded here or seen in a summary).
        self._known: set[str] = set()

    def upload_blob(self, data: bytes) -> BlobHandle:
        blob_id = hashlib.sha256(data).hexdigest()
        if self._runtime.container.attached:
            self._storage().create_blob(blob_id, data)
        else:
            self._detached[blob_id] = data
        self._known.add(blob_id)
        return BlobHandle(self._runtime, blob_id)

    def read(self, blob_id: str) -> bytes:
        if blob_id in self._detached:
            return self._detached[blob_id]
        return self._storage().read_blob(blob_id)

    def get_handle(self, blob_id: str) -> BlobHandle:
        return BlobHandle(self._runtime, blob_id)

    def on_attach(self) -> None:
        for blob_id, data in self._detached.items():
            self._storage().create_blob(blob_id, data)
        self._detached.clear()

    def _storage(self):
        return self._runtime.container._service.storage

    # -- summary ---------------------------------------------------------------

    def summarize(self) -> dict:
        return {"ids": sorted(self._known)}

    def load(self, content: dict | None) -> None:
        self._known = set((content or {}).get("ids", []))