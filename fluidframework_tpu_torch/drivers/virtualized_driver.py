"""Virtualized snapshot driver — partial fetch + managed summary upload.

Reference parity: the odsp-driver's remaining depth beyond caching
(drivers/cached_driver.py):

* **Snapshot virtualization / partial fetch** (odsp-driver/src/
  fetchSnapshot.ts, odspDocumentStorageManager.ts): opening a large
  document must not download every channel's content. On upload, channel
  snapshots above an inline budget are written as content-addressed
  BLOBS through the service's blob API and the snapshot tree carries
  stubs; on load the tree (and every small channel) arrives in one
  fetch, while stubbed channels download lazily — the runtime realizes a
  channel on first access (runtime/datastore.py lazy realization) and
  resolves its stub through :meth:`_VirtualizedStorage.resolve_blob`
  with an LRU blob cache.

* **Summary upload management** (odspSummaryUploadManager.ts):
  content-addressed handle reuse — a channel whose bytes hash to a blob
  already uploaded by THIS client skips the transfer entirely (the
  server dedups by content anyway; the manager saves the wire cost) —
  plus bounded retry with exponential backoff on retryable driver
  errors.

Composes over ANY document service whose storage exposes
``create_blob``/``read_blob`` (local, network/alfred, durable) — like
the caching wrapper, production driver machinery stays OUTSIDE the
loader. Stack order: ``CachingDocumentService(VirtualizedDocumentService
(inner))`` gives odsp's full shape (cache + epoch + virtualization).
"""

from __future__ import annotations

import hashlib
import json
import time
from collections import OrderedDict
from typing import Any

from ..protocol.summary import is_handle
from .utils import DriverError

#: Marker key of a virtualized channel stub inside a snapshot tree.
VIRTUAL_KEY = "__virtualBlob__"


def make_stub(blob_id: str, size: int, channel_type: str = "") -> dict:
    # The channel TYPE rides in the stub so the runtime can decide
    # whether a lazy channel must realize for lifecycle events (e.g.
    # membership-sensitive consensus collections) without fetching it.
    return {VIRTUAL_KEY: {"id": blob_id, "size": size,
                          "type": channel_type}}


def is_virtual_stub(node: Any) -> bool:
    return isinstance(node, dict) and VIRTUAL_KEY in node


def _canonical(node: dict) -> bytes:
    return json.dumps(node, sort_keys=True,
                      separators=(",", ":")).encode()


def _with_retry(fn, attempts: int = 4, base_delay: float = 0.05):
    """runWithRetry analog (driver-utils): bounded exponential backoff on
    retryable driver errors; non-retryable ones surface immediately."""
    for attempt in range(attempts):
        try:
            return fn()
        except DriverError as err:
            if not getattr(err, "can_retry", False) \
                    or attempt == attempts - 1:
                raise
            time.sleep(base_delay * (2 ** attempt))


class _VirtualizedStorage:
    def __init__(self, service: "VirtualizedDocumentService") -> None:
        self._service = service

    # -- load side -------------------------------------------------------------

    def get_latest_snapshot(self) -> dict | None:
        """One fetch returns the tree + protocol + every small channel;
        stubbed channels stay stubs until resolve_blob."""
        return self._service.inner.storage.get_latest_snapshot()

    def resolve_blob(self, stub: dict) -> dict:
        """Materialize one virtualized channel snapshot (LRU-cached) —
        the lazy half of fetchSnapshot.ts's partial downloads."""
        service = self._service
        blob_id = stub[VIRTUAL_KEY]["id"]
        cached = service._blob_cache.get(blob_id)
        if cached is not None:
            service._blob_cache.move_to_end(blob_id)
            service.stats["blob_cache_hits"] += 1
            return json.loads(cached.decode())
        def fetch_verified() -> bytes:
            data = service.inner.storage.read_blob(blob_id)
            if hashlib.sha256(data).hexdigest() != blob_id:
                # Retryable INSIDE the backoff loop: a truncated or
                # corrupt transfer re-fetches before failing the caller.
                raise DriverError(
                    f"blob {blob_id} content hash mismatch",
                    can_retry=True)
            return data

        data = _with_retry(fetch_verified)
        service._remember(blob_id, data)
        # A verified fetch PROVES the server holds this exact content —
        # the upload manager can reuse the handle without re-sending
        # (a fresh client's first summary must not re-upload every
        # realized-but-unchanged channel).
        service._uploaded.add(blob_id)
        service.stats["blob_fetches"] += 1
        return json.loads(data.decode())

    # -- upload side (the summary upload manager) ------------------------------

    def upload_snapshot(self, snapshot: dict,
                        parent: str | None = None) -> str:
        service = self._service
        budget = service.inline_blob_bytes
        tree = dict(snapshot)
        runtime = dict(tree.get("runtime") or {})
        datastores = {}
        for ds_id, ds in (runtime.get("datastores") or {}).items():
            if is_handle(ds) or is_virtual_stub(ds):
                datastores[ds_id] = ds
                continue
            ds_out = dict(ds)
            channels = {}
            for ch_id, ch in (ds.get("channels") or {}).items():
                if is_handle(ch) or is_virtual_stub(ch):
                    # Incremental handle stubs (protocol/summary.py) and
                    # never-realized virtual stubs pass through — both
                    # already reference durable content.
                    channels[ch_id] = ch
                    continue
                body = _canonical(ch)
                if len(body) < budget:
                    channels[ch_id] = ch
                    continue
                blob_id = hashlib.sha256(body).hexdigest()
                if blob_id not in service._uploaded:
                    _with_retry(lambda b=blob_id, d=body:
                                service.inner.storage.create_blob(b, d))
                    service._uploaded.add(blob_id)
                    service._remember(blob_id, body)
                    service.stats["blobs_uploaded"] += 1
                    service.stats["bytes_uploaded"] += len(body)
                else:
                    service.stats["blobs_reused"] += 1
                    service.stats["bytes_saved"] += len(body)
                channels[ch_id] = make_stub(
                    blob_id, len(body),
                    (ch.get("attributes") or {}).get("type", ""))
            ds_out["channels"] = channels
            datastores[ds_id] = ds_out
        runtime["datastores"] = datastores
        tree["runtime"] = runtime
        return _with_retry(
            lambda: self._service.inner.storage.upload_snapshot(
                tree, parent))

    # -- passthrough blob API --------------------------------------------------

    def create_blob(self, blob_id: str, data: bytes) -> str:
        return self._service.inner.storage.create_blob(blob_id, data)

    def read_blob(self, blob_id: str) -> bytes:
        return self._service.inner.storage.read_blob(blob_id)


class VirtualizedDocumentService:
    """Snapshot-virtualizing wrapper around another document service."""

    def __init__(self, inner, inline_blob_bytes: int = 1024,
                 blob_cache_entries: int = 256) -> None:
        self.inner = inner
        self.inline_blob_bytes = inline_blob_bytes
        self._blob_cache_entries = max(8, blob_cache_entries)
        self._blob_cache: OrderedDict[str, bytes] = OrderedDict()
        # Content hashes this client knows are durable server-side — the
        # upload manager's handle-reuse set.
        self._uploaded: set[str] = set()
        self.storage = _VirtualizedStorage(self)
        self.stats = {"blobs_uploaded": 0, "blobs_reused": 0,
                      "bytes_uploaded": 0, "bytes_saved": 0,
                      "blob_fetches": 0, "blob_cache_hits": 0}

    def _remember(self, blob_id: str, data: bytes) -> None:
        self._blob_cache[blob_id] = data
        self._blob_cache.move_to_end(blob_id)
        while len(self._blob_cache) > self._blob_cache_entries:
            self._blob_cache.popitem(last=False)

    @property
    def delta_storage(self):
        return self.inner.delta_storage

    def connect(self, handler, on_nack=None, on_signal=None,
                mode: str = "write"):
        return self.inner.connect(handler, on_nack=on_nack,
                                  on_signal=on_signal, mode=mode)

    def close(self) -> None:
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()


__all__ = ["VirtualizedDocumentService", "is_virtual_stub", "make_stub",
           "VIRTUAL_KEY"]
