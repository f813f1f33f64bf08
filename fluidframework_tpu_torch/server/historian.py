"""Historian — caching proxy in front of the snapshot store.

Reference parity: server/historian (a Redis-backed caching proxy exposing
gitrest's git REST API to drivers and scribe — historian/README.md:1-4).
Here the same role is an in-process read-through cache wrapped around any
snapshot backend with the four-method surface RouterliciousService uses
(upload / get / head / set_head — durable_store.GitSnapshotStore or the
in-memory store). Alfred's snapshot ops and scribe's validation reads go
through it, so repeat reads of hot summaries never touch the backing
object files.

Cache design (instead of the reference's external Redis):
  * content-addressed objects are IMMUTABLE — cached forever under an LRU
    bounded by object count and total bytes;
  * per-document heads are MUTABLE — cached write-through, so a single
    service's reads are coherent; a second historian over the same backend
    sees new heads once its TTL lapses (``head_ttl_s``), mirroring the
    reference's shared-Redis coherence window.
"""

from __future__ import annotations

import time
from collections import OrderedDict

from ..utils import MetricsRegistry


class Historian:
    """Read-through LRU over a snapshot store; same surface + get_object."""

    def __init__(self, backend, max_objects: int = 4096,
                 max_bytes: int = 64 * 1024 * 1024,
                 head_ttl_s: float = 1.0,
                 metrics: MetricsRegistry | None = None,
                 clock=time.monotonic) -> None:
        self._backend = backend
        self._max_objects = max_objects
        self._max_bytes = max_bytes
        self._head_ttl_s = head_ttl_s
        self._clock = clock
        self._metrics = metrics if metrics is not None else MetricsRegistry()
        self._objects: OrderedDict[str, bytes] = OrderedDict()
        self._bytes = 0
        # Bounded like the object cache: long-lived services touch many
        # short-lived documents and must not accumulate heads forever.
        self._max_heads = max(64, max_objects)
        self._heads: OrderedDict[str, tuple[str | None, float]] = \
            OrderedDict()

    # -- object cache ---------------------------------------------------------

    def _remember(self, sha: str, data: bytes) -> None:
        if sha in self._objects:
            self._objects.move_to_end(sha)
            return
        if len(data) > self._max_bytes:
            return  # larger than the whole budget: serve, don't cache
        self._objects[sha] = data
        self._bytes += len(data)
        while (len(self._objects) > self._max_objects
               or self._bytes > self._max_bytes):
            _, evicted = self._objects.popitem(last=False)
            self._bytes -= len(evicted)
            self._metrics.counter("historian.evictions").inc()

    def get_object(self, sha: str) -> bytes:
        cached = self._objects.get(sha)
        if cached is not None:
            self._objects.move_to_end(sha)
            self._metrics.counter("historian.object_hits").inc()
            return cached
        self._metrics.counter("historian.object_misses").inc()
        data = self._backend.get_object(sha)
        self._remember(sha, data)
        return data

    def put_object(self, data: bytes) -> str:
        sha = self._backend.put_object(data)
        self._remember(sha, data)
        return sha

    # -- snapshot surface (what the service binds to) -------------------------

    def upload(self, doc_id: str, snapshot: dict) -> str:
        # Write through OUR put_object when the backend supports injection,
        # so freshly-uploaded chunks serve hot (scribe validates the very
        # summary a client just uploaded).
        if hasattr(self._backend, "put_object"):
            return self._backend.upload(doc_id, snapshot,
                                        put_object=self.put_object)
        return self._backend.upload(doc_id, snapshot)

    def get(self, doc_id: str, handle: str | None) -> dict | None:
        if handle is None:
            return None
        # Reassemble through the object cache when the backend exposes
        # object plumbing (GitSnapshotStore) — the tree/chunk format is
        # parsed only by the backend; otherwise delegate whole.
        if hasattr(self._backend, "get_object"):
            return self._backend.get(doc_id, handle,
                                     read_object=self.get_object)
        return self._backend.get(doc_id, handle)

    def _cache_head(self, doc_id: str, value: str | None,
                    now: float) -> None:
        self._heads[doc_id] = (value, now)
        self._heads.move_to_end(doc_id)
        while len(self._heads) > self._max_heads:
            self._heads.popitem(last=False)

    def head(self, doc_id: str) -> str | None:
        entry = self._heads.get(doc_id)
        now = self._clock()
        if entry is not None and now - entry[1] < self._head_ttl_s:
            self._metrics.counter("historian.head_hits").inc()
            return entry[0]
        value = self._backend.head(doc_id)
        self._cache_head(doc_id, value, now)
        self._metrics.counter("historian.head_misses").inc()
        return value

    def set_head(self, doc_id: str, handle: str) -> None:
        self._backend.set_head(doc_id, handle)
        self._cache_head(doc_id, handle, self._clock())

    def invalidate_heads(self) -> int:
        """Drop every cached head — the failover hook: a leader
        promotion (server/replication.py) rolls journaled head flips
        straight onto the BACKEND, so any historian front still serving
        must not answer from pre-failover entries for up to a TTL.
        Object caches stay — content-addressed chunks are immutable.
        Returns the number of entries dropped."""
        dropped = len(self._heads)
        self._heads.clear()
        return dropped

    def release(self, doc_id: str, handle: str) -> list[str]:
        """GC pass-through (GitSnapshotStore refcounted release), with
        exactly the DELETED objects dropped from the cache — a deleted
        blob must not keep serving from memory as if alive (objects the
        backend kept — shared chunks — stay cached)."""
        release = getattr(self._backend, "release", None)
        if release is None:
            return []
        deleted = release(doc_id, handle)
        for sha in deleted:
            cached = self._objects.pop(sha, None)
            if cached is not None:
                self._bytes -= len(cached)
        return deleted

    # -- observability --------------------------------------------------------

    def stats(self) -> dict:
        snap = self._metrics.snapshot()
        return {
            "objects": len(self._objects),
            "bytes": self._bytes,
            "object_hits": snap.get("historian.object_hits", 0),
            "object_misses": snap.get("historian.object_misses", 0),
            "evictions": snap.get("historian.evictions", 0),
        }
