"""Caching driver — snapshot/delta caching with epoch coherence.

Reference parity: the odsp-driver's distinguishing machinery, rebuilt
over this framework's driver seam: a persistent snapshot/ops cache
(odspCache.ts, odspDocumentStorageManager.ts) fronted by an
**EpochTracker** (epochTracker.ts:25 — every storage response carries the
file's epoch; a mismatch means the file was restored/branched, so the
entire cache for that document is poisoned and must be flushed, and the
request fails retryably so the loader refetches fresh state).

``CachingDocumentService`` wraps ANY ``DocumentService`` (local, network,
replay, durable) — the point of the reference's driver abstraction is
exactly that such production concerns compose outside the loader.
"""

from __future__ import annotations

from typing import Any, Callable

from ..protocol.messages import SequencedDocumentMessage
from .utils import DriverError


class EpochMismatchError(DriverError):
    """The document's epoch changed under the cache (file restored or
    branched server-side) — caches were flushed; retry refetches."""

    def __init__(self, cached_epoch: Any, current_epoch: Any) -> None:
        super().__init__(
            f"epoch changed: cached {cached_epoch!r} != "
            f"current {current_epoch!r}", can_retry=True)


class _CachingSnapshotStorage:
    def __init__(self, service: "CachingDocumentService") -> None:
        self._service = service

    def get_latest_snapshot(self) -> dict | None:
        return self._service._get_snapshot()

    def upload_snapshot(self, snapshot: dict,
                        parent: str | None = None) -> str:
        handle = self._service.inner.storage.upload_snapshot(snapshot,
                                                             parent)
        # An upload is not the acked head until the service sequences the
        # summarize/ack (it may be nacked or lose a summary race), so only
        # invalidate — the next read fetches whatever the service honors.
        self._service._snapshot_cache = None
        return handle

    def resolve_blob(self, stub: dict) -> dict:
        """Pass virtualized-stub resolution through to a virtualizing
        inner storage (stubs only exist when one produced them)."""
        return self._service.inner.storage.resolve_blob(stub)


class _CachingDeltaStorage:
    def __init__(self, service: "CachingDocumentService") -> None:
        self._service = service

    def get_deltas(self, from_seq: int, to_seq: int | None = None
                   ) -> list[SequencedDocumentMessage]:
        return self._service._get_deltas(from_seq, to_seq)


class CachingDocumentService:
    """Epoch-validated caching wrapper around another document service."""

    def __init__(self, inner, epoch_source: Callable[[], Any] | None = None
                 ) -> None:
        self.inner = inner
        # odsp learns the epoch from join/fetch responses; here the source
        # is pluggable: a durable backend's generation counter, a
        # service-side value, or None (epoch checking disabled).
        self._epoch_source = (epoch_source if epoch_source is not None
                              else lambda: getattr(inner, "epoch", None))
        self._epoch: Any = self._epoch_source()
        self.storage = _CachingSnapshotStorage(self)
        self.delta_storage = _CachingDeltaStorage(self)
        self._snapshot_cache: dict | None = None
        # Contiguous delta log cache: ops with seq in
        # (_cache_base, _cached_thru]. The base seeds from the FIRST read
        # so a snapshot-anchored load never drags the full history in.
        self._delta_cache: list[SequencedDocumentMessage] = []
        self._cache_base: int | None = None
        self._cached_thru = 0
        self.stats = {"snapshot_hits": 0, "snapshot_fetches": 0,
                      "delta_hits": 0, "delta_fetches": 0,
                      "epoch_flushes": 0}

    # -- epoch coherence (epochTracker.ts validateEpochFromResponse) ----------

    def _validate_epoch(self) -> None:
        current = self._epoch_source()
        if current != self._epoch:
            cached = self._epoch
            self._epoch = current
            self.flush_cache()
            self.stats["epoch_flushes"] += 1
            raise EpochMismatchError(cached, current)

    def flush_cache(self) -> None:
        self._snapshot_cache = None
        self._delta_cache = []
        self._cache_base = None
        self._cached_thru = 0

    def _absorb(self, messages) -> None:
        """Extend the contiguous cache; the invariant lives ONLY here."""
        for message in messages:
            if message.sequence_number == self._cached_thru + 1:
                self._delta_cache.append(message)
                self._cached_thru = message.sequence_number

    # -- cached reads ----------------------------------------------------------

    def _get_snapshot(self) -> dict | None:
        self._validate_epoch()
        if self._snapshot_cache is not None:
            self.stats["snapshot_hits"] += 1
            return self._snapshot_cache
        self.stats["snapshot_fetches"] += 1
        snapshot = self.inner.storage.get_latest_snapshot()
        if snapshot is not None:
            self._snapshot_cache = snapshot
        return snapshot

    def _get_deltas(self, from_seq: int, to_seq: int | None
                    ) -> list[SequencedDocumentMessage]:
        self._validate_epoch()
        if self._cache_base is None:
            # Anchor the window at the first read's floor (a
            # snapshot-anchored load starts deep in the log).
            self._cache_base = from_seq
            self._cached_thru = from_seq
        if from_seq < self._cache_base:
            # Below the cached window — serve straight from the backend
            # rather than dragging the whole history into the cache.
            self.stats["delta_fetches"] += 1
            return self.inner.delta_storage.get_deltas(from_seq, to_seq)
        if to_seq is not None and to_seq <= self._cached_thru:
            self.stats["delta_hits"] += 1
        else:
            self.stats["delta_fetches"] += 1
            self._absorb(self.inner.delta_storage.get_deltas(
                self._cached_thru, to_seq))
        return [m for m in self._delta_cache
                if m.sequence_number > from_seq
                and (to_seq is None or m.sequence_number <= to_seq)]

    # -- live connection (pass-through; ops also warm the delta cache) --------

    def connect(self, handler, on_nack=None, on_signal=None,
                mode: str = "write"):
        def caching_handler(messages: list[SequencedDocumentMessage]) -> None:
            if self._cache_base is None and messages:
                self._cache_base = messages[0].sequence_number - 1
                self._cached_thru = self._cache_base
            self._absorb(messages)
            handler(messages)

        return self.inner.connect(caching_handler, on_nack=on_nack,
                                  on_signal=on_signal, mode=mode)

    def close(self) -> None:
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()
