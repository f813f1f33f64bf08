"""Tiered hot/cold document residency — serve millions of REGISTERED
documents from a device pool sized for the HOT set.

Port of ``fluidframework_tpu/server/residency.py``: the bookkeeping is
the reference's line for line; the two places that touch the device go
through the merge host's row helpers — a hydration writes the map row
in place on the device (``KernelMergeHost.write_map_row``) and an
eviction reads it back with one gather and one copy
(``KernelMergeHost.read_map_rows``, counted in its ``map_row_reads``).

Reference parity: routerlicious never keeps every document in a lambda's
memory — cold documents exist only as gitrest content-addressed snapshots
plus their Mongo op-log tail (PAPER.md §2.6-§2.7), and the first
``connect_document`` against one loads it into a deli/scriptorium
partition on demand. Here the same tiering runs over the device pool:

* **hot** — the document holds a sequencer row (``KernelSequencerHost``)
  and a map row (``KernelMergeHost``) and serves at full device rate.
* **cold** — the document is ONE content-addressed snapshot in the
  shared :class:`~fluidframework_tpu_torch.server.durable_store.
  GitSnapshotStore` (its sequencer checkpoint + map-row planes + the
  compact per-doc tick index) keyed ``__cold__::<doc_id>``; its op
  history stays in the storm WAL. Zero bytes of host or device RAM.

The first frame (or connect) against a cold document **hydrates** it —
restore the snapshot into a recycled pool row — and documents idle past
the timeout **evict**: settle + durability barrier, upload the per-doc
snapshot, flip its head ref, then blank and recycle the rows
(``KernelSequencerHost.release_doc`` / ``KernelMergeHost.
release_map_row``). Registration is OPEN and store-resident: a doc id
that has never been served costs nothing anywhere but the namespace (the
reference's Mongo ``documents`` collection analog is the snapshot store's
ref files, on disk, not RAM) — which is exactly why steady-state RSS
scales with the hot set, not the registered population.

Safety invariants (chaos-proven, ``residency.mid_hydrate`` /
``residency.mid_evict`` crashpoints):

* **acked ⇒ durable survives eviction.** Eviction barriers on the WAL
  fsync watermark BEFORE uploading the snapshot and flips the head ref
  atomically; the rows are released only after the flip. A kill anywhere
  in between loses ONLY volatile device state — recovery replays the
  global snapshot + WAL and reconverges byte-identically.
* **hydration is restore-only.** Nothing durable moves, so a kill
  mid-hydrate is indistinguishable from never having hydrated.
* **quarantined documents are pinned resident.** Their device rows are
  the readmission evidence; an eviction would snapshot poisoned planes.
* **no eviction while the WAL is degraded.** The snapshot watermark
  cannot barrier on durability with the fsync breaker open.

Hydration storms are admission-gated by a :class:`~fluidframework_tpu_torch.
server.riddler.TokenBucket` with per-DOC claimable reservations: a
refused hydration reserves a future slot once (debited against the
bucket) and ANY client of that doc claims it by returning at/after the
hint — so a cold-doc stampede degrades to hydrations queued at exactly
the bucket's drain rate instead of an OOM or compounding debt.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np

from ..utils import CountedLRU, faults
from .merge_host import ChannelKey, _nd_pack, _nd_unpack

#: Format version stamped on every cold-doc snapshot. Readers accept
#: 0..CURRENT and refuse anything newer (a rolled-back binary must not
#: misparse a newer cold tier).
COLD_DOC_VERSION = 1

#: Snapshot-store key prefix for cold-doc heads (the GitSnapshotStore
#: hashes keys into ref paths, so any doc id is safe here).
COLD_KEY_PREFIX = "__cold__::"


class EvictionRefused(RuntimeError):
    """Eviction would violate a safety invariant: the doc is quarantined
    (its device rows are the readmission evidence), the WAL fsync breaker
    is open (the snapshot watermark cannot barrier on durability), or a
    replay is in flight."""


class ResidencyManager:
    """Hot/cold residency over one :class:`~fluidframework_tpu_torch.server.
    storm.StormController` stack. Attaches itself as
    ``storm.residency``; the controller consults it at frame admission
    (hydrate-or-nack), during WAL replay (hydrate-on-first-touch with
    watermark-exact filtering) and after recovery (cold-index trim)."""

    def __init__(self, storm, snapshots=None,
                 max_resident: int | None = None,
                 idle_evict_s: float = 300.0,
                 hydration_rate_per_s: float = 200.0,
                 hydration_burst: float | None = None,
                 cold_handle_cache: int = 4096,
                 host_label: str | None = None,
                 clock=time.monotonic) -> None:
        from .riddler import TokenBucket
        self.storm = storm
        # Cluster identity (parallel/placement.py): cold snapshots are
        # stamped with the host that wrote them, because their compact
        # tick index references THAT host's WAL — a doc hydrating on
        # another host (live migration over the shared store) must not
        # resolve foreign tick ids into its own WAL. None (single-host)
        # keeps the round-12 behavior bit-for-bit.
        self.host_label = host_label
        #: doc -> {origin host -> its tick index}: the migrated doc's
        #: pre-migration catch-up indexes, carried through subsequent
        #: evictions so every host keeps serving its own WAL segments.
        self.foreign_ticks: dict[str, dict[str, list]] = {}
        self.snapshots = (snapshots if snapshots is not None
                          else storm.snapshots)
        if self.snapshots is None:
            raise ValueError(
                "ResidencyManager needs a snapshot store — cold documents "
                "live there (pass snapshots= here or on the controller)")
        self.max_resident = max_resident
        self.idle_evict_s = idle_evict_s
        self._clock = clock
        # Hydration admission: one bucket for the host's hydration I/O
        # budget (snapshot read + row restore per hydration). reserve()
        # refusals ladder a stampede out at the drain rate; the per-doc
        # reservation below makes the refusal CLAIMABLE so retries never
        # re-debit (the AdmissionController.admit_connect pattern).
        self.hydrations = TokenBucket(hydration_rate_per_s,
                                      hydration_burst, clock=clock)
        self._reservations: dict[str, float] = {}  # doc -> claimable at
        #: doc -> last-touch clock. Python dicts are insertion-ordered and
        #: touch() re-inserts, so iteration order IS the LRU order.
        self.resident: dict[str, float] = {}
        metrics = storm.merge_host.metrics
        self._metrics = metrics
        # Cold-doc handle cache over the store's head refs: RAM stays
        # O(cache), the store stays the authority (restart-safe; a miss
        # is one ref-file read).
        self._cold_handles = CountedLRU(max(1, cold_handle_cache),
                                        registry=metrics,
                                        prefix="residency.handle_cache")
        self._known_cold = 0  # evictions minus cold re-hydrations, this life
        self.stats = {"hydrations": 0, "cold_hydrations": 0,
                      "evictions": 0, "hydration_nacks": 0,
                      "evict_refusals": 0, "replay_hydrations": 0}
        # Cold snapshots read during a recovery replay, cached so a doc
        # touched by many replayed ticks reads its snapshot once.
        self._replay_cache: dict[str, dict | None] = {}
        # evict() flushes, flush pumps the service, and the service's
        # idle pass drives evict_idle — the guard keeps that cycle from
        # re-entering the sweep mid-eviction.
        self._sweeping = False
        # Adopt rows already live on the hosts (docs served before the
        # manager attached).
        now = self._clock()
        for doc in storm.seq_host._rows:
            self.resident[doc] = now
        storm.residency = self
        self._update_gauges()

    # -- directory -------------------------------------------------------------

    @staticmethod
    def _cold_key(doc_id: str) -> str:
        return COLD_KEY_PREFIX + doc_id

    def is_resident(self, doc_id: str) -> bool:
        return doc_id in self.resident

    def cold_handle(self, doc_id: str) -> str | None:
        """Snapshot handle of the doc's cold head, or None when the doc
        has never been evicted (fresh registration / purely hot)."""
        cached = self._cold_handles.get(doc_id)
        if cached is not None:
            return cached or None  # "" caches a confirmed absence
        handle = self.snapshots.head(self._cold_key(doc_id))
        self._cold_handles.put(doc_id, handle or "")
        return handle

    def cold_doc_ticks(self, doc_id: str) -> list[tuple[int, int, int]]:
        """A COLD doc's compact catch-up index, read from its cold head
        WITHOUT hydrating — a gap fetch is a read and must not churn the
        pool. Empty for fresh registrations (no cold head). Tick ids
        resolve into THIS host's WAL only: a foreign-home snapshot (the
        doc migrated away and was re-evicted elsewhere) serves this
        host's segment from its ``foreign_ticks`` carry-through."""
        handle = self.cold_handle(doc_id)
        if not handle:
            return []
        snap = self.snapshots.get(self._cold_key(doc_id), handle)
        if snap is None:
            # The cached head was superseded by ANOTHER host's eviction
            # and its chunks GC'd (cluster re-home + re-evict): refresh
            # from the authoritative ref and retry once.
            handle = self.snapshots.head(self._cold_key(doc_id))
            self._cold_handles.put(doc_id, handle or "")
            snap = (self.snapshots.get(self._cold_key(doc_id), handle)
                    if handle else None)
            if snap is None:
                return []
        home = snap.get("home")
        if home is not None and home != self.host_label:
            return [tuple(t) for t in snap.get(
                "foreign_ticks", {}).get(self.host_label or "", ())]
        return [tuple(t) for t in snap.get("doc_ticks", ())]

    def adopt_cold(self, doc_id: str, handle: str) -> None:
        """Register an externally-written cold head (the history
        plane's branch-fork seed writes the cold record itself): cache
        the handle and count the doc cold — the first connect/frame
        hydrates it through the normal admission-gated path."""
        assert doc_id not in self.resident, doc_id
        self._cold_handles.put(doc_id, handle)
        self._known_cold += 1
        self._update_gauges()

    def touch(self, doc_id: str, now: float | None = None) -> None:
        """Refresh a resident doc's idle clock (re-insert = LRU order)."""
        self.resident.pop(doc_id, None)
        self.resident[doc_id] = self._clock() if now is None else now

    # -- frame admission (the storm._admit seam) -------------------------------

    def admit_docs(self, docs: list[str]
                   ) -> tuple[float | None, str | None]:
        """Residency gate for one validated frame's doc set: touch the
        resident docs and synchronously hydrate the cold ones. Returns
        ``(None, None)`` once every doc is resident, else
        ``(retry_after_s, code)`` for the busy-nack — ``"hydrating"``
        when the token bucket laddered the stampede out, ``"busy"`` when
        the pool has no evictable slot."""
        now = self._clock()
        cold = [d for d in docs if d not in self.resident]
        if not cold:
            for d in docs:
                self.touch(d, now)
            return None, None
        # Token gate first (cheap), one token per cold doc; capacity
        # (which may pay an eviction) only for admitted frames.
        spent = 0
        worst: float | None = None
        for doc in cold:
            retry = self._gate_hydration(doc, now)
            if retry is None:
                spent += 1
            elif worst is None or retry > worst:
                worst = retry
        if worst is not None:
            # Whole-frame refusal: refund the tokens freshly spent in
            # this call (claimed/ladder reservations stand — they are the
            # stampede spreading mechanism).
            if spent:
                self.hydrations.refund("hydrate", spent)
            self.stats["hydration_nacks"] += 1
            return worst, "hydrating"
        retry = self._free_slots(len(cold), exclude=set(docs))
        if retry is not None:
            if spent:
                self.hydrations.refund("hydrate", spent)
            return retry, "busy"
        for doc in cold:
            self.hydrate(doc)
        for d in docs:
            self.touch(d, now)
        return None, None

    def ensure_resident(self, doc_id: str, gate: bool = True
                        ) -> float | None:
        """Connect-path residency: hydrate a cold doc (admission-gated
        unless ``gate=False`` — in-process callers), returning the
        ``retry_after_s`` hint on refusal and None once resident."""
        if doc_id in self.resident:
            self.touch(doc_id)
            return None
        now = self._clock()
        if gate:
            retry = self._gate_hydration(doc_id, now)
            if retry is not None:
                self.stats["hydration_nacks"] += 1
                return retry
        retry = self._free_slots(1, exclude={doc_id})
        if retry is not None:
            if gate:
                self.hydrations.refund("hydrate")
            return retry
        self.hydrate(doc_id)
        return None

    def _gate_hydration(self, doc: str, now: float) -> float | None:
        """One doc through the hydration bucket with a CLAIMABLE per-doc
        reservation: the refusal debits the bucket once; any client of
        the doc claims that slot by returning at/after the hint."""
        at = self._reservations.get(doc)
        if at is not None:
            wait = at - now
            if wait > 1e-9:
                return wait  # came back early; the same slot stands
            del self._reservations[doc]
            self._metrics.gauge("residency.hydrating_docs").set(
                len(self._reservations))
            return None  # claiming the already-debited slot
        if len(self._reservations) > 4096:
            # Docs whose clients never came back leave unclaimed entries;
            # sweep the long-expired ones (the bounded-memory rule).
            from .riddler import TokenBucket
            horizon = now - TokenBucket.RESERVE_HORIZON_S
            for key in [d for d, t in self._reservations.items()
                        if t < horizon]:
                del self._reservations[key]
        retry, reserved = self.hydrations.reserve("hydrate")
        if retry is not None and reserved:
            self._reservations[doc] = now + retry
            self._metrics.gauge("residency.hydrating_docs").set(
                len(self._reservations))
        return retry

    def _free_slots(self, need: int, exclude: set[str]) -> float | None:
        """Make room for ``need`` hydrations, evicting LRU residents if
        the pool is capped. Returns a retry hint when no evictable slot
        exists (every resident is quarantined/excluded/refusing)."""
        if self.max_resident is None:
            return None
        while len(self.resident) + need > self.max_resident:
            victim = None
            for doc in self.resident:  # LRU order
                if doc in exclude or doc in self.storm.quarantined:
                    continue
                victim = doc
                break
            if victim is None:
                return self.storm.busy_retry_s
            try:
                self.evict(victim, reason="capacity")
            except EvictionRefused:
                return self.storm.busy_retry_s
        return None

    # -- hydration -------------------------------------------------------------

    def hydrate(self, doc_id: str) -> bool:
        """Load a cold doc into the device pool (restore-only: nothing
        durable moves, so a kill mid-hydrate loses nothing). Returns True
        when a cold snapshot was restored, False for a fresh registration
        (rows lazy-allocate on the doc's first tick)."""
        assert doc_id not in self.resident, doc_id
        t0 = time.perf_counter()
        # Authoritative head read, NOT the cached handle: in a cluster
        # another host may have flipped this doc's cold head since we
        # cached ours (live migration re-homes + re-evictions), and the
        # superseded snapshot may already be GC'd — hydrating from a
        # stale handle would silently restore nothing. One ref-file
        # read on the already-expensive hydration path.
        handle = self.snapshots.head(self._cold_key(doc_id))
        self._cold_handles.put(doc_id, handle or "")
        snap = (self.snapshots.get(self._cold_key(doc_id), handle)
                if handle else None)
        restored = False
        if snap is not None:
            self._restore(doc_id, snap)
            restored = True
            self.stats["cold_hydrations"] += 1
            self._known_cold = max(0, self._known_cold - 1)
        else:
            faults.crashpoint("residency.mid_hydrate")
        self.resident[doc_id] = self._clock()
        self.stats["hydrations"] += 1
        self._metrics.counter("residency.hydrations").inc()
        self._metrics.histogram("residency.hydrate_s").observe(
            time.perf_counter() - t0)
        self._update_gauges()
        return restored

    def _restore(self, doc_id: str, snap: dict) -> None:
        """Install one cold snapshot into recycled pool rows."""
        version = snap.get("format_version", 0)
        if not 0 <= version <= COLD_DOC_VERSION:
            raise ValueError(
                f"cold-doc snapshot format v{version} is newer than this "
                f"reader (max v{COLD_DOC_VERSION})")
        storm = self.storm
        from .sequencer import SequencerCheckpoint
        storm.seq_host.restore(doc_id,
                               SequencerCheckpoint(**snap["sequencer"]))
        # Chaos kill class "mid-hydrate": the sequencer row is restored,
        # the map row is NOT — the half-hydrated doc is volatile only and
        # recovery re-hydrates from the same durable snapshot.
        faults.crashpoint("residency.mid_hydrate")
        m = snap.get("map_row")
        if m is not None:
            mrow = storm._storm_mrow(doc_id)
            s_live = storm.merge_host._map_slots
            vals = {"present": np.zeros(s_live, np.bool_),
                    "value": np.zeros(s_live, np.int32),
                    "vseq": np.full(s_live, -1, np.int32)}
            for f in ("present", "value", "vseq"):
                plane = _nd_unpack(m[f])
                assert plane.shape[0] <= s_live, (
                    f"cold map row wider than live "
                    f"({plane.shape[0]} > {s_live})")
                vals[f][:plane.shape[0]] = plane
            storm.merge_host.write_map_row(
                mrow.row, vals["present"], vals["value"], vals["vseq"],
                m["cleared_seq"])
            mrow.last_seq = m["last_seq"]
        # The compact catch-up index travels with the doc. During
        # recovery the __init__ blob scan already rebuilt a COMPLETE
        # index (it covers post-snapshot ticks too) — never overwrite it
        # with the snapshot's shorter one. A FOREIGN-home snapshot (live
        # migration over the shared store) must not adopt at all: its
        # tick ids reference the origin host's WAL, and adopting them
        # here would resolve catch-up reads into the wrong blobs — the
        # origin index is carried as foreign_ticks instead, so every
        # host keeps serving its own WAL segments.
        home = snap.get("home")
        if home is not None and home != self.host_label:
            carried = dict(snap.get("foreign_ticks", {}))
            if snap.get("doc_ticks"):
                carried[home] = [list(t) for t in snap["doc_ticks"]]
            # A doc migrating BACK to a prior home re-adopts that
            # home's own segment into the live index (its tick ids
            # resolve HERE; the next local eviction then exports a
            # complete local doc_ticks again) — leaving it only in
            # foreign_ticks would drop this host's pre-migration
            # segment from every later catch-up read.
            own = (carried.pop(self.host_label, None)
                   if self.host_label is not None else None)
            if own and doc_id not in storm._doc_ticks:
                storm._doc_ticks[doc_id] = [tuple(t) for t in own]
            if carried:
                self.foreign_ticks[doc_id] = carried
        else:
            if snap.get("doc_ticks") and doc_id not in storm._doc_ticks:
                storm._doc_ticks[doc_id] = [tuple(t)
                                            for t in snap["doc_ticks"]]
            if snap.get("foreign_ticks"):
                self.foreign_ticks[doc_id] = dict(snap["foreign_ticks"])
        if doc_id not in storm.doc_tick_counts:
            storm.doc_tick_counts[doc_id] = snap.get("tick_count", 0)

    # -- eviction --------------------------------------------------------------

    def evict(self, doc_id: str, reason: str = "idle") -> str:
        """Demote one resident doc to the cold tier: settle + durability
        barrier, upload its snapshot, flip the head ref atomically, THEN
        release the device rows and trim the per-doc bookkeeping. Raises
        :class:`EvictionRefused` when the invariants forbid it. Returns
        the cold snapshot handle."""
        storm = self.storm
        if doc_id not in self.resident:
            raise KeyError(f"{doc_id!r} is not resident")
        if doc_id in storm.quarantined:
            self.stats["evict_refusals"] += 1
            raise EvictionRefused(
                f"{doc_id!r} is quarantined — its device rows are the "
                "readmission evidence; readmit before evicting")
        megadoc = getattr(storm, "megadoc", None)
        if megadoc is not None and (megadoc.is_promoted(doc_id)
                                    or megadoc.parent_of(doc_id)):
            # A promoted doc's live state spans lane rows + the combiner
            # mirror; the per-doc cold record would capture only the
            # frozen baseline row. Mega docs are pinned resident.
            self.stats["evict_refusals"] += 1
            raise EvictionRefused(
                f"{doc_id!r} is mega-promoted (write scale-out); demote "
                "before evicting")
        if storm._replay:
            self.stats["evict_refusals"] += 1
            raise EvictionRefused("eviction during WAL replay")
        if storm._in_round:
            # The pump inside _flush_round reached an idle pass: the
            # cohort being assembled may include this doc — refuse; the
            # next top-level sweep evicts it.
            self.stats["evict_refusals"] += 1
            raise EvictionRefused("eviction during a serving round")
        if storm.wal_degraded:
            self.stats["evict_refusals"] += 1
            raise EvictionRefused(
                "WAL fsync breaker open: the cold snapshot's watermark "
                "cannot barrier on durability")
        if getattr(storm, "replication", None) is not None \
                and storm.replication.fenced:
            # A demoted ex-leader flipping a cold head would clobber the
            # promoted incarnation's record — fenced hosts never write
            # shared-store heads.
            self.stats["evict_refusals"] += 1
            raise EvictionRefused(
                "eviction on a fenced (demoted) leader: cold-head flips "
                "belong to the promoted incarnation")
        t0 = time.perf_counter()
        # Settle everything: bus-path ops (client joins/leaves, per-op
        # submits) sequence first — a doc whose JOIN is still buffered
        # has no device row yet — then the storm frames serve or shed,
        # and the durability watermark pins past every harvested tick
        # (the snapshot must never claim state the WAL could still
        # lose). The sweep guard blocks the pump's idle pass from
        # re-entering eviction under us.
        prev_sweeping, self._sweeping = self._sweeping, True
        try:
            storm.service.pump()
            storm.flush()
        finally:
            self._sweeping = prev_sweeping
        if doc_id not in storm.seq_host._rows:
            # Registered/connected but never served one op: nothing on
            # device to demote, nothing new to make durable. Drop the
            # residency entry; any existing cold head stays authoritative.
            self.resident.pop(doc_id)
            self.stats["evictions"] += 1
            self._update_gauges()
            return self.cold_handle(doc_id) or ""
        if storm._group_wal is not None:
            from .durable_store import WalDegradedError
            try:
                storm._group_wal.sync()
            except WalDegradedError as err:
                self.stats["evict_refusals"] += 1
                raise EvictionRefused(
                    "WAL degraded during the eviction barrier") from err
        if doc_id in storm.quarantined:
            # The settle flush itself tripped the sentinel: the poisoned
            # row must never become the cold rebuild source.
            self.stats["evict_refusals"] += 1
            raise EvictionRefused(
                f"{doc_id!r} quarantined during the eviction flush")
        snap = self._export(doc_id)
        key = self._cold_key(doc_id)
        superseded = self.cold_handle(doc_id)
        handle = self.snapshots.upload(key, snap)
        # Chaos kill class "mid-evict": snapshot uploaded, head ref NOT
        # yet flipped, rows still live — recovery sees the doc resident
        # (global snapshot + WAL) and the orphan upload is harmless.
        faults.crashpoint("residency.mid_evict")
        self.snapshots.set_head(key, handle)
        if superseded and superseded != handle:
            # Cold-store GC: the old head's unreferenced blobs delete on
            # the flip (content-addressed refcounts — chunks another
            # doc's snapshot shares survive). A churned cold doc's disk
            # cost stays ONE snapshot, not one per eviction. Kill-window
            # safety: the release runs after the flip, so a crash in
            # between leaks at most one superseded snapshot.
            release = getattr(self.snapshots, "release", None)
            if release is not None:
                try:
                    release(key, superseded)
                except Exception:
                    pass  # GC is best-effort; serving state is already safe
        # Kill window between the flip and the release: the doc is
        # durable BOTH ways (cold head == live state), so either recovery
        # choice reconverges byte-identically.
        faults.crashpoint("residency.post_evict")
        storm.seq_host.release_doc(doc_id)
        ckey = ChannelKey(doc_id, storm.datastore, storm.channel)
        if ckey in storm.merge_host._map_rows:
            storm.merge_host.release_map_row(ckey)
        # Per-doc bookkeeping rides the snapshot, not RAM (the O(hot)
        # bound): the tick index and telemetry count restore on hydrate.
        storm._doc_ticks.pop(doc_id, None)
        storm.doc_tick_counts.pop(doc_id, None)
        self.foreign_ticks.pop(doc_id, None)  # exported above
        self.resident.pop(doc_id)
        self._cold_handles.put(doc_id, handle)
        self._known_cold += 1
        self.stats["evictions"] += 1
        self._metrics.counter("residency.evictions").inc()
        self._metrics.histogram("residency.evict_s").observe(
            time.perf_counter() - t0)
        self._update_gauges()
        return handle

    def evict_idle(self, now: float | None = None,
                   max_evictions: int | None = None) -> list[str]:
        """Evict every resident doc idle past ``idle_evict_s`` (the
        deli-checkIdleClients analog at DOC granularity — the service's
        idle-ejection pass drives this). Quarantined docs are skipped
        (pinned resident); refusals leave the doc resident."""
        if self._sweeping:
            return []  # re-entered through evict → flush → pump
        now = self._clock() if now is None else now
        evicted: list[str] = []
        self._sweeping = True
        try:
            for doc, last in list(self.resident.items()):
                if now - last < self.idle_evict_s:
                    break  # LRU order: everything after is fresher
                if doc in self.storm.quarantined:
                    continue
                try:
                    self.evict(doc, reason="idle")
                except EvictionRefused:
                    continue
                evicted.append(doc)
                if max_evictions is not None \
                        and len(evicted) >= max_evictions:
                    break
        finally:
            self._sweeping = False
        return evicted

    def _export(self, doc_id: str) -> dict:
        storm = self.storm
        snap: dict[str, Any] = {
            "kind": "cold-doc",
            "format_version": COLD_DOC_VERSION,
            "doc": doc_id,
            # Every tick BELOW the watermark is reflected in this
            # snapshot; hydration during recovery drops the doc's
            # replayed entries below it (watermark-exact, no double
            # apply, no reliance on dedup).
            "tick_watermark": storm._tick_counter,
            "sequencer": dataclasses.asdict(
                storm.seq_host.checkpoint(doc_id)),
            "map_row": None,
            "doc_ticks": [list(t)
                          for t in storm._doc_ticks.get(doc_id, ())],
            "tick_count": storm.doc_tick_counts.get(doc_id, 0),
        }
        if self.host_label is not None:
            snap["home"] = self.host_label
            if doc_id in self.foreign_ticks:
                snap["foreign_ticks"] = self.foreign_ticks[doc_id]
        ckey = ChannelKey(doc_id, storm.datastore, storm.channel)
        mrow = storm.merge_host._map_rows.get(ckey)
        if mrow is not None:
            planes = storm.merge_host.read_map_rows([mrow.row])
            snap["map_row"] = {
                "present": _nd_pack(planes["present"][0]),
                "value": _nd_pack(planes["value"][0]),
                "vseq": _nd_pack(planes["vseq"][0]),
                "cleared_seq": int(planes["cleared_seq"][0]),
                "last_seq": mrow.last_seq,
            }
        return snap

    # -- recovery (storm.recover / _replay_wal seams) --------------------------

    def adopt_resident(self) -> None:
        """Mark every doc the global snapshot restored as resident
        (called by recover() between the restore and the WAL replay)."""
        now = self._clock()
        for doc in self.storm.seq_host._rows:
            self.resident.setdefault(doc, now)
        self._update_gauges()

    def prepare_replay(self, entries: list, tick: int) -> list:
        """Residency-aware WAL replay filter for one tick's doc entries:
        resident docs replay as-is; a cold doc hydrates ON FIRST TOUCH
        from its cold head — and its entries for ticks BELOW the cold
        snapshot's watermark are dropped (the snapshot already reflects
        them, watermark-exact). Fresh docs (no cold head) replay into
        lazily-allocated rows exactly like live traffic. The pool cap is
        ignored during replay (recovery must not write new cold
        snapshots mid-replay); idle eviction re-tiers afterwards."""
        out = []
        now = self._clock()
        for entry in entries:
            doc = entry[0]
            if doc in self.resident:
                out.append(entry)
                continue
            if doc in self._replay_cache:
                snap = self._replay_cache[doc]
            else:
                handle = self.cold_handle(doc)
                snap = (self.snapshots.get(self._cold_key(doc), handle)
                        if handle else None)
                self._replay_cache[doc] = snap
            if snap is None:
                self.resident[doc] = now  # fresh doc: adopt, rows lazy
                out.append(entry)
                continue
            home = snap.get("home")
            if (home is None or home == self.host_label) \
                    and tick < snap.get("tick_watermark", 0):
                continue  # already inside the cold snapshot
            # A FOREIGN-home snapshot's watermark counts the ORIGIN
            # host's ticks — it never filters local entries (every
            # local entry for a migrated-in doc post-dates the
            # hydration by construction).
            self._restore(doc, snap)
            self.resident[doc] = now
            self.stats["replay_hydrations"] += 1
            out.append(entry)
        return out

    def after_recover(self) -> None:
        """Post-recovery trim: docs whose ticks the __init__ blob scan
        indexed but which are COLD (head present, not restored, not
        touched by the replayed tail) drop their in-RAM index — it lives
        in their cold snapshot and restores on hydrate. Keeps a restarted
        host's RAM O(hot), not O(ever-served)."""
        storm = self.storm
        self._replay_cache.clear()
        self.adopt_resident()
        for doc in list(storm._doc_ticks):
            if doc in self.resident:
                continue
            if self.cold_handle(doc):
                storm._doc_ticks.pop(doc, None)
                storm.doc_tick_counts.pop(doc, None)
        self._update_gauges()

    # -- observability ---------------------------------------------------------

    def _update_gauges(self) -> None:
        self._metrics.gauge("residency.hot_docs").set(len(self.resident))
        self._metrics.gauge("residency.known_cold_docs").set(
            self._known_cold)
        # "Hydrating" = cold docs holding a claimable reservation (their
        # clients were laddered out and will return at the hint).
        self._metrics.gauge("residency.hydrating_docs").set(
            len(self._reservations))
        rss = _rss_mb()
        if rss is not None:
            self._metrics.gauge("residency.rss_mb").set(rss)


def _rss_mb() -> float | None:
    """Current (not peak) resident set size in MiB; None off-Linux."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        import os
        return pages * os.sysconf("SC_PAGE_SIZE") / (1024 * 1024)
    except (OSError, ValueError, IndexError):
        return None


__all__ = ["ResidencyManager", "EvictionRefused", "COLD_DOC_VERSION"]
