"""Elastic multi-host serving — live doc migration + load-based
placement (the round-16 tentpole; ROADMAP item "Elastic multi-host
serving", the reference's Kafka-partition rebalance analog,
PAPER §2.9 ``IPartitionLambdaFactory``).

Port of ``fluidframework_tpu/parallel/placement.py``: host Python, line
for line, but :func:`make_cluster_host` takes ``device`` (the card
unless the caller asks for the CPU) and builds its sequencer and merge
hosts there.

The single-host story is complete (fast, durable, bounded, observable)
but doc→host placement was static: ``parallel/serving.py`` pinned docs
by crc32 with offline checkpoint/kill/rebalance, so one hot host capped
the fleet and a new host served nothing. This module makes placement
LIVE:

* **migration** — moving one doc is the residency machinery pointed
  across hosts: quarantine-freeze at the source front door (frames shed
  ``"migrating"`` with ``retry_after_s``), evict-to-cold (the PR 12
  cold record: snapshot + WAL-tail semantics carried through the SHARED
  content-addressed store), hydrate on the target, then the directory
  flip — after which the source sheds ``"moved"`` nacks carrying a
  ``moved_to`` hint and clients redial through the PR 8
  reconnect/backoff path. Zero acked-durable ops lost: acked ⇒ inside
  the eviction barrier ⇒ inside the cold record; unacked frames resend
  and the sequencer's cseq dedup absorbs overlap. Blackout is bounded
  to the evict+hydrate window (measured per migration).
* **durable intent** — the directory lives in the shared snapshot store
  (``__placement__`` head): a migration writes a MIGRATING intent
  before touching state and flips to the new owner last, so a crash at
  any phase recovers by ROLLING THE MIGRATION FORWARD deterministically
  (:meth:`StormCluster.recover`). Chaos kill points bracket the three
  phases: ``placement.pre_evict`` / ``placement.post_evict`` (cold, no
  owner serving) / ``placement.post_hydrate`` (serving on the target,
  redirect not yet published).
* **load-based placement** — :class:`PlacementController` consumes each
  host's stage-ledger tick cost and queue depth
  (:meth:`StormCluster.load_signals`) and plans migrations: drain a hot
  host, converge a 2→4 host scale-out (new hosts receive docs only via
  migration — the genesis hash never silently re-routes), bounded moves
  per round.
* **viewer re-home** — migrating a doc drops its source viewer room
  through the PR 13 ``viewer_resync`` dance with the new owner in the
  directive (``moved_to``): viewers catch up via the cold-read
  ``get_deltas`` path (served from the shared cold head without
  hydrating) and resume on the target.

History stays host-local: each host's WAL keeps its own segment of a
migrated doc's history, the cold snapshot is stamped with its ``home``
host, and origin indexes ride ``foreign_ticks`` so every host keeps
serving exactly the ticks its WAL holds (:meth:`StormCluster.
get_deltas` is the cross-host merged read).

The same :class:`PlacementController` drives the device-lane tier:
:class:`~.serving.ShardResidency` exposes the identical backend surface
(``hosts``/``owned``/``load_signals``/``migrate``), where a host is a
device-row range of one mesh-sharded assembly and migration moves the
cold record between row pools.
"""

from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple

from ..utils import faults

#: Chaos kill classes bracketing the three migration phases (see
#: tools/chaos.py MIGRATION_KILL_POINTS): intent durable but source
#: still serving / doc cold with no owner serving / target hydrated but
#: the redirect not yet published. Recovery rolls the migration forward
#: from the durable intent and must reconverge byte-identically with
#: zero acked-durable ops lost.
MIGRATION_KILL_POINTS = ("placement.pre_evict", "placement.post_evict",
                         "placement.post_hydrate")


class MigrationResult(NamedTuple):
    doc: str
    src: Any
    dst: Any
    blackout_s: float


class PlacementController:
    """Load-driven placement over a duck-typed cluster backend
    (:class:`StormCluster` or :class:`~.serving.ShardResidency`):

    * ``backend.hosts_list() -> list[host]`` — active hosts;
    * ``backend.owned(host) -> list[doc]`` — docs the host owns,
      cheapest-to-move first;
    * ``backend.load_signals(host) -> {"docs", "queue_depth",
      "tick_cost_ms"}`` — the stage-ledger cost + queue-depth inputs;
    * ``backend.migrate(doc, host)`` — one live migration.

    A host's SCORE is its owned-doc count weighted by its observed
    per-tick cost relative to the cluster mean (a host whose ticks run
    hot sheds docs first) plus its queue depth — so the plan drains
    load, not just doc counts. Planning is deterministic in the
    signals: the same loads produce the same moves on every host."""

    def __init__(self, backend, max_moves_per_round: int = 8,
                 tolerance: int = 1) -> None:
        self.backend = backend
        self.max_moves_per_round = max(1, max_moves_per_round)
        self.tolerance = max(0, tolerance)
        self.moves: list[MigrationResult] = []

    # -- signals ---------------------------------------------------------------

    def _signals(self) -> dict[Any, dict]:
        sigs = {}
        for host in self.backend.hosts_list():
            sig = dict(self.backend.load_signals(host))
            sig.setdefault("tick_cost_ms", 0.0)
            sig.setdefault("queue_depth", 0)
            sigs[host] = sig
        costs = [s["tick_cost_ms"] for s in sigs.values()
                 if s["tick_cost_ms"] > 0]
        ref = (sum(costs) / len(costs)) if costs else 0.0
        for sig in sigs.values():
            weight = (sig["tick_cost_ms"] / ref
                      if ref > 0 and sig["tick_cost_ms"] > 0 else 1.0)
            sig["score"] = sig["docs"] * weight + sig["queue_depth"]
        return sigs

    def signals(self) -> dict[Any, dict]:
        """Per-host load signals + the derived score (observability)."""
        return self._signals()

    # -- planning --------------------------------------------------------------

    #: Docs examined per donor pick when tenant-aware (bounded scan
    #: keeps plan() O(moves × scan), not O(moves × owned)).
    TENANT_SCAN = 8

    def plan(self, max_moves: int | None = None) -> list[tuple]:
        """One round's migration plan ``[(doc, src, dst), ...]``: move
        docs from the highest-scored host to the lowest until the
        owned-doc spread is within ``tolerance`` or the move budget is
        spent. With a tenant-aware backend (``doc_tenant`` +
        ``tenant_load`` signals) the donor sheds its HOTTEST tenant's
        docs first and count-tied receivers prefer the host where that
        tenant is lightest — a hot tenant SPREADS across hosts instead
        of saturating its weighted share on one. Pure — no state
        changes."""
        budget = max_moves if max_moves is not None \
            else self.max_moves_per_round
        sigs = self._signals()
        if len(sigs) < 2:
            return []
        docs = {h: list(self.backend.owned(h)) for h in sigs}
        doc_tenant = getattr(self.backend, "doc_tenant", None)
        plan: list[tuple] = []
        for _ in range(budget):
            counts = {h: len(docs[h]) for h in sigs}
            # Receiver by COUNT (convergence is the count-spread bound;
            # a low observed tick cost must not turn a full host into a
            # sink), then by score as the tie-break. The cost score
            # picks WHICH over-count host drains first — that is where
            # "one hot host caps the fleet" bites — and must never
            # stall convergence by nominating a host with nothing to
            # give (ledger noise, e.g. compile ticks, would).
            cold = min(sigs, key=lambda h: (counts[h], sigs[h]["score"],
                                            str(h)))
            donors = [h for h in sigs
                      if docs[h]
                      and counts[h] - counts[cold] > self.tolerance]
            if not donors:
                break
            hot = max(donors, key=lambda h: (sigs[h]["score"],
                                             counts[h], str(h)))
            doc = docs[hot][0]  # cheapest-to-move first
            tenant = None
            if doc_tenant is not None:
                # Shed the donor's hottest tenant first: among the
                # cheapest few movable docs, the one whose tenant holds
                # the biggest slice of this host's load (index order
                # breaks ties, preserving cheapest-first).
                hot_load = sigs[hot].get("tenant_load", {})
                best = -1
                for cand in docs[hot][:self.TENANT_SCAN]:
                    t = doc_tenant(hot, cand)
                    load = hot_load.get(t, 0) if t is not None else 0
                    if load > best:
                        best, doc, tenant = load, cand, t
                if tenant is not None:
                    # Count-tied receivers: the host where this tenant
                    # is LIGHTEST takes the doc (spread, not pile-up).
                    ties = [h for h in sigs if h != hot
                            and counts[h] == counts[cold]]
                    if ties:
                        cold = min(ties, key=lambda h: (
                            sigs[h].get("tenant_load", {}).get(tenant,
                                                               0),
                            sigs[h]["score"], str(h)))
            docs[hot].remove(doc)
            docs[cold].append(doc)
            # The per-doc weight moves with the doc (score tracks docs).
            per_doc = sigs[hot]["score"] / max(1, counts[hot])
            sigs[hot]["score"] -= per_doc
            sigs[cold]["score"] += per_doc
            if tenant is not None:
                hl = sigs[hot].setdefault("tenant_load", {})
                hl[tenant] = max(0, hl.get(tenant, 0) - 1)
                cl = sigs[cold].setdefault("tenant_load", {})
                cl[tenant] = cl.get(tenant, 0) + 1
            plan.append((doc, hot, cold))
        return plan

    def _execute(self, plan: list[tuple]) -> list[MigrationResult]:
        results = []
        for doc, src, dst in plan:
            t0 = time.perf_counter()
            self.backend.migrate(doc, dst)
            results.append(MigrationResult(
                doc, src, dst, time.perf_counter() - t0))
        self.moves.extend(results)
        return results

    def rebalance(self, max_rounds: int = 64) -> dict:
        """Plan + migrate until the owned-doc spread converges (the
        2→4 scale-out driver). Returns the convergence report."""
        t0 = time.perf_counter()
        moves: list[MigrationResult] = []
        rounds = 0
        for _ in range(max_rounds):
            plan = self.plan()
            if not plan:
                break
            rounds += 1
            moves.extend(self._execute(plan))
        counts = {h: len(self.backend.owned(h))
                  for h in self.backend.hosts_list()}
        spread = (max(counts.values()) - min(counts.values())
                  if counts else 0)
        return {
            "rounds": rounds,
            "moves": len(moves),
            "converged": spread <= self.tolerance,
            "doc_spread": spread,
            "docs_per_host": counts,
            "elapsed_s": round(time.perf_counter() - t0, 4),
            "blackout_s": [round(m.blackout_s, 6) for m in moves],
        }

    def drain(self, host) -> dict:
        """Move EVERY doc off one host (maintenance / scale-in). With a
        batch-capable backend (``migrate_batch``) the whole range moves
        in ONE durable directory intent write + ONE completion write —
        not per-doc intents; otherwise each doc goes to the currently
        least-loaded other host one migration at a time."""
        t0 = time.perf_counter()
        others = [h for h in self.backend.hosts_list()
                  if h != host]
        if not others:
            raise ValueError("cannot drain the only active host")
        batch = getattr(self.backend, "migrate_batch", None)
        if batch is not None:
            sigs = self._signals()
            counts = {h: sigs[h]["docs"] for h in others}
            moves: list[tuple] = []
            for doc in list(self.backend.owned(host)):
                dst = min(others, key=lambda h: (counts[h],
                                                 sigs[h]["score"],
                                                 str(h)))
                counts[dst] += 1
                moves.append((doc, dst))
            report = batch(moves)
            self.moves.extend(
                MigrationResult(doc, host, dst, report["blackout_s"])
                for doc, dst in moves
                if doc not in {d for d, _e in report["aborted"]})
            return {"drained": host, "moves": report["moved"],
                    "aborted": len(report["aborted"]),
                    "directory_writes": report["directory_writes"],
                    "elapsed_s": round(time.perf_counter() - t0, 4),
                    "remaining": len(self.backend.owned(host))}
        moved = []
        for doc in list(self.backend.owned(host)):
            sigs = self._signals()
            dst = min(others, key=lambda h: (sigs[h]["score"], str(h)))
            moved.extend(self._execute([(doc, host, dst)]))
        return {"drained": host, "moves": len(moved),
                "elapsed_s": round(time.perf_counter() - t0, 4),
                "remaining": len(self.backend.owned(host))}


class StormClusterDirectory:
    """The durable doc→host directory over the cluster's SHARED
    content-addressed snapshot store. Default owner = stable hash over
    the GENESIS host list (never changes when hosts are added); the
    overlay holds only migrated docs. Mutations publish atomically
    (upload, then head flip) under the ``__placement__`` key, so the
    directory survives any host's crash and a half-done migration is a
    durable MIGRATING intent recovery rolls forward."""

    KEY = "__placement__"

    def __init__(self, snapshots, genesis: list) -> None:
        self.snapshots = snapshots
        head = snapshots.head(self.KEY)
        snap = snapshots.get(self.KEY, head) if head else None
        if snap is not None:
            self.genesis = tuple(snap["genesis"])
            self.owners: dict = dict(snap["owners"])
            self.migrating: dict = {d: tuple(v) for d, v
                                    in snap["migrating"].items()}
            # Activated hosts are part of the durable placement state
            # (a restart must not forget a completed scale-out); snaps
            # from before the field default to the genesis set.
            self.active: list = list(snap.get("active", self.genesis))
            # Failover fencing stamps: label -> incarnation count.
            # Bumped by fail_over when a replication plane promotes a
            # follower under the same serving label; snaps from before
            # the field default to incarnation 0 everywhere.
            self.incarnations: dict = dict(snap.get("incarnations", {}))
        else:
            self.genesis = tuple(genesis)
            self.owners = {}
            self.migrating = {}
            self.active = list(self.genesis)
            self.incarnations = {}
            self._save()

    def _save(self) -> None:
        handle = self.snapshots.upload(self.KEY, {
            "kind": "cluster-placement",
            "genesis": list(self.genesis),
            "owners": self.owners,
            "migrating": {d: list(v) for d, v in self.migrating.items()},
            "active": list(self.active),
            "incarnations": self.incarnations,
        })
        self.snapshots.set_head(self.KEY, handle)

    def activate(self, label) -> None:
        if label not in self.active:
            self.active.append(label)
            self._save()

    def incarnation_of(self, label) -> int:
        return self.incarnations.get(label, 0)

    def bump_incarnation(self, label) -> int:
        """Durable fencing flip: a NEW incarnation now serves ``label``
        (leader failover). Old-incarnation zombies compare their stamp
        against this and fence themselves."""
        self.incarnations[label] = self.incarnations.get(label, 0) + 1
        self._save()
        return self.incarnations[label]

    def genesis_owner(self, doc: str):
        """The stable hash default (ignores the migration overlay)."""
        import zlib
        return self.genesis[zlib.crc32(doc.encode()) % len(self.genesis)]

    def owner_of(self, doc: str):
        owner = self.owners.get(doc)
        if owner is not None:
            return owner
        return self.genesis_owner(doc)

    def freeze(self, doc: str, src, dst) -> None:
        """Durable migration intent: the doc routes ``migrating``
        everywhere until :meth:`complete` (or an abort) unfreezes."""
        self.migrating[doc] = (src, dst)
        self._save()

    def complete(self, doc: str, dst) -> None:
        self.owners[doc] = dst
        self.migrating.pop(doc, None)
        self._save()

    def abort(self, doc: str) -> None:
        """Roll a frozen migration BACK (the eviction refused): the doc
        keeps its previous owner and serving resumes at the source."""
        self.migrating.pop(doc, None)
        self._save()

    # Batch-drain forms (ONE durable directory write per call — a hot
    # host's whole range freezes/completes in one head flip instead of
    # one write per doc; recovery semantics are unchanged because the
    # per-doc intents are the same records, published together).

    def freeze_many(self, items: list[tuple]) -> None:
        """``items`` = [(doc, src, dst), ...] frozen in one write."""
        for doc, src, dst in items:
            self.migrating[doc] = (src, dst)
        self._save()

    def complete_many(self, items: list[tuple]) -> None:
        """``items`` = [(doc, dst), ...] completed in one write."""
        for doc, dst in items:
            self.owners[doc] = dst
            self.migrating.pop(doc, None)
        self._save()

    def abort_many(self, docs: list[str]) -> None:
        for doc in docs:
            self.migrating.pop(doc, None)
        self._save()


class _HostRouter:
    """One host's ``storm.placement`` seam: routes every admitted
    frame's docs against the live directory."""

    __slots__ = ("cluster", "label")

    def __init__(self, cluster: "StormCluster", label) -> None:
        self.cluster = cluster
        self.label = label

    @property
    def retry_after_s(self) -> float:
        return self.cluster.retry_after_s

    def route(self, doc: str) -> tuple[str | None, Any]:
        return self.cluster._route(doc, self.label)


class StormCluster:
    """N StormController serving hosts over ONE shared snapshot store —
    the in-process deployment shape of the elastic cluster (a
    multi-process launch runs the identical directory over the same
    store; each host keeps its OWN WAL/bus/state, only the
    content-addressed store and the placement head are shared). Each
    host must have a :class:`~..server.residency.ResidencyManager`
    attached with ``host_label`` set and a host-unique
    ``storm.SNAPSHOT_DOC`` (see :func:`make_cluster_host`)."""

    def __init__(self, hosts: dict, snapshots,
                 active: list | None = None,
                 retry_after_s: float = 0.05) -> None:
        self.hosts = dict(hosts)
        self.labels = sorted(self.hosts)
        self.retry_after_s = retry_after_s
        for label, storm in self.hosts.items():
            res = storm.residency
            if res is None or res.host_label != label:
                raise ValueError(
                    f"host {label!r} needs a ResidencyManager with "
                    f"host_label={label!r} (cold snapshots must stamp "
                    "their WAL home)")
        self.directory = StormClusterDirectory(
            snapshots, sorted(active) if active else self.labels)
        # The active set is durable directory state: a rebuilt cluster
        # resumes the scale-out it had completed, not genesis.
        self.active = list(self.directory.active)
        for label in self.labels:
            self.hosts[label].placement = _HostRouter(self, label)
        self.stats = {"migrations": 0, "rehomed_viewers": 0}
        self.blackouts_s: list[float] = []
        self._update_gauges()

    # -- routing ---------------------------------------------------------------

    def activate_host(self, label) -> None:
        """Bring one constructed host online as a migration target (the
        scale-out step; genesis-hash defaults never re-route). The
        activation is DURABLE directory state — a restarted cluster
        keeps its scale-out."""
        if label not in self.hosts:
            raise KeyError(label)
        if label not in self.active:
            self.directory.activate(label)
            self.active.append(label)
        self._update_gauges()

    def fail_over(self, label, promoted_storm,
                  blackout_ms: float | None = None) -> int:
        """Replace a dead host's controller with a PROMOTED follower
        serving the SAME label (server/replication.py built it over the
        replica log): the directory's incarnation stamp bumps durably —
        the fencing flip an old-incarnation zombie checks itself
        against — routing stays byte-identical (labels never change, so
        no doc re-homes), and the old controller, if still in-process,
        is fenced so its every frame sheds ``moved`` toward the new
        incarnation. Returns the new incarnation number."""
        if label not in self.hosts:
            raise KeyError(label)
        res = promoted_storm.residency
        if res is None or res.host_label != label:
            raise ValueError(
                f"promoted host for {label!r} needs a ResidencyManager "
                f"with host_label={label!r}")
        old = self.hosts[label]
        if old is not promoted_storm \
                and getattr(old, "replication", None) is not None \
                and not old.replication.fenced:
            old.replication.fence(moved_to=label)
        self.hosts[label] = promoted_storm
        promoted_storm.placement = _HostRouter(self, label)
        incarnation = self.directory.bump_incarnation(label)
        # Promotion rolled journaled head flips straight onto the
        # shared backend, so any historian cache layer still serving
        # must drop its head entries now or answer from pre-failover
        # refs for up to a TTL (server/historian.py invalidate_heads).
        seen: set = set()
        for store in [self.directory.snapshots] + [
                h.snapshots for h in self.hosts.values()
                if h.snapshots is not None]:
            layer = store
            while layer is not None and id(layer) not in seen:
                seen.add(id(layer))
                # type-dict lookup: wrapper stores (ReplicatedHeadStore)
                # delegate unknown attrs to their backend, which is
                # walked below anyway.
                invalidate = type(layer).__dict__.get("invalidate_heads")
                if invalidate is not None:
                    invalidate(layer)
                layer = getattr(layer, "_backend", None)
        self.stats["failovers"] = self.stats.get("failovers", 0) + 1
        if blackout_ms is not None:
            self.blackouts_s.append(blackout_ms / 1000.0)
            m = promoted_storm.merge_host.metrics
            m.gauge("cluster.last_blackout_ms").set(
                round(blackout_ms, 3))
            m.gauge("repl.last_failover_blackout_ms").set(
                round(blackout_ms, 3))
        self._update_gauges()
        return incarnation

    def owner_of(self, doc: str):
        return self.directory.owner_of(doc)

    def storm_for(self, doc: str):
        """The owning host's controller (the front-door routing any
        cluster-aware client performs from the ``moved_to`` hints)."""
        return self.hosts[self.owner_of(doc)]

    def _route(self, doc: str, local) -> tuple[str | None, Any]:
        if doc in self.directory.migrating:
            return "migrating", None
        owner = self.owner_of(doc)
        if owner == local:
            return None, None
        return "moved", owner

    # -- placement-controller backend surface ----------------------------------

    def hosts_list(self) -> list:
        return list(self.active)

    # PlacementController duck-typing: hosts() collides with the attr
    # name, so the backend surface uses explicit methods.
    def owned(self, label) -> list[str]:
        """Docs the host currently owns, cheapest-to-move FIRST (the
        PlacementController pops index 0): cold overlay docs move
        without an eviction barrier, then residents in LRU order (the
        victims eviction would pick anyway)."""
        res = self.hosts[label].residency
        resident = [d for d in res.resident
                    if self.owner_of(d) == label]
        seen = set(resident)
        cold = [d for d, owner in self.directory.owners.items()
                if owner == label and d not in seen]
        return cold + resident

    def load_signals(self, label) -> dict:
        """The load inputs placement decides on: owned docs, the
        host's inbound queue depth, its stage-ledger mean per-tick
        attributed cost over the ring window, and — multi-tenant — the
        per-tenant slice of its owned docs (the QoS×placement seam: a
        hot tenant's docs spread across hosts instead of saturating its
        weighted share on one)."""
        storm = self.hosts[label]
        att = storm.ledger.attribution()
        win = att.get("_window") or {}
        ticks = win.get("ticks", 0)
        cost = (win.get("attributed_ms", 0.0) / ticks) if ticks else 0.0
        tenant_load: dict[str, int] = {}
        doc_tenant = storm.qos.doc_tenant
        if doc_tenant:
            for doc in self.owned(label):
                t = doc_tenant.get(doc)
                if t is not None:
                    tenant_load[t] = tenant_load.get(t, 0) + 1
        return {"docs": len(self.owned(label)),
                "queue_depth": storm._pending_docs,
                "tick_cost_ms": cost,
                "tenant_load": tenant_load}

    def doc_tenant(self, label, doc: str) -> str | None:
        """The tenant observed owning ``doc`` on host ``label`` (None
        for single-tenant traffic — placement then ignores tenants)."""
        return self.hosts[label].qos.doc_tenant.get(doc)

    # -- migration (the tentpole) ----------------------------------------------

    def migrate(self, doc: str, dst,
                on_phase: Callable[[str], None] | None = None) -> float:
        """LIVE migration of one doc to host ``dst``. Phases (each with
        its chaos kill point; ``on_phase`` observes them — the bench's
        blackout probe and the race tests hook here):

        1. ``frozen``   — durable MIGRATING intent published; every
           host sheds the doc's frames ``"migrating"`` + retry hint.
        2. ``evicted``  — source settled (durability barrier inside
           evict) and demoted to the shared cold record.
        3. ``hydrated`` — target restored the record; source viewer
           room re-homed via ``viewer_resync`` + ``moved_to``.
        4. directory flip — the source now sheds ``"moved"`` with the
           ``moved_to`` hint; blackout ends.

        Returns the blackout in seconds (freeze → flip)."""
        src = self.owner_of(doc)
        if dst not in self.hosts:
            raise KeyError(dst)
        if dst == src:
            return 0.0
        if doc in self.directory.migrating:
            raise RuntimeError(f"{doc!r} is already migrating")
        src_storm, dst_storm = self.hosts[src], self.hosts[dst]
        t0 = time.perf_counter()
        self.directory.freeze(doc, src, dst)
        self._update_gauges()
        if on_phase is not None:
            on_phase("frozen")
        faults.crashpoint("placement.pre_evict")
        try:
            res = src_storm.residency
            if res.is_resident(doc):
                res.evict(doc, reason="migration")
            if on_phase is not None:
                on_phase("evicted")
            faults.crashpoint("placement.post_evict")
            retry = dst_storm.residency.ensure_resident(doc, gate=False)
            if retry is not None:
                raise RuntimeError(
                    f"target {dst!r} refused hydration of {doc!r} "
                    f"(retry {retry}s)")
        except BaseException:
            if doc in self.directory.migrating:
                # A refused eviction (quarantine, degraded WAL) rolls
                # BACK: the doc keeps serving at the source. A planned
                # chaos kill never reaches here (os._exit).
                self.directory.abort(doc)
                self._update_gauges()
            raise
        if on_phase is not None:
            on_phase("hydrated")
        faults.crashpoint("placement.post_hydrate")
        viewers = getattr(src_storm.service, "viewers", None)
        if viewers is not None:
            self.stats["rehomed_viewers"] += viewers.resync_room(
                doc, reason="moved", moved_to=dst)
        self.directory.complete(doc, dst)
        blackout = time.perf_counter() - t0
        self.blackouts_s.append(blackout)
        self.stats["migrations"] += 1
        for storm in self.hosts.values():
            m = storm.merge_host.metrics
            m.counter("cluster.migrations").inc()
            m.gauge("cluster.last_blackout_ms").set(
                round(blackout * 1e3, 3))
        self._update_gauges()
        if on_phase is not None:
            on_phase("completed")
        return blackout

    def migrate_batch(self, moves: list[tuple],
                      on_phase: Callable[[str], None] | None = None
                      ) -> dict:
        """Batch drain: migrate ``moves`` = [(doc, dst), ...] with ONE
        durable directory write for the whole batch's intents and ONE
        for the completions (vs two per doc in :meth:`migrate`) — the
        scale-in/maintenance shape where a hot host's whole range moves
        at once. Per-doc semantics are unchanged: the same evict →
        hydrate phases, the same kill points, and recovery rolls every
        frozen intent forward individually. A doc whose eviction
        refuses aborts alone; the rest of the batch completes."""
        items: list[tuple] = []
        seen: set[str] = set()
        for doc, dst in moves:
            if dst not in self.hosts:
                raise KeyError(dst)
            if doc in self.directory.migrating:
                raise RuntimeError(f"{doc!r} is already migrating")
            if doc in seen:
                raise ValueError(f"{doc!r} repeats within one batch")
            seen.add(doc)
            src = self.owner_of(doc)
            if src != dst:
                items.append((doc, src, dst))
        result = {"moved": 0, "aborted": [], "blackout_s": 0.0,
                  "directory_writes": 0}
        if not items:
            return result
        t0 = time.perf_counter()
        self.directory.freeze_many(items)  # ONE durable intent write
        result["directory_writes"] += 1
        self._update_gauges()
        if on_phase is not None:
            on_phase("frozen")
        faults.crashpoint("placement.pre_evict")
        completed: list[tuple] = []
        try:
            for doc, src, dst in items:
                try:
                    res = self.hosts[src].residency
                    if res.is_resident(doc):
                        res.evict(doc, reason="migration")
                    faults.crashpoint("placement.post_evict")
                    retry = self.hosts[dst].residency.ensure_resident(
                        doc, gate=False)
                    if retry is not None:
                        raise RuntimeError(
                            f"target {dst!r} refused hydration of "
                            f"{doc!r} (retry {retry}s)")
                except (RuntimeError, KeyError) as err:
                    # Refused eviction/hydration rolls THIS doc back;
                    # the rest of the batch proceeds (drain must make
                    # progress).
                    result["aborted"].append((doc, repr(err)))
                    continue
                faults.crashpoint("placement.post_hydrate")
                viewers = getattr(self.hosts[src].service, "viewers",
                                  None)
                if viewers is not None:
                    self.stats["rehomed_viewers"] += \
                        viewers.resync_room(doc, reason="moved",
                                            moved_to=dst)
                completed.append((doc, dst))
        except BaseException:
            # Unexpected failure mid-batch (disk full, interrupt — a
            # planned chaos kill never reaches here, os._exit): flip
            # what finished, abort EVERY other frozen intent, then
            # surface the error — live hosts must never keep shedding
            # "migrating" for intents nobody will complete (the
            # single-doc migrate()'s abort contract, batch-wide).
            done = {d for d, _dst in completed}
            aborted = {d for d, _e in result["aborted"]}
            stranded = [d for d, _s, _dst in items
                        if d not in done and d not in aborted]
            if completed:
                self.directory.complete_many(completed)
            if stranded or aborted:
                self.directory.abort_many(stranded + sorted(aborted))
            self._update_gauges()
            raise
        if completed:
            self.directory.complete_many(completed)  # ONE flip write
            result["directory_writes"] += 1
        if result["aborted"]:
            self.directory.abort_many([d for d, _ in result["aborted"]])
            result["directory_writes"] += 1
        blackout = time.perf_counter() - t0
        result["moved"] = len(completed)
        result["blackout_s"] = blackout
        if completed:
            self.blackouts_s.append(blackout)
            self.stats["migrations"] += len(completed)
            for storm in self.hosts.values():
                m = storm.merge_host.metrics
                m.counter("cluster.migrations").inc(len(completed))
                m.gauge("cluster.last_blackout_ms").set(
                    round(blackout * 1e3, 3))
        self._update_gauges()
        if on_phase is not None:
            on_phase("completed")
        return result

    def recover(self) -> list[str]:
        """Roll forward every durable MIGRATING intent after the hosts
        recovered their own snapshots + WALs (call once, after each
        host's ``storm.recover()``). Deterministic: whatever phase the
        crash hit, the doc ends owned (and served) by the intended
        target with the identical cold-record state — a source that
        resurrected the doc resident re-evicts it (the eviction barrier
        makes the re-export byte-identical), a target that lost its
        volatile hydration re-hydrates."""
        completed = []
        for doc, (src, dst) in list(self.directory.migrating.items()):
            res = self.hosts[src].residency
            if res.is_resident(doc):
                res.evict(doc, reason="migration")
            self.hosts[dst].residency.ensure_resident(doc, gate=False)
            viewers = getattr(self.hosts[src].service, "viewers", None)
            if viewers is not None:
                viewers.resync_room(doc, reason="moved", moved_to=dst)
            self.directory.complete(doc, dst)
            completed.append(doc)
        self._update_gauges()
        return completed

    # -- cross-host reads ------------------------------------------------------

    def get_deltas(self, doc: str, from_seq: int = 0,
                   to_seq: int | None = None) -> list:
        """The doc's merged sequenced history across every host: each
        host serves exactly the ticks its own WAL holds (a migrated
        doc's pre-migration segment stays readable at its origin via
        the home-stamped cold head / ``foreign_ticks`` carry-through);
        the union ordered by seq is the complete history."""
        merged: dict[int, Any] = {}
        for label in self.labels:
            for m in self.hosts[label].service.get_deltas(
                    doc, from_seq, to_seq):
                merged.setdefault(m.sequence_number, m)
        return [merged[s] for s in sorted(merged)]

    # -- observability ---------------------------------------------------------

    def _update_gauges(self) -> None:
        for label, storm in self.hosts.items():
            m = storm.merge_host.metrics
            m.gauge("cluster.hosts").set(len(self.active))
            m.gauge("cluster.host_docs").set(len(self.owned(label)))
            m.gauge("cluster.migrations_in_flight").set(
                len(self.directory.migrating))


def make_cluster_host(label: str, data_dir: str, shared_snapshots,
                      num_docs: int = 64,
                      max_resident: int | None = None,
                      device=None, **storm_kw):
    """One cluster serving host over its OWN durable directories and
    the SHARED snapshot store: routerlicious service + storm controller
    (host-unique global-snapshot key) + residency manager stamped with
    the host label, its sequencer and merge hosts on ``device`` (the
    card by default). Returns the StormController (service/hosts hang
    off it)."""
    import os

    from ..server.durable_store import DurableMessageBus, FileStateStore
    from ..server.kernel_host import KernelSequencerHost
    from ..server.merge_host import KernelMergeHost
    from ..server.residency import ResidencyManager
    from ..server.routerlicious import RouterliciousService
    from ..server.storm import StormController

    seq_host = KernelSequencerHost(num_slots=2,
                                   initial_capacity=num_docs,
                                   device=device)
    merge_host = KernelMergeHost(flush_threshold=10**9, device=device)
    service = RouterliciousService(
        bus=DurableMessageBus(os.path.join(data_dir, "bus")),
        store=FileStateStore(os.path.join(data_dir, "state")),
        merge_host=merge_host, batched_deli_host=seq_host,
        auto_pump=False, idle_check_interval=10**9)
    storm_kw.setdefault("flush_threshold_docs", 1)
    storm_kw.setdefault("durability", "group")
    storm_kw.setdefault("spill_dir", os.path.join(data_dir, "spill"))
    storm = StormController(service, seq_host, merge_host,
                            snapshots=shared_snapshots, **storm_kw)
    # Host-unique global-snapshot key: N hosts share ONE
    # content-addressed store, and colliding "__storm__" heads would
    # make every host recover some other host's pool.
    storm.SNAPSHOT_DOC = f"__storm__::{label}"
    ResidencyManager(storm, max_resident=max_resident,
                     idle_evict_s=1e9, hydration_rate_per_s=1e9,
                     host_label=label)
    return storm


class ReplicaBalancer:
    """Read-replica scoring + re-home (the read-tier half of placement,
    server/read_replica.py): spreads hot docs' AUDIENCE across N
    replicas while writer traffic stays wherever the placement
    directory puts it. Scoring is (rooms assigned, replica lag) — the
    fewest-loaded, freshest replica wins — and a re-home flips the
    replica directory FIRST (ship-then-flip under a replicated store),
    then drops the leader's room through the viewer plane's spread so
    every member redials its hash-assigned label.

    Also the leader-side staleness scrape: :meth:`update_gauges` folds
    each assigned room's ``leader watermark − replica applied seq`` gap
    into the shared registry (``replica.staleness_seqs`` histogram +
    the gauges tools/monitor.py renders)."""

    def __init__(self, directory, replicas: dict[str, Any],
                 leader_storm=None, metrics=None,
                 retry_after_s: float = 0.05) -> None:
        self.directory = directory
        self.replicas = dict(replicas)
        self.leader = leader_storm
        if metrics is None:
            metrics = (leader_storm.merge_host.metrics
                       if leader_storm is not None else None)
        from ..utils import MetricsRegistry
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry()
        self.retry_after_s = retry_after_s
        self.stats = {"rehomed_rooms": 0, "rehomed_viewers": 0}
        for label, replica in self.replicas.items():
            self.directory.register(label,
                                    node=getattr(replica.node,
                                                 "node_id", label))
        self._c_rooms = self.metrics.counter("replica.rehomed_rooms")
        self._c_viewers = self.metrics.counter(
            "replica.rehomed_viewers")
        self._h_staleness = self.metrics.histogram(
            "replica.staleness_seqs")
        self.update_gauges()

    # -- scoring ---------------------------------------------------------------

    def score(self, label: str,
              _room_stale: dict | None = None) -> tuple[int, int, int]:
        """(rooms assigned here, worst PER-ROOM staleness gap, shipped-
        but-unapplied WAL records) — lower is better on every axis. The
        middle term is the room watermark gap (leader sequenced
        watermark − replica applied seq, per room assigned to this
        label), so a replica that is idle-fresh globally but behind on
        its one hot room stops winning new rooms until it catches up."""
        stale = (_room_stale if _room_stale is not None
                 else self.room_staleness())
        worst = max((per.get(label, 0) for per in stale.values()),
                    default=0)
        return (len(self.directory.rooms_on(label)), worst,
                self.replicas[label].lag)

    def pick(self, n: int = 1) -> list[str]:
        """The ``n`` least-loaded replicas, freshest first on ties."""
        stale = self.room_staleness()
        return sorted(self.replicas,
                      key=lambda lb: self.score(lb, stale))[:max(1, n)]

    # -- re-home ---------------------------------------------------------------

    def spread_room(self, doc: str, labels: list[str] | None = None,
                    n: int = 1) -> dict:
        """Assign ``doc``'s read audience to ``labels`` (default: the
        ``n`` best-scoring replicas) and re-home the leader's live room
        through the viewer plane — each member's resync directive names
        its hash-assigned replica, and late joiners route through the
        directory at connect time. Returns the assignment + per-label
        re-home counts."""
        if labels is None:
            labels = self.pick(n)
        self.directory.assign_room(doc, labels)
        counts: dict[str, int] = {}
        viewers = getattr(getattr(self.leader, "service", None),
                          "viewers", None)
        if viewers is not None:
            counts = viewers.spread_room(doc, labels, reason="moved")
        self.stats["rehomed_rooms"] += 1
        self.stats["rehomed_viewers"] += sum(counts.values())
        self._c_rooms.inc()
        self._c_viewers.inc(sum(counts.values()))
        self.update_gauges()
        return {"doc": doc, "labels": list(labels), "rehomed": counts}

    def unspread_room(self, doc: str) -> None:
        """Return ``doc``'s reads to the leader (directory flip only;
        replica-side viewers lag-drop back on their next resync)."""
        self.directory.unassign_room(doc)
        self.update_gauges()

    # -- staleness (per room, against the leader's watermark) ------------------

    def _leader_seq(self, doc: str) -> int:
        if self.leader is None:
            return 0
        ticks = self.leader._doc_ticks.get(doc)
        return max((ls for _fs, ls, _t in ticks), default=0) \
            if ticks else 0

    def room_staleness(self) -> dict[str, dict[str, int]]:
        """room doc -> {replica label: leader watermark − applied seq}
        (0 = fully caught up; the BOUND a replica-served read of that
        room can be behind by right now)."""
        out: dict[str, dict[str, int]] = {}
        for doc, labels in self.directory.rooms().items():
            lead = self._leader_seq(doc)
            out[doc] = {
                label: max(0, lead
                           - self.replicas[label].doc_seq(doc))
                for label in labels if label in self.replicas}
        return out

    def update_gauges(self) -> None:
        m = self.metrics
        m.gauge("replica.hosts").set(len(self.replicas))
        rooms = self.directory.rooms()
        m.gauge("replica.rooms").set(len(rooms))
        worst = 0
        stale_rooms = 0
        for per_label in self.room_staleness().values():
            room_worst = 0
            for gap in per_label.values():
                self._h_staleness.observe(gap)
                room_worst = max(room_worst, gap)
            worst = max(worst, room_worst)
            if room_worst > 0:
                stale_rooms += 1
        m.gauge("replica.staleness_worst").set(worst)
        m.gauge("replica.stale_rooms").set(stale_rooms)
        m.gauge("replica.lag_records").set(
            max((r.lag for r in self.replicas.values()), default=0))


__all__ = ["PlacementController", "StormCluster",
           "StormClusterDirectory", "MigrationResult",
           "MIGRATION_KILL_POINTS", "ReplicaBalancer",
           "make_cluster_host"]
