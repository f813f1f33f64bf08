"""Multi-tenant QoS — deficit-weighted fair tick composition and
per-tenant SLO accounting (ROADMAP item 5, the round-17 tentpole).

Reference parity: the reference serves thousands of tenants through one
ordering service (riddler tenant/auth + alfred connect), but its
fairness story stops at admission throttles. Per-tenant token buckets
alone bound each tenant's admitted RATE, yet tick
batch composition stayed first-come — one hot tenant could fill every
tick's doc slots and move every other tenant's ack p99 (the classic
noisy-neighbor failure). This module adds the missing layer between
admission and the device tick:

* **per-tenant pending queues** — buffered storm frames group by the
  session-validated ``tenant_id`` (threaded through
  ``storm.submit_frame``; never the client-controlled frame header);
* **deficit round robin** — each tick, every tenant with pending
  frames accrues ``quantum x weight`` doc-slot credit (capped at one
  tick's quantum — an idle tick must not bank unbounded burst) and the
  composer drains frames in rotation while credit and the tick's slot
  budget last. An abusive tenant at 10x its rate saturates only its own
  share; the others' frames keep landing in the next tick;
* **weighted shed** — under queue pressure the OVER-share tenant sheds
  first (per-tenant pending caps; borrowing beyond the weighted share
  is allowed only while the global queue is shallow), and busy-nacks
  carry a per-tenant ``retry_after_s`` scaled by that tenant's own
  backlog, so the abuser backs off hardest;
* **per-tenant observability** — sequenced/submitted/shed counters and
  an ack-latency histogram per tenant in the shared registry
  (``storm.tenant.<id>.*`` — alfred's ``get_metrics`` exports them,
  ``tools/monitor.py render_tenants`` renders the SLO columns), plus a
  bounded ring of per-tick slot slices for windowed share attribution.

Determinism and replay safety: composition is a pure function of
(scheduler state, buffered frames), scheduler state is tiny
(deficits + rotation), rides every tick's WAL header (``"qos"`` field)
and the storm snapshot, and ``StormController._replay_wal`` restores it
tick by tick — so a recovered host resumes composing exactly where the
crashed one stopped (chaos kill point ``storm.qos_mid_compose``).
A single-tenant scheduler with no slot budget composes EXACTLY the
legacy first-come cohort (the compatibility bar every pre-QoS test
holds us to).
"""

from __future__ import annotations

import math
from collections import deque
from typing import Any

#: Tenant every unauthenticated session lands on (riddler-less doors).
DEFAULT_TENANT = "default"


class TenantScheduler:
    """Deficit-round-robin composer + per-tenant QoS bookkeeping.

    ``weights`` maps tenant id -> relative share (default 1.0 each).
    ``quantum_docs`` is the per-tick credit a weight-1.0 tenant accrues;
    None derives it from the tick slot budget at compose time (budget /
    total active weight — the work-conserving default).

    The scheduler never owns frames: :meth:`compose` PLANS a tick over
    the controller's buffered frame list (collision/fence rules
    included) and :meth:`commit` applies the plan's deficit charges —
    split so an undersized cohort can be declined without moving
    scheduler state (the ``require_full`` contract).
    """

    def __init__(self, weights: dict[str, float] | None = None,
                 default_weight: float = 1.0,
                 quantum_docs: int | None = None,
                 weight_source=None,
                 registry=None, prefix: str = "storm.tenant",
                 slice_capacity: int = 1024) -> None:
        self.weights: dict[str, float] = dict(weights or {})
        for t, w in self.weights.items():
            if w <= 0:
                raise ValueError(f"tenant {t!r} weight must be > 0, got {w}")
        # Tenant-record weight derivation (riddler paid tiers): a
        # callable ``tenant_id -> weight | None`` consulted LIVE for
        # tenants with no explicit/journaled weight — never cached, so
        # a ``set_tier`` upgrade takes effect on the very next compose
        # and an idle tenant's derived weight never bloats the
        # journaled roster (pending_cap counts configured tenants as
        # active). Recovery re-derives from the same durable tenant
        # store; replay itself never re-composes, so weights need no
        # per-tick journal of their own.
        self.weight_source = weight_source
        self.default_weight = float(default_weight)
        self.quantum_docs = quantum_docs
        self._registry = registry
        self._prefix = prefix
        # Runtime weight changes (set_weight / weight_source cache) must
        # journal even before multi-tenant traffic makes the deficits
        # non-trivial — constructor config alone stays unstamped (the
        # pre-QoS byte-compat contract).
        self._weights_dirty = False
        # DRR state (the replay-safe part): per-tenant deficit credit +
        # the rotation order/pointer. Rotation entry is first-seen order
        # — deterministic under deterministic workloads.
        self.deficit: dict[str, float] = {}
        self._rr: list[str] = []
        self._rr_idx = 0
        # Live accounting (NOT replayed — rebuilt from buffered frames).
        self.pending_docs: dict[str, int] = {}
        # doc -> owning tenant (observed at submit; bounded, insertion-
        # ordered eviction). The cluster placement tier reads this to
        # spread a hot tenant's docs ACROSS hosts instead of letting it
        # saturate its weighted share on one (parallel/placement.py).
        self.doc_tenant: dict[str, str] = {}
        self.max_doc_tenants = 65536
        # Windowed per-tick slot slices: (tick, {tenant: [docs, ops]}).
        self._slices: deque = deque(maxlen=max(1, slice_capacity))
        # Lazily-created per-tenant metrics (a tenant that never sends
        # never appears in a scrape).
        self._counters: dict[tuple[str, str], Any] = {}
        self._hists: dict[str, Any] = {}
        self._gauges: dict[str, Any] = {}

    # -- weights ---------------------------------------------------------------

    def weight(self, tenant: str) -> float:
        w = self.weights.get(tenant)
        if w is not None:
            return w
        if self.weight_source is not None:
            derived = self.weight_source(tenant)
            if derived is not None and derived > 0:
                return float(derived)
        return self.default_weight

    def set_weight(self, tenant: str, weight: float) -> None:
        """Runtime weight change — journals like scheduler state: the
        next composed tick's WAL header (and the next snapshot) carries
        it, and recovery restores it (import_state OVERRIDES, so a
        journaled change survives a restart over static config)."""
        if weight <= 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        self.weights[tenant] = float(weight)
        self._weights_dirty = True

    # -- metrics plumbing ------------------------------------------------------

    def _counter(self, tenant: str, name: str):
        key = (tenant, name)
        c = self._counters.get(key)
        if c is None and self._registry is not None:
            c = self._registry.counter(f"{self._prefix}.{tenant}.{name}")
            self._counters[key] = c
        return c

    def _hist(self, tenant: str):
        h = self._hists.get(tenant)
        if h is None and self._registry is not None:
            h = self._registry.histogram(f"{self._prefix}.{tenant}.ack_s")
            self._hists[tenant] = h
        return h

    def _gauge(self, tenant: str):
        g = self._gauges.get(tenant)
        if g is None and self._registry is not None:
            g = self._registry.gauge(
                f"{self._prefix}.{tenant}.pending_docs")
            self._gauges[tenant] = g
        return g

    # -- live accounting -------------------------------------------------------

    def note_submitted(self, tenant: str, n_ops: int) -> None:
        c = self._counter(tenant, "submitted_ops")
        if c is not None:
            c.inc(n_ops)

    def note_buffered(self, tenant: str, n_docs: int) -> None:
        self.pending_docs[tenant] = self.pending_docs.get(tenant, 0) \
            + n_docs
        g = self._gauge(tenant)
        if g is not None:
            g.set(self.pending_docs[tenant])

    def note_doc_tenants(self, tenant: str, docs) -> None:
        """Record doc ownership for the placement tier (called per
        multi-tenant frame; re-insertion refreshes the eviction order)."""
        dt = self.doc_tenant
        for doc in docs:
            dt.pop(doc, None)
            dt[doc] = tenant
        while len(dt) > self.max_doc_tenants:
            dt.pop(next(iter(dt)))

    def note_shed(self, tenant: str, n_ops: int) -> None:
        c = self._counter(tenant, "shed_ops")
        if c is not None:
            c.inc(n_ops)

    def observe_ack(self, tenant: str, latency_s: float) -> None:
        h = self._hist(tenant)
        if h is not None:
            h.observe(max(0.0, latency_s))

    def reset_pending(self, frames) -> None:
        """Rebuild the per-tenant pending-doc levels from the
        controller's buffered frame list (called once per composed tick
        — the buffered set is bounded by ``max_pending_docs``)."""
        fresh: dict[str, int] = {}
        for f in frames:
            t = getattr(f, "tenant", DEFAULT_TENANT)
            fresh[t] = fresh.get(t, 0) + len(f.docs)
        for t in set(self.pending_docs) | set(fresh):
            level = fresh.get(t, 0)
            self.pending_docs[t] = level
            g = self._gauge(t)
            if g is not None:
                g.set(level)

    # -- weighted shed (the _admit seam) ---------------------------------------

    def pending_cap(self, tenant: str, max_pending: int) -> int | None:
        """This tenant's weighted share of the bounded inbound queue, or
        None when only one tenant is in play (single-tenant serving must
        keep the legacy global bound exactly)."""
        active = {t for t, n in self.pending_docs.items() if n > 0}
        active.add(tenant)
        active.update(self.weights)
        if len(active) <= 1:
            return None
        total_w = sum(self.weight(t) for t in active)
        return max(1, int(max_pending * self.weight(tenant) / total_w))

    def shed_hint(self, tenant: str, base_s: float,
                  max_pending: int | None = None) -> float:
        """Per-tenant ``retry_after_s``: the deeper THIS tenant's own
        backlog relative to its share, the longer it is told to wait —
        the abuser backs off hardest while a victim tenant's hint stays
        at the base."""
        if max_pending is None:
            return base_s
        cap = self.pending_cap(tenant, max_pending)
        if cap is None:
            return base_s
        backlog = self.pending_docs.get(tenant, 0)
        return base_s * (1.0 + backlog / cap)

    # -- composition (the tick seam) -------------------------------------------

    def _cap_for(self, tenant: str, quantum: float) -> float:
        return max(1.0, quantum * self.weight(tenant))

    def compose(self, frames: list, budget: int | None = None) -> dict:
        """Plan one tick's cohort over the buffered ``frames`` (arrival
        order). Returns a plan dict::

            {"selected": [frame, ...],   # in serving order
             "kept": [frame, ...],       # arrival order, unselected
             "charge": {tenant: docs},   # deficit debits commit() applies
             "slices": {tenant: docs}}   # per-tenant slots this tick

        Rules, in priority order: (1) one frame per doc per tick — a
        frame naming an already-taken doc is passed over (per-tenant
        FIFO holds; the frame stays buffered); (2) the mega FIFO fence —
        once any frame of a promoted doc is passed over, every later
        frame of that doc is too; (3) deficit round robin over tenants
        with ``budget`` total doc slots (None = unbounded). A
        single-tenant, unbounded compose reduces exactly to the legacy
        first-come scan. The plan is side-effect free until
        :meth:`commit` — scheduler state never moves for a declined
        cohort."""
        queues: dict[str, list] = {}
        for i, f in enumerate(frames):
            t = getattr(f, "tenant", DEFAULT_TENANT)
            queues.setdefault(t, []).append((i, f))
        for t in queues:
            if t not in self.deficit:
                self.deficit[t] = 0.0
                self._rr.append(t)
        active = [t for t in self._rr if t in queues]
        remaining = math.inf if budget is None else max(1, int(budget))
        taken: set[str] = set()
        blocked_parents: set[str] = set()
        picked: list[tuple[int, Any]] = []
        charge: dict[str, float] = {}
        kept_idx: set[int] = set()
        plan_quantum: float | None = None

        def fdocs(frame) -> set[str]:
            return {doc for doc, *_ in frame.docs}

        def fparents(frame) -> set[str]:
            if frame.mega is None:
                return set()
            return {info["doc"] for info in frame.mega if info is not None}

        # Global per-doc (and per-mega-parent) arrival heads: a frame is
        # takable only while it IS the oldest unselected frame naming
        # each of its docs — the rotation must never serve a later
        # arrival ahead of an earlier one for the SAME doc just because
        # they belong to different tenants (per-doc FIFO and the mega
        # cohort-admission-order law are cross-tenant invariants; the
        # per-tenant queues alone only guarantee them within a tenant).
        heads: dict[str, list[int]] = {}
        for i, f in enumerate(frames):
            for d in fdocs(f) | fparents(f):
                heads.setdefault(d, []).append(i)

        def try_take(i: int, frame, tenant: str) -> bool:
            """Collision/fence/arrival-order check + selection
            bookkeeping (shared by the fair and legacy paths)."""
            nonlocal remaining
            docs = fdocs(frame)
            parents = fparents(frame)
            stale = any(heads[d][0] != i for d in docs | parents)
            if stale or not taken.isdisjoint(docs) \
                    or not blocked_parents.isdisjoint(parents):
                blocked_parents.update(parents)
                kept_idx.add(i)
                return False
            for d in docs | parents:
                heads[d].pop(0)
            taken.update(docs)
            picked.append((i, frame))
            charge[tenant] = charge.get(tenant, 0.0) + len(frame.docs)
            remaining -= len(frame.docs)
            return True

        if len(active) == 1 and budget is None:
            # Legacy single-tenant scan: every disjoint frame serves
            # this tick, arrival order, no deficit charges (fairness is
            # moot with one tenant — and the pre-QoS byte-for-byte
            # behavior is the compatibility contract).
            t = active[0]
            for i, frame in queues[t]:
                try_take(i, frame, t)
            charge.clear()
        elif active:
            quantum = self.quantum_docs
            if quantum is None:
                total_w = sum(self.weight(t) for t in active)
                quantum = (remaining / total_w
                           if budget is not None else 64.0)
            plan_quantum = float(quantum)
            # Plan against a COPY of the deficits (commit applies them).
            deficit = dict(self.deficit)
            for t in active:
                cap = self._cap_for(t, quantum)
                deficit[t] = min(deficit[t] + quantum * self.weight(t),
                                 cap)
            # Rotation starts at the persistent pointer so leftover
            # budget rotates across ticks instead of favoring the
            # first-seen tenant forever.
            start = self._rr_idx % max(1, len(self._rr))
            rotation = [t for t in self._rr[start:] + self._rr[:start]
                        if t in queues]
            cursors = {t: 0 for t in rotation}

            def drain(use_credit: bool) -> None:
                """Round-robin pass: one frame per tenant visit, looped
                until no tenant progresses or the budget is spent. With
                ``use_credit`` a tenant stops at its deficit; without it
                (the borrow phase) any frame within the remaining budget
                serves — still charged, so the borrower's deficit goes
                negative and repays out of its next quanta."""
                nonlocal remaining
                progress = True
                while progress and remaining > 0:
                    progress = False
                    for t in rotation:
                        if remaining <= 0:
                            break
                        q = queues[t]
                        cur = cursors[t]
                        while cur < len(q):
                            i, frame = q[cur]
                            if i in kept_idx:
                                cur += 1
                                continue
                            cost = len(frame.docs)
                            if cost > remaining or (
                                    use_credit and deficit[t]
                                    < min(cost, self._cap_for(t, quantum))
                                    - 1e-9):
                                break  # out of credit/budget this visit
                            if try_take(i, frame, t):
                                deficit[t] -= cost
                                cur += 1
                                progress = True
                                break  # one frame/visit: round robin
                            cur += 1  # collision: scan past, stays
                        cursors[t] = cur

            drain(use_credit=True)
            # Work-conserving borrow phase: every fair quantum is spent
            # but slots remain — per-tick utilization stays full while
            # long-run shares hold (the victims' frames were already
            # served in the credit phase above).
            drain(use_credit=False)
            if not picked and frames:
                # Starvation guard (the oversized-frame case): serve the
                # oldest buffered frame regardless of credit — the
                # deficit goes negative and self-heals at quantum/tick,
                # so long-run fairness holds while progress is
                # guaranteed (flush(force=True) must always terminate).
                i, frame = min((it for q in queues.values() for it in q),
                               key=lambda it: it[0])
                t = getattr(frame, "tenant", DEFAULT_TENANT)
                kept_idx.discard(i)
                taken.clear()
                blocked_parents.clear()
                try_take(i, frame, t)
        picked.sort(key=lambda it: it[0])
        selected = [f for _i, f in picked]
        sel_idx = {i for i, _f in picked}
        kept = [f for i, f in enumerate(frames) if i not in sel_idx]
        slices = {}
        for _i, f in picked:
            t = getattr(f, "tenant", DEFAULT_TENANT)
            slices[t] = slices.get(t, 0) + len(f.docs)
        return {"selected": selected, "kept": kept, "charge": charge,
                "quantum": plan_quantum, "slices": slices}

    def commit(self, plan: dict) -> None:
        """Apply one composed tick's deficit movement: active tenants
        accrue their quantum (capped), selected frames debit theirs.
        Matches the arithmetic :meth:`compose` planned with."""
        charge = plan["charge"]
        if not charge:
            return  # single-tenant legacy tick: no fairness state moves
        active = {getattr(f, "tenant", DEFAULT_TENANT)
                  for f in plan["selected"] + plan["kept"]}
        quantum = plan.get("quantum")
        if quantum is None:
            quantum = self.quantum_docs if self.quantum_docs is not None \
                else 64.0
        for t in active:
            cap = self._cap_for(t, quantum)
            self.deficit[t] = min(
                self.deficit.get(t, 0.0) + quantum * self.weight(t), cap)
        for t, cost in charge.items():
            self.deficit[t] = self.deficit.get(t, 0.0) - cost
        if self._rr:
            self._rr_idx = (self._rr_idx + 1) % len(self._rr)

    # -- per-tick slices (the ledger slice plane) ------------------------------

    def note_tick(self, tick_id: int, slices: dict[str, int],
                  sequenced: dict[str, int] | None = None) -> None:
        """Record one harvested tick's per-tenant doc slots (+ sequenced
        ops) into the windowed ring and the cumulative counters."""
        rec = {t: [int(n), int((sequenced or {}).get(t, 0))]
               for t, n in slices.items()}
        for t, extra in (sequenced or {}).items():
            if t not in rec:
                rec[t] = [0, int(extra)]
        self._slices.append((int(tick_id), rec))
        for t, (docs, ops) in rec.items():
            c = self._counter(t, "tick_docs")
            if c is not None:
                c.inc(docs)
            c = self._counter(t, "sequenced_ops")
            if c is not None:
                c.inc(ops)

    def attribution(self) -> dict:
        """Windowed per-tenant share of tick doc slots:
        {tenant: {"share", "docs", "ops", "ticks"}} + "_window". The
        stage-ledger slice by tenant — which tenant consumed the
        serving capacity the ledger attributes to stages."""
        out: dict[str, Any] = {}
        slices = list(self._slices)
        totals: dict[str, list[int]] = {}
        ticks_seen: dict[str, int] = {}
        grand = 0
        for _tick, rec in slices:
            for t, (docs, ops) in rec.items():
                tot = totals.setdefault(t, [0, 0])
                tot[0] += docs
                tot[1] += ops
                ticks_seen[t] = ticks_seen.get(t, 0) + 1
                grand += docs
        for t, (docs, ops) in sorted(totals.items()):
            out[t] = {"share": round(docs / grand, 4) if grand else 0.0,
                      "docs": docs, "ops": ops,
                      "ticks": ticks_seen.get(t, 0),
                      "pending": self.pending_docs.get(t, 0)}
        out["_window"] = {"ticks": len(slices), "docs": grand}
        return out

    # -- replay-safe state -----------------------------------------------------

    def is_trivial(self) -> bool:
        """True while no fairness state worth journaling exists: at most
        the default tenant has ever composed AND no runtime weight
        change happened. Keeps single-tenant WAL headers byte-compatible
        with every pre-QoS reader and golden."""
        if self._weights_dirty:
            return False
        return not self.deficit or self._rr == [DEFAULT_TENANT]

    def export_state(self) -> dict:
        """The replay-safe scheduler state (deficits + rotation) — rides
        every multi-tenant tick's WAL header and the storm snapshot.
        Deficits export at FULL float precision (JSON round-trips
        doubles exactly): a rounded export would re-compose differently
        after recovery than the live host at an epsilon boundary."""
        return {"deficit": {t: float(d)
                            for t, d in sorted(self.deficit.items())},
                "rr": list(self._rr), "rr_idx": self._rr_idx,
                "weights": {t: w for t, w in sorted(self.weights.items())}}

    def import_state(self, snap: dict) -> None:
        self.deficit = {t: float(d)
                        for t, d in snap.get("deficit", {}).items()}
        self._rr = list(snap.get("rr", ()))
        self._rr_idx = int(snap.get("rr_idx", 0))
        for t, w in snap.get("weights", {}).items():
            # Journaled weights OVERRIDE constructor config: a runtime
            # set_weight is scheduler STATE, and recovery must compose
            # against what the crashed host actually used — the tick
            # headers roll these forward exactly like the deficits.
            self.weights[t] = float(w)
        if snap.get("weights"):
            # Restored runtime weights must KEEP journaling: without
            # this, a single-tenant host whose deficits look trivial
            # again would stop stamping headers and a second restart
            # would silently revert to constructor config.
            self._weights_dirty = True


__all__ = ["TenantScheduler", "DEFAULT_TENANT"]
