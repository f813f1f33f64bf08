"""Riddler — tenant management, token auth, throttling.

Reference parity: server/routerlicious-base's riddler tenant/auth service
and alfred's JWT validation at the socket front door
(alfred/index.ts:343: ``connect_document`` verifies a tenant-signed JWT
carrying scopes; services-core IThrottler / ITenantManager seams).
Tokens are HS256 JWTs (header.payload.signature, base64url) signed with
the tenant secret — dependency-free via hmac/hashlib.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import secrets
import time
from dataclasses import dataclass, field


class AuthError(Exception):
    pass


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64url(text: str) -> bytes:
    pad = "=" * (-len(text) % 4)
    return base64.urlsafe_b64decode(text + pad)


def sign_token(tenant_id: str, secret: str, document_id: str,
               scopes: list[str], user: str = "",
               lifetime_s: float = 3600.0,
               now: float | None = None) -> str:
    """Mint an HS256 access token (services-client generateToken)."""
    now = time.time() if now is None else now
    header = {"alg": "HS256", "typ": "JWT"}
    claims = {"tenantId": tenant_id, "documentId": document_id,
              "scopes": list(scopes), "user": user,
              "iat": now, "exp": now + lifetime_s}
    signing_input = (_b64url(json.dumps(header, sort_keys=True).encode())
                     + "." +
                     _b64url(json.dumps(claims, sort_keys=True).encode()))
    signature = hmac.new(secret.encode(), signing_input.encode(),
                         hashlib.sha256).digest()
    return signing_input + "." + _b64url(signature)


@dataclass
class Tenant:
    tenant_id: str
    secret: str
    #: Paid-tier column (the QoS weight source): serving fairness weights
    #: derive from the tenant RECORD, not static scheduler config — see
    #: :meth:`TenantManager.weight_for` and server/qos.py weight_source.
    tier: str = "standard"


#: Paid tier -> relative fair-share weight (the deficit scheduler's
#: per-tenant multiplier). Unknown tiers are rejected at create time.
TIER_WEIGHTS = {"free": 0.25, "standard": 1.0, "pro": 2.0,
                "premium": 4.0}


class TenantManager:
    """Tenant registry + token validation (riddler's core; tenants persist
    in the given store so a restarted service honors old tokens)."""

    STORE_KEY = "riddler/tenants"

    def __init__(self, store=None) -> None:
        self._store = store
        self._tenants: dict[str, Tenant] = {}
        if store is not None:
            for tenant_id, rec in (store.get(self.STORE_KEY) or {}).items():
                if isinstance(rec, str):  # legacy store: bare secret
                    self._tenants[tenant_id] = Tenant(tenant_id, rec)
                else:
                    self._tenants[tenant_id] = Tenant(
                        tenant_id, rec["secret"],
                        rec.get("tier", "standard"))

    def create_tenant(self, tenant_id: str,
                      secret: str | None = None,
                      tier: str = "standard") -> Tenant:
        if tenant_id in self._tenants:
            raise ValueError(f"tenant {tenant_id!r} exists")
        if tier not in TIER_WEIGHTS:
            raise ValueError(f"unknown tier {tier!r} "
                             f"(one of {sorted(TIER_WEIGHTS)})")
        tenant = Tenant(tenant_id, secret or secrets.token_hex(16), tier)
        self._tenants[tenant_id] = tenant
        self._persist()
        return tenant

    def get_tenant(self, tenant_id: str) -> Tenant:
        if tenant_id not in self._tenants:
            raise AuthError(f"unknown tenant {tenant_id!r}")
        return self._tenants[tenant_id]

    def set_tier(self, tenant_id: str, tier: str) -> None:
        """Move a tenant between paid tiers (durable; the scheduler
        resolves the new weight on its next compose through
        weight_source and journals it with its state)."""
        if tier not in TIER_WEIGHTS:
            raise ValueError(f"unknown tier {tier!r} "
                             f"(one of {sorted(TIER_WEIGHTS)})")
        self.get_tenant(tenant_id).tier = tier
        self._persist()

    def weight_for(self, tenant_id: str) -> float | None:
        """QoS weight derived from the tenant record's paid tier, or
        None for unknown tenants (the scheduler falls back to its
        default weight — an unauthenticated door must not crash the
        composer)."""
        tenant = self._tenants.get(tenant_id)
        if tenant is None:
            return None
        return TIER_WEIGHTS.get(tenant.tier)

    def tenant_weights(self) -> dict[str, float]:
        """Every registered tenant's derived weight (the static-config
        replacement for ``StormController(tenant_weights=...)``)."""
        return {t.tenant_id: TIER_WEIGHTS[t.tier]
                for t in self._tenants.values()
                if t.tier in TIER_WEIGHTS}

    def _persist(self) -> None:
        if self._store is not None:
            self._store.put(self.STORE_KEY, {
                t.tenant_id: {"secret": t.secret, "tier": t.tier}
                for t in self._tenants.values()})

    def validate_token(self, token: str, document_id: str | None = None,
                       now: float | None = None) -> dict:
        """Verify signature, expiry and (optionally) the document binding;
        returns the claims. Raises AuthError on any failure."""
        now = time.time() if now is None else now
        try:
            header_b64, claims_b64, signature_b64 = token.split(".")
            claims = json.loads(_unb64url(claims_b64))
            given = _unb64url(signature_b64)
        except (ValueError, json.JSONDecodeError) as err:
            raise AuthError(f"malformed token: {err}") from err
        tenant = self.get_tenant(claims.get("tenantId", ""))
        expected = hmac.new(tenant.secret.encode(),
                            f"{header_b64}.{claims_b64}".encode(),
                            hashlib.sha256).digest()
        if not hmac.compare_digest(given, expected):
            raise AuthError("bad signature")
        if claims.get("exp", 0) < now:
            raise AuthError("token expired")
        if document_id is not None and claims.get("documentId") != document_id:
            raise AuthError(
                f"token bound to {claims.get('documentId')!r}, "
                f"not {document_id!r}")
        return claims


@dataclass
class _Window:
    start: float
    used: float = 0.0


class Throttler:
    """Fixed-window rate limiter (services-core IThrottler; alfred
    throttles connects and submits per tenant/client). ``try_consume``
    returns None when allowed, else seconds until the window resets.

    KNOWN DEFECT (pinned by tests/test_riddler.py, fixed by
    :class:`TokenBucket`): a fixed window admits up to 2x the budget
    across a window edge — a full budget in the last instant of window N
    plus another full budget in the first instant of window N+1. Kept as
    the regression reference; new admission points use the token bucket.
    """

    def __init__(self, rate_per_interval: float = 1_000_000,
                 interval_s: float = 1.0,
                 clock=time.monotonic) -> None:
        self.rate = rate_per_interval
        self.interval = interval_s
        self._clock = clock
        self._windows: dict[str, _Window] = {}

    def try_consume(self, key: str, weight: float = 1.0) -> float | None:
        now = self._clock()
        window = self._windows.get(key)
        if window is None or now - window.start >= self.interval:
            window = _Window(start=now)
            self._windows[key] = window
        if window.used + weight > self.rate:
            return max(0.0, window.start + self.interval - now)
        window.used += weight
        return None


class TokenBucket:
    """Per-key token-bucket rate limiter — the admission primitive.

    Each key accrues ``rate_per_s`` tokens/second up to ``burst``;
    ``try_consume`` spends ``weight`` tokens and returns None, or returns
    the seconds until enough tokens accrue (the ``retry_after_s`` hint).
    Unlike the fixed window it is burst-safe at any boundary: over ANY
    interval T the admitted weight is bounded by ``burst + rate*T`` —
    there is no window edge where 2x the budget slips through.
    Same ``try_consume`` surface as :class:`Throttler`, so the front
    doors take either.
    """

    def __init__(self, rate_per_s: float, burst: float | None = None,
                 clock=time.monotonic) -> None:
        if rate_per_s <= 0:
            raise ValueError(f"rate_per_s must be > 0, got {rate_per_s}")
        self.rate = float(rate_per_s)
        self.burst = float(burst) if burst is not None \
            else max(1.0, self.rate)
        self._clock = clock
        self._buckets: dict[str, list[float]] = {}  # key -> [tokens, at]

    #: Sweep trigger: above this many tracked keys, inserting a new one
    #: first evicts every bucket that has refilled to FULL (a full
    #: bucket is indistinguishable from an absent one) — per-client keys
    #: churn (one per driver instance), and the admission layer must not
    #: itself grow without bound.
    MAX_IDLE_BUCKETS = 4096

    def _bucket(self, key: str, now: float) -> list[float]:
        bucket = self._buckets.get(key)
        if bucket is None:
            if len(self._buckets) > self.MAX_IDLE_BUCKETS:
                for stale in [k for k, b in self._buckets.items()
                              if b[0] + (now - b[1]) * self.rate
                              >= self.burst]:
                    del self._buckets[stale]
            bucket = [self.burst, now]
            self._buckets[key] = bucket
        return bucket

    def try_consume(self, key: str, weight: float = 1.0) -> float | None:
        now = self._clock()
        bucket = self._bucket(key, now)
        tokens = min(self.burst,
                     bucket[0] + (now - bucket[1]) * self.rate)
        bucket[1] = now
        if tokens >= weight:
            bucket[0] = tokens - weight
            return None
        if weight > self.burst and tokens >= self.burst - 1e-9:
            # Oversized request (weight can never fit the burst): admit
            # at a FULL bucket and carry the deficit as debt — the debt
            # refills before anything else admits, so long-run rate
            # holds, and the caller is never livelocked by a hint it can
            # never satisfy.
            bucket[0] = tokens - weight
            return None
        bucket[0] = tokens
        # Hint = time until admittable: a full bucket for oversized
        # requests, `weight` tokens otherwise.
        return (min(weight, self.burst) - tokens) / self.rate

    def refund(self, key: str, weight: float = 1.0) -> None:
        """Return tokens spent on an admission a LATER tier refused —
        one client exhausting its own bucket must not drain the shared
        tenant bucket for its neighbours."""
        bucket = self._buckets.get(key)
        if bucket is not None:
            bucket[0] = min(self.burst, bucket[0] + weight)

    #: Reservation ceiling: refusals reserve at most this many seconds of
    #: future capacity; beyond it the herd's own backoff takes over.
    RESERVE_HORIZON_S = 60.0

    def reserve(self, key: str, weight: float = 1.0
                ) -> tuple[float | None, bool]:
        """``try_consume`` whose refusal RESERVES a future admission slot
        (tokens go negative); returns ``(retry_hint, slot_reserved)``. A
        synchronized herd refused in one instant gets hints that ladder
        at the bucket's own drain rate — the N-th refusal waits ~N/rate —
        so honoring ``retry_after_s`` re-spreads the herd instead of
        re-colliding it one hint later (the thundering-herd property the
        reconnect-storm scenario asserts). The reservation tail is capped
        at ``RESERVE_HORIZON_S``; past it the hint stops growing, NOTHING
        is debited, and ``slot_reserved`` is False — callers must not
        treat such a refusal as claimable (an unbacked claim would admit
        for free later); client-side backoff carries the spread."""
        now = self._clock()
        bucket = self._bucket(key, now)
        tokens = min(self.burst,
                     bucket[0] + (now - bucket[1]) * self.rate)
        bucket[1] = now
        if tokens >= weight:
            bucket[0] = tokens - weight
            return None, False
        if tokens > -self.rate * self.RESERVE_HORIZON_S:
            bucket[0] = tokens - weight  # reserve the future slot
            return (weight - tokens) / self.rate, True
        return (weight - tokens) / self.rate, False  # horizon full


class AdmissionController:
    """Token-bucket admission control for the front doors and the
    batched tick ingress (the alfred/deli throttling seam of the
    reference, rebuilt burst-safe).

    Two tiers per op class — a per-tenant bucket shared by all of a
    tenant's clients and a per-client bucket — consumed in that order
    (with a tenant refund when only the client tier refuses). A refusal
    returns the ``retry_after_s`` hint the busy-nack carries.

    Shedding is DETERMINISTIC under queue pressure: hosts register
    pressure probes (0.0 = idle, 1.0 = inbound queue full); signals shed
    first (``SHED_SIGNALS_AT``), reads next (``SHED_READS_AT``), writes
    only when the queue is genuinely full or their own buckets refuse —
    signals/reads before writes, always in that order, so overload
    degrades the same way every time instead of by arrival race.
    """

    SHED_SIGNALS_AT = 0.50
    SHED_READS_AT = 0.75
    SHED_WRITES_AT = 1.00

    def __init__(self,
                 connect_rate_per_s: float = 100.0,
                 connect_burst: float | None = None,
                 write_rate_per_s: float = 100_000.0,
                 write_burst: float | None = None,
                 client_write_rate_per_s: float | None = None,
                 client_write_burst: float | None = None,
                 pressure_retry_s: float = 0.05,
                 clock=time.monotonic) -> None:
        self.connects = TokenBucket(connect_rate_per_s, connect_burst,
                                    clock=clock)
        self.writes = TokenBucket(write_rate_per_s, write_burst,
                                  clock=clock)
        # Per-client fairness tier: one hot client must not starve its
        # tenant's neighbours. Default = a quarter of the tenant budget.
        self.client_writes = TokenBucket(
            client_write_rate_per_s if client_write_rate_per_s is not None
            else max(1.0, write_rate_per_s / 4),
            client_write_burst, clock=clock)
        self.pressure_retry_s = pressure_retry_s
        self._clock = clock
        # Claimable connect reservations: (tenant, client) -> admission
        # time. A refused connect debits the tenant bucket ONCE
        # (TokenBucket.reserve) and the client claims that slot on
        # return — no re-debit, so the herd drains at exactly the
        # bucket rate instead of compounding its own debt.
        self._connect_reservations: dict[tuple[str, str], float] = {}
        self._probes: list = []
        self.stats = {"admitted_writes": 0, "shed_writes": 0,
                      "shed_reads": 0, "shed_signals": 0,
                      "shed_connects": 0}

    # -- queue-pressure probes -------------------------------------------------

    def add_pressure_probe(self, probe) -> None:
        """Register a 0..1 inbound-queue-fill callable (the storm
        controller's pending-doc ratio, a session's outbox depth, ...)."""
        self._probes.append(probe)

    def pressure(self) -> float:
        return max((float(p()) for p in self._probes), default=0.0)

    def _pressure_retry(self, pressure: float) -> float:
        # Deeper queues hint longer retries so retry waves spread out.
        return self.pressure_retry_s * max(1.0, 4.0 * pressure)

    # -- op classes ------------------------------------------------------------

    def admit_connect(self, tenant_id: str, client_key: str | None = None
                      ) -> float | None:
        """Connect admission (alfred throttles connects per tenant).
        Connects are control-plane: they shed on their bucket only, never
        on data-queue pressure (a full tick queue must not lock clients
        out of reattaching in read mode). Refusals RESERVE a future slot
        (TokenBucket.reserve, debited once) which the client CLAIMS by
        returning at/after its hint — so a reconnect storm's retries
        ladder out at exactly the drain rate instead of re-colliding and
        compounding debt."""
        if client_key is not None:
            rkey = (tenant_id, client_key)
            reserved_at = self._connect_reservations.get(rkey)
            if reserved_at is not None:
                wait = reserved_at - self._clock()
                if wait <= 1e-9:
                    del self._connect_reservations[rkey]
                    return None  # claiming the already-debited slot
                self.stats["shed_connects"] += 1
                return wait  # came back early; same slot stands
            if len(self._connect_reservations) > 4096:
                # Clients that never came back leave unclaimed entries;
                # sweep the long-expired ones so the controller built to
                # bound memory does not itself grow without bound.
                horizon = self._clock() - TokenBucket.RESERVE_HORIZON_S
                for key in [k for k, at in
                            self._connect_reservations.items()
                            if at < horizon]:
                    del self._connect_reservations[key]
        if client_key is None:
            # Keyless (legacy) clients cannot claim a reservation, so a
            # refusal must not RESERVE — each retry would re-debit the
            # shared tenant bucket into unclaimable compounding debt,
            # locking the whole tenant out.
            retry = self.connects.try_consume(f"tenant/{tenant_id}")
            if retry is not None:
                self.stats["shed_connects"] += 1
            return retry
        retry, reserved = self.connects.reserve(f"tenant/{tenant_id}")
        if retry is not None:
            # Tenant-tier refusal: record a claimable slot ONLY when
            # reserve() actually DEBITED one (a reservation without a
            # debit — horizon-full refusals included — would admit for
            # free at claim time, bypassing both buckets).
            if reserved:
                self._connect_reservations[rkey] = self._clock() + retry
            self.stats["shed_connects"] += 1
            return retry
        retry = self.connects.try_consume(f"client/{client_key}")
        if retry is not None:
            # Client-tier refusal: refund the tenant, record NOTHING
            # (nothing stayed debited); the client retries through
            # the normal path on its own backoff.
            self.connects.refund(f"tenant/{tenant_id}")
            self.stats["shed_connects"] += 1
        return retry

    def admit_write(self, tenant_id: str, client_id: str | None = None,
                    weight: float = 1.0) -> float | None:
        pressure = self.pressure()
        if pressure >= self.SHED_WRITES_AT:
            self.stats["shed_writes"] += 1
            return self._pressure_retry(pressure)
        retry = self.writes.try_consume(f"tenant/{tenant_id}", weight)
        if retry is None and client_id is not None:
            retry = self.client_writes.try_consume(
                f"client/{client_id}", weight)
            if retry is not None:
                self.writes.refund(f"tenant/{tenant_id}", weight)
        if retry is not None:
            self.stats["shed_writes"] += 1
            return retry
        self.stats["admitted_writes"] += 1
        return None

    def admit_read(self, tenant_id: str) -> float | None:
        pressure = self.pressure()
        if pressure >= self.SHED_READS_AT:
            self.stats["shed_reads"] += 1
            return self._pressure_retry(pressure)
        return None

    def admit_signal(self, tenant_id: str) -> float | None:
        pressure = self.pressure()
        if pressure >= self.SHED_SIGNALS_AT:
            self.stats["shed_signals"] += 1
            return self._pressure_retry(pressure)
        return None
