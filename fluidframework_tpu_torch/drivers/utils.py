"""Driver plumbing shared by all backends: error classification and
retry/backoff.

Reference parity: packages/loader/driver-utils — ``NetworkErrorBasic`` /
error classification (networkUtils.ts) and ``runWithRetry`` with
exponential backoff (runWithRetry.ts). The reference retries anything the
driver marks ``canRetry``; deli's clientSeqNumber dedup makes re-sent ops
idempotent, so retrying submits is safe.
"""

from __future__ import annotations

import time
from typing import Any, Callable, TypeVar

T = TypeVar("T")


class DriverError(Exception):
    """Base driver error. ``can_retry`` drives runWithRetry;``retry_after_s``
    is the server-suggested delay (throttling NACKs)."""

    def __init__(self, message: str, can_retry: bool = False,
                 retry_after_s: float | None = None) -> None:
        super().__init__(message)
        self.can_retry = can_retry
        self.retry_after_s = retry_after_s


class NetworkError(DriverError):
    """Transient transport failure — always retriable."""

    def __init__(self, message: str,
                 retry_after_s: float | None = None) -> None:
        super().__init__(message, can_retry=True,
                         retry_after_s=retry_after_s)


class AuthorizationError(DriverError):
    """401/403 — never retriable without a new token."""

    def __init__(self, message: str) -> None:
        super().__init__(message, can_retry=False)


class ThrottlingError(DriverError):
    """429 — retriable after the server-given delay."""

    def __init__(self, message: str, retry_after_s: float) -> None:
        super().__init__(message, can_retry=True,
                         retry_after_s=retry_after_s)


class DocumentMovedError(DriverError):
    """Connect-time redirect (live cluster migration): the doc is served
    by ``moved_to`` — redial THAT host, don't retry this one."""

    def __init__(self, message: str, moved_to: str,
                 retry_after_s: float = 0.0) -> None:
        super().__init__(message, can_retry=True,
                         retry_after_s=retry_after_s)
        self.moved_to = moved_to


class ReconnectPolicy:
    """Reconnect pacing: exponential backoff with full jitter, honoring
    server ``retry_after_s`` hints (deltaManager.ts reconnect delays +
    the NACK retryAfter contract).

    ``next_delay(attempt, retry_after_s)`` is pure given the seeded rng:
    ``min(max_s, base * mult^attempt)`` scaled into ``[1-jitter, 1]`` of
    itself, then floored at the server hint (the hint is a promise the
    server will still be busy sooner — honoring it keeps the retry from
    being sheddable-on-arrival). Jitter is what dissolves a reconnect
    storm: 1k clients killed at the same instant spread their N-th
    retries over ``jitter * backoff`` rather than re-converging on one
    tick. Seed per client (e.g. a hash of the client id) for determinism
    in tests and simulation."""

    def __init__(self, base_s: float = 0.1, max_s: float = 30.0,
                 multiplier: float = 2.0, jitter: float = 0.5,
                 seed: int | None = None) -> None:
        import random
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        self.base_s = base_s
        self.max_s = max_s
        self.multiplier = multiplier
        self.jitter = jitter
        self._rng = random.Random(seed)

    def next_delay(self, attempt: int,
                   retry_after_s: float | None = None) -> float:
        raw = min(self.max_s, self.base_s * self.multiplier ** attempt)
        delay = raw * (1.0 - self.jitter * self._rng.random())
        if retry_after_s is not None:
            # Honor the hint as a FLOOR, keeping this client's jitter on
            # top — everyone nacked in the same window must not all come
            # back exactly retry_after_s later.
            delay = retry_after_s + delay
        return delay


def run_with_retry(fn: Callable[[], T], *, max_retries: int = 5,
                   base_delay_s: float = 0.05, max_delay_s: float = 8.0,
                   retriable: tuple[type[BaseException], ...]
                   = (ConnectionError, OSError, TimeoutError),
                   sleep: Callable[[float], Any] = time.sleep) -> T:
    """Exponential backoff around a transient-failure-prone call
    (driver-utils runWithRetry). DriverError honors can_retry and
    retry_after_s; the listed exception types always retry."""
    attempt = 0
    while True:
        try:
            return fn()
        except DriverError as err:
            if not err.can_retry or attempt >= max_retries:
                raise
            delay = err.retry_after_s if err.retry_after_s is not None \
                else min(max_delay_s, base_delay_s * (2 ** attempt))
        except retriable:
            if attempt >= max_retries:
                raise
            delay = min(max_delay_s, base_delay_s * (2 ** attempt))
        attempt += 1
        sleep(delay)
