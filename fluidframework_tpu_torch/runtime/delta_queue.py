"""DeltaQueue — pausable single-consumer FIFO.

Reference parity: packages/loader/container-loader/src/deltaQueue.ts:10.
Pausing is the test-orchestration primitive the reference uses for
deterministic op interleaving (test-utils OpProcessingController).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Generic, TypeVar

T = TypeVar("T")


class DeltaQueue(Generic[T]):
    def __init__(self, handler: Callable[[T], None],
                 scheduler: "DeltaScheduler | None" = None) -> None:
        self._handler = handler
        self._queue: deque[T] = deque()
        self._pause_count = 1  # starts paused; resume() when connected
        self._processing = False
        self.scheduler = scheduler

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def paused(self) -> bool:
        return self._pause_count > 0

    def push(self, item: T) -> None:
        self._queue.append(item)
        self._drain()

    def pause(self) -> None:
        self._pause_count += 1

    def resume(self) -> None:
        assert self._pause_count > 0, "resume without matching pause"
        self._pause_count -= 1
        self._drain()

    def clear(self) -> None:
        """Drop all queued items (outbound teardown on disconnect: pending
        ops resubmit with fresh clientSeqNumbers, never the stale batches)."""
        self._queue.clear()

    def process_one(self) -> bool:
        """Process a single item regardless of pause state (test stepping)."""
        if not self._queue:
            return False
        self._handler(self._queue.popleft())
        return True

    def _drain(self) -> None:
        if self._processing:
            return
        self._processing = True
        try:
            if self.scheduler is not None:
                self.scheduler.on_drain_start(len(self._queue))
            processed = 0
            while self._queue and not self.paused:
                self._handler(self._queue.popleft())
                processed += 1
                if self.scheduler is not None:
                    self.scheduler.on_processed(processed, len(self._queue))
        finally:
            self._processing = False


class DeltaScheduler:
    """Inbound catch-up yielding (container-runtime deltaScheduler.ts:25).

    The reference interrupts a long synchronous inbound drain so the JS
    thread can paint. The Python analog: after each ``batch_size`` ops in
    one drain, the registered ``on_yield`` callbacks run (host event
    pumps, progress UI, watchdog kicks) before processing continues."""

    DEFAULT_BATCH = 64

    def __init__(self, batch_size: int = DEFAULT_BATCH) -> None:
        self.batch_size = batch_size
        self.on_yield: list[Callable[[int, int], None]] = []
        self.catch_up_drains = 0  # drains that started with a deep queue

    def on_drain_start(self, queued: int) -> None:
        if queued > self.batch_size:
            self.catch_up_drains += 1

    def on_processed(self, processed: int, remaining: int) -> None:
        if processed % self.batch_size == 0 and remaining:
            for cb in self.on_yield:
                cb(processed, remaining)
