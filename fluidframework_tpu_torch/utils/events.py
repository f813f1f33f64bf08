"""Event/async primitives shared across the stack.

Reference parity: common/lib/common-utils — ``TypedEventEmitter``
(typedEventEmitter.ts), ``Deferred``/``LazyPromise`` (promises.ts),
``BatchManager`` (batchManager.ts), ``Heap`` (heap.ts). Python needs no
promise machinery, so Deferred collapses to a set-once result latch.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, Generic, TypeVar

T = TypeVar("T")


class TypedEventEmitter:
    """Minimal synchronous emitter: on/once/off/emit by event name.

    Listener errors propagate to the emitter (the reference crashes the
    container on listener throw — error containment is the caller's job).
    """

    def __init__(self) -> None:
        self._listeners: dict[str, list[Callable[..., None]]] = {}
        self._once: dict[str, set[Callable[..., None]]] = {}

    def on(self, event: str, listener: Callable[..., None]) -> Callable[[], None]:
        self._listeners.setdefault(event, []).append(listener)
        return lambda: self.off(event, listener)

    def once(self, event: str, listener: Callable[..., None]) -> None:
        self.on(event, listener)
        self._once.setdefault(event, set()).add(listener)

    def off(self, event: str, listener: Callable[..., None]) -> None:
        listeners = self._listeners.get(event, [])
        if listener in listeners:
            listeners.remove(listener)
        self._once.get(event, set()).discard(listener)

    def emit(self, event: str, *args: Any, **kwargs: Any) -> int:
        listeners = list(self._listeners.get(event, []))
        for listener in listeners:
            if listener in self._once.get(event, set()):
                self.off(event, listener)
            listener(*args, **kwargs)
        return len(listeners)

    def listener_count(self, event: str) -> int:
        return len(self._listeners.get(event, []))


class Deferred(Generic[T]):
    """Set-once result latch (common-utils promises.ts ``Deferred``)."""

    _UNSET = object()

    def __init__(self) -> None:
        self._value: Any = Deferred._UNSET
        self._error: BaseException | None = None
        self._callbacks: list[tuple[Callable[[T], None],
                                    Callable[[BaseException], None] | None]] \
            = []

    @property
    def is_completed(self) -> bool:
        return self._value is not Deferred._UNSET or self._error is not None

    def resolve(self, value: T) -> None:
        if self.is_completed:
            return
        self._value = value
        for cb, _ in self._callbacks:
            cb(value)
        self._callbacks.clear()

    def reject(self, error: BaseException) -> None:
        if self.is_completed:
            return
        self._error = error
        for _, on_error in self._callbacks:
            if on_error is not None:
                on_error(error)
        self._callbacks.clear()

    def then(self, callback: Callable[[T], None],
             on_error: Callable[[BaseException], None] | None = None) -> None:
        if self._value is not Deferred._UNSET:
            callback(self._value)
        elif self._error is not None:
            if on_error is not None:
                on_error(self._error)
        else:
            self._callbacks.append((callback, on_error))

    @property
    def value(self) -> T:
        if self._error is not None:
            raise self._error
        if self._value is Deferred._UNSET:
            raise RuntimeError("Deferred not resolved")
        return self._value


class BatchManager(Generic[T]):
    """Accumulate items per key and flush as batches
    (common-utils batchManager.ts; used by the reference's delta connection
    to coalesce outbound ops into one socket emit).
    """

    def __init__(self, process: Callable[[str, list[T]], None],
                 max_batch_size: int = 100) -> None:
        self._process = process
        self._max = max_batch_size
        self._pending: dict[str, list[T]] = {}

    def add(self, key: str, item: T) -> None:
        batch = self._pending.setdefault(key, [])
        batch.append(item)
        if len(batch) >= self._max:
            self.drain(key)

    def drain(self, key: str | None = None) -> None:
        keys = [key] if key is not None else list(self._pending)
        for k in keys:
            batch = self._pending.pop(k, [])
            if batch:
                self._process(k, batch)


class Heap(Generic[T]):
    """Min-heap with explicit comparison key (common-utils heap.ts).

    The reference uses it for MSN tracking and timer wheels; here it backs
    the delta scheduler and summarizer heuristics.
    """

    def __init__(self, key: Callable[[T], Any] = lambda x: x) -> None:
        self._key = key
        self._items: list[tuple[Any, int, T]] = []
        self._counter = 0  # tie-break, keeps heapq away from T comparisons

    def __len__(self) -> int:
        return len(self._items)

    def push(self, item: T) -> None:
        self._counter += 1
        heapq.heappush(self._items, (self._key(item), self._counter, item))

    def peek(self) -> T:
        return self._items[0][2]

    def pop(self) -> T:
        return heapq.heappop(self._items)[2]
