"""ctypes binding for the C++ fan-out service (fanout.cpp).

The fan-out is the broadcast hop between the broadcaster lambda and the
connection frontends — the Redis-pub/sub + redisSocketIoAdapter analog
(SURVEY.md §2.9 row 3). Rooms are documents; ``publish`` appends the
payload to every room member's queue; each frontend drains its
subscriber's queue. ``make_fanout`` returns the native implementation
when the toolchain is available and falls back to a pure-Python twin
with the identical surface otherwise.
"""

from __future__ import annotations

import ctypes
from collections import deque
from pathlib import Path

from ._loader import build_and_load

_SRC = Path(__file__).parent / "fanout.cpp"
_configured: ctypes.CDLL | None = None

#: Slow-consumer bound, mirrored in fanout.cpp's kMaxQueue.
MAX_QUEUE = 65536


def _load_library() -> ctypes.CDLL | None:
    global _configured
    if _configured is not None:
        return _configured
    lib = build_and_load("fanout", _SRC)
    if lib is None:
        return None
    lib.fanout_create.restype = ctypes.c_void_p
    lib.fanout_destroy.argtypes = [ctypes.c_void_p]
    lib.fanout_connect.restype = ctypes.c_int64
    lib.fanout_connect.argtypes = [ctypes.c_void_p]
    lib.fanout_disconnect.restype = ctypes.c_int
    lib.fanout_disconnect.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    for name in ("fanout_join", "fanout_leave"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_char_p, ctypes.c_uint32]
    lib.fanout_publish.restype = ctypes.c_int64
    lib.fanout_publish.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_uint32]
    lib.fanout_publish_batch.restype = ctypes.c_int64
    lib.fanout_publish_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
    lib.fanout_pending.restype = ctypes.c_int64
    lib.fanout_pending.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.fanout_next_size.restype = ctypes.c_int64
    lib.fanout_next_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.fanout_poll.restype = ctypes.c_int64
    lib.fanout_poll.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_char_p, ctypes.c_int64]
    lib.fanout_delivered_total.restype = ctypes.c_int64
    lib.fanout_delivered_total.argtypes = [ctypes.c_void_p]
    lib.fanout_was_evicted.restype = ctypes.c_int
    lib.fanout_was_evicted.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.fanout_set_queue_limit.restype = ctypes.c_int
    lib.fanout_set_queue_limit.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                           ctypes.c_int64]
    lib.fanout_room_size.restype = ctypes.c_int64
    lib.fanout_room_size.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_uint32]
    lib.fanout_room_count.restype = ctypes.c_int64
    lib.fanout_room_count.argtypes = [ctypes.c_void_p]
    lib.fanout_poll_batch.restype = ctypes.c_int64
    lib.fanout_poll_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_char), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    _configured = lib
    return _configured


class NativeFanout:
    """Pub/sub rooms backed by the C++ library."""

    is_native = True

    def __init__(self, lib: ctypes.CDLL) -> None:
        self._lib = lib
        self._handle = lib.fanout_create()
        # Thread-local scratch for the poll() fast path: one FFI call
        # per message in the common (small-payload) case instead of a
        # next_size + poll pair — the 100k-viewer drain is poll-bound.
        import threading
        self._tls = threading.local()

    def __del__(self) -> None:
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.fanout_destroy(handle)
            self._handle = None

    def connect(self) -> int:
        return int(self._lib.fanout_connect(self._handle))

    def disconnect(self, sub: int) -> None:
        self._lib.fanout_disconnect(self._handle, sub)

    def join(self, sub: int, room: str) -> None:
        key = room.encode()
        if self._lib.fanout_join(self._handle, sub, key, len(key)) != 0:
            raise KeyError(f"unknown subscriber {sub}")

    def leave(self, sub: int, room: str) -> None:
        key = room.encode()
        self._lib.fanout_leave(self._handle, sub, key, len(key))

    def publish(self, room: str, payload: bytes) -> int:
        key = room.encode()
        return int(self._lib.fanout_publish(self._handle, key, len(key),
                                            payload, len(payload)))

    def publish_batch(self, items) -> int:
        """Publish many (room, payload) pairs in ONE native call — the
        O(batch) broadcast hop of a serving tick (one lock, one FFI
        round trip, however many documents the tick touched)."""
        if not items:
            return 0
        import struct as _struct

        pack = _struct.Struct("<I").pack
        parts: list[bytes] = []
        for room, payload in items:
            key = room.encode()
            parts += (pack(len(key)), key, pack(len(payload)), payload)
        buf = b"".join(parts)
        delivered = int(self._lib.fanout_publish_batch(
            self._handle, buf, len(buf), len(items)))
        if delivered < 0:  # -1 = record framing bug; never return it as
            raise ValueError("malformed publish batch")  # a count
        return delivered

    def pending(self, sub: int) -> int:
        return max(0, int(self._lib.fanout_pending(self._handle, sub)))

    def poll(self, sub: int) -> bytes | None:
        # Fast path: poll straight into the thread-local scratch (one
        # FFI round trip); payloads over the scratch size fall back to
        # the exact-size loop below.
        scratch = getattr(self._tls, "buf", None)
        if scratch is None:
            scratch = self._tls.buf = ctypes.create_string_buffer(1 << 17)
        written = self._lib.fanout_poll(self._handle, sub, scratch,
                                        len(scratch))
        if written >= 0:
            # string_at copies exactly `written` bytes (scratch.raw
            # would copy the whole scratch first).
            return ctypes.string_at(scratch, int(written))
        if written != -2:  # -1 unknown sub, -3 empty queue
            return None
        size = self._lib.fanout_next_size(self._handle, sub)
        if size < 0:  # -1 unknown sub, -2 empty queue
            return None
        while True:
            # size may be 0 (empty payloads are legal and must still drain).
            buf = ctypes.create_string_buffer(max(int(size), 1))
            written = self._lib.fanout_poll(self._handle, sub, buf, len(buf))
            if written == -2:
                # Head grew between next_size and poll (another producer
                # appended and a concurrent consumer popped): the message
                # is retained — re-size and retry rather than wedging.
                size = self._lib.fanout_next_size(self._handle, sub)
                if size < 0:
                    return None
                continue
            if written < 0:  # -1 unknown sub, -3 drained meanwhile
                return None
            return buf.raw[:written]

    def was_evicted(self, sub: int) -> bool:
        return bool(self._lib.fanout_was_evicted(self._handle, sub))

    def delivered_total(self) -> int:
        return int(self._lib.fanout_delivered_total(self._handle))

    def set_queue_limit(self, sub: int, n: int | None) -> None:
        """Per-subscriber slow-consumer bound (None restores the shared
        default) — the per-connection-class eviction point: viewers
        lag-drop at a shallow queue, writers keep the deep default."""
        if self._lib.fanout_set_queue_limit(self._handle, sub,
                                            0 if n is None else n) != 0:
            raise KeyError(f"unknown subscriber {sub}")

    def room_size(self, room: str) -> int:
        key = room.encode()
        return int(self._lib.fanout_room_size(self._handle, key, len(key)))

    def room_count(self) -> int:
        return int(self._lib.fanout_room_count(self._handle))

    def poll_batch(self, subs) -> tuple[memoryview, "object"]:
        """Pop the head message of every subscriber in ``subs`` (an
        int64 numpy array) in ONE native call. Returns ``(buf, lens)``:
        payloads packed contiguously in ``buf`` in subscriber order;
        ``lens[i]`` is the payload byte length, -1 = empty queue, -2 =
        unknown/evicted subscriber. The big-room frontend drain — FFI
        cost O(1) per call instead of O(members). The returned view
        aliases a REUSED thread-local scratch (allocating + zeroing a
        fresh MB per call would dominate the drain loop): it is valid
        only until this thread's next poll_batch — copy what you keep."""
        import numpy as np

        subs = np.ascontiguousarray(subs, np.int64)
        n = len(subs)
        lens = np.empty(n, np.int64)
        subs_p = subs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        lens_p = lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        buf = getattr(self._tls, "batch_buf", None)
        if buf is None:
            buf = self._tls.batch_buf = ctypes.create_string_buffer(
                1 << 20)
        while True:
            got = int(self._lib.fanout_poll_batch(
                self._handle, subs_p, n, buf, len(buf), lens_p))
            if got >= 0:
                return memoryview(buf)[:got], lens
            # Nothing was popped; grow the scratch to the exact need
            # (kept for later calls) and retry.
            buf = self._tls.batch_buf = ctypes.create_string_buffer(-got)


class PyFanout:
    """Pure-Python twin (toolchain-free fallback; identical surface)."""

    is_native = False

    def __init__(self) -> None:
        self._next = 1
        self._queues: dict[int, deque[bytes]] = {}
        self._rooms: dict[str, set[int]] = {}
        self._memberships: dict[int, set[str]] = {}
        self._limits: dict[int, int] = {}
        self._delivered = 0
        self._evicted: set[int] = set()

    def connect(self) -> int:
        sub = self._next
        self._next += 1
        self._queues[sub] = deque()
        return sub

    def disconnect(self, sub: int) -> None:
        for room in self._memberships.pop(sub, set()):
            members = self._rooms.get(room)
            if members is not None:
                members.discard(sub)
                if not members:
                    del self._rooms[room]
        self._queues.pop(sub, None)
        self._limits.pop(sub, None)
        self._evicted.discard(sub)

    def join(self, sub: int, room: str) -> None:
        if sub not in self._queues:
            raise KeyError(f"unknown subscriber {sub}")
        self._rooms.setdefault(room, set()).add(sub)
        self._memberships.setdefault(sub, set()).add(room)

    def leave(self, sub: int, room: str) -> None:
        members = self._rooms.get(room)
        if members is not None:
            members.discard(sub)
            if not members:  # empty-room reclamation, as in fanout.cpp
                del self._rooms[room]
        self._memberships.get(sub, set()).discard(room)

    def publish(self, room: str, payload: bytes) -> int:
        count = 0
        over = []
        for sub in self._rooms.get(room, ()):  # set order is fine: queues
            if len(self._queues[sub]) >= self._limits.get(sub, MAX_QUEUE):
                over.append(sub)
                continue
            self._queues[sub].append(payload)  # are per-subscriber FIFO
            count += 1
        for sub in over:  # slow-consumer eviction, mirroring fanout.cpp
            self.disconnect(sub)
            self._evicted.add(sub)
        self._delivered += count
        return count

    def publish_batch(self, items) -> int:
        return sum(self.publish(room, payload) for room, payload in items)

    def pending(self, sub: int) -> int:
        return len(self._queues.get(sub, ()))

    def poll(self, sub: int) -> bytes | None:
        queue = self._queues.get(sub)
        if not queue:
            return None
        return queue.popleft()

    def was_evicted(self, sub: int) -> bool:
        return sub in self._evicted

    def delivered_total(self) -> int:
        return self._delivered

    def set_queue_limit(self, sub: int, n: int | None) -> None:
        if sub not in self._queues:
            raise KeyError(f"unknown subscriber {sub}")
        if n is None or n <= 0:
            self._limits.pop(sub, None)
        else:
            self._limits[sub] = n

    def room_size(self, room: str) -> int:
        return len(self._rooms.get(room, ()))

    def room_count(self) -> int:
        return len(self._rooms)

    def poll_batch(self, subs):
        """Batched head-pop over many subscribers (NativeFanout twin):
        (packed payload view, per-sub lengths with -1 empty / -2
        unknown). CONTRACT (shared with the native impl, whose view
        aliases a reused scratch): the returned view is only valid
        until this thread's next poll_batch — copy what you keep."""
        import numpy as np

        lens = np.empty(len(subs), np.int64)
        parts: list[bytes] = []
        for i, sub in enumerate(subs):
            queue = self._queues.get(int(sub))
            if queue is None:
                lens[i] = -2
            elif not queue:
                lens[i] = -1
            else:
                payload = queue.popleft()
                parts.append(payload)
                lens[i] = len(payload)
        return memoryview(b"".join(parts)), lens


def make_fanout(force_python: bool = False):
    """Native fan-out when buildable, Python twin otherwise."""
    if not force_python:
        lib = _load_library()
        if lib is not None:
            return NativeFanout(lib)
    return PyFanout()
