"""ctypes binding for the C++ op-stream shuttle (shuttle.cpp).

The shuttle is the in-memory broker between the front door and the lambda
workers: topics partitioned by key (crc32, identical to
server.bus.partition_for), per-consumer-group committed offsets,
at-least-once delivery. server/native_bus.py wraps this in the MessageBus
object model; when the toolchain is unavailable callers fall back to the
pure-Python bus.
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path

from ._loader import build_and_load

_SRC = Path(__file__).parent / "shuttle.cpp"
_configured: ctypes.CDLL | None = None


def _load_library() -> ctypes.CDLL | None:
    global _configured
    if _configured is not None:
        return _configured
    lib = build_and_load("shuttle", _SRC, extra_flags=("-lz",))
    if lib is None:
        return None
    lib.shuttle_create.restype = ctypes.c_void_p
    lib.shuttle_create.argtypes = [ctypes.c_int]
    lib.shuttle_num_partitions.restype = ctypes.c_int
    lib.shuttle_num_partitions.argtypes = [ctypes.c_void_p]
    lib.shuttle_produce.restype = ctypes.c_int64
    lib.shuttle_produce.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_int)]
    lib.shuttle_count.restype = ctypes.c_int64
    lib.shuttle_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.shuttle_read_size.restype = ctypes.c_int64
    lib.shuttle_read_size.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int64, ctypes.c_int64]
    lib.shuttle_read.restype = ctypes.c_int64
    lib.shuttle_read.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_char_p, ctypes.c_int64]
    lib.shuttle_committed.restype = ctypes.c_int64
    lib.shuttle_committed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_int]
    lib.shuttle_commit.restype = ctypes.c_int
    lib.shuttle_commit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int, ctypes.c_int64]
    lib.shuttle_destroy.restype = None
    lib.shuttle_destroy.argtypes = [ctypes.c_void_p]
    _configured = lib
    return _configured


def shuttle_available() -> bool:
    return _load_library() is not None


class Shuttle:
    """One topic: partitioned append-only record streams in C++."""

    def __init__(self, num_partitions: int) -> None:
        lib = _load_library()
        if lib is None:
            raise OSError("native shuttle unavailable (no toolchain)")
        self._lib = lib
        self._handle = lib.shuttle_create(num_partitions)
        if not self._handle:
            raise OSError("shuttle_create failed")

    @property
    def num_partitions(self) -> int:
        return self._lib.shuttle_num_partitions(self._handle)

    def produce(self, key: bytes, payload: bytes) -> tuple[int, int]:
        partition = ctypes.c_int(-1)
        offset = self._lib.shuttle_produce(
            self._handle, key, len(key), payload, len(payload),
            ctypes.byref(partition))
        if offset < 0:
            raise OSError("shuttle_produce failed")
        return partition.value, int(offset)

    def count(self, partition: int) -> int:
        return int(self._lib.shuttle_count(self._handle, partition))

    def read(self, partition: int, from_offset: int,
             max_messages: int | None = None) -> list[tuple[bytes, bytes]]:
        # Snapshot the record count FIRST and pass it as the limit to both
        # calls: a concurrent produce between size and fill (socket thread
        # vs pump thread) must not grow the fill past the sized buffer.
        count = self.count(partition)
        if count < 0:
            raise IndexError(partition)
        limit = count - from_offset
        if max_messages is not None:
            limit = min(limit, max_messages)
        if limit <= 0:
            return []
        size = self._lib.shuttle_read_size(self._handle, partition,
                                           from_offset, limit)
        if size <= 0:
            return []
        buf = ctypes.create_string_buffer(int(size))
        n = self._lib.shuttle_read(self._handle, partition, from_offset,
                                   limit, buf, size)
        if n < 0:
            raise OSError("shuttle_read failed")
        out: list[tuple[bytes, bytes]] = []
        raw = buf.raw
        pos = 0
        for _ in range(int(n)):
            # "=I" = native order, matching shuttle.cpp's memcpy framing.
            klen = struct.unpack_from("=I", raw, pos)[0]
            pos += 4
            key = raw[pos:pos + klen]
            pos += klen
            plen = struct.unpack_from("=I", raw, pos)[0]
            pos += 4
            out.append((key, raw[pos:pos + plen]))
            pos += plen
        return out

    def committed(self, group: str, partition: int) -> int:
        return int(self._lib.shuttle_committed(self._handle,
                                               group.encode(), partition))

    def commit(self, group: str, partition: int, next_offset: int) -> None:
        self._lib.shuttle_commit(self._handle, group.encode(), partition,
                                 next_offset)

    def close(self) -> None:
        if self._handle:
            self._lib.shuttle_destroy(self._handle)
            self._handle = None

    def __del__(self) -> None:  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass
