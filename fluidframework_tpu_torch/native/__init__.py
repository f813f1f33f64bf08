"""Native runtime components (C++): the CRC-framed append-only record
log, the partition-log message bus and the broadcast fan-out service.

Reference parity: SURVEY.md §2.9 — the reference's server leans on native
code for its transport/storage hot paths (librdkafka for the ordering
bus, MongoDB for the durable op log, libgit2 for snapshots, Redis
pub/sub for broadcast). Here each is a C++ file compiled with g++ on
first use into the package's git-ignored ``_build/native/`` (named by a
hash of the source) and bound via ctypes:

* ``oplog.cpp`` (this module's ``OpLog``) — a CRC-framed append-only
  record log; server/durable_store.py builds the durable bus, state
  store, group-commit WAL and snapshot store on top of it;
* ``shuttle.cpp`` (``shuttle.py``) — partition logs with crc32 key
  partitioning and consumer-group offsets, under
  server/native_bus.py's ``NativeMessageBus``;
* ``fanout.cpp`` (``fanout.py``) — rooms, per-subscriber queues with a
  bound, and batched publishes, under server/broadcaster.py's viewer
  plane.

Each picks the C++ implementation when the toolchain is available and
otherwise the reference's own pure-Python twin of the same behaviour
(not a device fallback): ``OpLog`` writes the IDENTICAL file format, so
logs are portable between the two — and between this package and
``fluidframework_tpu``.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib
from pathlib import Path

from ._loader import build_and_load

_SRC = Path(__file__).parent / "oplog.cpp"
_configured: ctypes.CDLL | None = None


def _load_library() -> ctypes.CDLL | None:
    global _configured
    if _configured is not None:
        return _configured
    lib = build_and_load("oplog", _SRC, extra_flags=("-lz",))
    if lib is None:
        return None
    lib.oplog_open.restype = ctypes.c_void_p
    lib.oplog_open.argtypes = [ctypes.c_char_p]
    lib.oplog_count.restype = ctypes.c_long
    lib.oplog_count.argtypes = [ctypes.c_void_p]
    lib.oplog_append.restype = ctypes.c_long
    lib.oplog_append.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_uint32]
    lib.oplog_sync.restype = ctypes.c_int
    lib.oplog_sync.argtypes = [ctypes.c_void_p]
    lib.oplog_read_len.restype = ctypes.c_long
    lib.oplog_read_len.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.oplog_read.restype = ctypes.c_long
    lib.oplog_read.argtypes = [ctypes.c_void_p, ctypes.c_long,
                               ctypes.c_char_p, ctypes.c_uint32]
    lib.oplog_close.restype = None
    lib.oplog_close.argtypes = [ctypes.c_void_p]
    _configured = lib
    return _configured


class _NativeOpLog:
    def __init__(self, path: str) -> None:
        lib = _load_library()
        assert lib is not None
        self._lib = lib
        self._handle = lib.oplog_open(path.encode())
        if not self._handle:
            raise OSError(f"oplog_open failed: {path}")

    def __len__(self) -> int:
        return self._lib.oplog_count(self._handle)

    def append(self, data: bytes) -> int:
        idx = self._lib.oplog_append(self._handle, data, len(data))
        if idx < 0:
            raise OSError("oplog_append failed")
        return idx

    def read(self, index: int) -> bytes:
        length = self._lib.oplog_read_len(self._handle, index)
        if length < 0:
            raise IndexError(index)
        buf = ctypes.create_string_buffer(length)
        got = self._lib.oplog_read(self._handle, index, buf, length)
        if got != length:
            raise OSError("oplog_read failed")
        return buf.raw

    def sync(self) -> None:
        # A swallowed -1 here would be catastrophic: the group-commit
        # writer would advance the durability watermark (and release
        # withheld acks) over bytes that never reached disk, and the
        # WAL fsync circuit breaker could never open on a real failure.
        if self._lib.oplog_sync(self._handle) < 0:
            raise OSError("oplog_sync (fdatasync) failed")

    def close(self) -> None:
        if self._handle:
            self._lib.oplog_close(self._handle)
            self._handle = None


class _PythonOpLog:
    """Same file format as oplog.cpp ([u32 len][u32 crc32][payload] LE),
    including torn-tail truncation on open."""

    def __init__(self, path: str) -> None:
        self._path = path
        self._index: list[tuple[int, int]] = []  # (payload offset, len)
        self._fh = open(path, "a+b")
        self._fh.seek(0, os.SEEK_END)
        size = self._fh.tell()
        pos = 0
        while pos + 8 <= size:
            self._fh.seek(pos)
            header = self._fh.read(8)
            length, crc = struct.unpack("<II", header)
            if pos + 8 + length > size:
                break
            payload = self._fh.read(length)
            if len(payload) != length or zlib.crc32(payload) != crc:
                break
            self._index.append((pos + 8, length))
            pos += 8 + length
        if pos < size:
            self._fh.truncate(pos)
        self._end = pos

    def __len__(self) -> int:
        return len(self._index)

    def append(self, data: bytes) -> int:
        self._fh.seek(self._end)
        self._fh.write(struct.pack("<II", len(data), zlib.crc32(data)))
        self._fh.write(data)
        self._fh.flush()
        self._index.append((self._end + 8, len(data)))
        self._end += 8 + len(data)
        return len(self._index) - 1

    def read(self, index: int) -> bytes:
        offset, length = self._index[index]
        self._fh.seek(offset)
        return self._fh.read(length)

    def sync(self) -> None:
        self._fh.flush()
        os.fdatasync(self._fh.fileno())

    def close(self) -> None:
        self._fh.close()


def OpLog(path: str | os.PathLike):
    """Open (creating if missing) an append-only record log."""
    if _load_library() is not None:
        return _NativeOpLog(str(path))
    return _PythonOpLog(str(path))


def native_available() -> bool:
    return _load_library() is not None
