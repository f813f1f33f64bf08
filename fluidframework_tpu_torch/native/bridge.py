"""ctypes binding for the C++ front-door socket bridge (bridge.cpp).

The bridge owns every socket: accept, framed reads, framed writes — the
native transport layer of SURVEY.md §2.9/§5.8 (the libuv/ws analog under
alfred). Python pumps decoded events and pushes response bodies; framing
never crosses the boundary. g++ builds ``bridge.cpp`` at first use into
the package's git-ignored ``_build/native/``, named by a hash of the
source (``_loader.py``). :func:`start_bridge` returns ``None`` when the
toolchain is unavailable; ``server/bridge_host.BridgeFrontDoor`` then
raises rather than serving through another door.
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path

from ._loader import build_and_load

_SRC = Path(__file__).parent / "bridge.cpp"
_configured: ctypes.CDLL | None = None

EV_OPEN = 0
EV_DATA = 1
EV_CLOSE = 2


def _load_library() -> ctypes.CDLL | None:
    global _configured
    if _configured is not None:
        return _configured
    lib = build_and_load("bridge", _SRC)
    if lib is None:
        return None
    lib.bridge_start.restype = ctypes.c_void_p
    lib.bridge_start.argtypes = [ctypes.c_int]
    lib.bridge_port.restype = ctypes.c_int
    lib.bridge_port.argtypes = [ctypes.c_void_p]
    lib.bridge_next_size.restype = ctypes.c_int64
    lib.bridge_next_size.argtypes = [ctypes.c_void_p]
    lib.bridge_poll.restype = ctypes.c_int64
    # POINTER(c_char) (not c_char_p): poll fills a caller-owned bytearray
    # so the event body can be returned as a zero-copy memoryview.
    lib.bridge_poll.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_char),
                                ctypes.c_int64]
    lib.bridge_poll_wait.restype = ctypes.c_int64
    lib.bridge_poll_wait.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bridge_send.restype = ctypes.c_int
    lib.bridge_send.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_char_p, ctypes.c_uint32]
    lib.bridge_set_max_outbox.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.bridge_set_conn_max_outbox.restype = ctypes.c_int
    lib.bridge_set_conn_max_outbox.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
    lib.bridge_close.restype = ctypes.c_int
    lib.bridge_close.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.bridge_stop.argtypes = [ctypes.c_void_p]
    _configured = lib
    return _configured


class NativeBridge:
    """Framed-TCP server; poll() yields (conn_id, kind, body bytes)."""

    def __init__(self, lib: ctypes.CDLL, handle: int) -> None:
        self._lib = lib
        self._handle = handle
        self.port = int(lib.bridge_port(handle))

    def poll(self, wait_ms: int = 0) -> tuple[int, int, memoryview] | None:
        """Pop the next event; with wait_ms > 0 block until one arrives
        (condition variable in the C++ side — no busy polling). The body
        is a memoryview over the event's own buffer: the storm ingress
        path parses it IN PLACE (codec.decode_storm_body →
        StormController.submit_frame) with no further Python-level
        copies."""
        if not self._handle:
            return None
        if wait_ms > 0:
            size = self._lib.bridge_poll_wait(self._handle, wait_ms)
        else:
            size = self._lib.bridge_next_size(self._handle)
        if size < 0:
            return None
        raw = bytearray(int(size))
        cbuf = (ctypes.c_char * len(raw)).from_buffer(raw)
        got = self._lib.bridge_poll(self._handle, cbuf, size)
        if got < 12:
            return None
        conn, kind = struct.unpack_from("<qi", raw, 0)
        return conn, kind, memoryview(raw)[12:got]

    def send(self, conn: int, body) -> int:
        """Enqueue one framed body. Returns the native rc: 0 ok, -1
        unknown/closing connection, -2 outbox full (the peer stopped
        reading) — the CALLER owns the slow-consumer policy (bridge_host
        disconnects it; silently dropping the frame is never ok)."""
        if not self._handle:
            return -1
        if not isinstance(body, bytes):
            # bytes subclasses (RawBody) pass through uncopied — a
            # bytes(body) here would re-copy the shared broadcast body
            # once per subscriber, exactly what encode-once avoids.
            body = bytes(body)
        return int(self._lib.bridge_send(self._handle, conn,
                                         body, len(body)))

    def set_max_outbox(self, n: int) -> None:
        """Tune the per-connection outbox bound at which send returns -2."""
        if self._handle:
            self._lib.bridge_set_max_outbox(self._handle, n)

    def set_conn_max_outbox(self, conn: int, n: int | None) -> int:
        """Per-connection outbox override (None restores the bridge
        default) — the connection-CLASS bound: viewer connections take a
        shallow outbox so a stalled viewer trips the slow-consumer drop
        (and its resync path) early, without touching writer bounds.
        Returns the native rc (0 ok, -1 unknown connection)."""
        if not self._handle:
            return -1
        return int(self._lib.bridge_set_conn_max_outbox(
            self._handle, conn, 0 if n is None else n))

    def close_conn(self, conn: int) -> None:
        if self._handle:
            self._lib.bridge_close(self._handle, conn)

    def stop(self) -> None:
        if self._handle:
            self._lib.bridge_stop(self._handle)
            self._handle = 0

    def __del__(self) -> None:
        try:
            self.stop()
        except Exception:
            pass


def start_bridge(port: int = 0) -> NativeBridge | None:
    """Start a native bridge server; None if the toolchain is missing."""
    lib = _load_library()
    if lib is None:
        return None
    handle = lib.bridge_start(port)
    if not handle:
        return None
    return NativeBridge(lib, handle)
