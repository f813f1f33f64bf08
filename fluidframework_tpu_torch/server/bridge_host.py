"""Native-bridge front door — alfred's request surface over the C++
socket bridge.

Reference parity: the alfred socket handler (alfred/index.ts:140-477)
with the transport owned by native code (SURVEY.md §2.9's front-door ↔
TPU-host bridge): bridge.cpp accepts connections and does all framed
socket IO; this host pumps decoded request frames through the SAME
request dispatch the asyncio alfred uses (one wire protocol, two
transports — the network driver connects to either unchanged).

Run standalone (the kernel host on the card unless ``--device cpu``)::

    python -m fluidframework_tpu_torch.server.bridge_host --port 7071

It prints ``READY <port>``, then ``DEVICE <merge host's device>``
(``none`` with ``--no-merge-host``).
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from typing import Any

from ..native.bridge import EV_CLOSE, EV_DATA, EV_OPEN, start_bridge
from ..protocol.codec import decode_body, encode_push, is_storm_body
from ..utils import MetricsRegistry, NullLogger, TelemetryLogger
from .alfred import RequestSession


class _BridgeSession(RequestSession):
    """Alfred request session whose outbox is the native bridge."""

    def __init__(self, server: "BridgeFrontDoor", conn_id: int) -> None:
        super().__init__(server)
        self.conn_id = conn_id

    def push(self, payload: dict) -> None:
        if payload is None:
            return
        rc = self.server._bridge.send(self.conn_id, encode_push(payload))
        if rc == -2:
            # Outbox full: the peer stopped reading. A frame we cannot
            # deliver must never be dropped SILENTLY under a connection
            # that stays up — disconnect the slow consumer (its reconnect
            # path resyncs from the durable log) and close the service
            # side now rather than waiting for the reaped EV_CLOSE.
            self.server.metrics.counter(
                "bridge.slow_consumer_drops").inc()
            self.server.logger.send_event("BridgeSlowConsumerDropped",
                                          conn=self.conn_id)
            self.drop()
            if self.connection is not None:
                connection, self.connection = self.connection, None
                connection.close()

    def drop(self) -> None:
        # Service-initiated disconnect: close the native connection; the
        # resulting EV_CLOSE finishes session cleanup in the pump.
        self.server._bridge.close_conn(self.conn_id)

    def _on_viewer_connected(self) -> None:
        # Viewer connection class: shrink THIS connection's outbox bound
        # (bridge_set_conn_max_outbox) so a stalled viewer trips the
        # slow-consumer -2 early and resyncs, without touching writer
        # connections' deep default.
        bound = self.server.viewer_max_outbox
        if bound is not None:
            self.server._bridge.set_conn_max_outbox(self.conn_id, bound)


class BridgeFrontDoor:
    """Pumps bridge events through the alfred request dispatch."""

    def __init__(self, service, port: int = 0,
                 logger: TelemetryLogger | None = None,
                 metrics: MetricsRegistry | None = None,
                 tenants=None, throttler=None, admission=None,
                 viewer_max_outbox: int | None = 1024) -> None:
        bridge = start_bridge(port)
        if bridge is None:
            raise RuntimeError("native bridge unavailable (no toolchain)")
        self.service = service
        self.logger = logger if logger is not None else NullLogger()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tenants = tenants
        self.throttler = throttler
        # Same admission seam as AlfredServer (RequestSession reads it).
        self.admission = admission
        # Viewer-class outbox bound (per-connection override of the
        # bridge's -2 threshold); None keeps viewers at the default.
        self.viewer_max_outbox = viewer_max_outbox
        self._bridge = bridge
        self.port = bridge.port
        self._sessions: dict[int, _BridgeSession] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._pump_loop, daemon=True)
        self._thread.start()

    # -- event pump ------------------------------------------------------------

    def _pump_loop(self) -> None:
        while not self._stop.is_set():
            # Blocking poll (cv in the C++ side): no busy-wait, and the
            # bounded timeout keeps close() responsive.
            event = self._bridge.poll(wait_ms=50)
            if event is None:
                # Idle: non-blocking storm service — drain acks whose
                # group commit completed, run partial-cohort tails, and
                # harvest ready in-flight ticks. Deliberately NOT a full
                # flush(): a windowed (flow-controlled) sender goes
                # quiet between frames while ticks are still in flight,
                # and a forced settle on every quiet poll would collapse
                # the dispatch/fsync overlap back into lockstep ticks.
                storm = getattr(self.service, "storm", None)
                if storm is not None and (storm._frames or storm._inflight
                                          or storm._unacked):
                    try:
                        storm.idle_drain()
                    except Exception as err:
                        self.logger.send_error("BridgeStormFlushFailed", err)
                # Idle residency sweep on the serving thread: docs idle
                # past the timeout demote to the cold tier here (the
                # bridge deployment never pumps the service's own idle
                # pass — this IS its idle cadence), freeing pool slots
                # for the next cold-doc hydration.
                residency = getattr(getattr(self.service, "storm", None),
                                    "residency", None)
                if residency is not None:
                    try:
                        # Bounded per pass (each eviction is a flush +
                        # fsync + upload on this serving thread); the
                        # next idle poll continues the drain.
                        residency.evict_idle(max_evictions=32)
                    except Exception as err:
                        self.logger.send_error("BridgeEvictIdleFailed",
                                               err)
                # Viewer-plane idle drain: flush queued broadcast frames
                # to viewer transports between ticks (resumed viewers,
                # per-op traffic on otherwise-quiet docs).
                viewers = getattr(self.service, "viewers", None)
                if viewers is not None and viewers.active_rooms:
                    try:
                        viewers.drain_all()
                    except Exception as err:
                        self.logger.send_error("BridgeViewerDrainFailed",
                                               err)
                continue
            try:
                self._dispatch(*event)
            except Exception as err:  # the pump must never die
                self.logger.send_error("BridgePumpFailed", err)

    def _dispatch(self, conn_id: int, kind: int, body: bytes) -> None:
        if kind == EV_OPEN:
            self._sessions[conn_id] = _BridgeSession(self, conn_id)
        elif kind == EV_CLOSE:
            session = self._sessions.pop(conn_id, None)
            if session is not None:
                if session.connection is not None:
                    session.connection.close()
                session.close_viewer()
            # Reap the native side (fd + writer thread) too.
            self._bridge.close_conn(conn_id)
        elif kind == EV_DATA:
            self._handle_data(conn_id, body)

    def _handle_data(self, conn_id: int, body: bytes) -> None:
        # Bridge-ingress timestamp: stamped BEFORE the codec decode so a
        # sampled trace's first hop (and the ledger's ingress_decode
        # split) covers the decode itself.
        t_rx = time.monotonic_ns()
        session = self._sessions.get(conn_id)
        if session is None:
            return
        if is_storm_body(body):
            try:
                resp = session.handle_binary(body, ingress_ns=t_rx)
            except Exception as err:
                self.logger.send_error("BridgeStormFailed", err)
                resp = {"rid": None, "error": repr(err)}
            if resp is not None:
                session.push(resp)
            return
        try:
            req: Any = decode_body(body)
        except Exception:
            self._bridge.close_conn(conn_id)
            return
        if not isinstance(req, dict):
            session.push({"rid": None, "error": "request must be an object"})
            return
        try:
            resp = session.handle_request(req)
        except Exception as err:  # keep the socket alive, report
            self.logger.send_error("BridgeRequestFailed", err,
                                   op=req.get("op"))
            resp = {"rid": req.get("rid"), "error": repr(err)}
        session.push(resp)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)
        for session in list(self._sessions.values()):
            if session.connection is not None:
                session.connection.close()
            session.close_viewer()
        self._sessions.clear()
        if self._thread.is_alive():
            # A request is wedged inside the service; freeing the native
            # bridge under the pump would be a use-after-free. Leak it —
            # process teardown reclaims the fds.
            self.logger.send_event("BridgeStopLeaked")
            return
        self._bridge.stop()


def main(argv: list[str] | None = None) -> None:
    from .alfred import build_default_service

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--port", type=int, default=7071)
    parser.add_argument("--no-merge-host", action="store_true")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--device", default="cuda",
                        help="device the kernel host runs on (cuda, or "
                             "cpu for the kernels' plain versions)")
    args = parser.parse_args(argv)
    service = build_default_service(args.data_dir,
                                    merge_host=not args.no_merge_host,
                                    device=args.device)
    front = BridgeFrontDoor(service, args.port)
    host = getattr(service, "merge_host", None)
    print(f"READY {front.port}", flush=True)
    print(f"DEVICE {host.device if host is not None else 'none'}",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        front.close()


if __name__ == "__main__":
    main(sys.argv[1:])
