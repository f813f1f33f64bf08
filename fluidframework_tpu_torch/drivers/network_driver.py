"""Network driver — reaches an alfred front door over TCP.

Reference parity: packages/drivers/routerlicious-driver (socket ordering
connection documentDeltaConnection.ts:61, REST delta/storage reads
deltaStorageService.ts:24, documentStorageService.ts:36) over the
driver-base connection machinery (documentDeltaConnection.ts:35). One
socket multiplexes the live delta connection and the storage RPCs, framed
by protocol.codec.

Threading model: the reference client is single-threaded (JS event loop);
here a background reader thread receives pushed events. Two dispatch
modes:

  * ``auto_dispatch=True`` (default): a dispatcher thread invokes inbound
    callbacks (ops/nack/signal) holding ``dispatch_lock`` — a host driving
    local edits from another thread takes the same lock around them (the
    e2e tests do), which serializes the container stack exactly like the
    reference's event loop does.
  * ``auto_dispatch=False``: pushed events queue until the host calls
    :meth:`NetworkDocumentService.pump_events` — every callback then runs
    on the CALLER's thread, so a single-threaded host (the examples) needs
    no locking at all. This is the DeltaQueue pause/resume shape.
"""

from __future__ import annotations

import itertools
import queue
import socket
import struct
import threading
import time
from typing import Any, Callable

from ..protocol.codec import (
    MAX_FRAME,
    decode_body,
    decode_storm_push,
    encode_frame,
    encode_storm_frame,
    is_storm_body,
    stamp_trace,
)
from ..protocol.messages import DocumentMessage, NackMessage, SequencedDocumentMessage
from ..utils.events import TypedEventEmitter
from .base import IncomingHandler

_LEN = struct.Struct(">I")


class _NetworkConnection:
    """DeltaConnection over the shared socket."""

    def __init__(self, service: "NetworkDocumentService",
                 client_id: str) -> None:
        self._service = service
        self.client_id = client_id
        self.open = True

    def submit(self, messages: list[DocumentMessage]) -> None:
        assert self.open, "submit on closed connection"
        self._service._request({"op": "submit", "messages": messages})

    def signal(self, content: Any) -> None:
        assert self.open, "signal on closed connection"
        self._service._request({"op": "signal", "content": content})

    def close(self) -> None:
        if self.open:
            self.open = False
            self._service._request({"op": "disconnect"})


class _NetworkSnapshotStorage:
    def __init__(self, service: "NetworkDocumentService") -> None:
        self._service = service

    def get_latest_snapshot(self) -> dict | None:
        return self._service._request({"op": "get_latest_snapshot"})[
            "snapshot"]

    def upload_snapshot(self, snapshot: dict,
                        parent: str | None = None) -> str:
        return self._service._request({"op": "upload_snapshot",
                                       "snapshot": snapshot,
                                       "parent": parent})["handle"]

    def create_blob(self, blob_id: str, data: bytes) -> str:
        import base64
        return self._service._request({
            "op": "create_blob", "blob_id": blob_id,
            "data": base64.b64encode(data).decode()})["blob_id"]

    def read_blob(self, blob_id: str) -> bytes:
        import base64
        return base64.b64decode(self._service._request(
            {"op": "read_blob", "blob_id": blob_id})["data"])


class _NetworkDeltaStorage:
    def __init__(self, service: "NetworkDocumentService") -> None:
        self._service = service

    def get_deltas(self, from_seq: int, to_seq: int | None = None
                   ) -> list[SequencedDocumentMessage]:
        return self._service._request({"op": "get_deltas",
                                       "from_seq": from_seq,
                                       "to_seq": to_seq})["messages"]


class NetworkDocumentService:
    """IDocumentService over a TCP alfred."""

    def __init__(self, host: str, port: int, doc_id: str,
                 scopes=None, timeout: float = 30.0,
                 token: str | None = None,
                 auto_dispatch: bool = True,
                 hosts: dict[str, tuple[str, int]] | None = None) -> None:
        self.doc_id = doc_id
        self._token = token
        # Cluster address book: host label (the ``moved_to`` value the
        # placement directory answers with) -> (host, port). A
        # connect-time "moved" redirect redials the named owner
        # directly; without an entry the error surfaces to the caller
        # (who owns service discovery).
        self.hosts = dict(hosts or {})
        self.storage = _NetworkSnapshotStorage(self)
        self.delta_storage = _NetworkDeltaStorage(self)
        self._scopes = scopes
        self._timeout = timeout
        self._addr = (host, port)
        self._auto_dispatch = auto_dispatch
        # Stable per-client admission identity, carried on connect: the
        # front door keys its per-client connect bucket AND claimable
        # reservations on it. Stable across reconnect() (same driver
        # instance = same client), unlike the ephemeral socket peername;
        # self-chosen is fine — it buys fairness/ladder slots, not auth.
        import uuid
        self._client_key = uuid.uuid4().hex
        # Set by StormStream: gates the reader-thread rx-timestamp stamp
        # on storm pushes (plain handlers see the wire payload as-is).
        self._stamp_storm_rx = False
        self.dispatch_lock = threading.RLock()
        self.events = TypedEventEmitter()  # "disconnect" on socket loss

        self._send_lock = threading.Lock()
        self._rid = itertools.count(1)
        self._pending: dict[int, queue.Queue] = {}
        self._handlers: dict[str, Callable] = {}
        # The reader thread must never block on dispatch_lock (a caller may
        # hold it while awaiting an RPC response only the reader can
        # deliver), so pushed events drain through a separate dispatcher
        # thread; RPC responses route directly from the reader.
        self._events: queue.Queue = queue.Queue()
        # Transport generation: each (re)dial bumps it; a superseded
        # reader that dies late must not post teardown events into the
        # NEW session's queue.
        self._generation = 0
        self._open_transport()

    def _open_transport(self) -> None:
        """Dial the socket and start the reader/dispatcher pair — split
        out of __init__ so :meth:`reconnect` re-establishes the SAME
        session object over a fresh socket."""
        self._sock = socket.create_connection(self._addr,
                                              timeout=self._timeout)
        # The timeout above covers connection ESTABLISHMENT only. Left in
        # place it would also bound the reader thread's recv, tearing the
        # connection down after `timeout` seconds of idle (no inbound
        # broadcasts) — RPC timeouts are enforced at the response queue in
        # _request, so recv must block indefinitely. Sends stay bounded
        # via SO_SNDTIMEO (kernel-level, independent of the Python socket
        # timeout): a peer that stops reading must not wedge _send_lock
        # holders forever.
        self._sock.settimeout(None)
        self._sock.setsockopt(
            socket.SOL_SOCKET, socket.SO_SNDTIMEO,
            struct.pack("ll", int(self._timeout),
                        int((self._timeout % 1.0) * 1_000_000)))
        self._closed = False
        self._generation += 1
        self._reader = threading.Thread(target=self._read_loop,
                                        args=(self._generation,),
                                        daemon=True)
        self._reader.start()
        self._dispatcher = None
        if self._auto_dispatch:
            # Bound to THIS session's queue object (not the attribute):
            # after a reconnect swaps self._events, a still-winding-down
            # old dispatcher must never steal events from the new queue.
            self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                                args=(self._events,),
                                                daemon=True)
            self._dispatcher.start()

    def reconnect(self) -> None:
        """Re-dial a lost transport: tears down the dead socket (no-op if
        already gone) and opens a fresh one. The caller then re-issues
        ``connect`` (DeltaManager.connect does the catch-up + resubmit
        dance). Safe only after the old reader has disconnected."""
        self._closed = True
        # Supersede the old reader FIRST: however late it dies, its
        # teardown path (generation-checked) can no longer touch the new
        # session's waiters or event queue.
        self._generation += 1
        try:
            # shutdown() (not just close) reliably wakes a reader still
            # blocked in recv; close alone may leave it parked past the
            # join timeout below.
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        old_reader = self._reader
        # The old reader must be out of its recv before a new one starts
        # (two readers would interleave frame halves).
        if (old_reader.is_alive()
                and old_reader is not threading.current_thread()):
            old_reader.join(timeout=self._timeout)
        # Wind down the old dispatcher through ITS queue (it may have
        # missed the reader's sentinel if the reader outlived the join),
        # then drop the dead session's backlog.
        self._events.put({"event": "__stop__"})
        self._events = queue.Queue()
        # Fail-and-forget the dead transport's RPC waiters: their rids
        # can never be answered, and a long-lived auto-reconnecting
        # client must not accumulate one dict entry per lost RPC.
        for waiter in self._pending.values():
            waiter.put_nowait(ConnectionError("connection lost"))
        self._pending.clear()
        self._open_transport()

    @property
    def closed(self) -> bool:
        """True once the transport is down (deliberately or by socket
        death) — reconnect() is needed before further RPCs."""
        return self._closed

    # -- framing --------------------------------------------------------------

    def _send(self, payload: dict) -> None:
        data = encode_frame(payload)
        with self._send_lock:
            self._sock.sendall(data)

    def send_storm(self, header: dict, payload) -> None:
        """One binary storm frame down the shared socket (fire-and-
        forget; the columnar ack arrives as a "storm_ack" pushed event)."""
        data = encode_storm_frame(header, payload)
        with self._send_lock:
            self._sock.sendall(data)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("socket closed")
            buf += chunk
        return buf

    def _read_loop(self, generation: int) -> None:
        try:
            while True:
                header = self._recv_exact(4)
                length = _LEN.unpack(header)[0]
                if length > MAX_FRAME:
                    raise ConnectionError(f"oversized frame: {length}")
                body = self._recv_exact(length)
                try:
                    storm = is_storm_body(body)
                    payload = (decode_storm_push(body) if storm
                               else decode_body(body))
                except ValueError as err:
                    # Undecodable frame (corrupt storm body, bad JSON):
                    # a protocol error is a dead transport, not a silent
                    # reader death — route through the ConnectionError
                    # teardown below so waiters fail and the host sees
                    # the disconnect event.
                    raise ConnectionError(
                        f"undecodable frame: {err!r}") from err
                if storm:
                    # Binary storm push (columnar acks): dispatched as a
                    # pushed event (the "storm_ack" handler key), never
                    # into the RPC waiters — its rid is the sender's
                    # tick id, not an RPC correlation id. When a trace
                    # consumer (StormStream) is attached, the receive
                    # timestamp is stamped HERE (reader thread) so a
                    # traced ack's rx hop excludes dispatch queueing;
                    # handlers without one see the wire payload
                    # untouched.
                    if self._stamp_storm_rx:
                        payload["_rx_ns"] = time.monotonic_ns()
                    self._events.put(payload)
                    continue
                self._dispatch(payload)
        except (ConnectionError, OSError):
            # The reader must never die SILENTLY on a broken socket: fail
            # every waiter and surface a disconnect event so the host
            # (DeltaManager/Container) degrades to disconnected/readonly
            # instead of hanging on a transport that will never speak
            # again. A deliberate close() (self._closed already set) is
            # not a disconnect — no event then. A SUPERSEDED reader (a
            # reconnect() already dialed a newer transport) exits
            # without touching the new session's waiters or queue.
            if generation != self._generation:
                return
            intentional = self._closed
            self._closed = True
            for q in self._pending.values():
                q.put_nowait(ConnectionError("connection lost"))
            self._events.put({"event": "__disconnect__" if not intentional
                              else "__stop__"})

    def _dispatch(self, payload: dict) -> None:
        if isinstance(payload, dict) and payload.get("storm"):
            # JSON-path storm pushes (busy/shed nacks from the storm
            # ingress, quarantine refusals): these carry the SENDER's
            # frame rid, not an RPC correlation id — routing them into
            # the RPC waiters would drop them on the floor (no waiter
            # ever registered that rid), and the flow-control window
            # MUST see every refusal: a shed frame that vanishes here
            # frees client budget silently, as if it had been sequenced.
            # Deliver through the same pushed-event channel as binary
            # storm acks, with the same reader-thread rx stamp.
            payload.setdefault("event", "storm_ack")
            if self._stamp_storm_rx:
                payload["_rx_ns"] = time.monotonic_ns()
            self._events.put(payload)
            return
        rid = payload.get("rid")
        if rid is not None:
            q = self._pending.pop(rid, None)
            if q is not None:
                q.put_nowait(payload)
            return
        self._events.put(payload)

    def _deliver(self, payload: dict) -> bool:
        """Run one pushed event's handler; False once disconnected."""
        if payload.get("event") == "__stop__":
            return False  # deliberate close: wind down, no disconnect event
        if payload.get("event") == "__disconnect__":
            with self.dispatch_lock:
                self.events.emit("disconnect")
            return False
        handler = self._handlers.get(payload.get("event"))
        if handler is not None:
            with self.dispatch_lock:
                handler(payload)
        return True

    def _dispatch_loop(self, events: queue.Queue) -> None:
        while True:
            if not self._deliver(events.get()):
                return

    def pump_events(self) -> int:
        """auto_dispatch=False mode: drain queued pushed events on the
        calling thread; returns the number delivered."""
        assert self._dispatcher is None, \
            "pump_events requires auto_dispatch=False"
        delivered = 0
        while True:
            try:
                payload = self._events.get_nowait()
            except queue.Empty:
                return delivered
            self._deliver(payload)
            delivered += 1

    def _request(self, req: dict) -> dict:
        if self._closed:
            raise ConnectionError("connection lost")
        rid = next(self._rid)
        q: queue.Queue = queue.Queue()
        self._pending[rid] = q
        # Default the session's document, but let an explicit doc_id in the
        # request through (e.g. get_help's all-documents None).
        self._send({"doc_id": self.doc_id, **req, "rid": rid})
        resp = q.get(timeout=self._timeout)
        if isinstance(resp, Exception):
            raise resp
        if "error" in resp:
            if resp["error"] == "throttled":
                from .utils import ThrottlingError
                raise ThrottlingError("throttled by alfred",
                                      retry_after_s=resp["retry_after_s"])
            if resp["error"] == "moved" and resp.get("moved_to"):
                from .utils import DocumentMovedError
                raise DocumentMovedError(
                    f"doc served by {resp['moved_to']}",
                    moved_to=resp["moved_to"],
                    retry_after_s=resp.get("retry_after_s", 0.0))
            if resp["error"] == "migrating":
                # Mid-migration blackout: retryable after the hint (the
                # route resolves to "moved" or back here once the
                # directory flips).
                from .utils import ThrottlingError
                raise ThrottlingError(
                    "doc mid-migration",
                    retry_after_s=resp.get("retry_after_s", 0.05))
            raise RuntimeError(f"alfred error: {resp['error']}")
        return resp

    # -- IDocumentService ------------------------------------------------------

    def connect(self, handler: IncomingHandler,
                on_nack: Callable[[NackMessage], None] | None = None,
                on_signal: Callable[[Any], None] | None = None,
                mode: str = "write") -> _NetworkConnection:
        self._handlers["ops"] = lambda p: handler(p["messages"])
        if on_nack is not None:
            self._handlers["nack"] = lambda p: on_nack(p["nack"])
        if on_signal is not None:
            self._handlers["signal"] = lambda p: on_signal(p["signal"])
        req: dict = {"op": "connect", "mode": mode,
                     "client_key": self._client_key}
        if self._scopes is not None:
            req["scopes"] = list(self._scopes)
        if self._token is not None:
            req["token"] = self._token
        from .utils import DocumentMovedError
        for _hop in range(4):
            try:
                resp = self._request(req)
            except DocumentMovedError as err:
                # Connect-time cluster redirect: the placement directory
                # named the owning host — redial IT (same session
                # object, fresh socket) and re-issue the connect there.
                # Unknown labels (no address-book entry) surface to the
                # caller; a redirect chain is bounded (a directory flip
                # racing the redial can bounce once, never forever).
                addr = self.hosts.get(err.moved_to)
                if addr is None:
                    raise
                self._addr = tuple(addr)
                self.reconnect()
                continue
            return _NetworkConnection(self, resp["client_id"])
        raise ConnectionError("connect redirect chain did not converge")

    # -- agent control surface (headless runner ↔ foreman over the wire) -------

    def help_tasks(self, doc_id: str | None = None) -> list[dict]:
        req: dict = {"op": "get_help", "doc_id": doc_id}
        if self._token is not None:
            req["token"] = self._token
        return self._request(req)["tasks"]

    def complete_help(self, key: str) -> None:
        req: dict = {"op": "complete_help", "key": key}
        if self._token is not None:
            req["token"] = self._token
        self._request(req)

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


class StormStream:
    """Client half of the sampled per-op tracing plane
    (connectionTelemetry.ts op round-trip latency, columnar): sends
    storm frames over a :class:`NetworkDocumentService` socket and
    stamps a trace id on every ``sample_every``-th frame
    (``sample_every=0`` disables tracing). When the traced ack returns,
    the server's hop marks (monotonic ns, same host clock domain) join
    with the client's own send/receive timestamps into one end-to-end
    span on :attr:`tracer` — ack latency decomposed into
    send→ingress→admit→dispatch→sequenced[→durable]→ack_tx→rx.

    Windowed flow control: with ``window=N`` at most N frames
    stay in flight (submitted, neither acked nor nacked) — :meth:`submit`
    blocks until the ack watermark frees a slot, so a sender can never
    build a multi-second socket/ingress backlog in front of the serving
    tick ("latency" that is client queueing, not the server). Size the window at least
    ``server pipeline_depth + 1``: acks lag dispatch by up to ``depth``
    ticks, and a window smaller than that starves the cohort. A
    busy-nack (``retry_after_s``) frees its slot — the frame is dead
    server-side — but counts on :attr:`nacked`, never :attr:`acked`,
    and arms a send-side backoff honoring the hint; the frame must be
    resubmitted to be sequenced.

    Registers itself as the service's ``storm_ack`` handler; pass
    ``on_ack`` to also observe every ack payload (traced or not) and
    ``on_nack`` to observe refusals.
    """

    def __init__(self, service: NetworkDocumentService,
                 sample_every: int = 64,
                 on_ack: Callable[[dict], None] | None = None,
                 window: int | None = None,
                 on_nack: Callable[[dict], None] | None = None,
                 on_moved: Callable[[dict], None] | None = None) -> None:
        from ..utils import TraceSpans
        self._service = service
        self.sample_every = max(0, sample_every)
        self._on_ack = on_ack
        self._on_nack = on_nack
        self._on_moved = on_moved
        #: doc -> owning-host label learned from "moved" nacks (live
        #: migration redirects): the caller redials the named host —
        #: through the same reconnect/backoff machinery as any
        #: transport loss — and resubmits the frame there.
        self.moved: dict[str, str] = {}
        self._sent = 0
        self._next_tc = itertools.count(1)
        # Guarded: submit() runs on the app thread while _handle_ack
        # pops on the dispatcher thread.
        self._send_lock = threading.Lock()
        self._send_ns: dict[Any, int] = {}
        self.tracer = TraceSpans()
        self.acked = 0
        self.nacked = 0
        if window is not None and window < 1:
            raise ValueError(f"flow-control window must be >= 1, "
                             f"got {window}")
        self.window = window
        self.inflight = 0
        self._flow = threading.Condition()
        # Monotonic deadline from the latest busy-nack's retry_after_s:
        # submit() sleeps it off before sending (never the dispatcher
        # thread, which must keep draining acks).
        self._backoff_until = 0.0
        service._handlers["storm_ack"] = self._handle_ack
        service._stamp_storm_rx = True

    #: Outstanding traced sends kept at most this many: a sampled frame
    #: whose ack never comes back (admission nack, disconnect) must not
    #: leak its send timestamp forever.
    MAX_PENDING_TRACES = 1024

    def submit(self, docs: list, payload, rid=None,
               timeout: float | None = 30.0):
        """One storm frame: ``docs`` is the header doc list
        ([[doc_id, client_id, cseq0, ref_seq, count], ...]), ``payload``
        the packed op words. With a flow-control window, blocks while
        the window is full (``timeout`` bounds the wait; None waits
        forever) and sleeps out any pending busy-nack backoff first.
        Returns the trace id when this frame drew the sample, else
        None."""
        if self.window is not None:
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            with self._flow:
                while self.inflight >= self.window:
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError(
                            f"storm flow-control window {self.window} "
                            f"still full after {timeout}s "
                            f"({self.inflight} in flight)")
                    self._flow.wait(timeout=remaining)
                self.inflight += 1
            # Honor the latest retry_after_s OUTSIDE the lock: the
            # dispatcher thread must stay free to drain acks meanwhile.
            # The hint is server-controlled and uncapped (the admission
            # ladder can hand out minutes), so it must respect the
            # caller's timeout bound — fail loudly rather than hang a
            # 30s-bounded submit for 2 minutes holding a window slot.
            wait_s = self._backoff_until - time.monotonic()
            if wait_s > 0:
                if deadline is not None \
                        and time.monotonic() + wait_s > deadline:
                    with self._flow:
                        self.inflight = max(0, self.inflight - 1)
                        self._flow.notify_all()
                    raise TimeoutError(
                        f"busy-nack backoff {wait_s:.2f}s exceeds the "
                        f"submit timeout {timeout}s")
                time.sleep(wait_s)
        header = {"op": "storm", "rid": rid, "docs": docs}
        tc = None
        if self.sample_every and self._sent % self.sample_every == 0:
            tc = next(self._next_tc)
            stamp_trace(header, tc)
            with self._send_lock:
                while len(self._send_ns) >= self.MAX_PENDING_TRACES:
                    self._send_ns.pop(next(iter(self._send_ns)), None)
                self._send_ns[tc] = time.monotonic_ns()
        self._sent += 1
        try:
            self._service.send_storm(header, payload)
        except BaseException:
            # The frame never left: its window slot must not leak (the
            # reconnect path resubmits through a fresh submit()).
            if self.window is not None:
                with self._flow:
                    self.inflight = max(0, self.inflight - 1)
                    self._flow.notify_all()
            raise
        return tc

    def _handle_ack(self, payload: dict) -> None:
        rx_ns = payload.pop("_rx_ns", None) or time.monotonic_ns()
        err = payload.get("error")
        if err is None:
            self.acked += 1
        else:
            # Busy/shed nack: the frame DIED server-side. It frees its
            # flow-control slot (the budget really is available again)
            # but must never count as acked — the ops were not
            # sequenced, and the caller resubmits after the hint.
            # Treating it as an ack would leak: a shed frame would
            # silently free budget as if it had been served.
            self.nacked += 1
            moved_to = payload.get("moved_to")
            if err == "moved" and isinstance(moved_to, dict):
                # Live-migration redirect: the docs are served by
                # another host now. Record the hints (the caller
                # redials via the reconnect path) and do NOT arm the
                # send backoff — the right move is a different host,
                # not a slower retry here.
                self.moved.update(moved_to)
                if self._on_moved is not None:
                    self._on_moved(payload)
            else:
                retry = payload.get("retry_after_s")
                if retry:
                    until = time.monotonic() + float(retry)
                    if until > self._backoff_until:
                        self._backoff_until = until
        if self.window is not None:
            with self._flow:
                if self.inflight > 0:
                    self.inflight -= 1
                self._flow.notify_all()
        tc = payload.get("tc")
        with self._send_lock:
            send_ns = self._send_ns.pop(tc, None) if tc is not None \
                else None
        if send_ns is not None and isinstance(payload.get("hops"), dict):
            self.tracer.mark(tc, "client_send", send_ns)
            for hop, t_ns in payload["hops"].items():
                self.tracer.mark(tc, hop, t_ns)
            self.tracer.mark(tc, "client_rx", rx_ns)
            self.tracer.finish(tc, rid=payload.get("rid"))
        if err is not None and self._on_nack is not None:
            self._on_nack(payload)
        if self._on_ack is not None:
            self._on_ack(payload)


class ViewerStream:
    """Read-only broadcast viewer (the client half of the viewer plane,
    server/broadcaster.py): connects ``mode="viewer"`` — no CLIENT_JOIN,
    no quorum, no admission debit server-side — and consumes the
    document's broadcast stream:

    * binary ``storm_tick`` frames (the storm path's once-per-doc-per-
      tick broadcast: sequenced window + raw op words),
    * ``ops`` events (the per-op JSON path),
    * ``viewer_presence`` roster samples + counts,
    * ``viewer_resync`` lag-drop directives — on one, the stream marks
      itself lagged; :meth:`resync` catches up out-of-band (latest
      snapshot + ``get_deltas`` from the last seq seen, which serves
      even cold docs from their cold-head tick index) and re-enters the
      live stream via the gated ``viewer_resume`` op, honoring
      ``retry_after_s`` like every admission-aware client.
    """

    def __init__(self, service: NetworkDocumentService,
                 on_tick: Callable[[dict], None] | None = None,
                 on_ops: Callable[[list], None] | None = None) -> None:
        self._service = service
        self._on_tick = on_tick
        self._on_ops = on_ops
        self.viewer_id: str | None = None
        self.last_seq = 0
        self.audience_total = 0
        self.lagged = False
        #: Owning-host label from a re-home directive (live migration):
        #: after the catch-up read, resume against THIS host — a fresh
        #: service dial through the reconnect path, not viewer_resume
        #: on the old one.
        self.moved_to: str | None = None
        self.stats = {"ticks": 0, "ops": 0, "resyncs": 0,
                      "presence_updates": 0, "rehomes": 0}
        service._handlers["storm_tick"] = self._handle_tick
        service._handlers["ops"] = self._handle_ops
        service._handlers["viewer_presence"] = self._handle_presence
        service._handlers["viewer_resync"] = self._handle_resync

    def connect(self) -> dict:
        req: dict = {"op": "connect", "mode": "viewer",
                     "client_key": self._service._client_key}
        if self._service._token is not None:
            req["token"] = self._service._token
        from .utils import DocumentMovedError
        for _hop in range(4):
            try:
                hello = self._service._request(req)
            except DocumentMovedError as err:
                # Read-tier redirect: the replica directory (or the
                # placement directory) named the host serving this
                # doc's viewer room — redial IT, same bounded-chain
                # contract as the write connect path.
                addr = self._service.hosts.get(err.moved_to)
                if addr is None:
                    raise
                self._service._addr = tuple(addr)
                self._service.reconnect()
                continue
            self.viewer_id = hello["client_id"]
            self.last_seq = max(self.last_seq, hello.get("seq", 0))
            self.audience_total = hello.get("viewers", 0)
            return hello
        raise ConnectionError(
            "viewer connect redirect chain did not converge")

    def _handle_tick(self, payload: dict) -> None:
        self.stats["ticks"] += 1
        self.last_seq = max(self.last_seq, payload.get("last", 0))
        if self._on_tick is not None:
            self._on_tick(payload)

    def _handle_ops(self, payload: dict) -> None:
        messages = payload.get("messages", [])
        self.stats["ops"] += len(messages)
        for m in messages:
            seq = getattr(m, "sequence_number", 0)
            if seq > self.last_seq:
                self.last_seq = seq
        if self._on_ops is not None:
            self._on_ops(messages)

    def _handle_presence(self, payload: dict) -> None:
        self.stats["presence_updates"] += 1
        self.audience_total = payload.get("total", self.audience_total)

    def _handle_resync(self, payload: dict) -> None:
        self.lagged = True
        self.stats["resyncs"] += 1
        moved_to = payload.get("moved_to")
        if moved_to is not None:
            self.moved_to = moved_to
            self.stats["rehomes"] += 1

    def resync(self, max_attempts: int = 16) -> list:
        """Catch up after a lag-drop and re-enter the live stream:
        fetch the deltas the dropped queue would have carried (from
        ``last_seq``; a doc evicted to the cold tier meanwhile serves
        this from its cold-head index without hydrating), then
        ``viewer_resume`` — retrying at the server's ``retry_after_s``
        hint when the resume storm is being laddered out. A re-home
        directive (``moved_to`` — live migration, or a room spread onto
        the read-replica tier) redials the named host and re-JOINS
        there instead of resuming on the old one. Returns the
        caught-up messages."""
        moved = self.moved_to
        if moved is not None \
                and moved in getattr(self._service, "hosts", {}):
            # Catch up from the OLD host first (its WAL holds the seqs
            # the dropped queue would have carried), then dial the new
            # owner and join fresh — viewer_resume has no registration
            # on the new host to resume.
            caught_up = self._fetch_gap()
            self._service._addr = tuple(self._service.hosts[moved])
            self._service.reconnect()
            self.moved_to = None
            hello = self.connect()
            if hello.get("seq", 0) > self.last_seq:
                caught_up += self._fetch_gap()
            self.lagged = False
            return caught_up
        caught_up = self._fetch_gap()
        for _ in range(max_attempts):
            try:
                hello = self._service._request({
                    "op": "viewer_resume",
                    "client_key": self._service._client_key})
            except Exception as err:
                retry = getattr(err, "retry_after_s", None)
                if retry is None:
                    raise
                time.sleep(retry)
                continue
            if hello.get("seq", 0) > self.last_seq:
                # Ops sequenced between the catch-up read and the
                # resume (the resume loop may have slept through
                # throttle hints) were never queued for the dead
                # subscriber — close the remaining gap up to the
                # resume point, where the live stream takes over.
                caught_up += self._fetch_gap()
            self.lagged = False
            self.audience_total = hello.get("viewers",
                                            self.audience_total)
            return caught_up
        raise TimeoutError("viewer_resume still throttled after "
                           f"{max_attempts} attempts")

    def _fetch_gap(self) -> list:
        messages = self._service.delta_storage.get_deltas(self.last_seq)
        for m in messages:
            seq = getattr(m, "sequence_number", 0)
            if seq > self.last_seq:
                self.last_seq = seq
        return messages
