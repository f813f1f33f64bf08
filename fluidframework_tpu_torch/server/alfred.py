"""Alfred — the network front door: a socket server over the ordering
service.

Reference parity: server/routerlicious/packages/lambdas/src/alfred/
index.ts:140-477 — the socket handler exposing ``connect_document``
(→ :343), ``submitOp`` (→ :367-385), ``submitSignal`` (→ :427) plus the
REST-ish storage/delta reads (routerlicious-base alfred app). Transport is
length-prefixed JSON over TCP (asyncio) instead of socket.io — the DCN hop
of SURVEY.md §5.8; the ordering service behind it is unchanged
(RouterliciousService or LocalCollabServer, duck-typed).

Wire protocol (all frames = 4-byte BE length + JSON, protocol.codec):
  client→server requests carry ``rid``; the response echoes it:
    {rid, op: "connect", doc_id, mode, scopes?}     → {rid, client_id}
    {rid, op: "submit", messages: [DocumentMessage]} → {rid, ok}
    {rid, op: "signal", content}                     → {rid, ok}
    {rid, op: "get_deltas", from_seq, to_seq}        → {rid, messages}
    {rid, op: "upload_snapshot", snapshot}           → {rid, handle}
    {rid, op: "get_latest_snapshot"}                 → {rid, snapshot}
    {rid, op: "disconnect"}                          → {rid, ok}
  server→client events (no rid):
    {event: "ops", messages: [SequencedDocumentMessage]}
    {event: "nack", nack: NackMessage}
    {event: "signal", signal}

Run standalone (the tinylicious analog):
    python -m fluidframework_tpu_torch.server.alfred --port 7070
"""

from __future__ import annotations

import argparse
import asyncio
import sys
import time
from typing import Any

from ..protocol.codec import (
    MAX_FRAME,
    decode_body,
    encode_ops_event,
    encode_push,
    frame_body,
    is_storm_body,
)
from ..utils import MetricsRegistry, NullLogger, TelemetryLogger


async def read_frame_raw(reader: asyncio.StreamReader) -> bytes:
    header = await reader.readexactly(4)
    length = int.from_bytes(header, "big")
    if length > MAX_FRAME:
        raise ConnectionError(f"oversized frame: {length}")
    return await reader.readexactly(length)


async def read_frame(reader: asyncio.StreamReader) -> Any:
    return decode_body(await read_frame_raw(reader))


def read_frame_raw_sync(sock) -> bytes:
    """Blocking-socket twin of :func:`read_frame_raw` — one definition
    of the length-prefixed wire format for synchronous callers (the
    replication transport's client half, ``server/transport.py``).
    Raises ``ConnectionError`` on a closed or over-limit peer; socket
    timeouts propagate for the caller's deadline/retry policy."""

    def recv_exact(n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("peer closed mid-frame")
            buf += chunk
        return bytes(buf)

    length = int.from_bytes(recv_exact(4), "big")
    if length > MAX_FRAME:
        raise ConnectionError(f"oversized frame: {length}")
    return recv_exact(length)


class RequestSession:
    """One connection = one (doc, client) session, mirroring the
    reference's per-socket connection state (alfred index.ts:278).
    Transport-agnostic: subclasses own ``push`` (asyncio writer here,
    the native bridge in server.bridge_host)."""

    def __init__(self, server) -> None:
        self.server = server
        self.connection = None  # service-side live connection
        self.doc_id: str | None = None
        self.tenant_id = "default"  # set from token claims on connect
        # mode="viewer" sessions register on the viewer plane instead of
        # the ordering service (server/broadcaster.py): no CLIENT_JOIN,
        # no admission token debit, no ack bookkeeping.
        self.viewer_id: str | None = None

    def push(self, payload: dict) -> None:
        raise NotImplementedError

    def push_ops(self, messages) -> None:
        """Broadcast one sequenced-op batch. A BroadcastBatch shared by
        many sessions is serialized ONCE (codec.encode_ops_event caches
        the body on the batch); every subscriber then pays only a
        transport write."""
        self.push(encode_ops_event(messages))

    def drop(self) -> None:
        """Close this session's transport (service-initiated disconnect,
        e.g. slow-consumer eviction). Subclasses owning a socket override."""

    def close_viewer(self) -> None:
        """Tear down this session's viewer-plane registration (transport
        death / explicit disconnect)."""
        if self.viewer_id is not None:
            viewers = getattr(self.server.service, "viewers", None)
            if viewers is not None:
                viewers.leave(self.viewer_id)
            self.viewer_id = None

    def _pending_probe(self):
        """Transport-outbox depth probe for the viewer plane's lag
        detection; None when the transport cannot report one (the
        fan-out queue bound still applies)."""
        return None

    def _on_viewer_connected(self) -> None:
        """Transport hook after a viewer connect: subclasses shrink the
        connection's outbox bound to the viewer class (the native bridge
        sets its per-connection -2 threshold here)."""

    def handle_binary(self, body: bytes,
                      ingress_ns: int | None = None) -> dict | None:
        """A storm frame (codec.is_storm_body): columnar op batch into the
        service's fast path. The ack is pushed after the tick that
        sequences it; None = no immediate response. ``ingress_ns`` is the
        transport's receive timestamp (monotonic ns) so the stage ledger
        attributes the codec decode to ingress_decode (None is fine —
        submit_frame defaults to its own entry time)."""
        from ..protocol.codec import decode_storm_body

        storm = getattr(self.server.service, "storm", None)
        if storm is None:
            return {"rid": None, "error": "storm path not enabled"}
        try:
            header, payload = decode_storm_body(body)
        except Exception as err:
            return {"rid": None, "error": f"bad storm frame: {err!r}"}
        try:
            # Admission identities come from the SESSION (validated
            # tenant, service-assigned client id), never the frame's
            # client-controlled header.
            storm.submit_frame(
                self.push, header, payload, tenant_id=self.tenant_id,
                client_id=getattr(self.connection, "client_id", None),
                ingress_ns=ingress_ns)
        except Exception as err:
            # The error must answer the offending frame and keep the
            # socket alive — exactly like the JSON request path.
            return {"rid": header.get("rid"), "error": repr(err)}
        return None

    def handle_request(self, req: dict) -> dict:
        """Dispatch one request synchronously against the service."""
        service = self.server.service
        op = req["op"]
        rid = req.get("rid")
        if op == "connect":
            # Symmetric guard: one session, one registration — a viewer
            # session re-connecting in write mode would otherwise leak
            # its plane registration and overwrite doc_id under it.
            assert self.connection is None and self.viewer_id is None, \
                "already connected"
            self.doc_id = req["doc_id"]
            if req.get("mode") == "viewer":
                return self._connect_viewer(req, rid)
            kwargs: dict = {"mode": req.get("mode", "write")}
            if self.server.tenants is not None:
                # Auth-enabled front door (alfred index.ts:343): the token
                # is the ONLY source of scopes; client-requested scopes are
                # ignored.
                from .riddler import AuthError
                token = req.get("token")
                if not token:
                    raise AuthError("connect requires a token")
                claims = self.server.tenants.validate_token(
                    token, document_id=self.doc_id)
                kwargs["scopes"] = tuple(claims["scopes"])
                self.tenant_id = claims.get("tenantId", "default")
            elif req.get("scopes") is not None:
                kwargs["scopes"] = tuple(req["scopes"])
            redirect = self._placement_redirect(rid)
            if redirect is None:
                # A write connect dialed at a read replica sheds to the
                # leader (the replica's self-router names it).
                redirect = self._read_redirect(rid, "write")
            if redirect is not None:
                return redirect
            admission = self.server.admission
            if admission is not None:
                # The client-tier key is the driver's stable per-client
                # id (claimable reservations must survive a redial's new
                # socket AND must not be shared by a doc's other clients
                # — a doc-keyed reservation would let neighbours steal a
                # refused client's slot). Absent (old clients), fall
                # back to tenant-only admission.
                retry = admission.admit_connect(self.tenant_id,
                                                req.get("client_key"))
                if retry is not None:
                    return {"rid": rid, "error": "throttled",
                            "retry_after_s": retry}
            elif self.server.throttler is not None:
                retry = self.server.throttler.try_consume(
                    f"connect/{self.doc_id}")
                if retry is not None:
                    return {"rid": rid, "error": "throttled",
                            "retry_after_s": retry}
            residency = getattr(getattr(service, "storm", None),
                                "residency", None)
            if residency is not None:
                # Cold-doc connect hydrates through the admission-gated
                # path: a hydration stampede busy-nacks with the
                # bucket's laddered retry hint instead of serializing
                # every cold connect behind snapshot restores.
                retry = residency.ensure_resident(self.doc_id)
                if retry is not None:
                    return {"rid": rid, "error": "hydrating",
                            "retryable": True, "retry_after_s": retry}
            self.connection = service.connect(
                self.doc_id,
                self.push_ops,
                on_nack=lambda n: self.push({"event": "nack", "nack": n}),
                on_signal=lambda s: self.push({"event": "signal",
                                              "signal": s}),
                **kwargs)
            self.server.metrics.counter("alfred.connects").inc()
            self.connection.on_closed = self.drop
            return {"rid": rid, "client_id": self.connection.client_id}
        if op == "submit":
            if self.server.admission is not None:
                retry = self.server.admission.admit_write(
                    self.tenant_id, self.connection.client_id,
                    weight=len(req["messages"]))
                if retry is not None:
                    return {"rid": rid, "error": "throttled",
                            "retry_after_s": retry}
            elif self.server.throttler is not None:
                retry = self.server.throttler.try_consume(
                    f"submit/{self.connection.client_id}",
                    weight=len(req["messages"]))
                if retry is not None:
                    return {"rid": rid, "error": "throttled",
                            "retry_after_s": retry}
            self.connection.submit(req["messages"])
            return {"rid": rid, "ok": True}
        if op == "signal":
            if self.server.admission is not None:
                # Deterministic shed order: signals are the FIRST class
                # dropped under queue pressure (they are transient by
                # contract — a shed signal loses nothing durable).
                retry = self.server.admission.admit_signal(self.tenant_id)
                if retry is not None:
                    return {"rid": rid, "error": "throttled",
                            "retry_after_s": retry}
            self.connection.signal(req["content"])
            return {"rid": rid, "ok": True}
        if op == "get_deltas":
            if self.server.admission is not None:
                # Reads shed second (before writes): a catch-up read can
                # retry; an admitted write the tick can't absorb cannot.
                retry = self.server.admission.admit_read(self.tenant_id)
                if retry is not None:
                    return {"rid": rid, "error": "throttled",
                            "retry_after_s": retry}
            doc = req.get("doc_id", self.doc_id)
            redirect = self._read_redirect(rid, "get_deltas", doc=doc,
                                           key=req.get("client_key"))
            if redirect is not None:
                return redirect
            return self._serve_read(rid, lambda: {
                "rid": rid, "messages": service.get_deltas(
                    doc, req["from_seq"], req.get("to_seq"))})
        if op == "read_at":
            # Historical read (the history plane): sheds like any other
            # catch-up read — it is a read, and it must never outrank
            # admitted writes under pressure.
            if self.server.admission is not None:
                retry = self.server.admission.admit_read(self.tenant_id)
                if retry is not None:
                    return {"rid": rid, "error": "throttled",
                            "retry_after_s": retry}
            doc = req.get("doc_id", self.doc_id)
            redirect = self._read_redirect(rid, "read_at", doc=doc,
                                           key=req.get("client_key"))
            if redirect is not None:
                return redirect
            return self._serve_read(rid, lambda: {
                "rid": rid, **service.read_at(doc, req["seq"])})
        if op in ("fork", "merge_back"):
            # Branch verbs are WRITE-class: fork settles the pipeline
            # and uploads seeds, merge_back re-submits a branch's whole
            # delta history through the sequencer — a throttled tenant
            # must not route the write load admission is shedding
            # through this door (the storm-side _admit still gates the
            # individual merge frames).
            if self.server.admission is not None:
                retry = self.server.admission.admit_write(
                    self.tenant_id,
                    getattr(self.connection, "client_id", None))
                if retry is not None:
                    return {"rid": rid, "error": "throttled",
                            "retry_after_s": retry}
            if op == "fork":
                doc = req.get("doc_id", self.doc_id)
                return self._serve_read(rid, lambda: {
                    "rid": rid,
                    "branch": service.fork_doc(doc, req["seq"],
                                               req.get("name"))})
            return self._serve_read(rid, lambda: {
                "rid": rid,
                **service.merge_back(req.get("branch",
                                             self.doc_id))})
        if op == "upload_snapshot":
            doc = req.get("doc_id", self.doc_id)
            return {"rid": rid,
                    "handle": service.upload_snapshot(doc, req["snapshot"],
                                                      req.get("parent"))}
        if op == "get_latest_snapshot":
            doc = req.get("doc_id", self.doc_id)
            return {"rid": rid, "snapshot": service.get_latest_snapshot(doc)}
        if op == "create_blob":
            import base64
            doc = req.get("doc_id", self.doc_id)
            blob_id = service.create_blob(
                doc, req["blob_id"], base64.b64decode(req["data"]))
            return {"rid": rid, "blob_id": blob_id}
        if op == "read_blob":
            import base64
            doc = req.get("doc_id", self.doc_id)
            data = service.read_blob(doc, req["blob_id"])
            return {"rid": rid, "data": base64.b64encode(data).decode()}
        if op == "get_help":
            # Headless agent runners poll assignments; doc_id None spans
            # all documents (the agent-pool discovery shape). With auth
            # enabled this is privileged: assignment records expose doc and
            # client ids across tenants, so an agent-scoped token gates it.
            self._require_agent_scope(req)
            return {"rid": rid,
                    "tasks": service.help_tasks(req.get("doc_id"))}
        if op == "complete_help":
            self._require_agent_scope(req)
            service.complete_help(req["key"])
            return {"rid": rid, "ok": True}
        if op == "get_metrics":
            # service-monitor surface: one scrape = front-door counters +
            # the assembly's shared registry (deli/scribe/merge-host/...).
            snap = dict(self.server.metrics.snapshot())
            service_metrics = getattr(service, "metrics", None)
            if service_metrics is not None and service_metrics \
                    is not self.server.metrics:
                snap.update(service_metrics.snapshot())
            return {"rid": rid, "metrics": snap}
        if op == "disconnect":
            if self.connection is not None:
                self.connection.close()
                self.connection = None
            self.close_viewer()
            return {"rid": rid, "ok": True}
        if op == "viewer_resume":
            # Re-enter the live stream after a lag-drop (the client has
            # caught up via snapshot + get_deltas). A resync storm is a
            # join storm: the same reservation gate applies.
            viewers = getattr(service, "viewers", None)
            if viewers is None or self.viewer_id is None:
                return {"rid": rid, "error": "no viewer session"}
            # Directory-aware resume: a room spread across replicas
            # hands each resuming viewer ITS hash-assigned host — the
            # client redials the label and re-joins there, which is how
            # one hot doc's audience lands on N replicas.
            redirect = self._read_redirect(rid, "viewer",
                                           key=req.get("client_key"))
            if redirect is not None:
                return redirect
            retry = viewers.admit_join(self.doc_id, req.get("client_key"),
                                       tenant_id=self.tenant_id)
            if retry is not None:
                return {"rid": rid, "error": "throttled",
                        "retry_after_s": retry}
            hello = viewers.resume(self.viewer_id)
            return {"rid": rid, **hello}
        if op == "storm_flush":
            storm = getattr(service, "storm", None)
            if storm is None:
                return {"rid": rid, "error": "storm path not enabled"}
            storm.flush()
            return {"rid": rid, "ok": True}
        return {"rid": rid, "error": f"unknown op {op!r}"}

    def _placement_redirect(self, rid) -> dict | None:
        """Cluster-aware connect (ROADMAP item 2 residue): consult the
        placement directory so a client dialing the wrong host learns
        the owner AT CONNECT TIME (``moved_to``) instead of connecting
        locally and only discovering the move from per-frame nacks; a
        doc mid-migration answers "migrating" with the blackout hint.
        Runs AFTER token validation (and claims the tenant) — placement
        is cluster topology, and an unauthenticated prober must not
        enumerate doc→host mappings through the connect path."""
        placement = getattr(getattr(self.server.service, "storm", None),
                            "placement", None)
        if placement is None:
            return None
        code, owner = placement.route(self.doc_id)
        if code == "moved":
            return {"rid": rid, "error": "moved", "retryable": True,
                    "moved_to": owner,
                    "retry_after_s": placement.retry_after_s}
        if code == "migrating":
            return {"rid": rid, "error": "migrating", "retryable": True,
                    "retry_after_s": placement.retry_after_s}
        return None

    def _read_redirect(self, rid, kind: str, doc: str | None = None,
                       key: str | None = None) -> dict | None:
        """Read-tier routing (server/read_replica.py): on a leader with
        a replica directory, directory-assigned read classes answer
        ``moved`` with the serving replica's label (clients hash-spread
        across a doc's label list by ``client_key``); on a replica, the
        self-router sheds writes — and reads it cannot serve — back to
        the leader. No router attached = no redirect (every assembly
        without a replica tier)."""
        router = getattr(self.server.service, "read_router", None)
        if router is None:
            return None
        target = router.route_read(doc if doc is not None
                                   else self.doc_id, kind, key=key)
        if target is None:
            return None
        return {"rid": rid, "error": "moved", "retryable": True,
                "moved_to": target,
                "retry_after_s": router.retry_after_s}

    def _serve_read(self, rid, fn) -> dict:
        """Run one service read/branch verb, mapping a replica-raised
        redirect (anything carrying ``moved_to`` — duck-typed so no
        replica import rides every assembly) to the retryable ``moved``
        response the drivers' redial machinery already understands."""
        try:
            return fn()
        except Exception as err:
            moved = getattr(err, "moved_to", None)
            if moved is None:
                raise
            return {"rid": rid, "error": "moved", "retryable": True,
                    "moved_to": moved,
                    "retry_after_s": getattr(err, "retry_after_s",
                                             0.05)}

    def _connect_viewer(self, req: dict, rid) -> dict:
        """``mode="viewer"`` connect (the broadcast viewer plane,
        server/broadcaster.py): token-authenticated like any connect but
        NEVER debits write/connect admission, never sequences a
        CLIENT_JOIN, never allocates merge/ack state — the session joins
        the doc's fan-out room and drains broadcast frames. Join storms
        gate through the plane's own TokenBucket with claimable
        reservations."""
        # Mirror the write-path connect guard: a second connect on one
        # socket must not leak the first plane registration (an orphaned
        # viewer would double-push frames and outlive the session).
        assert self.viewer_id is None, "already connected"
        service = self.server.service
        viewers = getattr(service, "viewers", "unsupported")
        if viewers == "unsupported":
            return {"rid": rid, "error": "viewer plane not enabled"}
        if viewers is None:
            # Assemblies that carry the seam but were built without a
            # plane (bare RouterliciousService) get the default lazily —
            # same contract as an in-process mode="viewer" connect.
            from .broadcaster import ViewerPlane
            viewers = ViewerPlane(service,
                                  metrics=getattr(service, "metrics",
                                                  None))
        if self.server.tenants is not None:
            from .riddler import AuthError
            token = req.get("token")
            if not token:
                raise AuthError("connect requires a token")
            claims = self.server.tenants.validate_token(
                token, document_id=self.doc_id)
            self.tenant_id = claims.get("tenantId", "default")
        redirect = self._placement_redirect(rid)
        if redirect is None:
            # Replica-directory routing: a directory-assigned room's
            # viewers land on their hash-assigned replica at CONNECT
            # time (writer traffic never routes here).
            redirect = self._read_redirect(rid, "viewer",
                                           key=req.get("client_key"))
        if redirect is not None:
            return redirect
        retry = viewers.admit_join(self.doc_id, req.get("client_key"),
                                   tenant_id=self.tenant_id)
        if retry is not None:
            return {"rid": rid, "error": "throttled",
                    "retry_after_s": retry}
        hello = viewers.join(self.doc_id, self.push,
                             pending_probe=self._pending_probe())
        self.viewer_id = hello["viewer_id"]
        self._on_viewer_connected()
        self.server.metrics.counter("alfred.viewer_connects").inc()
        return {"rid": rid, "client_id": hello["viewer_id"],
                "viewer": True, "seq": hello["seq"],
                "viewers": hello["viewers"]}

    def _require_agent_scope(self, req: dict) -> None:
        if self.server.tenants is None:
            return
        from ..protocol.messages import ScopeType
        from .riddler import AuthError
        token = req.get("token")
        if not token:
            raise AuthError("agent control requires a token")
        claims = self.server.tenants.validate_token(token)
        if ScopeType.AGENT not in claims.get("scopes", ()):
            raise AuthError("agent scope required")


class _ClientSession(RequestSession):
    """RequestSession over an asyncio stream writer."""

    def __init__(self, server: "AlfredServer",
                 writer: asyncio.StreamWriter) -> None:
        super().__init__(server)
        self.writer = writer
        self.outbox: asyncio.Queue = asyncio.Queue()

    def push(self, payload: dict) -> None:
        self.outbox.put_nowait(payload)

    def _pending_probe(self):
        # Viewer lag detection: the session outbox depth IS the
        # transport backlog for the asyncio door.
        return self.outbox.qsize

    async def writer_loop(self) -> None:
        while True:
            payload = await self.outbox.get()
            if payload is None:
                break
            # encode_push: pre-encoded RawBody / columnar StormAck go out
            # without a JSON pass; plain dicts encode as before.
            self.writer.write(frame_body(encode_push(payload)))
            await self.writer.drain()

    def drop(self) -> None:
        # Runs on the event-loop thread (service pumps happen inside
        # handle_request): closing the transport unblocks the session's
        # read_frame, whose teardown path finishes the cleanup.
        self.push(None)
        try:
            self.writer.close()
        except RuntimeError:
            pass  # loop already torn down


class AlfredServer:
    def __init__(self, service, host: str = "127.0.0.1", port: int = 0,
                 logger: TelemetryLogger | None = None,
                 metrics: MetricsRegistry | None = None,
                 tenants=None, throttler=None, admission=None) -> None:
        self.service = service
        self.host = host
        self.port = port
        self.logger = logger if logger is not None else NullLogger()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # Optional riddler integration: a TenantManager enforces token auth
        # on connect; an AdmissionController (token buckets + pressure
        # shed) rate-limits connects/submits/reads/signals. ``throttler``
        # (the legacy fixed-window surface) is honored when no admission
        # controller is given.
        self.tenants = tenants
        self.throttler = throttler
        self.admission = admission
        self._server: asyncio.AbstractServer | None = None

    async def start(self) -> int:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self.logger.send_event("AlfredListening", port=self.port)
        return self.port

    async def serve_forever(self) -> None:
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        session = _ClientSession(self, writer)
        writer_task = asyncio.create_task(session.writer_loop())
        try:
            while True:
                try:
                    body = await read_frame_raw(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                if is_storm_body(body):
                    resp = session.handle_binary(
                        body, ingress_ns=time.monotonic_ns())
                    if resp is not None:
                        session.push(resp)
                    continue
                req = decode_body(body)
                try:
                    resp = session.handle_request(req)
                except Exception as err:  # report, keep the socket alive
                    self.logger.send_error("AlfredRequestFailed", err,
                                           op=req.get("op"))
                    resp = {"rid": req.get("rid"), "error": repr(err)}
                session.push(resp)
        finally:
            if session.connection is not None:
                session.connection.close()
            session.close_viewer()
            try:
                session.push(None)
                await writer_task
            except RuntimeError:
                pass  # event loop already torn down mid-disconnect
            finally:
                try:
                    writer.close()
                except RuntimeError:
                    pass  # transport.close on an already-closed loop


def build_default_service(data_dir: str | None = None, merge_host=True,
                          native_bus: bool = False,
                          batched_cadence: bool = False,
                          native_fanout: bool = False,
                          device="cuda"):
    """Standalone assembly: routerlicious lambdas (+ device merge host,
    + durable file-backed storage when ``data_dir`` is given, + the C++
    shuttle bus with ``native_bus`` in in-memory mode). With
    ``batched_cadence`` the service never pumps inline — the operator
    ticks it (alfred --cadence-ms runs the tick loop) and deli sequences
    through the device-batched host, the BASELINE throughput shape.
    Both device hosts run on ``device`` (the card unless the caller asks
    for the CPU)."""
    from ..utils import MetricsRegistry
    from .routerlicious import RouterliciousService
    metrics = MetricsRegistry()  # one registry spans the whole assembly
    kwargs: dict = {"metrics": metrics}
    if merge_host:
        from .merge_host import KernelMergeHost
        kwargs["merge_host"] = KernelMergeHost(device=device)
    if batched_cadence:
        from .kernel_host import KernelSequencerHost
        kwargs["auto_pump"] = False
        kwargs["batched_deli_host"] = KernelSequencerHost(device=device)
    if native_bus and data_dir is None:
        from .native_bus import make_message_bus
        kwargs["bus"] = make_message_bus()
    if native_fanout:
        from ..native.fanout import make_fanout
        kwargs["fanout"] = make_fanout()
    if data_dir is not None:
        from .durable_store import (
            DurableMessageBus, FileStateStore, GitSnapshotStore)
        from .historian import Historian
        kwargs["bus"] = DurableMessageBus(f"{data_dir}/bus")
        kwargs["store"] = FileStateStore(f"{data_dir}/state")
        kwargs["snapshots"] = Historian(GitSnapshotStore(f"{data_dir}/git"),
                                        metrics=metrics)
    service = RouterliciousService(**kwargs)
    # The broadcast viewer plane (mode="viewer" connects) rides every
    # standalone assembly: construction is O(1) — its fan-out spine is
    # lazy, so a deployment that never sees a viewer pays nothing.
    from .broadcaster import ViewerPlane
    ViewerPlane(service, metrics=metrics)
    return service


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7070)
    parser.add_argument("--no-merge-host", action="store_true",
                        help="skip the device kernel host (CPU-only box)")
    parser.add_argument("--data-dir", default=None,
                        help="directory for durable bus/state/snapshots; "
                             "omitted = in-memory (tinylicious mode)")
    parser.add_argument("--native-bus", action="store_true",
                        help="run the in-memory bus on the C++ shuttle")
    parser.add_argument("--native-fanout", action="store_true",
                        help="broadcast through the C++ fan-out service "
                             "(Redis pub/sub analog)")
    parser.add_argument("--cadence-ms", type=int, default=None,
                        help="batched-cadence mode: sequence through the "
                             "device host on this tick interval instead "
                             "of inline per submit")
    parser.add_argument("--device", default="cuda",
                        help="device the kernel hosts run on (cuda, or "
                             "cpu for the kernels' plain versions)")
    args = parser.parse_args(argv)
    if args.native_bus and args.data_dir is not None:
        parser.error("--native-bus is in-memory only; it cannot be "
                     "combined with --data-dir (the durable bus)")
    if args.cadence_ms is not None and args.cadence_ms <= 0:
        parser.error("--cadence-ms must be a positive interval")

    service = build_default_service(args.data_dir,
                                    merge_host=not args.no_merge_host,
                                    native_bus=args.native_bus,
                                    batched_cadence=args.cadence_ms
                                    is not None,
                                    native_fanout=args.native_fanout,
                                    device=args.device)
    # The device hosts' devices, printed after READY (``none`` without
    # a kernel host) so an operator sees where the kernels run; then the
    # classes of the bus and the fan-out, so a quiet fall back to their
    # Python twins shows.
    devices = " ".join(
        str(h.device) for h in (getattr(service, "merge_host", None),
                                getattr(service, "_batched_deli_host", None))
        if h is not None) or "none"
    hops = " ".join(type(hop).__name__ if hop is not None else "none"
                    for hop in (service.bus, service.fanout))

    async def run() -> None:
        server = AlfredServer(service, args.host, args.port)
        port = await server.start()
        if args.cadence_ms is not None:
            async def tick_loop() -> None:
                while True:
                    await asyncio.sleep(args.cadence_ms / 1000)
                    try:
                        service.pump()  # one batched device tick
                    except Exception as err:  # a dead loop halts ALL
                        print(f"TICK ERROR {err!r}",  # sequencing
                              file=sys.stderr, flush=True)
            # The loop keeps only a weak reference to tasks; anchor it on
            # the server so GC can never silently stop the tick loop.
            server._tick_task = asyncio.get_running_loop().create_task(
                tick_loop())
        print(f"READY {port}", flush=True)
        print(f"DEVICE {devices}", flush=True)
        print(f"HOPS {hops}", flush=True)
        await server.serve_forever()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main(sys.argv[1:])
