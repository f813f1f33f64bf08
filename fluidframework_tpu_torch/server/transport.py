"""Networked replication transport: the wire under the plane.

The replication tier — quorum-shipped WAL batches, replicated head
flips, read replicas tailing a follower — runs over one seam,
``ReplicaLink.call()``. In process that is a direct method call that
can never time out, partition, reorder or duplicate. This module puts
a real network under the same seam:

* :class:`ReplicaServer` / :class:`ReplicaServerThread` — host a
  :class:`~.replication.ReplicaNode` behind an asyncio TCP listener.
  The framing is ``server/alfred.py``'s: a 4-byte big-endian length
  prefix, ``MAX_FRAME``-bounded, one response frame per request frame.
  Replication frames (storm-codec bodies) carry ``ReplicaNode.on_frame``
  BYTE-FOR-BYTE — the gap/dup/nack stream protocol, the version stamps
  and the incarnation fencing are the same bytes whether the follower
  is a local object or another OS process. JSON bodies are control
  frames (``hello``, ``ping``, ``shutdown`` + caller-registered verbs —
  the read-replica children register ``read_at``/``get_deltas`` here,
  so the ``ReplicaDirectory`` reads ride the same socket).
* :class:`NetworkReplicaLink` — the client half, a drop-in for
  ``ReplicaLink`` (same ``call(frame) -> header`` contract, so
  ``ReplicationPlane`` needs no transport-specific code): blocking
  socket per link, per-call deadline, bounded retries with exponential
  backoff + decorrelated jitter, transparent reconnection. Retrying a
  frame is safe BECAUSE the replica protocol is idempotent (dup
  delivery acks, gaps nack into the leader's resync) — the transport
  leans on the stream protocol instead of duplicating its sequencing.
* :class:`FaultyTransport` — a seeded, deterministic link-fault
  injector in the spirit of ``utils/faults.py`` crashpoints: named
  faults (``drop``, ``delay``, ``dup``, ``reorder``, ``slow``,
  ``partition``, ``partition_send``, ``partition_recv``) installable
  per edge from a plan, so the chaos harness drives real network
  pathology — not just ``kill -9``.

Failure detection rides the same frames: every successful call renews
the link's lease on the leader (``ReplicationPlane.heartbeat`` probes
idle links and trips ``quorum_ok`` when fewer than ``acks_required``
leases are fresh), and every inbound frame stamps the FOLLOWER's
``last_frame_monotonic`` (surfaced as ``leader_silence_s`` in
``hello`` — the promotion-eligibility signal a cluster harness polls).
"""

from __future__ import annotations

import asyncio
import json
import random
import socket
import threading
import time

from ..protocol.codec import frame_body, is_storm_body
from .alfred import read_frame_raw_sync
from .replication import ReplicationLinkDown, _frame

#: Per-call socket deadline (connect and round trip alike). Generous:
#: a follower fsync under load is milliseconds; seconds means dead.
DEFAULT_CALL_TIMEOUT_S = 5.0

#: Bounded retransmits per call — each retry reconnects, so a bounced
#: follower process is transparently redialed mid-stream.
DEFAULT_RETRIES = 3

#: Exponential backoff base/cap between retransmits. Jitter is
#: multiplicative in [0.5, 1.5) from the link's own seeded RNG, so a
#: partition healing under N leaders does not produce N synchronized
#: retry storms.
BACKOFF_BASE_S = 0.05
BACKOFF_MAX_S = 1.0

#: Failure-detector defaults (``ReplicationPlane.start_failure_detector``):
#: probe cadence and the lease a silent follower holds before it stops
#: counting toward the quorum.
HEARTBEAT_INTERVAL_S = 0.5
LEASE_S = 2.0

#: Installable link faults (see :class:`FaultyTransport`). ``partition``
#: drops both directions; ``partition_send`` loses requests (the
#: follower never sees the frame); ``partition_recv`` delivers the
#: frame but loses the response (the asymmetric half — the follower's
#: state advances while the leader counts a failure and retries, the
#: duplicate-delivery path exercised for real).
LINK_FAULTS = ("drop", "delay", "dup", "reorder", "slow",
               "partition", "partition_send", "partition_recv")


def _percentile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1)))
    return sorted_vals[idx]


# -- server half ---------------------------------------------------------------


class ReplicaServer:
    """Serve one :class:`ReplicaNode` over asyncio TCP. Storm-codec
    bodies dispatch to ``node.on_frame`` (off the event loop — a
    follower fsync must not stall another connection's heartbeat);
    JSON bodies dispatch to control handlers. Built-in controls:

    * ``hello`` — ``{node_id, len, hseq, heads, role, incarnation,
      leader_silence_s}``: the link handshake AND the promotion-
      eligibility scrape (``leader_silence_s`` past the lease means
      this follower stopped hearing from its leader).
    * ``ping`` — liveness, no node state touched.
    * ``shutdown`` — close the node (releasing its WAL — the step a
      cluster harness takes before promoting this directory) and stop
      serving.

    Extra verbs come from ``handlers`` (``name -> callable(dict) ->
    dict``) — the read-replica child registers its read surface here.
    """

    def __init__(self, node, host: str = "127.0.0.1", port: int = 0,
                 handlers: dict | None = None) -> None:
        self.node = node
        self.host = host
        self.port = port
        self.handlers = dict(handlers or {})
        self._server: asyncio.AbstractServer | None = None
        self._shutdown = asyncio.Event()
        self.stats = {"frames": 0, "control": 0, "bad_frames": 0}

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, host=self.host, port=self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def serve_until_shutdown(self) -> None:
        await self._shutdown.wait()
        self.close()

    def close(self) -> None:
        if self._server is not None:
            self._server.close()
            self._server = None

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        from .alfred import read_frame_raw
        try:
            while True:
                body = await read_frame_raw(reader)
                if is_storm_body(body):
                    self.stats["frames"] += 1
                    resp = await asyncio.to_thread(
                        self.node.on_frame, bytes(body))
                else:
                    self.stats["control"] += 1
                    resp = await self._control(bytes(body))
                writer.write(frame_body(resp))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            writer.close()

    async def _control(self, body: bytes) -> bytes:
        try:
            req = json.loads(body.decode())
            op = req.get("op")
            if op == "ping":
                out = {"ok": True}
            elif op == "hello":
                out = self._hello()
            elif op == "shutdown":
                await asyncio.to_thread(self.node.close)
                out = {"ok": True, "closed": True}
                self._shutdown.set()
            elif op in self.handlers:
                out = await asyncio.to_thread(self.handlers[op], req)
            else:
                out = {"error": f"unknown op {op!r}"}
        except Exception as err:  # a broken verb must not kill the link
            self.stats["bad_frames"] += 1
            out = {"error": f"{type(err).__name__}: {err}"}
        return json.dumps(out).encode()

    def _hello(self) -> dict:
        node = self.node
        last = getattr(node, "last_frame_monotonic", None)
        return {
            "ok": True,
            "node_id": node.node_id,
            "role": getattr(node, "role", "follower"),
            "len": node.log_len,
            "hseq": node.max_hseq,
            "incarnation": getattr(node, "incarnation", 0),
            "heads": sorted([hseq, key, handle] for key, (hseq, handle)
                            in node.heads.items()),
            "leader_silence_s": (None if last is None
                                 else round(time.monotonic() - last, 6)),
        }


class ReplicaServerThread:
    """Own-loop wrapper: run a :class:`ReplicaServer` on a daemon
    thread (the conftest ``secure_alfred`` pattern) so synchronous
    hosts — tests, the follower child's main — get a listening port
    back without owning an event loop."""

    def __init__(self, node, host: str = "127.0.0.1", port: int = 0,
                 handlers: dict | None = None) -> None:
        self.server = ReplicaServer(node, host=host, port=port,
                                    handlers=handlers)
        self._loop = asyncio.new_event_loop()
        started = threading.Event()

        async def run() -> None:
            await self.server.start()
            started.set()

        self._thread = threading.Thread(
            target=lambda: (self._loop.run_until_complete(run()),
                            self._loop.run_forever()),
            daemon=True, name=f"replica-server-{node.node_id}")
        self._thread.start()
        if not started.wait(10):
            raise RuntimeError("replica server failed to start")

    @property
    def port(self) -> int:
        return self.server.port

    def close(self) -> None:
        def _shutdown() -> None:
            # Stop listening, cancel in-flight connection handlers, and
            # only THEN stop the loop — a handler parked in a read must
            # unwind (closing its writer) while the loop is still
            # alive, or teardown leaks a destroyed-pending task.
            self.server.close()
            for task in asyncio.all_tasks(self._loop):
                task.cancel()
            self._loop.call_soon(self._loop.stop)

        self._loop.call_soon_threadsafe(_shutdown)
        self._thread.join(10)


# -- client half ---------------------------------------------------------------


class NetworkReplicaLink:
    """One leader->follower edge over TCP: the ``ReplicaLink.call``
    contract (encoded frame in, decoded response header out) with
    deadlines, bounded retransmits and reconnection underneath. The
    handshake ``hello`` populates the node-shaped attributes
    (``node_id``/``log_len``/``max_hseq``/``heads``) the plane reads
    at construction, and ``self.node is self`` keeps every
    ``link.node.<attr>`` call site working unchanged."""

    def __init__(self, address, node_id: str | None = None,
                 call_timeout_s: float = DEFAULT_CALL_TIMEOUT_S,
                 retries: int = DEFAULT_RETRIES,
                 backoff_base_s: float = BACKOFF_BASE_S,
                 backoff_max_s: float = BACKOFF_MAX_S,
                 seed: int = 0) -> None:
        if isinstance(address, int):
            address = ("127.0.0.1", address)
        self.address = tuple(address)
        self.call_timeout_s = call_timeout_s
        self.retries = retries
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._rng = random.Random(f"{seed}:{self.address}")
        self._sock: socket.socket | None = None
        self._io_lock = threading.Lock()
        # Node-shaped surface (refreshed by hello()):
        self.node_id = node_id or f"{self.address[0]}:{self.address[1]}"
        self.log_len = 0
        self.max_hseq = 0
        self.heads: dict[str, tuple[int, str]] = {}
        self.incarnation = 0
        self.role = "follower"
        self.data_dir = None  # remote: promotion needs the local path
        self.last_ok: float = 0.0
        self.stats = {"calls": 0, "retransmits": 0, "reconnects": 0,
                      "timeouts": 0}
        self._rtts: list[float] = []
        self.hello()

    #: ``plane._acked[lk.node.node_id]`` etc. — the link self-describes.
    @property
    def node(self) -> "NetworkReplicaLink":
        return self

    # -- raw round trip --------------------------------------------------------

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self.address,
                                        timeout=self.call_timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.stats["reconnects"] += 1
        return sock

    def _roundtrip(self, body: bytes) -> bytes:
        with self._io_lock:
            if self._sock is None:
                self._sock = self._connect()
            sock = self._sock
            try:
                sock.settimeout(self.call_timeout_s)
                sock.sendall(frame_body(body))
                return read_frame_raw_sync(sock)
            except Exception:
                # Whatever failed, the stream is unusable mid-frame:
                # drop it and let the retry loop redial.
                self._sock = None
                try:
                    sock.close()
                except OSError:
                    pass
                raise

    def call_raw(self, body: bytes) -> bytes:
        """Deadline + bounded retransmits with jittered exponential
        backoff. Raises :class:`ReplicationLinkDown` once the budget is
        spent — the plane's transient-failure path (count, resync on
        next contact)."""
        self.stats["calls"] += 1
        last_err: Exception | None = None
        for attempt in range(self.retries + 1):
            if attempt:
                self.stats["retransmits"] += 1
                delay = min(self.backoff_max_s,
                            self.backoff_base_s * (2 ** (attempt - 1)))
                time.sleep(delay * (0.5 + self._rng.random()))
            try:
                t0 = time.perf_counter()
                resp = self._roundtrip(body)
                rtt = time.perf_counter() - t0
                self._rtts.append(rtt)
                if len(self._rtts) > 1024:
                    del self._rtts[:512]
                self.last_ok = time.monotonic()
                return resp
            except socket.timeout as err:
                self.stats["timeouts"] += 1
                last_err = err
            except OSError as err:
                last_err = err
        raise ReplicationLinkDown(
            f"{self.node_id}: {type(last_err).__name__}: {last_err}")

    # -- the ReplicaLink contract ----------------------------------------------

    def call(self, frame: bytes) -> dict:
        from ..protocol.codec import decode_storm_body
        hdr, _payload = decode_storm_body(self.call_raw(bytes(frame)))
        return hdr

    def control(self, op: str, **kw) -> dict:
        return json.loads(
            self.call_raw(json.dumps({"op": op, **kw}).encode()))

    def hello(self) -> dict:
        d = self.control("hello")
        self.node_id = d["node_id"]
        self.log_len = d["len"]
        self.max_hseq = d["hseq"]
        self.incarnation = d.get("incarnation", 0)
        self.role = d.get("role", "follower")
        self.heads = {key: (hseq, handle)
                      for hseq, key, handle in d.get("heads", ())}
        return d

    def transport_stats(self) -> dict:
        """Aggregatable wire stats (plane gauges / monitor line)."""
        return {"rtt_s": list(self._rtts), **self.stats}

    def close(self) -> None:
        with self._io_lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None


# -- fault injection -----------------------------------------------------------


class FaultyTransport:
    """Deterministic link-fault wrapper around any ``call``-shaped link
    (in-process or network). Faults are installed BY NAME per edge —
    ``install("drop", p=0.2)`` — or wholesale from a plan dict
    (``{edge: {fault: params}}``, the shape
    ``utils/faults.link_fault_plan_from_env`` parses), and healed with
    :meth:`heal`. Probabilistic faults draw from a per-edge seeded RNG,
    so a chaos scenario replays byte-identically.

    Fault semantics (all surfaced to the caller exactly as a real
    network would surface them — the plane must survive each through
    its ordinary retry/resync/dup machinery):

    * ``partition`` — every call fails, nothing delivered.
    * ``partition_send`` — requests lost: fail, nothing delivered.
    * ``partition_recv`` — responses lost: the frame IS delivered
      (follower state advances), then the call fails. The leader's
      retransmit becomes a genuine duplicate delivery.
    * ``drop`` (p) — per-call loss, nothing delivered.
    * ``delay`` (s, p) / ``slow`` (s) — added latency before delivery.
    * ``dup`` (p) — the frame delivers twice; the second (idempotent)
      response is returned.
    * ``reorder`` (p) — the frame is HELD and delivered before the
      next call instead (a genuine out-of-order arrival at the node);
      the caller sees a nack carrying the follower's current length,
      exactly what a reordering network produces, and the plane
      resyncs.
    """

    def __init__(self, inner, edge: str = "link", seed: int = 0,
                 plan: dict | None = None) -> None:
        self.inner = inner
        self.edge = edge
        self.rng = random.Random(f"{seed}:{edge}")
        self.faults: dict[str, dict] = {}
        self._held: list[bytes] = []
        self.stats = {name: 0 for name in LINK_FAULTS}
        self.stats["delivered"] = 0
        for name, params in (plan or {}).get(edge, {}).items():
            self.install(name, **params)

    #: the plane reads ``link.node.<attr>`` through the wrapper.
    @property
    def node(self):
        return self.inner.node

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def install(self, name: str, **params) -> None:
        if name not in LINK_FAULTS:
            raise ValueError(f"unknown link fault {name!r} "
                             f"(known: {LINK_FAULTS})")
        self.faults[name] = params

    def heal(self, name: str | None = None) -> None:
        if name is None:
            self.faults.clear()
        else:
            self.faults.pop(name, None)

    def _chance(self, params: dict) -> bool:
        return self.rng.random() < float(params.get("p", 1.0))

    def _deliver_held(self) -> None:
        while self._held:
            try:
                self.inner.call(self._held.pop(0))
            except Exception:
                pass  # a held frame lost to a second fault stays lost

    def call(self, frame: bytes) -> dict:
        f = self.faults
        if "partition" in f:
            self.stats["partition"] += 1
            raise ReplicationLinkDown(f"{self.edge}: partition")
        if "partition_send" in f:
            self.stats["partition_send"] += 1
            raise ReplicationLinkDown(f"{self.edge}: partition (send)")
        if "slow" in f:
            self.stats["slow"] += 1
            time.sleep(float(f["slow"].get("s", 0.01)))
        if "delay" in f and self._chance(f["delay"]):
            self.stats["delay"] += 1
            time.sleep(float(f["delay"].get("s", 0.01)))
        if "drop" in f and self._chance(f["drop"]):
            self.stats["drop"] += 1
            raise ReplicationLinkDown(f"{self.edge}: dropped")
        self._deliver_held()
        if "reorder" in f and self._chance(f["reorder"]):
            # Hold this frame past the next one. The synchronous nack
            # (with the follower's REAL length, probed through the
            # link) is what a reordered arrival looks like from the
            # sender: not-yet-appended, resync me.
            self.stats["reorder"] += 1
            self._held.append(bytes(frame))
            try:
                have = self.inner.call(_frame("probe", {})).get("len", 0)
            except Exception:
                have = 0
            return {"v": 1, "k": "nack", "len": have, "reason": "reorder"}
        if "partition_recv" in f:
            self.stats["partition_recv"] += 1
            try:
                self.inner.call(frame)  # delivered; the ack is lost
            except Exception:
                pass
            raise ReplicationLinkDown(
                f"{self.edge}: partition (response lost)")
        self.stats["delivered"] += 1
        hdr = self.inner.call(frame)
        if "dup" in f and self._chance(f["dup"]):
            self.stats["dup"] += 1
            hdr = self.inner.call(frame)  # idempotent re-delivery
        return hdr


__all__ = [
    "DEFAULT_CALL_TIMEOUT_S", "DEFAULT_RETRIES", "HEARTBEAT_INTERVAL_S",
    "LEASE_S", "LINK_FAULTS", "ReplicaServer", "ReplicaServerThread",
    "NetworkReplicaLink", "FaultyTransport",
]
