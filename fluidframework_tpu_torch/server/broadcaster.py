"""Broadcast viewer plane — serve one hot document to 100k read-only
viewers without touching the merge path.

Reference parity: the broadcaster lambda + Redis socket.io-adapter tier
(PAPER §2.6/§2.9) — huge live-event audiences consume the sequenced op
stream and summaries through a dedicated fan-out tier; they never enter
admission accounting, sequencing, or per-connection ack bookkeeping.
Here that tier is :class:`ViewerPlane`:

* a **viewer** is a ``mode="viewer"`` connect (alfred / routerlicious):
  no CLIENT_JOIN, no quorum entry, no deli row, no admission token
  debit — it joins the document's room in the native fan-out service
  (``native/fanout.cpp``) and drains broadcast frames.
* each serving tick's broadcast frame is serialized **once per doc per
  tick** (``codec.encode_viewer_tick_body`` for storm ticks;
  ``codec.encode_ops_event``'s shared :class:`BroadcastBatch` body on
  the per-op path) and fanned out in **O(batch) native writes** — one
  ``fanout_publish_batch`` call however many documents ticked, one
  refcounted payload however many viewers the room holds.
* **slow viewers lag-drop, never stall the tick**: every viewer
  subscriber carries a shallow per-sub queue bound
  (``fanout_set_queue_limit``); a viewer whose queue overflows (or whose
  transport probe reports a deep outbox) is dropped from the room and
  handed a ``viewer_resync`` directive — it catches up from the latest
  snapshot + ``get_deltas`` (which serves cold docs from their cold-head
  tick index without hydrating, the cold-doc read path) and re-enters
  the live stream via ``viewer_resume``.
* **join storms are admission-gated** through the existing
  :class:`~.riddler.TokenBucket` reservation
  machinery: a refused join debits the bucket once and the (doc,
  client) reservation is CLAIMABLE at the hint — a 100k-viewer stampede
  drains at exactly the bucket rate instead of re-colliding.
* presence is **interest-sampled** (server/audience.py shape): a new
  viewer receives a bounded roster sample plus the exact total, and
  peers receive coalesced count updates — never one join event per
  member.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from ..protocol.codec import (
    BroadcastBatch,
    RawBody,
    encode_body,
    encode_ops_event,
    encode_viewer_tick_body,
)
from ..utils import MetricsRegistry


class _Viewer:
    """One registered viewer session: its fan-out subscriber, transport
    push, and lag bookkeeping. ``sub`` is None while lag-dropped
    (awaiting ``viewer_resume``)."""

    __slots__ = ("vid", "doc_id", "push", "pending_probe", "sub",
                 "lag_drops", "delivered")

    def __init__(self, vid: str, doc_id: str,
                 push: Callable[[Any], None],
                 pending_probe: Callable[[], int] | None) -> None:
        self.vid = vid
        self.doc_id = doc_id
        self.push = push
        self.pending_probe = pending_probe
        self.sub: int | None = None
        self.lag_drops = 0
        self.delivered = 0


class ViewerConnection:
    """Duck-typed connection for in-process ``mode="viewer"`` connects
    (routerlicious.connect): read-only — ``submit`` raises; payloads
    arrive through the handler exactly as the wire would carry them
    (dicts for control events, :class:`RawBody` broadcast frames)."""

    def __init__(self, plane: "ViewerPlane", vid: str,
                 doc_id: str) -> None:
        self._plane = plane
        self.client_id = vid
        self.doc_id = doc_id
        self.mode = "viewer"
        self.open = True
        self.on_closed: Callable[[], None] | None = None

    def submit(self, messages) -> None:
        raise PermissionError("viewer connections are read-only")

    def signal(self, content) -> None:
        raise PermissionError("viewer connections are read-only")

    def close(self) -> None:
        if self.open:
            self.open = False
            self._plane.leave(self.client_id)


class ViewerPlane:
    """The read-only fan-out tier over one service assembly. Attaches
    itself as ``service.viewers``; the storm harvest and the per-op
    broadcaster publish through it, the front doors join/leave viewer
    sessions through it."""

    #: Room-name prefix in the shared fan-out service: viewer rooms are
    #: namespaced apart from the writer-connection rooms the service's
    #: own ``_drain_fanout`` consumes.
    ROOM_PREFIX = "v::"

    def __init__(self, service, fanout=None,
                 metrics: MetricsRegistry | None = None,
                 join_rate_per_s: float = 2000.0,
                 join_burst: float | None = None,
                 tenant_join_rate_per_s: float | None = None,
                 tenant_join_burst: float | None = None,
                 max_lag_frames: int = 256,
                 transport_lag_frames: int = 1024,
                 roster_sample: int = 16,
                 clock: Callable[[], float] = time.monotonic) -> None:
        from .riddler import TokenBucket
        self.service = service
        self._own_fanout = fanout
        self.metrics = metrics if metrics is not None \
            else getattr(service, "metrics", None) or MetricsRegistry()
        self._clock = clock
        #: Per-viewer fan-out queue bound: a viewer this many frames
        #: behind the broadcast head lag-drops to a resync instead of
        #: buffering on (the per-room outbox bound of fanout.cpp).
        self.max_lag_frames = max_lag_frames
        #: Transport-probe bound (session outbox depth) — the second lag
        #: signal, for transports whose backpressure the fan-out queue
        #: cannot see.
        self.transport_lag_frames = transport_lag_frames
        self.roster_sample = roster_sample
        # Join-storm admission: one bucket for the plane, per-(doc,
        # client) CLAIMABLE reservations (the admit_connect /
        # residency-hydration pattern — a refusal debits once; the
        # client claims the slot by returning at/after the hint).
        self.joins = TokenBucket(join_rate_per_s, join_burst, clock=clock)
        # Per-tenant viewer-join budget (the multi-tenant noisy-neighbor
        # extension of the read side): one tenant's 100k-viewer event
        # must not consume the whole PLANE's join budget and lock every
        # other tenant's viewers out. Stacked UNDER the plane bucket —
        # the tenant tier debits first, and a plane-tier refusal refunds
        # it (the AdmissionController two-tier pattern). None (default)
        # = plane-wide gating only, the pre-QoS behavior.
        self.tenant_joins = (
            TokenBucket(tenant_join_rate_per_s, tenant_join_burst,
                        clock=clock)
            if tenant_join_rate_per_s is not None else None)
        self._reservations: dict[tuple[str, str], float] = {}
        self._next_vid = 1
        self._viewers: dict[str, _Viewer] = {}
        self._rooms: dict[str, dict[str, _Viewer]] = {}
        # Per-room (members, subs-array) cache for the batched drain —
        # invalidated on any membership change.
        self._room_arrays: dict[str, tuple] = {}
        #: doc -> last sequenced seq published on this plane (the viewer
        #: hello's stream position; catch-up reads cover anything older).
        self._last_seq: dict[str, int] = {}
        #: doc -> viewer count at the last presence announce (coalescing
        #: state: announce when the population moved enough to matter).
        self._announced: dict[str, int] = {}
        self.stats = {"joins": 0, "leaves": 0, "join_nacks": 0,
                      "tick_encodes": 0, "ops_encodes": 0,
                      "lag_drops": 0, "resumes": 0,
                      "presence_updates": 0, "broadcast_bytes": 0,
                      "delivered_frames": 0}
        service.viewers = self

    # -- fan-out backend -------------------------------------------------------

    @property
    def fanout(self):
        """The delivery spine, created lazily so an assembly that never
        sees a viewer pays nothing: the service's own fan-out when one is
        configured, else a plane-private instance (native when the
        toolchain allows — the O(batch) publish + refcounted payloads)."""
        if self._own_fanout is None:
            service_fanout = getattr(self.service, "fanout", None)
            if service_fanout is not None:
                self._own_fanout = service_fanout
            else:
                from ..native.fanout import make_fanout
                self._own_fanout = make_fanout()
        return self._own_fanout

    def _room(self, doc_id: str) -> str:
        return self.ROOM_PREFIX + doc_id

    def has_viewers(self, doc_id: str) -> bool:
        return bool(self._rooms.get(doc_id))

    def room_size(self, doc_id: str) -> int:
        return len(self._rooms.get(doc_id, ()))

    @property
    def active_rooms(self) -> int:
        return len(self._rooms)

    # -- join / leave ----------------------------------------------------------

    def _tenant_nack(self, tenant_id: str | None, retry: float) -> float:
        self.stats["join_nacks"] += 1
        if tenant_id is not None:
            self.metrics.counter(
                f"viewer.tenant.{tenant_id}.join_nacks").inc()
        return retry

    def admit_join(self, doc_id: str,
                   client_key: str | None = None,
                   tenant_id: str | None = None) -> float | None:
        """Viewer-join admission (the storm gate for 100k viewers
        arriving at a live event's start): None admits; a refusal
        returns ``retry_after_s`` and — when ``client_key`` is given —
        reserves a claimable slot so the retry never re-debits.
        ``tenant_id`` (the SESSION's validated tenant) additionally
        debits that tenant's join budget when one is configured — a
        plane-tier refusal refunds it."""
        # Claims are namespaced by tenant: client_key is CLIENT-
        # controlled, so a reservation must only be claimable by the
        # tenant that paid for it — a cross-tenant claim on a guessed
        # key would admit past an exhausted tenant budget for free and
        # steal the payer's slot.
        rkey = None
        if client_key is not None:
            rkey = (doc_id, client_key if tenant_id is None
                    else f"{tenant_id}:{client_key}")
        if self.tenant_joins is not None and tenant_id is not None:
            if rkey is None or rkey not in self._reservations:
                # A claim of an existing reservation already paid the
                # tenant tier when it was reserved — never re-debit it.
                retry = self.tenant_joins.try_consume(
                    f"tenant/{tenant_id}")
                if retry is not None:
                    return self._tenant_nack(tenant_id, retry)
        if client_key is None:
            retry = self.joins.try_consume(f"viewers/{doc_id}")
            if retry is not None:
                self.stats["join_nacks"] += 1
                if self.tenant_joins is not None and tenant_id is not None:
                    self.tenant_joins.refund(f"tenant/{tenant_id}")
            return retry
        reserved_at = self._reservations.get(rkey)
        now = self._clock()
        if reserved_at is not None:
            wait = reserved_at - now
            if wait <= 1e-9:
                del self._reservations[rkey]
                return None  # claiming the already-debited slot
            self.stats["join_nacks"] += 1
            return wait  # came back early; the same slot stands
        if len(self._reservations) > 8192:
            # Viewers that never returned leave unclaimed entries; sweep
            # the long-expired ones (the bounded-memory rule every
            # reservation table here follows).
            from .riddler import TokenBucket
            horizon = now - TokenBucket.RESERVE_HORIZON_S
            for key in [k for k, at in self._reservations.items()
                        if at < horizon]:
                del self._reservations[key]
        retry, reserved = self.joins.reserve(f"viewers/{doc_id}")
        if retry is not None:
            if reserved:
                # The slot IS claimable later — the tenant debit stands
                # and covers the claim (which never re-debits).
                self._reservations[rkey] = now + retry
            elif self.tenant_joins is not None and tenant_id is not None:
                # Horizon-full refusal: nothing stayed debited on the
                # plane tier, so nothing may stay debited on the tenant
                # tier either (the retry pays both afresh).
                self.tenant_joins.refund(f"tenant/{tenant_id}")
            self.stats["join_nacks"] += 1
        return retry

    def join(self, doc_id: str, push: Callable[[Any], None],
             pending_probe: Callable[[], int] | None = None) -> dict:
        """Register one admitted viewer: fan-out subscriber with the
        shallow viewer queue bound, room membership, presence snapshot.
        Returns the viewer hello ({viewer_id, seq, viewers})."""
        vid = f"viewer-{self._next_vid}"
        self._next_vid += 1
        viewer = _Viewer(vid, doc_id, push, pending_probe)
        self._subscribe(viewer)
        self._viewers[vid] = viewer
        room = self._rooms.setdefault(doc_id, {})
        room[vid] = viewer
        self._room_arrays.pop(doc_id, None)
        self.stats["joins"] += 1
        self.metrics.counter("viewer.joins").inc()
        self._update_gauges()
        # Interest-sampled presence: the NEWCOMER gets a bounded sample
        # + the exact total; peers get a coalesced count update only
        # when the population moved materially (_maybe_announce).
        sample = [v.vid for _, v in zip(range(self.roster_sample),
                                        room.values())]
        push({"event": "viewer_presence", "doc": doc_id,
              "total": len(room), "sample": sample})
        self._maybe_announce(doc_id)
        return {"viewer_id": vid, "seq": self._last_seq.get(doc_id, 0),
                "viewers": len(room)}

    def _subscribe(self, viewer: _Viewer) -> None:
        fanout = self.fanout
        sub = fanout.connect()
        set_limit = getattr(fanout, "set_queue_limit", None)
        if set_limit is not None:  # duck-typed legacy fanouts lack it
            set_limit(sub, self.max_lag_frames)
        fanout.join(sub, self._room(viewer.doc_id))
        viewer.sub = sub

    def leave(self, vid: str) -> None:
        viewer = self._viewers.pop(vid, None)
        if viewer is None:
            return
        if viewer.sub is not None:
            self.fanout.disconnect(viewer.sub)
            viewer.sub = None
        room = self._rooms.get(viewer.doc_id)
        self._room_arrays.pop(viewer.doc_id, None)
        if room is not None:
            room.pop(vid, None)
            if not room:
                del self._rooms[viewer.doc_id]
                self._announced.pop(viewer.doc_id, None)
            else:
                self._maybe_announce(viewer.doc_id)
        self.stats["leaves"] += 1
        self._update_gauges()

    def resume(self, vid: str) -> dict:
        """Re-enter the live stream after a lag-drop: fresh subscriber,
        same viewer id. The caller re-gates through :meth:`admit_join`
        first (a resync storm is a join storm). Returns the hello shape
        (the seq the live stream resumes from; the gap up to it is the
        client's snapshot + get_deltas catch-up)."""
        viewer = self._viewers.get(vid)
        if viewer is None:
            raise KeyError(f"unknown viewer {vid!r}")
        if viewer.sub is None:
            self._subscribe(viewer)
            self._rooms.setdefault(viewer.doc_id, {})[vid] = viewer
            self._room_arrays.pop(viewer.doc_id, None)
            self.stats["resumes"] += 1
            self.metrics.counter("viewer.resumes").inc()
            self._update_gauges()
        return {"viewer_id": vid,
                "seq": self._last_seq.get(viewer.doc_id, 0),
                "viewers": self.room_size(viewer.doc_id)}

    # -- broadcast (the serving-tick hop) --------------------------------------

    def publish_ticks(self, items: list) -> int:
        """One serving tick's viewer broadcasts: ``items`` is
        ``[(doc_id, n_seq, first, last, msn, count, words_bytes), ...]``
        (only docs the storm harvest found viewer rooms for). Each doc's
        frame is encoded ONCE; the whole batch goes down in one
        ``fanout_publish_batch`` native call; the room queues then drain
        to the member transports with lag-drop applied. Returns frames
        delivered."""
        pubs = []
        docs = []
        for doc_id, n_seq, first, last, msn, count, words in items:
            if not self._rooms.get(doc_id):
                continue
            body = encode_viewer_tick_body(doc_id, n_seq, first, last,
                                           msn, count, words)
            self.stats["tick_encodes"] += 1
            if last > self._last_seq.get(doc_id, 0):
                self._last_seq[doc_id] = last
            pubs.append((self._room(doc_id), body))
            docs.append(doc_id)
        if not pubs:
            return 0
        self.metrics.counter("viewer.tick_encodes").inc(len(pubs))
        fanout = self.fanout
        batch_pub = getattr(fanout, "publish_batch", None)
        if batch_pub is not None:
            batch_pub(pubs)
        else:
            for room, body in pubs:
                fanout.publish(room, body)
        return self._drain(docs)

    def publish_ops(self, doc_id: str, messages) -> int:
        """Per-op path (the JSON broadcaster lambda): the sequenced-op
        batch encodes once through the shared :class:`BroadcastBatch`
        body and fans out to the doc's viewer room. Returns frames
        delivered (0 with no viewers — and no encode either)."""
        if not self._rooms.get(doc_id):
            return 0
        last = max((m.sequence_number for m in messages), default=0)
        if last <= self._last_seq.get(doc_id, 0):
            return 0  # bus crash-replay: the room already saw this op
        if not isinstance(messages, BroadcastBatch):
            messages = BroadcastBatch(messages)
        body = encode_ops_event(messages)
        self.stats["ops_encodes"] += 1
        self._last_seq[doc_id] = last
        self.fanout.publish(self._room(doc_id), body)
        return self._drain([doc_id])

    def _drain(self, docs: list[str]) -> int:
        """Deliver the named rooms' queued frames to their member
        transports. A member whose fan-out subscriber was evicted (queue
        past its viewer bound) or whose transport probe reports a deep
        outbox is LAG-DROPPED: removed from the room, handed a resync
        directive, tick untouched. Big rooms drain through
        ``fanout_poll_batch`` — FFI cost O(1) per room pass, however
        many viewers the room holds."""
        fanout = self.fanout
        batch_poll = getattr(fanout, "poll_batch", None)
        delivered = 0
        drained_bytes = 0
        for doc_id in docs:
            room = self._rooms.get(doc_id)
            if not room:
                continue
            # Transport-probe lag check first (Python-side signal the
            # fan-out cannot see); probes are rare, the attr check isn't.
            for viewer in [v for v in room.values()
                           if v.pending_probe is not None
                           and v.sub is not None
                           and v.pending_probe()
                           > self.transport_lag_frames]:
                self._lag_drop(viewer, "transport-backlog")
            if not room:
                continue
            if batch_poll is None:
                d, b = self._drain_room_single(room)
            else:
                d, b = self._drain_room_batched(doc_id, room, batch_poll)
            delivered += d
            drained_bytes += b
        if delivered:
            self.stats["delivered_frames"] += delivered
            self.stats["broadcast_bytes"] += drained_bytes
            self.metrics.counter("viewer.delivered_frames").inc(delivered)
            self.metrics.counter("viewer.broadcast_bytes").inc(
                drained_bytes)
        return delivered

    def _drain_room_single(self, room: dict) -> tuple[int, int]:
        """Per-subscriber drain for duck-typed fan-outs without the
        batch surface."""
        fanout = self.fanout
        delivered = drained_bytes = 0
        for viewer in list(room.values()):
            sub = viewer.sub
            if sub is None:
                continue
            if fanout.was_evicted(sub):
                self._lag_drop(viewer, "fanout-backlog")
                continue
            while (payload := fanout.poll(sub)) is not None:
                try:
                    viewer.push(RawBody(payload))
                except Exception:
                    self._lag_drop(viewer, "transport-dead")
                    break
                viewer.delivered += 1
                delivered += 1
                drained_bytes += len(payload)
        return delivered, drained_bytes

    def _drain_room_batched(self, doc_id: str, room: dict,
                            batch_poll) -> tuple[int, int]:
        import numpy as np

        entry = self._room_arrays.get(doc_id)
        if entry is None:
            members = [v for v in room.values() if v.sub is not None]
            subs = np.array([v.sub for v in members], np.int64)
            self._room_arrays[doc_id] = entry = (members, subs)
        members, subs = entry
        if not members:
            return 0, 0
        delivered = drained_bytes = 0
        dead: list[_Viewer] = []   # ordered for the lag-drop pass below
        dead_set: set[int] = set()  # O(1) membership by viewer identity
        while True:
            buf, lens = batch_poll(subs)
            lens_l = lens.tolist()
            off = 0
            any_frame = False
            for i, viewer in enumerate(members):
                length = lens_l[i]
                if length < 0:
                    if length == -2 and viewer.sub is not None \
                            and id(viewer) not in dead_set:
                        dead.append(viewer)  # evicted under the bound
                        dead_set.add(id(viewer))
                    continue
                any_frame = True
                payload = RawBody(buf[off:off + length])
                off += length
                if id(viewer) in dead_set:
                    continue  # popped alongside peers; viewer is gone
                try:
                    viewer.push(payload)
                except Exception:
                    dead.append(viewer)
                    dead_set.add(id(viewer))
                    continue
                viewer.delivered += 1
                delivered += 1
                drained_bytes += length
            if not any_frame:
                break
        for viewer in dead:
            self._lag_drop(viewer, "fanout-backlog")
        return delivered, drained_bytes

    def drain_all(self) -> int:
        """Idle-loop drain (bridge pump / operator tick): flush every
        room's queued frames — viewers on slow transports keep receiving
        between ticks."""
        return self._drain(list(self._rooms))

    def _lag_drop(self, viewer: _Viewer, reason: str,
                  moved_to: str | None = None) -> None:
        """Drop one slow viewer out of the live stream: its queue is
        abandoned (the fan-out already evicted it, or we disconnect it
        here), a ``viewer_resync`` directive tells the client to catch
        up via snapshot + get_deltas — the cold-read path, so a
        doc that went cold meanwhile still serves the gap from its
        cold-head tick index — and ``viewer_resume`` re-enters the
        stream. The serving tick never waits. ``moved_to`` (live
        migration re-home) names the doc's new owning host: the client
        resumes THERE after the catch-up."""
        if viewer.sub is not None:
            self.fanout.disconnect(viewer.sub)
            viewer.sub = None
        room = self._rooms.get(viewer.doc_id)
        self._room_arrays.pop(viewer.doc_id, None)
        if room is not None:
            room.pop(viewer.vid, None)
            if not room:
                self._rooms.pop(viewer.doc_id, None)
                self._announced.pop(viewer.doc_id, None)
        viewer.lag_drops += 1
        self.stats["lag_drops"] += 1
        self.metrics.counter("viewer.lag_drops").inc()
        directive = {"event": "viewer_resync", "doc": viewer.doc_id,
                     "seq": self._last_seq.get(viewer.doc_id, 0),
                     "reason": reason}
        if moved_to is not None:
            directive["moved_to"] = moved_to
        try:
            viewer.push(directive)
        except Exception:
            pass  # transport already dead; the session teardown cleans up
        self._update_gauges()

    def resync_room(self, doc_id: str, reason: str = "moved",
                    moved_to: str | None = None) -> int:
        """Re-home one doc's WHOLE viewer room (live migration): every
        member is dropped to the resync dance with the new owner in the
        directive — catch-up rides the cold-read path (the migrated
        doc's cold head serves the gap without hydrating here), the
        resume lands on ``moved_to``. Returns viewers re-homed."""
        room = self._rooms.get(doc_id)
        if not room:
            return 0
        members = list(room.values())
        for viewer in members:
            self._lag_drop(viewer, reason, moved_to=moved_to)
        self.stats["rehomes"] = self.stats.get("rehomes", 0) \
            + len(members)
        self.metrics.counter("viewer.rehomes").inc(len(members))
        return len(members)

    def spread_room(self, doc_id: str, labels: list[str],
                    reason: str = "moved") -> dict[str, int]:
        """Re-home one doc's room ACROSS hosts (the read-replica tier's
        audience spread): each member is lag-dropped with a
        hash-assigned label in its directive, so the room's audience
        lands spread over ``labels`` instead of stampeding one host.
        A member that re-resolves through the replica directory instead
        may hash to a different label — either way it lands on a
        replica serving the doc. Returns viewers re-homed per label."""
        import zlib
        room = self._rooms.get(doc_id)
        if not room or not labels:
            return {}
        members = list(room.values())
        counts: dict[str, int] = {}
        for viewer in members:
            label = labels[zlib.crc32(viewer.vid.encode())
                           % len(labels)]
            self._lag_drop(viewer, reason, moved_to=label)
            counts[label] = counts.get(label, 0) + 1
        self.stats["rehomes"] = self.stats.get("rehomes", 0) \
            + len(members)
        self.metrics.counter("viewer.rehomes").inc(len(members))
        return counts

    # -- presence --------------------------------------------------------------

    def _maybe_announce(self, doc_id: str) -> None:
        """Coalesced presence: publish ONE count-update frame to the room
        when the population moved ≥ 1/8 since the last announce (O(log)
        announcements per audience doubling — never one per join)."""
        room = self._rooms.get(doc_id)
        if not room:
            return
        total = len(room)
        last = self._announced.get(doc_id, 0)
        if last and abs(total - last) < max(1, last // 8):
            return
        self._announced[doc_id] = total
        body = RawBody(encode_body({"event": "viewer_presence",
                                    "doc": doc_id, "total": total}))
        self.stats["presence_updates"] += 1
        self.metrics.counter("viewer.presence_updates").inc()
        self.fanout.publish(self._room(doc_id), body)

    # -- observability ---------------------------------------------------------

    def _update_gauges(self) -> None:
        self.metrics.gauge("viewer.rooms").set(len(self._rooms))
        self.metrics.gauge("viewer.viewers").set(len(self._viewers))


__all__ = ["ViewerPlane", "ViewerConnection"]
