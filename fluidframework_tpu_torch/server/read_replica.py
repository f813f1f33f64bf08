"""Read-replica tier — scale the ENTIRE read surface across follower
hosts.

A :class:`ReadReplica` is a read-only serving host built over one
replication follower (:class:`~.replication.ReplicaNode`): it tails the
replica WAL through the node's subscribe seam + its own poll loop,
maintains per-doc SCALAR state (the history plane's ``_FoldState`` twin
— no device rows and no kernel on the replica), and serves every
read class the leader serves:

* **viewer rooms** — the replica runs its OWN
  :class:`~.broadcaster.ViewerPlane` (this object is the duck-typed
  service it attaches to) and re-broadcasts each tailed tick's
  ``(doc, n_seq, first, last, msn, count, words)`` window exactly as
  the leader's harvest would, so a room re-homed here via the existing
  ``viewer_resync``/``moved_to`` machinery sees byte-identical frames;
* **viewer catch-up resync** + **cold get_deltas** —
  :meth:`get_deltas` materializes the tailed records through the SAME
  ``materialize_storm_records`` the leader's cold path uses;
* **read_at historical reads** and **branch reads** — :meth:`read_at`
  is the history plane's exact read path (``summary_base_for`` +
  ``fold_storm_records`` over the shared snapshot store and the tailed
  WAL), so replica-served state is byte-identical by construction.

Staleness is explicit, never silent: the replica tracks its applied
frontier against what the leader shipped (``lag``, per-doc
:meth:`doc_seq`, the ``replica.staleness_s`` apply-latency histogram),
and a read addressing seqs ABOVE the replica's watermark first waits
``read_wait_s`` for the stream to catch up, then sheds a retryable
``moved`` redirect naming the leader (:class:`ReplicaRedirect` — the
client's existing redial machinery lands it there). Reads the replica
can never serve — mega-promoted docs, whose lane-era records translate
only through the leader's live ``LaneCombineLog`` state — redirect
immediately (the documented scope limit; the leader keeps serving
them).

The :class:`ReplicaDirectory` maps rooms/read-classes to replica
labels in the SHARED snapshot store (upload-then-``set_head``, so
under a :class:`~.replication.ReplicatedHeadStore` every flip is
ship-then-flip for free, like ``__placement__``), and the leader's
front door consults a :class:`ReplicaRouter` over it: viewer connects
and cold reads for directory-assigned docs answer ``moved`` with a
replica label — a room's audience spreads across N replicas by hashing
each client's key over the doc's label list while writer traffic never
leaves the leader.

Chaos kill classes (tools/chaos.py ``--replicas``):
``replica.mid_apply`` (records indexed, broadcast not yet published)
and ``replica.mid_read`` (inside a replica-served read) — a restarted
replica rebuilds its whole index by re-polling its own durable WAL
from zero, and the digest-vs-twin bar proves replica reads never
change bytes.
"""

from __future__ import annotations

import json
import struct
import threading
import time
import zlib
from typing import Any

from ..utils import MetricsRegistry, faults
from .history import (
    HistoryError,
    fold_storm_records,
    load_summary_record,
    summary_base_for,
)

#: Shared-store key of the replica directory record (the
#: ``__placement__`` pattern — upload then set_head, ship-then-flip
#: under a ReplicatedHeadStore).
REPLICA_DIRECTORY_KEY = "__replicas__"

#: Read classes the directory can route (writes NEVER route to a
#: replica — the leader owns sequencing).
READ_KINDS = ("viewer", "read_at", "get_deltas")


class ReplicaRedirect(RuntimeError):
    """This read must be served elsewhere (stale replica, or a read
    class this replica cannot serve): carries the ``moved_to`` host
    label + retry hint, the same shape placement's live-migration
    redirects use — the front door maps it to a retryable ``moved``
    response and the client's existing redial machinery converges."""

    def __init__(self, message: str, moved_to: str | None,
                 retry_after_s: float = 0.05) -> None:
        super().__init__(message)
        self.moved_to = moved_to
        self.retry_after_s = retry_after_s


class ReplicaDirectory:
    """Rooms/read-classes → replica labels, in the shared store.

    One record under :data:`REPLICA_DIRECTORY_KEY`:
    ``{"replicas": {label: meta}, "rooms": {doc: [label, ...]},
    "reads": {kind: [label, ...]}}``. A doc's room assignment wins over
    the read-class default; a multi-label assignment spreads clients by
    ``crc32(client_key) % len(labels)`` (the ``genesis_owner`` idiom),
    which is how ONE hot doc's audience lands on N replicas."""

    def __init__(self, store) -> None:
        self.store = store
        self._rec: dict[str, Any] = {"kind": "replica-directory",
                                     "replicas": {}, "rooms": {},
                                     "reads": {}}
        self.reload()

    def reload(self) -> None:
        """Re-read the shared head (cross-host visibility: another
        host's assignment is live here after its flip)."""
        handle = self.store.head(REPLICA_DIRECTORY_KEY)
        if handle is None:
            return
        rec = self.store.get(REPLICA_DIRECTORY_KEY, handle)
        if rec is not None:
            self._rec = rec

    def _save(self) -> None:
        # Upload-then-flip: under a ReplicatedHeadStore the set_head
        # ships to the follower quorum BEFORE the backend flips, so a
        # failover never resurrects a stale directory.
        handle = self.store.upload(REPLICA_DIRECTORY_KEY, self._rec)
        self.store.set_head(REPLICA_DIRECTORY_KEY, handle)

    # -- membership ------------------------------------------------------------

    @property
    def replicas(self) -> dict[str, dict]:
        return dict(self._rec["replicas"])

    def register(self, label: str, **meta: Any) -> None:
        self._rec["replicas"][label] = dict(meta)
        self._save()

    def deregister(self, label: str) -> None:
        """Drop a dead replica: its room/read assignments fall back to
        the surviving labels (or the leader when none remain)."""
        self._rec["replicas"].pop(label, None)
        for key in ("rooms", "reads"):
            table = self._rec[key]
            for name in list(table):
                table[name] = [l for l in table[name] if l != label]
                if not table[name]:
                    del table[name]
        self._save()

    # -- assignment ------------------------------------------------------------

    def assign_room(self, doc: str, labels) -> None:
        labels = [labels] if isinstance(labels, str) else list(labels)
        self._rec["rooms"][doc] = labels
        self._save()

    def unassign_room(self, doc: str) -> None:
        if self._rec["rooms"].pop(doc, None) is not None:
            self._save()

    def assign_reads(self, kind: str, labels) -> None:
        """Default routing for one read class (``read_at`` /
        ``get_deltas`` / ``viewer``) when a doc has no room
        assignment."""
        if kind not in READ_KINDS:
            raise ValueError(f"unknown read class {kind!r} "
                             f"(one of {READ_KINDS})")
        labels = [labels] if isinstance(labels, str) else list(labels)
        self._rec["reads"][kind] = labels
        self._save()

    def rooms_on(self, label: str) -> list[str]:
        return [doc for doc, labels in self._rec["rooms"].items()
                if label in labels]

    def rooms(self) -> dict[str, list[str]]:
        return {doc: list(labels)
                for doc, labels in self._rec["rooms"].items()}

    def replica_for(self, doc: str, kind: str | None = None,
                    key: str | None = None) -> str | None:
        """The serving replica for one (doc, read-class, client): the
        doc's room assignment wins, else the read-class default; None
        = the leader serves. Deregistered labels never route."""
        labels = self._rec["rooms"].get(doc)
        if not labels and kind is not None:
            labels = self._rec["reads"].get(kind)
        if not labels:
            return None
        labels = [l for l in labels if l in self._rec["replicas"]]
        if not labels:
            return None
        ident = key if key else doc
        return labels[zlib.crc32(ident.encode()) % len(labels)]


class ReplicaRouter:
    """Leader-side read routing (``service.read_router``, consulted by
    the front door): writes always serve locally; directory-assigned
    read classes answer with the replica label to redirect to."""

    def __init__(self, directory: ReplicaDirectory,
                 local_label: str | None = None,
                 retry_after_s: float = 0.05,
                 metrics: MetricsRegistry | None = None) -> None:
        self.directory = directory
        self.local_label = local_label
        self.retry_after_s = retry_after_s
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry()
        self._c_redirects = self.metrics.counter("replica.redirects")

    def route_read(self, doc: str, kind: str,
                   key: str | None = None) -> str | None:
        if kind not in READ_KINDS:
            return None  # writes (and unknown classes) stay local
        self.directory.reload()
        target = self.directory.replica_for(doc, kind, key)
        if target is None or target == self.local_label:
            return None
        self._c_redirects.inc()
        return target


class _SelfRouter:
    """Replica-side routing: writes (and reads this replica cannot
    serve) shed back to the leader; everything else serves here."""

    def __init__(self, replica: "ReadReplica") -> None:
        self.replica = replica

    @property
    def retry_after_s(self) -> float:
        return self.replica.retry_after_s

    def route_read(self, doc: str, kind: str,
                   key: str | None = None) -> str | None:
        if kind in READ_KINDS and self.replica.can_serve(doc):
            return None
        return self.replica.leader_label


class ReadReplica:
    """One read-only serving host over a replication follower.

    Duck-types the slice of the service surface the front door's read
    ops touch (``read_at``/``get_deltas``/``viewers``/``metrics``), so
    an :class:`~.alfred.AlfredServer` can mount it directly; write
    verbs raise :class:`ReplicaRedirect` toward the leader.

    No kernel, no device rows, no merge host: state is the history
    plane's scalar fold over the shared snapshot store + the follower's
    own durable WAL. ``get_deltas`` serves the STORM record tier (the
    replicated total order); the leader-local per-op JSON tier (bus
    join/leave messages) stays with the leader — the same subset the
    chaos replication digests compare.
    """

    def __init__(self, node, snapshots, label: str,
                 leader_label: str | None = None,
                 datastore: str = "default", channel: str = "root",
                 read_wait_s: float = 0.25,
                 retry_after_s: float = 0.05,
                 metrics: MetricsRegistry | None = None,
                 fanout=None, viewer_plane: bool = True,
                 **viewer_kw: Any) -> None:
        self.node = node
        self.snapshots = snapshots
        self.label = label
        self.leader_label = leader_label
        self.datastore = datastore
        self.channel = channel
        self.read_wait_s = read_wait_s
        self.retry_after_s = retry_after_s
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry()
        self.fanout = fanout  # ViewerPlane's lazy-fanout seam
        node.role = "read-replica"
        #: WAL records applied (index frontier into the follower WAL).
        self.applied = 0
        #: doc -> [record dict, ...] in first_seq order — the replica's
        #: twin of the storm tick index (``n_seq > 0`` entries only,
        #: exactly what ``storm._doc_ticks`` indexes).
        self._doc_records: dict[str, list[dict]] = {}
        #: doc -> applied sequenced frontier (max last_seq tailed).
        self._doc_seq: dict[str, int] = {}
        #: branch doc -> {"parent", "seq", "name"} from tailed "hp"
        #: fork controls (lifecycle controls are never trimmed, so a
        #: from-zero re-poll always rebuilds this).
        self.branches: dict[str, dict] = {}
        #: Docs (and their lanes) ever mega-promoted: lane-era records
        #: translate only through the leader's combine logs, so these
        #: redirect — the documented replica scope limit.
        self._mega: set[str] = set()
        self._poll_lock = threading.Lock()
        # Arrival stamps from the subscribe seam (leader WAL-writer
        # thread → CHEAP: one dict store per record), drained by poll()
        # into the apply-latency histogram. Bounded: a replica that
        # stops polling must not grow this forever.
        self._arrivals: dict[int, float] = {}
        self._arrival_cap = 8192
        self.stats = {"polls": 0, "records_applied": 0,
                      "bad_records": 0, "stale_redirects": 0,
                      "room_stale_sheds": 0,
                      "reads": 0, "deltas": 0, "broadcast_ticks": 0}
        m = self.metrics
        self._g_applied = m.gauge("replica.applied")
        self._g_lag = m.gauge("replica.lag")
        self._h_staleness = m.histogram("replica.staleness_s")
        self._c_stale = m.counter("replica.stale_redirects")
        self._c_room_stale = m.counter("replica.room_stale_sheds")
        self.viewers = None
        if viewer_plane:
            from .broadcaster import ViewerPlane
            ViewerPlane(self, metrics=m, **viewer_kw)  # sets .viewers
        node.subscribe(self._on_shipped)
        self.read_router = _SelfRouter(self)
        self.poll()  # adopt whatever the follower WAL already holds

    # -- tail loop -------------------------------------------------------------

    def _on_shipped(self, start: int, records: list) -> None:
        """Subscribe-seam notifier (leader's WAL writer thread): stamp
        arrival times only — folding happens in :meth:`poll` on the
        replica's own time."""
        now = time.monotonic()
        arrivals = self._arrivals
        for i in range(start, start + len(records)):
            arrivals[i] = now
        while len(arrivals) > self._arrival_cap:
            arrivals.pop(next(iter(arrivals)), None)

    def poll(self, max_records: int | None = None) -> int:
        """Apply newly shipped WAL records: parse each storm header,
        register lifecycle controls, index per-doc records, and
        re-broadcast viewer tick windows to this replica's rooms.
        Returns records applied. Idempotent and restart-safe: a fresh
        replica over an existing follower directory re-polls from zero
        (retention fillers parse to docs-less no-ops)."""
        applied = 0
        with self._poll_lock:
            have = self.node.log_len
            stop = have if max_records is None \
                else min(have, self.applied + max_records)
            while self.applied < stop:
                idx = self.applied
                self._apply_record(idx)
                self.applied = idx + 1
                applied += 1
        if applied or self.stats["polls"] % 16 == 0:
            self._g_applied.set(self.applied)
            self._g_lag.set(self.lag)
        self.stats["polls"] += 1
        return applied

    def _apply_record(self, idx: int) -> None:
        data = bytes(self.node.read(idx))
        try:
            hlen = struct.unpack_from("<I", data)[0]
            header = json.loads(data[4:4 + hlen])
        except Exception:
            self.stats["bad_records"] += 1
            return  # never die on one bad blob; the index stays 1:1
        hp = header.get("hp")
        if hp is not None:
            self._apply_history_control(hp)
        mg = header.get("mg")
        if mg is not None:
            self._apply_mega_control(mg)
        ts = header.get("ts", 0)
        items = []
        viewers = self.viewers
        for entry in header.get("docs", ()):
            doc, client, cseq0, ref, count, ns, fs, ls, m, w_off = entry
            if ns <= 0:
                continue  # fully rejected batch: storm never indexes it
            self._doc_records.setdefault(doc, []).append({
                "client": client, "first_cseq": cseq0, "ref_seq": ref,
                "count": count, "n_seq": ns, "first_seq": fs,
                "last_seq": ls, "msn": m, "timestamp": ts,
                "tick": idx, "w_off": w_off})
            if ls > self._doc_seq.get(doc, 0):
                self._doc_seq[doc] = ls
            if viewers is not None and viewers._rooms.get(doc) \
                    and doc not in self._mega:
                words = data[4 + hlen + w_off:4 + hlen + w_off
                             + 4 * count]
                items.append((doc, ns, fs, ls, m, count, words))
        # Chaos kill class "mid-apply": records indexed/durable-applied
        # but this tick's viewer broadcast NOT yet published — a
        # restarted replica re-derives the identical index and the
        # re-homed viewers catch up through get_deltas, byte-identical.
        faults.crashpoint("replica.mid_apply")
        if items:
            viewers.publish_ticks(items)
            self.stats["broadcast_ticks"] += 1
        arrival = self._arrivals.pop(idx, None)
        if arrival is not None:
            self._h_staleness.observe(time.monotonic() - arrival)
        self.stats["records_applied"] += 1

    def _apply_history_control(self, event: dict) -> None:
        op = event.get("op")
        if op == "fork" and event["branch"] not in self.branches:
            self.branches[event["branch"]] = {
                "parent": event["parent"], "seq": int(event["seq"]),
                "name": event.get("name", event["branch"])}
        # pin/unpin/"trimmed" affect compaction policy, not reads —
        # the summary record's tail_floor is the read-side authority.

    def _apply_mega_control(self, event: dict) -> None:
        op = event.get("op")
        if op == "promote":
            doc = event["doc"]
            self._mega.add(doc)
            # Lane ids (megadoc.lane_id format, count + epoch ride the
            # control) — addressed directly they redirect too.
            lanes = int(event.get("lanes", 1))
            epoch = int(event.get("epoch", 0))
            pre = f"{doc}::~mg{epoch}." if epoch else f"{doc}::~mg"
            self._mega.update(f"{pre}{i}" for i in range(lanes))
        # A demoted doc STAYS redirected: its lane-era records still
        # translate only through the leader's combine logs.

    @property
    def lag(self) -> int:
        """Shipped-but-unapplied records (the replica's staleness bound
        in WAL ticks against what the leader has shipped here)."""
        return max(0, self.node.log_len - self.applied)

    def doc_seq(self, doc: str) -> int:
        """This replica's applied sequenced frontier for ``doc`` — what
        per-room staleness is measured against the leader's watermark."""
        return self._doc_seq.get(doc, 0)

    def room_staleness(self, doc: str,
                       leader_seq: int | None = None) -> int:
        """PER-ROOM staleness for ``doc`` in sequence numbers: a known
        leader sequenced watermark (the balancer scrapes it off the
        leader's doc ticks; a read carries it as the requested seq)
        minus this replica's addressable frontier, floored at 0.
        Without one, the shipped-but-unapplied record lag is the only
        local bound — shipping is FIFO, so zero lag means every room
        is exactly as fresh as the stream itself."""
        if leader_seq is None:
            return self.lag
        return max(0, int(leader_seq) - self.head_seq(doc))

    def can_serve(self, doc: str) -> bool:
        return doc not in self._mega

    # -- record access (the storm cold-path twins) -----------------------------

    def read_tick_words(self, tick: int) -> bytes:
        """Raw op-word bytes of one tailed WAL record (the replica's
        ``storm.read_tick_words``): header stripped, ``w_off`` byte
        offsets index straight in."""
        data = bytes(self.node.read(tick))
        hlen = struct.unpack_from("<I", data)[0]
        return data[4 + hlen:]

    def _records_for(self, doc: str, from_seq: int,
                     to_seq: int | None = None) -> list[dict]:
        hi = float("inf") if to_seq is None else to_seq
        floor = self._tail_floor(doc)
        lo = max(int(from_seq), floor)
        return [r for r in self._doc_records.get(doc, ())
                if not (r["last_seq"] <= lo or r["first_seq"] > hi)]

    def _tail_floor(self, doc: str) -> int:
        rec = load_summary_record(self.snapshots, doc)
        return int(rec.get("tail_floor", 0)) if rec is not None else 0

    # -- the read surface ------------------------------------------------------

    def head_seq(self, doc: str) -> int:
        """Newest seq addressable HERE: applied record frontier, the
        shared-store summary head, or a branch's fork seq."""
        last = self._doc_seq.get(doc, 0)
        rec = load_summary_record(self.snapshots, doc)
        if rec is not None:
            last = max(last, int(rec["seq"]))
        meta = self.branches.get(doc)
        if meta is not None:
            last = max(last, int(meta["seq"]))
        return last

    def read_at(self, doc: str, seq: int) -> dict:
        """Materialize ``doc``'s converged state at ``seq`` — the
        history plane's exact read path over the shared store + tailed
        records. A seq above this replica's watermark waits up to
        ``read_wait_s`` for the stream, then sheds a ``moved`` redirect
        to the leader (who alone may rule it beyond-head)."""
        self.poll()
        faults.crashpoint("replica.mid_read")
        seq = int(seq)
        self._require_servable(doc)
        deadline = time.monotonic() + self.read_wait_s
        shipped = self.node.log_len
        polls = 0
        while True:
            head = self.head_seq(doc)
            if seq <= head:
                state = self._state_at(doc, seq)
                self.stats["reads"] += 1
                return {"doc": doc, "seq": seq, "head_seq": head,
                        "entries": state.entries()}
            if time.monotonic() >= deadline:
                self._shed_stale(
                    f"seq {seq} is above this replica's watermark "
                    f"({head}) for {doc!r}")
            if polls and self.lag == 0 \
                    and self.node.log_len == shipped:
                # Early shed: everything shipped is applied and nothing
                # new arrived across a full grace poll — the missing seq
                # cannot materialize from records already here, so
                # burning the rest of ``read_wait_s`` only delays the
                # client's redial to the leader (who alone may rule the
                # seq beyond-head). The wait-then-shed decision is thus
                # per-ROOM: a busy stream keeps the wait alive, an idle
                # one sheds at once.
                self.stats["room_stale_sheds"] += 1
                self._c_room_stale.inc()
                self._shed_stale(
                    f"seq {seq} is above this replica's watermark "
                    f"({head}) for {doc!r} and the stream is idle")
            shipped = self.node.log_len
            time.sleep(0.002)
            self.poll()
            polls += 1

    def _state_at(self, doc: str, seq: int):
        meta = self.branches.get(doc)
        if meta is not None and seq < meta["seq"]:
            # History below the fork lives with the parent.
            return self._state_at(meta["parent"], seq)
        if seq < 0:
            raise HistoryError(f"negative seq {seq}")
        rec = load_summary_record(self.snapshots, doc)
        if rec is None and meta is not None:
            # Fork control tailed before the leader's seed summary
            # reached the shared store: momentarily stale, not absent.
            self._shed_stale(
                f"branch {doc!r} seed summary not yet visible")
        base = summary_base_for(self.snapshots, doc, seq, rec)
        if base.seq == seq:
            return base
        floor = int(rec.get("tail_floor", 0)) if rec is not None else 0
        if base.seq < floor and seq > base.seq:
            raise HistoryError(
                f"history of {doc!r} below seq {floor} is compacted "
                f"away (tail retention); only the summary chain's "
                f"exact states remain addressable there")
        state = base.copy()
        fold_storm_records(state,
                           self._records_for(doc, state.seq, seq),
                           seq, self.read_tick_words)
        state.seq = seq
        return state

    def get_deltas(self, doc: str, from_seq: int,
                   to_seq: int | None = None) -> list:
        """Sequenced messages in ``(from_seq, to_seq]`` from the tailed
        record tier (the replicated total order — the leader-local
        per-op JSON tier stays with the leader). A bounded ``to_seq``
        above the watermark waits briefly, then sheds to the leader;
        unbounded catch-up serves the applied frontier (the viewer
        resync contract: the live stream continues from wherever the
        reply ends)."""
        from .storm import materialize_storm_records
        self.poll()
        faults.crashpoint("replica.mid_read")
        self._require_servable(doc)
        if to_seq is not None:
            deadline = time.monotonic() + self.read_wait_s
            shipped = self.node.log_len
            polls = 0
            while self.head_seq(doc) < to_seq:
                if time.monotonic() >= deadline:
                    self._shed_stale(
                        f"get_deltas to_seq {to_seq} is above this "
                        f"replica's watermark "
                        f"({self.head_seq(doc)}) for {doc!r}")
                if polls and self.lag == 0 \
                        and self.node.log_len == shipped:
                    # Same early shed as read_at: an idle, fully
                    # applied stream cannot produce to_seq.
                    self.stats["room_stale_sheds"] += 1
                    self._c_room_stale.inc()
                    self._shed_stale(
                        f"get_deltas to_seq {to_seq} is above this "
                        f"replica's watermark "
                        f"({self.head_seq(doc)}) for {doc!r} and the "
                        f"stream is idle")
                shipped = self.node.log_len
                time.sleep(0.002)
                self.poll()
                polls += 1
        records = self._records_for(doc, from_seq, to_seq)
        messages = materialize_storm_records(
            records, self.datastore, self.channel,
            blob_reader=self.read_tick_words)
        messages.sort(key=lambda m: m.sequence_number)
        self.stats["deltas"] += 1
        return [m for m in messages
                if m.sequence_number > from_seq
                and (to_seq is None or m.sequence_number <= to_seq)]

    # -- write verbs: always the leader's --------------------------------------

    def connect(self, *_args, **kwargs):
        mode = kwargs.get("mode", "write")
        raise ReplicaRedirect(
            f"replica {self.label!r} is read-only: {mode!r} connects "
            f"are served by the leader", self.leader_label,
            self.retry_after_s)

    def fork_doc(self, doc: str, seq: int, name: str | None = None):
        raise ReplicaRedirect(
            f"fork of {doc!r} is a write — served by the leader",
            self.leader_label, self.retry_after_s)

    def merge_back(self, branch: str):
        raise ReplicaRedirect(
            f"merge_back of {branch!r} is a write — served by the "
            f"leader", self.leader_label, self.retry_after_s)

    # -- plumbing --------------------------------------------------------------

    def _require_servable(self, doc: str) -> None:
        if not self.can_serve(doc):
            raise ReplicaRedirect(
                f"{doc!r} is mega-promoted: lane-era records translate "
                f"only through the leader's combine logs",
                self.leader_label, self.retry_after_s)

    def _shed_stale(self, message: str) -> None:
        self.stats["stale_redirects"] += 1
        self._c_stale.inc()
        raise ReplicaRedirect(message, self.leader_label,
                              self.retry_after_s)

    def staleness(self) -> dict:
        """One scrape of this replica's staleness surface: WAL-record
        lag plus every tracked doc's applied seq frontier."""
        return {"lag_records": self.lag,
                "applied": self.applied,
                "doc_seq": dict(self._doc_seq)}

    def close(self) -> None:
        pass  # the follower node owns the durable state


__all__ = ["ReadReplica", "ReplicaDirectory", "ReplicaRouter",
           "ReplicaRedirect", "REPLICA_DIRECTORY_KEY", "READ_KINDS"]
