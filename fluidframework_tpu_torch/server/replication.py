"""Replication plane: quorum-shipped WAL batches, replicated head
flips, and leader failover — the jump from "crash-consistent process"
to "production cluster that loses hosts" (ROADMAP item 1).

Reference parity: the reference's ordering service is a durable,
highly-available CLUSTER — deli/scribe lambdas over Kafka, whose
partitions are themselves replicated to a follower quorum before an
offset is considered committed. Our reproduction's durability was one
host's fsync; this module adds the missing leg:

* **Log shipping** — :class:`ReplicationPlane` hooks the group-commit
  WAL's ``on_batch_durable`` seam (server/durable_store.py): every
  fsynced batch ships to F :class:`ReplicaNode` followers over the
  storm codec framing (versioned like the WAL "v" stamps), each
  follower appends the records at the SAME indices into its own
  CRC-framed replica log and fsyncs, and the plane advances a
  REPLICATED watermark once a quorum acked. The storm controller
  withholds client acks on ``min(durable, replicated)`` — an acked op
  now survives the leader's disk, not just its process.
* **Replicated head flips** — :class:`ReplicatedHeadStore` wraps a
  snapshot store and ships every ``set_head`` to the follower quorum
  BEFORE the backend flips (ship-then-flip). The ``__placement__``
  directory, storm checkpoints, cold-residency records and history
  summaries all flip through it, so a dead leader can never strand
  routing or cold state: promotion rolls the journaled flips forward.
* **Failover** — :func:`choose_promotion_candidate` picks the most
  advanced follower, :func:`promote_heads` applies its journaled head
  flips to the shared store, and a fresh storm stack built over the
  replica log (the follower lays its WAL out storm-shaped precisely
  for this) replays through the existing ``StormController.recover``
  path. The demoted ex-leader is FENCED: its plane stops shipping,
  its acks freeze at the replicated watermark, and ``_admit`` sheds
  every frame with a ``moved`` nack naming the new incarnation (the
  PR 16 ``moved_to`` machinery).

Quorum math: with F followers the leader counts itself, so a majority
of the F+1 replicas needs ``(F+1)//2`` follower acks — F=1 waits for
its only follower (2/2), F=2 for one of two (2/3). ``acks_required``
overrides it (F=2 with ``acks_required=2`` is chain-style full
replication). Head flips use the same quorum; an unreachable quorum
REFUSES the flip (checkpoint/migration fails loudly) so the backend
head can never run ahead of every follower's journal — the invariant
that makes promotion's roll-forward safe.

Port of ``fluidframework_tpu/server/replication.py``: host Python, line
for line, but :func:`promote` and :func:`make_replicated_host` take
``device`` (the card unless the caller asks for the CPU) and pass it to
:func:`~fluidframework_tpu_torch.parallel.placement.make_cluster_host`.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
from pathlib import Path

from ..native import OpLog
from ..protocol.codec import decode_storm_body, encode_storm_body
from ..utils import faults
from .durable_store import rewrite_oplog_records

#: Stream format stamp on every shipped frame ("v", exactly like the
#: storm WAL headers): a follower refuses frames newer than its reader.
REPLICATION_STREAM_VERSION = 1

#: The replica WAL lives storm-shaped inside the follower's data dir —
#: ``<dir>/spill/storm_tick_words.log`` — so promotion builds a serving
#: host DIRECTLY over the follower directory (same path the storm's own
#: spill WAL uses; see server/storm.py __init__).
REPLICA_WAL_RELPATH = os.path.join("spill", "storm_tick_words.log")

#: Journaled head flips (``[hseq, key, handle]`` records, CRC-framed).
REPLICA_HEADS_RELPATH = "replica_heads.log"

#: Journaled retention floors (one ASCII int per record): replica-side
#: WAL trim progress, durable so a restarted follower knows its replay
#: horizon without rescanning the log.
REPLICA_RETENTION_RELPATH = "replica_retention.log"

#: The follower's durable incarnation floor (one ASCII int, atomically
#: replaced): frames stamped with a LOWER incarnation are refused with
#: a ``fenced`` nack — a zombie ex-leader's ships are rejected ON THE
#: WIRE, not merely ignored, and the refusal survives a follower
#: restart.
REPLICA_INCARNATION_RELPATH = "replica_incarnation"

#: Kill classes for the chaos matrix: batch locally durable but not yet
#: shipped / shipped and quorum-acked but the leader's watermark not
#: yet advanced — recovery must prove no acked-replicated op is lost
#: whichever side of the ship the kill lands on.
REPLICATION_KILL_POINTS = ("repl.pre_ship", "repl.post_ship")

#: Records per resync batch frame (tail re-ship of a lagging follower).
RESYNC_BATCH_RECORDS = 64


class ReplicationLinkDown(OSError):
    """The follower link refused or dropped the frame (transport-level;
    the plane counts it and resyncs the follower later)."""


class ReplicationQuorumError(RuntimeError):
    """A head flip could not reach the follower quorum — the flip is
    REFUSED (backend untouched) so journals never lag the backend."""


def _frame(kind: str, header: dict, payload: bytes = b"") -> bytes:
    return encode_storm_body(
        {"v": REPLICATION_STREAM_VERSION, "k": kind, **header}, payload)


def _trimmed_filler() -> bytes:
    """The storm WAL's docs-less trimmed-tick blob — the SAME bytes
    ``server/storm.py trim_tick_blobs`` writes — so a retention-trimmed
    replica record still parses everywhere a real one would (promotion
    replay treats it as a no-op control tick, resync re-ships it
    verbatim). Imported lazily: the replica tier stays importable
    without pulling the torch-backed storm module in."""
    from .storm import STORM_WAL_VERSION
    header = json.dumps(
        {"v": STORM_WAL_VERSION, "ts": 0, "docs": [],
         "hp": {"op": "trimmed"}}, separators=(",", ":")).encode()
    return struct.pack("<I", len(header)) + header


class ReplicaNode:
    """One follower: a storm-shaped replica WAL plus a head-flip journal
    under its own data directory. Passive — it appends what the leader
    ships, fsyncs, and acks its log length; promotion turns the
    directory into a serving host.

    Batch protocol (all frames storm-codec bodies, ``v``-stamped):

    * ``batch`` ``{seq, lens}`` + concatenated record bytes — appended
      iff ``seq`` equals the local length. A duplicate delivery
      (``seq`` below the length) acks idempotently; a gap (``seq``
      ahead) nacks with the local length so the leader re-ships the
      missing tail. Torn frames (truncated payload, bad magic) are
      rejected before any append.
    * ``head`` ``{key, handle, hseq}`` — journaled iff ``hseq`` is new
      (monotonic per plane; duplicates ack idempotently).
    * ``heads`` ``{entries: [[hseq, key, handle], ...]}`` — bulk
      journal adoption (resync of a fresh/lagging follower).
    * ``probe`` — acks the current log length (resync discovery).
    """

    def __init__(self, data_dir: str | os.PathLike,
                 node_id: str | None = None, fsync: bool = True) -> None:
        root = Path(data_dir)
        (root / "spill").mkdir(parents=True, exist_ok=True)
        self.data_dir = str(root)
        self.node_id = node_id if node_id is not None else root.name
        self.fsync = fsync
        #: "follower" (pure failover candidate) or "read-replica" (a
        #: ReadReplica — server/read_replica.py — tails this node's WAL
        #: and serves the read surface off it). Descriptive only: the
        #: batch/head/trim protocol is identical either way.
        self.role = "follower"
        #: Tail seam subscribers: ``callback(start_index, records)``
        #: after each batch append (post-fsync). See :meth:`subscribe`.
        self._subscribers: list = []
        self._wal = OpLog(root / REPLICA_WAL_RELPATH)
        self._heads_log = OpLog(root / REPLICA_HEADS_RELPATH)
        self._retention_log = OpLog(root / REPLICA_RETENTION_RELPATH)
        #: Durable incarnation floor (wire fencing): the highest "inc"
        #: stamp ever accepted; lower-stamped frames nack ``fenced``.
        self._inc_path = root / REPLICA_INCARNATION_RELPATH
        self.incarnation = 0
        try:
            self.incarnation = int(self._inc_path.read_text())
        except (FileNotFoundError, ValueError):
            pass
        #: Monotonic stamp of the last frame heard from ANY leader —
        #: the follower-side lease (``hello`` surfaces it as
        #: ``leader_silence_s``; silence past the lease makes this
        #: node promotion-eligible).
        self.last_frame_monotonic: float | None = None
        self._retained_floor = 0
        for i in range(len(self._retention_log)):
            self._retained_floor = max(
                self._retained_floor, int(self._retention_log.read(i)))
        self._lock = threading.Lock()
        #: key -> (hseq, handle): the latest journaled flip per key.
        self.heads: dict[str, tuple[int, str]] = {}
        self.max_hseq = 0
        for i in range(len(self._heads_log)):
            hseq, key, handle = json.loads(self._heads_log.read(i))
            self.heads[key] = (hseq, handle)
            self.max_hseq = max(self.max_hseq, hseq)
        self.stats = {"batches": 0, "records": 0, "dup_records": 0,
                      "gap_nacks": 0, "head_flips": 0, "rejected": 0,
                      "retained_records": 0, "fenced_frames": 0}

    @property
    def log_len(self) -> int:
        with self._lock:
            return len(self._wal)

    @property
    def retained_floor(self) -> int:
        """Indices below this are retention-trimmed (filler bytes) —
        except the leader-named live set kept alongside each floor."""
        return self._retained_floor

    def subscribe(self, callback) -> None:
        """Tail seam: ``callback(start_index, records)`` fires after a
        batch appends (post-fsync) with the fresh record bytes in WAL
        order — how a read replica learns of new ticks without polling.
        Runs on the leader's WAL writer thread, so callbacks must be
        CHEAP (note a watermark, poke a condition); heavy folding
        belongs in the subscriber's own poll loop. Exceptions are
        swallowed like the WAL's own ``on_batch_durable`` hook — a
        broken reader must never nack the leader's ship."""
        self._subscribers.append(callback)

    def on_frame(self, frame: bytes) -> bytes:
        """Handle one shipped frame; returns the encoded response frame.
        Thread-safe (the leader ships batches from the WAL writer thread
        and head flips from the serving thread)."""
        try:
            hdr, payload = decode_storm_body(frame)
        except Exception as err:  # torn/alien frame
            self.stats["rejected"] += 1
            return _frame("nack", {"len": self.log_len,
                                   "reason": f"bad-frame: {err}"})
        if hdr.get("v", 0) > REPLICATION_STREAM_VERSION:
            self.stats["rejected"] += 1
            return _frame("nack", {"len": self.log_len,
                                   "reason": "version"})
        inc = int(hdr.get("inc", 0))
        if inc < self.incarnation:
            # Zombie leader: a NEWER incarnation already shipped here.
            # The frame is REFUSED on the wire (never appended, never
            # journaled) and the nack names the floor — the stale
            # plane's triage demotes itself on sight of it.
            self.stats["fenced_frames"] += 1
            return _frame("nack", {"len": self.log_len,
                                   "reason": "fenced",
                                   "inc": self.incarnation})
        if inc > self.incarnation:
            self._adopt_incarnation(inc)
        self.last_frame_monotonic = time.monotonic()
        kind = hdr.get("k")
        if kind == "batch":
            return self._on_batch(hdr, payload)
        if kind == "head":
            return self._on_head(hdr["hseq"], hdr["key"], hdr["handle"])
        if kind == "heads":
            with self._lock:
                for hseq, key, handle in hdr["entries"]:
                    self._journal_head(hseq, key, handle)
                if self.fsync:
                    self._heads_log.sync()
            return _frame("ack", {"len": self.log_len,
                                  "hseq": self.max_hseq})
        if kind == "probe":
            return _frame("ack", {"len": self.log_len,
                                  "hseq": self.max_hseq})
        if kind == "trim":
            return self._on_trim(hdr["floor"], hdr.get("keep"))
        self.stats["rejected"] += 1
        return _frame("nack", {"len": self.log_len, "reason": "kind"})

    def _on_batch(self, hdr: dict, payload) -> bytes:
        seq, lens = hdr["seq"], hdr["lens"]
        if sum(lens) != len(payload):
            # Torn mid-payload: the frame claims more record bytes than
            # arrived — reject whole (a partial append would CRC-frame
            # garbage at a real index and poison later reads).
            self.stats["rejected"] += 1
            return _frame("nack", {"len": self.log_len,
                                   "reason": "torn-payload"})
        fresh_start = 0
        fresh: list[bytes] = []
        with self._lock:
            have = len(self._wal)
            if seq > have:
                # Reordered/lost predecessor: refuse the gap, tell the
                # leader where the tail starts.
                self.stats["gap_nacks"] += 1
                return _frame("nack", {"len": have, "reason": "gap"})
            off = 0
            for i, ln in enumerate(lens):
                rec = bytes(payload[off:off + ln])
                off += ln
                if seq + i < have:
                    self.stats["dup_records"] += 1
                    continue  # duplicate delivery: already journaled
                got = self._wal.append(rec)
                assert got == seq + i, (got, seq + i)
                have = got + 1
                if not fresh:
                    fresh_start = got
                fresh.append(rec)
                self.stats["records"] += 1
            if fresh and self.fsync:
                self._wal.sync()
            self.stats["batches"] += 1
        if fresh:
            # Outside the lock: a subscriber may read back through the
            # node (read()/log_len take it).
            for cb in list(self._subscribers):
                try:
                    cb(fresh_start, fresh)
                except Exception:
                    pass
        return _frame("ack", {"len": have})

    def _on_head(self, hseq: int, key: str, handle: str) -> bytes:
        with self._lock:
            if self._journal_head(hseq, key, handle) and self.fsync:
                self._heads_log.sync()
            else:
                self.stats["dup_records"] += 1
        return _frame("ack", {"len": self.log_len, "hseq": self.max_hseq})

    def _journal_head(self, hseq: int, key: str, handle: str) -> bool:
        if hseq <= self.max_hseq:
            return False  # duplicate/old flip: idempotent
        self._heads_log.append(
            json.dumps([hseq, key, handle]).encode())
        self.heads[key] = (hseq, handle)
        self.max_hseq = hseq
        self.stats["head_flips"] += 1
        return True

    def _adopt_incarnation(self, inc: int) -> None:
        """Raise the durable fencing floor (atomic replace + fsync):
        once adopted, every lower-stamped frame is refused forever —
        including across this follower's own restarts."""
        with self._lock:
            if inc <= self.incarnation:
                return
            tmp = self._inc_path.with_name(self._inc_path.name + ".tmp")
            with open(tmp, "w") as fh:
                fh.write(str(int(inc)))
                fh.flush()
                if self.fsync:
                    os.fsync(fh.fileno())
            os.replace(tmp, self._inc_path)
            self.incarnation = int(inc)

    def _on_trim(self, floor: int, keep=None) -> bytes:
        try:
            trimmed = self.retain(floor, keep)
        except Exception as err:
            self.stats["rejected"] += 1
            return _frame("nack", {"len": self.log_len,
                                   "reason": f"trim: {err}"})
        return _frame("ack", {"len": self.log_len, "trimmed": trimmed})

    def retain(self, floor: int, keep=None) -> int:
        """Replica-side WAL retention (the PR 19 residue): shrink every
        record below ``floor`` — except the leader-named ``keep`` set,
        the ticks the leader itself still holds live (catch-up-indexed,
        control, history-pinned) — to the storm trimmed-tick filler.
        Record COUNT and indices are preserved, so the nack-driven
        gap/dup stream recovery and a later promotion replay are
        untouched, and the follower's bytes converge on exactly what
        the leader's own history trim left behind. The floor journals
        FIRST (fsynced) when it advances; the rewrite itself publishes
        atomically (tmp + rename), so a kill mid-trim keeps the
        original log and the next shipped floor reapplies. Returns the
        number of records shrunk."""
        keep = frozenset(keep or ())
        with self._lock:
            floor = min(int(floor), len(self._wal))
            filler = _trimmed_filler()
            victims = [i for i in range(floor)
                       if i not in keep
                       and len(self._wal.read(i)) > len(filler)]
            if floor > self._retained_floor:
                self._retention_log.append(str(floor).encode())
                if self.fsync:
                    self._retention_log.sync()
                self._retained_floor = floor
            if not victims:
                return 0
            hit = set(victims)

            def transform(idx: int, data: bytes) -> bytes | None:
                return filler if idx in hit else None

            self._wal, changed = rewrite_oplog_records(
                self._wal, Path(self.data_dir) / REPLICA_WAL_RELPATH,
                transform)
            self.stats["retained_records"] += changed
            return changed

    def read(self, index: int) -> bytes:
        with self._lock:
            return self._wal.read(index)

    def close(self) -> None:
        with self._lock:
            self._wal.close()
            self._heads_log.close()
            self._retention_log.close()


class ReplicaLink:
    """In-process transport carrying ENCODED frames to one follower —
    the seam a networked deployment replaces with the bridge transport.
    Tests flip :attr:`down` (partition) or set :attr:`transform`
    (byte-level corruption/truncation) to exercise the stream's failure
    modes; ``faults.install_failure("repl.ship")`` injects transient
    send failures without touching the link object."""

    def __init__(self, node: ReplicaNode) -> None:
        self.node = node
        self.down = False
        self.transform = None  # bytes -> bytes | None (None = dropped)

    def call(self, frame: bytes) -> dict:
        if self.down:
            raise ReplicationLinkDown(self.node.node_id)
        faults.failpoint("repl.ship")
        if self.transform is not None:
            frame = self.transform(frame)
            if frame is None:
                raise ReplicationLinkDown(self.node.node_id)
        hdr, _payload = decode_storm_body(self.node.on_frame(bytes(frame)))
        return hdr


class ReplicationPlane:
    """Leader-side quorum shipper. Attach to a storm controller with
    :meth:`attach`: the WAL's ``on_batch_durable`` hook then ships every
    fsynced batch SYNCHRONOUSLY on the writer thread (before the durable
    watermark advances), so ``wal.sync()`` returning already implies the
    ship attempt completed — the pipelined tick hides the whole round
    trip behind device dispatch exactly as it hides the fsync. Acks
    gate on :attr:`replicated_len` via the storm's effective watermark;
    a partitioned quorum freezes it and the controller withholds acks
    (clients resend — the degraded-WAL discipline, one tier out)."""

    def __init__(self, nodes, acks_required: int | None = None,
                 label: str = "leader") -> None:
        # Anything ``call``-shaped is already a link (in-process
        # ReplicaLink, a NetworkReplicaLink, a FaultyTransport wrapper);
        # bare nodes get the in-process link.
        links = [n if hasattr(n, "call") else ReplicaLink(n)
                 for n in nodes]
        if not links:
            raise ValueError("a replication plane needs >= 1 follower")
        self.links = links
        f = len(links)
        self.acks_required = ((f + 1) // 2 if acks_required is None
                              else max(1, min(acks_required, f)))
        self.label = label
        self.role = "leader"
        self.moved_to: str | None = None
        #: Wire-fencing stamp: every shipped frame carries it, and a
        #: follower whose durable floor is higher refuses the frame
        #: (``fenced`` nack) — promotion bumps it past every journal.
        self.incarnation = max(
            (getattr(lk.node, "incarnation", 0) for lk in links),
            default=0)
        # Failure detection (lease-based, armed by
        # start_failure_detector; without it quorum_ok only tracks
        # follower-set size — the in-process legacy behavior).
        self.lease_s: float | None = None
        self.hb_interval_s: float = 0.0
        #: How long writes PARK (admitted, buffered, unacked) under a
        #: lost quorum before _admit sheds them with a retry hint.
        self.park_max_s: float = 5.0
        self._hb_thread = None
        self._hb_stop: threading.Event | None = None
        self._degraded_since: float | None = None
        now = time.monotonic()
        self._last_ok = {lk.node.node_id: now for lk in links}
        self._lock = threading.Lock()
        self._acked = {lk.node.node_id: lk.node.log_len for lk in links}
        self._replicated = 0
        # Monotonic head-flip stamp, seeded PAST every journal so a
        # promoted incarnation's fresh plane never stamps below flips
        # the old leader already shipped.
        self._hseq = max((lk.node.max_hseq for lk in links), default=0)
        self._heads: dict[str, tuple[int, str]] = {}
        for lk in links:
            for key, (hseq, handle) in lk.node.heads.items():
                if hseq > self._heads.get(key, (0, ""))[0]:
                    self._heads[key] = (hseq, handle)
        self.storm = None
        self._wal = None
        self._metrics = None
        self.stats = {"batches_shipped": 0, "ship_failures": 0,
                      "resyncs": 0, "head_flips_shipped": 0,
                      "quorum_refusals": 0, "retention_floors_shipped": 0,
                      "ship_retries": 0, "heartbeat_misses": 0,
                      "fenced_nacks": 0, "followers_dropped": 0}

    def _stamp(self, kind: str, header: dict, payload: bytes = b"") \
            -> bytes:
        """A plane frame with this incarnation's fencing stamp."""
        if self.incarnation:
            header = {"inc": self.incarnation, **header}
        return _frame(kind, header, payload)

    # -- wiring ----------------------------------------------------------------

    def attach(self, storm) -> "ReplicationPlane":
        """Wire into a serving controller: resync every follower to the
        current durable length (a reopened leader may hold history the
        followers missed), then hook the shipping seam and the ack
        gate. Idempotent per storm."""
        assert storm._group_wal is not None, \
            "replication needs durability='group' (the WAL is the log)"
        self.storm = storm
        self._wal = storm._group_wal
        self._metrics = storm.merge_host.metrics
        durable = self._wal.durable_len
        for link in self.links:
            self._resync(link, upto=durable)
        self._advance()
        self._wal.on_batch_durable = self._ship_batch
        storm.replication = self
        self._update_gauges()
        return self

    @property
    def fenced(self) -> bool:
        return self.role == "demoted"

    def fence(self, moved_to: str | None = None) -> None:
        """Demote this leader (a newer incarnation serves): shipping
        stops, the replicated watermark freezes (withheld acks stay
        withheld forever — the zombie never acks again), and ``_admit``
        sheds every frame with a ``moved`` nack naming ``moved_to``."""
        self.role = "demoted"
        self.moved_to = moved_to
        self._update_gauges()

    @property
    def replicated_len(self) -> int:
        """Records a follower quorum has journaled+fsynced: the
        acked-replicated watermark the storm gates client acks on."""
        with self._lock:
            return self._replicated

    @property
    def follower_lag(self) -> int:
        """Leader durable length minus the slowest follower's acked
        length — the resync debt a failover would have to absorb if the
        most advanced follower also died."""
        durable = self._wal.durable_len if self._wal is not None else 0
        with self._lock:
            slowest = min(self._acked.values(), default=0)
        return max(0, durable - slowest)

    # -- shipping (WAL writer thread) ------------------------------------------

    def _ship_batch(self, records: list) -> None:
        if self.fenced or not records:
            return
        faults.crashpoint("repl.pre_ship")
        seq = records[0][0]
        frame = self._stamp(
            "batch", {"seq": seq, "lens": [len(b) for _i, b in records]},
            b"".join(b for _i, b in records))
        end = records[-1][0] + 1
        for link in self.links:
            self._ship_to(link, frame, end)
        self._advance()
        self.stats["batches_shipped"] += 1
        self._update_gauges()
        faults.crashpoint("repl.post_ship")

    def _ship_to(self, link: ReplicaLink, frame: bytes, end: int) -> None:
        """Ship one frame to one follower, triaging the failure modes:

        * TRANSIENT (timeout/reset/partition — ``ReplicationLinkDown``
          or any other ``OSError``): count it, retry ONCE immediately
          (the frame is idempotent — a dup delivery acks), and leave
          the follower's acked watermark alone; the next contact
          (heartbeat or batch) resyncs the missing tail.
        * PERMANENT — ``fenced`` nack: a newer incarnation owns this
          quorum, so THIS plane is the zombie — demote self, stop
          shipping. ``version`` nack: the follower cannot read this
          stream format, ever — drop it from the plane (quorum math
          shrinks with it; an unreachable quorum parks writes).
        * Gap nack: the ordinary behind-follower path — re-ship its
          missing tail from the leader log (resync's upper bound
          retries the batch implicitly).
        """
        hdr = None
        for attempt in (0, 1):
            try:
                hdr = link.call(frame)
                break
            except ReplicationLinkDown:
                self.stats["ship_failures"] += 1
                if attempt:
                    return
                self.stats["ship_retries"] += 1
            except Exception:
                self.stats["ship_failures"] += 1
                return
        if hdr is None:
            return
        if hdr.get("k") == "nack":
            reason = hdr.get("reason")
            if reason == "fenced":
                self.stats["fenced_nacks"] += 1
                self.fence(moved_to=self.moved_to)
                return
            if reason == "version":
                self._drop_follower(link, reason="version")
                return
            self._resync(link, upto=end)
            return
        nid = link.node.node_id
        self._last_ok[nid] = time.monotonic()
        with self._lock:
            self._acked[nid] = max(self._acked[nid], hdr["len"])

    def _drop_follower(self, link, reason: str) -> None:
        """Remove a PERMANENTLY incompatible follower from the plane.
        ``acks_required`` is unchanged — losing a follower must never
        silently weaken the quorum; if the remainder cannot reach it,
        writes park and head flips refuse, loudly."""
        with self._lock:
            if link in self.links:
                self.links.remove(link)
            self._acked.pop(link.node.node_id, None)
        self._last_ok.pop(link.node.node_id, None)
        self.stats["followers_dropped"] += 1
        close = getattr(link, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass
        self._update_gauges()

    def _resync(self, link: ReplicaLink, upto: int | None = None) -> None:
        """Bring one follower to ``upto`` (default: leader durable):
        probe its length, re-ship the tail in bounded batches straight
        from the leader log — records the history plane already trimmed
        arrive as the SAME filler bytes the leader holds, so a follower
        whose lag exceeded the retention floor converges on snapshot
        (journaled heads) + log tail exactly like a local recovery —
        then bulk-ship the journaled head flips it missed."""
        if self._wal is None:
            return
        if upto is None:
            upto = self._wal.durable_len
        self.stats["resyncs"] += 1
        try:
            have = link.call(self._stamp("probe", {}))["len"]
            while have < upto:
                batch = range(have, min(upto, have + RESYNC_BATCH_RECORDS))
                recs = [self._wal.read(i) for i in batch]
                hdr = link.call(self._stamp(
                    "batch",
                    {"seq": batch.start, "lens": [len(r) for r in recs]},
                    b"".join(recs)))
                if hdr.get("k") != "ack":
                    self.stats["ship_failures"] += 1
                    if hdr.get("reason") == "fenced":
                        self.stats["fenced_nacks"] += 1
                        self.fence(moved_to=self.moved_to)
                    return
                have = hdr["len"]
            with self._lock:
                entries = sorted(
                    [hseq, key, handle]
                    for key, (hseq, handle) in self._heads.items())
            if entries:
                link.call(self._stamp("heads", {"entries": entries}))
            self._last_ok[link.node.node_id] = time.monotonic()
            with self._lock:
                self._acked[link.node.node_id] = max(
                    self._acked[link.node.node_id], have)
        except Exception:
            self.stats["ship_failures"] += 1

    def _advance(self) -> None:
        with self._lock:
            acked = sorted(self._acked.values(), reverse=True)
            if len(acked) < self.acks_required:
                return  # dropped below quorum size: watermark freezes
            quorum = acked[self.acks_required - 1]
            self._replicated = max(self._replicated, quorum)

    # -- failure detection (lease-based heartbeats) ----------------------------

    @property
    def quorum_ok(self) -> bool:
        """``acks_required`` followers hold a FRESH lease. Without an
        armed detector (``lease_s`` unset) only the follower-set size
        counts — the in-process legacy semantics, where a slow link
        merely withholds acks."""
        if len(self.links) < self.acks_required:
            return False
        if self.lease_s is None:
            return True
        now = time.monotonic()
        live = sum(1 for lk in self.links
                   if now - self._last_ok.get(lk.node.node_id, 0.0)
                   <= self.lease_s)
        return live >= self.acks_required

    def quorum_degraded_s(self) -> float | None:
        """Seconds the quorum has been lost (None while healthy) —
        the storm's park-then-shed clock."""
        if self.quorum_ok:
            self._degraded_since = None
            return None
        now = time.monotonic()
        if self._degraded_since is None:
            self._degraded_since = now
        return now - self._degraded_since

    def heartbeat(self) -> bool:
        """One failure-detector round: probe links idle past the
        heartbeat interval, renew leases on success, and — the heal
        path — resync any follower whose acked length fell behind the
        durable frontier, so parked writes drain as soon as the first
        probe lands instead of waiting for the next batch. Returns
        ``quorum_ok``."""
        if self.fenced:
            return False
        now = time.monotonic()
        durable = self._wal.durable_len if self._wal is not None else None
        for link in list(self.links):
            nid = link.node.node_id
            if self.hb_interval_s \
                    and now - self._last_ok.get(nid, 0.0) \
                    < self.hb_interval_s:
                continue  # recent traffic IS the heartbeat
            try:
                hdr = link.call(self._stamp("probe", {}))
            except Exception:
                self.stats["heartbeat_misses"] += 1
                continue
            if hdr.get("k") != "ack":
                if hdr.get("reason") == "fenced":
                    self.stats["fenced_nacks"] += 1
                    self.fence(moved_to=self.moved_to)
                    return False
                self.stats["heartbeat_misses"] += 1
                continue
            self._last_ok[nid] = time.monotonic()
            with self._lock:
                self._acked[nid] = max(self._acked[nid], hdr["len"])
            if durable is not None and hdr["len"] < durable:
                self._resync(link)
        self._advance()
        ok = self.quorum_ok
        self._update_gauges()
        return ok

    def start_failure_detector(self, interval_s: float = 0.5,
                               lease_s: float = 2.0,
                               park_max_s: float | None = None) -> None:
        """Arm lease-based failure detection: a daemon thread probes
        every ``interval_s``; a follower silent past ``lease_s`` stops
        counting toward the quorum, and a lost quorum parks writes
        (``park_max_s`` caps the park before _admit sheds)."""
        self.hb_interval_s = float(interval_s)
        self.lease_s = float(lease_s)
        if park_max_s is not None:
            self.park_max_s = float(park_max_s)
        if self._hb_thread is not None:
            return
        self._hb_stop = threading.Event()

        def loop() -> None:
            while not self._hb_stop.wait(self.hb_interval_s):
                try:
                    self.heartbeat()
                except Exception:
                    pass  # the detector must outlive any one bad round

        self._hb_thread = threading.Thread(
            target=loop, daemon=True,
            name=f"repl-heartbeat-{self.label}")
        self._hb_thread.start()

    def stop_failure_detector(self) -> None:
        if self._hb_stop is not None:
            self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(5)
            self._hb_thread = None
            self._hb_stop = None

    # -- retention (checkpoint path) -------------------------------------------

    def _live_below(self, floor: int) -> list[int]:
        """WAL indices below ``floor`` the leader still holds LIVE —
        anything that isn't already a trimmed/padding filler: real doc
        batches the catch-up index may serve, history/mega control
        ticks, pinned ranges. Followers must keep exactly these so
        their read surface stays byte-identical to the leader's."""
        keep = []
        for i in range(floor):
            data = bytes(self._wal.read(i))
            try:
                hlen = struct.unpack_from("<I", data)[0]
                hdr = json.loads(data[4:4 + hlen])
            except Exception:
                keep.append(i)  # unparseable: never discard blindly
                continue
            hp = hdr.get("hp")
            if (hdr.get("docs") or hdr.get("mg") is not None
                    or (hp is not None and hp.get("op") != "trimmed")):
                keep.append(i)
        return keep

    def ship_retention(self, floor: int) -> None:
        """Replica-side WAL retention: after a checkpoint publishes,
        ship the snapshot tick watermark as the followers' trim floor
        plus the sub-floor indices the leader itself still holds live.
        Followers shrink everything else to the trimmed filler (see
        :meth:`ReplicaNode.retain`) — follower disks now track the
        leader's own trim instead of growing unbounded. Best-effort,
        no quorum: retention is hygiene, and a follower that misses a
        trim just holds bytes until the next one (or until resync
        re-ships the leader's fillers verbatim)."""
        if self.fenced or self._wal is None or floor <= 0:
            return
        frame = self._stamp("trim", {"floor": int(floor),
                                     "keep": self._live_below(int(floor))})
        for link in self.links:
            try:
                link.call(frame)
            except Exception:
                self.stats["ship_failures"] += 1
        self.stats["retention_floors_shipped"] += 1

    # -- head flips (serving thread) -------------------------------------------

    def ship_head(self, key: str, handle: str) -> None:
        """Journal one head flip on the follower quorum BEFORE the
        caller flips the backend. Raises ReplicationQuorumError (flip
        refused, backend untouched) when fewer than ``acks_required``
        followers journaled it — the invariant promotion relies on:
        every backend head is present in >= quorum journals."""
        if self.fenced:
            raise ReplicationQuorumError(
                f"head flip on a demoted leader (promoted incarnation: "
                f"{self.moved_to!r})")
        with self._lock:
            self._hseq += 1
            hseq = self._hseq
            self._heads[key] = (hseq, handle)
        frame = self._stamp("head", {"hseq": hseq, "key": key,
                                     "handle": handle})
        acks = 0
        for link in list(self.links):
            try:
                hdr = link.call(frame)
            except Exception:
                self.stats["ship_failures"] += 1
                continue
            if hdr.get("k") == "ack":
                acks += 1
                self._last_ok[link.node.node_id] = time.monotonic()
            elif hdr.get("reason") == "fenced":
                self.stats["fenced_nacks"] += 1
                self.fence(moved_to=self.moved_to)
                raise ReplicationQuorumError(
                    f"head flip for {key!r} fenced by a newer "
                    f"incarnation; this leader is demoted")
            elif hdr.get("reason") == "version":
                self._drop_follower(link, reason="version")
        if acks < self.acks_required:
            self.stats["quorum_refusals"] += 1
            raise ReplicationQuorumError(
                f"head flip for {key!r} reached {acks}/"
                f"{self.acks_required} followers; flip refused")
        self.stats["head_flips_shipped"] += 1

    # -- observability ---------------------------------------------------------

    def _update_gauges(self) -> None:
        m = self._metrics
        if m is None:
            return
        durable = self._wal.durable_len if self._wal is not None else 0
        m.gauge("repl.role_code").set(
            {"leader": 1, "follower": 2, "demoted": 3}.get(self.role, 0))
        m.gauge("repl.followers").set(len(self.links))
        m.gauge("repl.lag").set(self.follower_lag)
        m.gauge("repl.watermark_gap").set(
            max(0, durable - self.replicated_len))
        m.gauge("repl.shipped_batches").set(
            self.stats["batches_shipped"])
        m.gauge("repl.quorum_ok").set(1 if self.quorum_ok else 0)
        deg = self.quorum_degraded_s()
        m.gauge("repl.degraded_s").set(
            0.0 if deg is None else round(deg, 3))
        parked = 0
        if deg is not None and self.storm is not None:
            parked = self.storm._pending_docs
        m.gauge("repl.parked_docs").set(parked)
        # Wire-level stats exist only on networked links; aggregate
        # across edges so the monitor gets one transport line.
        rtts: list = []
        agg = {"calls": 0, "retransmits": 0, "reconnects": 0,
               "timeouts": 0}
        netlinks = 0
        for lk in self.links:
            ts = getattr(lk, "transport_stats", None)
            if ts is None:
                continue
            netlinks += 1
            s = ts()
            rtts.extend(s.get("rtt_s", ()))
            for k in agg:
                agg[k] += s.get(k, 0)
        if netlinks or self.lease_s is not None:
            rtts.sort()

            def pct(q: float) -> float:
                if not rtts:
                    return 0.0
                return rtts[min(len(rtts) - 1,
                                int(q * (len(rtts) - 1)))]

            m.gauge("transport.links").set(netlinks)
            m.gauge("transport.rtt_p50_ms").set(
                round(1000 * pct(0.50), 3))
            m.gauge("transport.rtt_p99_ms").set(
                round(1000 * pct(0.99), 3))
            m.gauge("transport.calls").set(agg["calls"])
            m.gauge("transport.retransmits").set(agg["retransmits"])
            m.gauge("transport.reconnects").set(agg["reconnects"])
            m.gauge("transport.timeouts").set(agg["timeouts"])
            m.gauge("transport.heartbeat_misses").set(
                self.stats["heartbeat_misses"])
            open_partitions = 0
            if self.lease_s is not None:
                now = time.monotonic()
                open_partitions = sum(
                    1 for lk in self.links
                    if now - self._last_ok.get(lk.node.node_id, 0.0)
                    > self.lease_s)
            m.gauge("transport.open_partitions").set(open_partitions)


class ReplicatedHeadStore:
    """Snapshot-store wrapper (the historian pattern) that puts every
    ``set_head`` on the replication plane: ship-then-flip. Uploads,
    reads and releases pass straight through — chunk content is
    content-addressed and idempotent; only the head REF decides what a
    recovery sees, so only the ref rides the quorum."""

    def __init__(self, backend, plane: ReplicationPlane) -> None:
        self._backend = backend
        self._plane = plane

    def set_head(self, doc_id: str, handle: str) -> None:
        self._plane.ship_head(doc_id, handle)
        self._backend.set_head(doc_id, handle)

    def upload(self, doc_id: str, snapshot, put_object=None):
        if put_object is not None:
            return self._backend.upload(doc_id, snapshot,
                                        put_object=put_object)
        return self._backend.upload(doc_id, snapshot)

    def get(self, doc_id: str, handle=None, *args, **kwargs):
        return self._backend.get(doc_id, handle, *args, **kwargs)

    def head(self, doc_id: str):
        return self._backend.head(doc_id)

    def release(self, doc_id: str, handle: str):
        return self._backend.release(doc_id, handle)

    def __getattr__(self, name):
        return getattr(self._backend, name)


# -- failover -----------------------------------------------------------------


def choose_promotion_candidate(nodes: list[ReplicaNode]) -> ReplicaNode:
    """The follower to promote: longest replica log first (it holds
    every record any quorum could have acked — zero acked-replicated
    ops lost), freshest head journal second, node id as the
    deterministic tiebreak."""
    return max(nodes,
               key=lambda n: (n.log_len, n.max_hseq, n.node_id))


def promote_heads(nodes: list[ReplicaNode], store) -> int:
    """Roll the journaled head flips forward onto the shared store:
    merge every surviving follower's journal (highest ``hseq`` per key
    wins) and flip each backend head that differs. Safe by the quorum
    invariant — a backend head was only ever flipped AFTER >= quorum
    followers journaled it, so with a surviving quorum the merged
    journal can never be older than the backend; flips the dead leader
    shipped but never applied (the crash window between ship and flip)
    roll FORWARD here. Returns the number of heads flipped."""
    merged: dict[str, tuple[int, str]] = {}
    for node in nodes:
        for key, (hseq, handle) in node.heads.items():
            if hseq > merged.get(key, (0, ""))[0]:
                merged[key] = (hseq, handle)
    flipped = 0
    for key, (_hseq, handle) in sorted(merged.items()):
        if store.head(key) != handle:
            store.set_head(key, handle)
            flipped += 1
    return flipped


def promote(label: str, nodes: list[ReplicaNode], shared_snapshots,
            cluster=None, num_docs: int = 64,
            follower_dirs: list[str] | None = None,
            acks_required: int | None = None, device=None,
            **storm_kw) -> tuple:
    """Full failover: pick the most advanced follower, roll its
    journaled heads onto the shared store, build a fresh serving host
    OVER the follower's directory (its replica WAL is storm-shaped —
    same spill path, same record indices), recover through the normal
    snapshot + WAL-tail path, and re-arm replication toward the
    remaining followers (plus any fresh ``follower_dirs``, resynced
    from zero through the plane's own tail re-ship). With a
    ``cluster``, the new host replaces the dead label and the
    directory's incarnation stamp bumps — the PR 16 ``moved_to``
    machinery then routes shed clients of the old incarnation here.

    Returns ``(storm, plane, report)`` where the report carries the
    promotion blackout in ms (dead leader detected -> new leader
    serving) and what was rolled forward."""
    from ..parallel.placement import make_cluster_host

    t0 = time.perf_counter()
    candidate = choose_promotion_candidate(nodes)
    flipped = promote_heads(nodes, shared_snapshots)
    remaining = [n for n in nodes if n is not candidate]
    followers = list(remaining)
    for d in follower_dirs or []:
        followers.append(ReplicaNode(d))
    plane = ReplicationPlane(followers, acks_required=acks_required,
                             label=label)
    # Fence the dead incarnation ON THE WIRE: bump past every journal's
    # durable floor before the first stamped frame ships (attach
    # resyncs), so the quorum refuses the zombie's frames outright.
    plane.incarnation = 1 + max(
        (getattr(n, "incarnation", 0) for n in nodes), default=0)
    store = ReplicatedHeadStore(shared_snapshots, plane)
    candidate.close()  # the promoted storm owns the WAL file now
    storm = make_cluster_host(label, candidate.data_dir, store,
                              num_docs=num_docs, device=device, **storm_kw)
    info = storm.recover()
    plane.attach(storm)
    blackout_ms = 1000.0 * (time.perf_counter() - t0)
    if cluster is not None:
        cluster.fail_over(label, storm, blackout_ms=blackout_ms)
    if plane._metrics is not None:
        plane._metrics.gauge("repl.last_failover_blackout_ms").set(
            round(blackout_ms, 3))
    report = {"promoted_node": candidate.node_id,
              "log_len": len(storm._blob_log),
              "heads_rolled_forward": flipped,
              "replayed_ticks": info["replayed_ticks"],
              "blackout_ms": round(blackout_ms, 3)}
    return storm, plane, report


def make_replicated_host(label: str, data_dir: str, shared_snapshots,
                         follower_dirs: list[str],
                         acks_required: int | None = None,
                         num_docs: int = 64, device=None,
                         **storm_kw) -> tuple:
    """One replicated serving host: a cluster host (on ``device``, the
    card by default) whose snapshot-store head flips and WAL batches
    both ride a fresh plane over ``follower_dirs``. Returns ``(storm,
    plane)``."""
    from ..parallel.placement import make_cluster_host

    # A follower may be a bare directory (in-process node) or anything
    # ``call``-shaped — a NetworkReplicaLink to another OS process, or
    # a FaultyTransport wrapping either.
    nodes = [d if hasattr(d, "call") else ReplicaNode(d)
             for d in follower_dirs]
    plane = ReplicationPlane(nodes, acks_required=acks_required,
                             label=label)
    store = ReplicatedHeadStore(shared_snapshots, plane)
    storm = make_cluster_host(label, data_dir, store,
                              num_docs=num_docs, device=device, **storm_kw)
    plane.attach(storm)
    return storm, plane


__all__ = [
    "REPLICATION_STREAM_VERSION", "REPLICATION_KILL_POINTS",
    "REPLICA_WAL_RELPATH", "REPLICA_RETENTION_RELPATH",
    "REPLICA_INCARNATION_RELPATH",
    "ReplicaNode", "ReplicaLink", "ReplicationPlane",
    "ReplicatedHeadStore", "ReplicationLinkDown",
    "ReplicationQuorumError", "choose_promotion_candidate",
    "promote_heads", "promote", "make_replicated_host",
]
