"""Mega-doc write scale-out — serve ONE document's merge from sharded
device lanes.

Port of ``fluidframework_tpu/server/megadoc.py``: the combiner, the
combine logs, the cross-lane fold and the lifecycle are the reference's
host code line for line. The device is touched in three places, each
through the merge or sequencer host: the lane reads gather the baseline
row and every lane row with one index and one copy
(``KernelMergeHost.read_map_rows``), demotion writes the fold back in
place (``KernelMergeHost.write_map_row``), and lane rows install through
``KernelSequencerHost.restore``.

The viewer plane (round 13) scaled one hot doc to 100k READERS and the
pipelined tick (round 14) hid the fsync, but the write path of a single
document was still one pool row fed by one sequential op stream: the
storm cohort takes at most ONE frame per doc per tick (acks are
positional per frame and per-doc total order is one sequencer row), so a
mass-editing event or an AI-agent swarm co-writing a doc serialized on a
single lane no matter how big the pool was.

This module is the serving-path wiring for the sequence-parallel tier:

* **promotion** — when a doc's writer count / op rate crosses a
  threshold (or by explicit pin), the doc is PROMOTED: it gets ``L``
  lane sub-rows (``<doc>::~mg<i>``) in the sequencer host and the map
  pool, and (for text channels) its block-table row migrates to the
  segment-sharded flat layout through the existing ``from_block_state``
  seam (``KernelMergeHost.promote_merge_row``). Demotion reverses both
  through ``mergetree_blocks.from_flat`` / the cross-lane fold when the
  doc cools — both conversions exact and pinned.
* **per-range sub-sequencers** — each writer hashes to a lane
  (``crc32(client) % L``); a lane's frames sequence on the lane's OWN
  device sequencer row (the sub-sequencer), so up to L writer frames of
  one doc serve in ONE tick instead of one.
* **the combiner** — a host-side scalar twin of the closed-form storm
  ticket (:class:`DocSequencerMirror`, the exact algebra of
  ``ops.sequencer.storm_tickets`` in DOC seq space) decides every
  batch's dup/gap/refseq/MSN outcome against the doc-level contract and
  stamps the doc's total order: sequenced lane batches take consecutive
  doc seqs in COHORT ADMISSION ORDER — exactly the order the single-lane
  path would have served the same frames across consecutive ticks, which
  is why sharded ≡ single-lane holds byte-for-byte. The lane↔doc seq
  mapping is a per-lane segment log (:class:`LaneCombineLog`), the
  analog of per-block summaries: position (seq) transforms stay O(log
  segments) lookups, never a rescan.
* **per-range summaries / reads** — a promoted doc's converged map is
  the LWW fold ACROSS lanes by translated doc seq
  (:func:`fold_map_rows` — per-range summaries rolling up exactly like
  block summaries), with the pre-promotion row kept frozen as the
  baseline range. Catch-up records translate lane windows to doc
  windows through the same log.

Division of labor with the device kernels: the lane sub-sequencer rows
run the REAL ``storm_tickets`` on device (their per-client cseq planes
are the dedup authority for cleaned batches) and the map fold runs the
real VMEM kernel per lane row; only the doc-LEVEL algebra (one scalar
update per frame — O(1), nowhere near the device critical path) runs on
the host, because doc seqs depend on admission order across lanes which
no single lane can see. The lane rows are fed CLEANED batches: the
mirror trims the dup prefix and rejects gap/refseq/inactive outcomes
before the device sees them, so lane-space cseq streams stay contiguous
and lane rows never NACK (their refs are pinned to 0; the doc-space
refseq law lives in the mirror, where the doc MSN actually is).

Durability: promoted serving rides the SAME storm WAL — lane entries
appear in tick headers under their lane ids (lane-space seqs; reads
translate), and promote/demote (and the rare refseq-NACK client mark,
the only zero-op outcome with state effects) append CONTROL records
(``"mg"`` header field) so replay re-decides the entire lifecycle
identically. Chaos kill points: ``megadoc.mid_promotion``,
``megadoc.mid_combine``, ``megadoc.mid_demotion``.

Known bounds (documented, not silent): the combine log grows one
segment per combined batch; with ``trim_combine_logs=True`` the
maintenance pass retires segments below the translated doc-MSN horizon
(converged reads stay exact through slot-aligned vseq floors; catch-up
reads below the horizon raise a reload-from-snapshot error — the
``doc_index_retention_ticks`` contract). A client that JOINS while
the doc is promoted is adopted by the mirror with join-at-current-MSN
semantics, but the join op itself sequences on the (frozen) doc row and
its seq-rev is discarded at demotion — join/leave churn belongs before
promotion or after demotion; quarantine of any lane freezes the whole
doc (readmission of a promoted doc means demote-after-readmit). A
demoted doc RE-promotes into a fresh lane EPOCH (``::~mg<e>.<i>`` ids),
so both cycles' records translate forever and replay re-decides both
identically. Viewer rooms key by the PARENT doc at harvest, so
per-tick viewer frames keep flowing for promoted docs (doc-space
windows via the combiner's ack quads).
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Callable, NamedTuple

import numpy as np

from ..ops import opcodes as oc
from ..utils import faults

INT32_MAX = int(oc.INT32_MAX)

#: Lane sub-doc id separator: ``<doc>::~mg<i>`` (promotion epoch 0, the
#: round-15 wire format) or ``<doc>::~mg<e>.<i>`` (re-promotion epochs —
#: a demoted doc that promotes AGAIN gets fresh lane seq spaces, so its
#: second-cycle lane ids must never alias the first cycle's WAL entries
#: or combine logs). The marker can't appear in user doc ids submitted
#: through the validated storm front door without *being* a lane id, and
#: parse/format stay exact inverses in both shapes.
LANE_SEP = "::~mg"


def lane_id(doc: str, lane: int, epoch: int = 0) -> str:
    if epoch:
        return f"{doc}{LANE_SEP}{epoch}.{lane}"
    return f"{doc}{LANE_SEP}{lane}"


def parse_lane_full(doc_id: str) -> tuple[str, int, int] | None:
    """(parent doc, epoch, lane index) for a lane sub-doc id, else
    None. Epoch-0 ids keep the round-15 ``<doc>::~mg<i>`` shape."""
    base, sep, idx = doc_id.rpartition(LANE_SEP)
    if not sep:
        return None
    epoch_s, dot, lane_s = idx.partition(".")
    try:
        if dot:
            return base, int(epoch_s), int(lane_s)
        return base, 0, int(epoch_s)
    except ValueError:
        return None


def parse_lane(doc_id: str) -> tuple[str, int] | None:
    """(parent doc, lane index) for a lane sub-doc id, else None."""
    full = parse_lane_full(doc_id)
    return None if full is None else (full[0], full[2])


def lane_of_writer(client_id: str, lanes: int) -> int:
    """Stable writer→lane assignment (the range partition): stateless,
    so ingress, replay and every host compute the same lane."""
    return zlib.crc32(client_id.encode()) % lanes


class Decision(NamedTuple):
    """One batch's doc-space ticket: the scalar twin of a
    ``storm_tickets`` row. ``n_seq == 0`` rows synthesize their ack
    without touching a lane; ``ack_row`` is the (n_seq, first, last,
    msn) i32 quad the client sees either way."""

    dups: int
    n_seq: int
    first: int     # doc seq of the first sequenced op (INT32_MAX if none)
    last: int      # doc seq of the last sequenced op (0 if none)
    msn: int       # doc MSN after this batch
    refnack: bool = False  # the state-bearing zero-op outcome

    @property
    def ack_row(self) -> tuple[int, int, int, int]:
        return (self.n_seq, self.first, self.last, self.msn)


class _Writer:
    """Doc-space mirror of one client's sequencer lane + its lane
    placement. ``offset`` maps lane-space cseqs back to the client's
    original stream (orig = lane + offset): it is fixed at adoption —
    both spaces advance together — so WAL lane entries round-trip."""

    __slots__ = ("cseq", "ref", "clu", "nack", "summarize", "evict",
                 "active", "lane", "offset")

    def __init__(self, cseq: int = 0, ref: int = 0, clu: int = 0,
                 nack: bool = False, summarize: bool = True,
                 evict: bool = True, active: bool = True,
                 lane: int = 0, offset: int = 0) -> None:
        self.cseq = cseq
        self.ref = ref
        self.clu = clu
        self.nack = nack
        self.summarize = summarize
        self.evict = evict
        self.active = active
        self.lane = lane
        self.offset = offset


class DocSequencerMirror:
    """The doc-level combiner's sequencer: an EXACT scalar twin of the
    closed-form storm ticket (``ops.sequencer.storm_tickets``) in doc
    seq space. One :meth:`decide` call per lane batch, in cohort
    admission order, IS the deterministic combiner — the interleaving it
    stamps is the same one the single-lane path produces when the same
    frames serve one per tick (buffer order), which the differential
    fuzz pins byte-for-byte.

    The doc-level ``SequencerState`` contract — dup/gap NACKs, the
    refseq-below-MSN mark, MSN/last_sent_msn law — is unchanged from the
    client's point of view; only WHERE it is computed moves (one scalar
    update per frame on the host instead of one vector row on device).

    The MSN (min ref over active writers) is tracked with a LAZY
    MIN-HEAP instead of an O(writers) scan per batch — at 10k writers
    the scan would dominate every combining tick. Correctness rests on
    the sequencer's own law: every ACCEPTED ref is >= the current MSN
    (refs below it refnack; ``ref == -1`` resolves to the head seq; the
    refnack mark itself writes cref = MSN), so the global minimum never
    decreases and stale heap entries can be popped lazily against a
    value->count map.
    """

    __slots__ = ("seq", "msn", "last_sent_msn", "nack_future", "writers",
                 "_ref_heap", "_ref_counts")

    def __init__(self, seq: int = 0, msn: int = 0,
                 last_sent_msn: int = 0,
                 nack_future: bool = False) -> None:
        self.seq = seq
        self.msn = msn
        self.last_sent_msn = last_sent_msn
        self.nack_future = nack_future
        self.writers: dict[str, _Writer] = {}
        self._ref_heap: list[int] = []
        self._ref_counts: dict[int, int] = {}

    def _track_ref(self, old: int | None, new: int) -> None:
        """Move one active writer's cref in the lazy-min structures."""
        import heapq
        if old is not None:
            self._ref_counts[old] -= 1
        c = self._ref_counts.get(new, 0)
        self._ref_counts[new] = c + 1
        if c == 0:
            heapq.heappush(self._ref_heap, new)

    @classmethod
    def from_checkpoint(cls, cp, lanes: int) -> "DocSequencerMirror":
        """Seed from a ``SequencerCheckpoint`` (the promotion source):
        every active client keeps its cseq/ref/nack state; lane
        placement hashes; offset = current cseq (lane streams restart at
        1 in lane space)."""
        m = cls(seq=cp.sequence_number, msn=cp.minimum_sequence_number,
                last_sent_msn=cp.last_sent_msn,
                nack_future=cp.nack_future)
        for c in cp.clients:
            m.writers[c["client_id"]] = _Writer(
                cseq=c["client_seq"], ref=c["ref_seq"],
                clu=c["last_update"], nack=c["nack"],
                summarize=c["can_summarize"], evict=c["can_evict"],
                active=True,
                lane=lane_of_writer(c["client_id"], lanes),
                offset=c["client_seq"])
            m._track_ref(None, c["ref_seq"])
        return m

    def adopt(self, client: str, lanes: int, clu: int) -> _Writer:
        """Register a writer that joined AFTER promotion: join-at-MSN
        semantics (cref = current msn, cseq = 0), exactly what a
        sequenced CLIENT_JOIN upserts on device."""
        w = _Writer(cseq=0, ref=self.msn, clu=clu,
                    lane=lane_of_writer(client, lanes), offset=0)
        self.writers[client] = w
        self._track_ref(None, w.ref)
        return w

    def decide(self, client: str, cseq0: int, ref: int, count: int,
               ts: int) -> Decision:
        """One batch through the doc-space ticket. Mirrors
        ``storm_tickets`` branch for branch (see its docstring for the
        deli/lambda.ts derivation); mutates the mirror exactly as the
        device mutates its row."""
        n = max(int(count), 0)
        w = self.writers.get(client)
        ok = (n > 0 and w is not None and w.active and not w.nack
              and not self.nack_future)
        if not ok:
            # Whole-batch reject (inactive / nacked / nack_future): no
            # state change; the ack quad reports the unchanged doc head.
            return Decision(0, 0, INT32_MAX, 0, self.msn)
        expected = w.cseq + 1
        no_gap = cseq0 <= expected
        dups = min(max(expected - cseq0, 0), n)
        m = (n - dups) if no_gap else 0
        refnack = no_gap and m > 0 and ref != -1 and ref < self.msn
        n_seq = 0 if refnack else m
        if refnack:
            # The refseq-below-MSN mark (deli lambda.ts:305-312): the
            # client is upserted nacked at refSeq=MSN. MSN itself does
            # not move (not a sequenced batch).
            w.cseq = cseq0 + dups
            self._track_ref(w.ref, self.msn)
            w.ref = self.msn
            w.clu = ts
            w.nack = True
            return Decision(dups, 0, INT32_MAX, 0, self.msn,
                            refnack=True)
        if n_seq == 0:
            # Gap or pure dup resend: no state change.
            return Decision(dups, 0, INT32_MAX, 0, self.msn)
        seq2 = self.seq + n_seq
        ref_eff = seq2 if ref == -1 else ref
        w.cseq = cseq0 + n - 1
        self._track_ref(w.ref, ref_eff)
        w.ref = ref_eff
        w.clu = ts
        w.nack = False
        self.seq = seq2
        self.msn = self._min_ref()
        self.last_sent_msn = self.msn
        return Decision(dups, n_seq, seq2 - n_seq + 1, seq2, self.msn)

    def _min_ref(self) -> int:
        """Min cref over active writers via the lazy heap (stale heads
        popped against the count map); the head seq with no writers —
        the kernel's no-active-clients branch."""
        import heapq
        heap = self._ref_heap
        while heap and self._ref_counts.get(heap[0], 0) <= 0:
            self._ref_counts.pop(heap[0], None)
            heapq.heappop(heap)
        return heap[0] if heap else self.seq

    def checkpoint(self, client_timeout_ms: int):
        """The doc row's restore source at demotion — byte-comparable to
        an unpromoted twin's ``KernelSequencerHost.checkpoint`` (clients
        sorted by id, the same field law)."""
        from .sequencer import SequencerCheckpoint
        clients = [{
            "client_id": cid, "client_seq": w.cseq, "ref_seq": w.ref,
            "last_update": w.clu, "can_evict": w.evict,
            "can_summarize": w.summarize, "nack": w.nack,
        } for cid, w in sorted(self.writers.items()) if w.active]
        return SequencerCheckpoint(
            sequence_number=self.seq,
            minimum_sequence_number=self.msn,
            last_sent_msn=self.last_sent_msn,
            no_active_clients=not clients,
            clients=clients,
            nack_future=self.nack_future,
            client_timeout_ms=client_timeout_ms,
            log_offset=-1,
        )

    def export(self) -> dict:
        return {
            "seq": self.seq, "msn": self.msn,
            "last_sent_msn": self.last_sent_msn,
            "nack_future": self.nack_future,
            "writers": {cid: [w.cseq, w.ref, w.clu, int(w.nack),
                              int(w.summarize), int(w.evict),
                              int(w.active), w.lane, w.offset]
                        for cid, w in self.writers.items()},
        }

    @classmethod
    def load(cls, snap: dict) -> "DocSequencerMirror":
        m = cls(seq=snap["seq"], msn=snap["msn"],
                last_sent_msn=snap["last_sent_msn"],
                nack_future=snap["nack_future"])
        for cid, f in snap["writers"].items():
            m.writers[cid] = _Writer(
                cseq=f[0], ref=f[1], clu=f[2], nack=bool(f[3]),
                summarize=bool(f[4]), evict=bool(f[5]),
                active=bool(f[6]), lane=f[7], offset=f[8])
            if f[6]:
                m._track_ref(None, f[1])
        return m


class LaneCombineLog:
    """One lane's combined-batch segments: contiguous lane-seq windows
    mapped to their doc-seq windows — the per-range summary the seq
    transforms roll up through. Lane seqs tile [1, seq] with no holes
    (every sequenced lane op was combined exactly once), so lane→doc
    translation is one binary search + an affine offset.

    Bounded memory (ROADMAP mega-doc residue): the log grows one segment
    per combined batch, so a long-lived promotion would accumulate the
    doc's whole lane-era history. :meth:`trim_below` retires segments
    wholly below a lane horizon (the translated doc MSN) AFTER capturing
    the exact doc-space translation of every live map-plane entry at or
    below it into a slot-aligned floor — the per-slot rebased vseq the
    LWW fold keeps using, so converged reads stay exact forever while
    the segment list is bounded by the collab window. Catch-up record
    translation below the floor becomes impossible (the
    ``doc_index_retention_ticks`` contract: readers that far behind
    reload from a snapshot)."""

    __slots__ = ("seq", "lane_firsts", "doc_firsts", "lane_lasts",
                 "msns", "floor_lane", "floor_doc", "_vseq_floor",
                 "_cleared_floor")

    def __init__(self) -> None:
        self.seq = 0               # lane seq high water
        self.lane_firsts: list[int] = []
        self.lane_lasts: list[int] = []
        self.doc_firsts: list[int] = []
        self.msns: list[int] = []  # doc MSN after each combined batch
        #: Lane seqs <= floor_lane have had their segments retired; the
        #: slot-aligned floors below carry their exact doc translations.
        self.floor_lane = 0
        self.floor_doc = 0
        self._vseq_floor: np.ndarray | None = None
        self._cleared_floor = -1

    def append(self, n: int, doc_first: int, msn: int) -> tuple[int, int]:
        """Combine one cleaned batch of ``n`` ops; returns its
        (lane_first, lane_last) window."""
        lane_first = self.seq + 1
        self.seq += n
        self.lane_firsts.append(lane_first)
        self.lane_lasts.append(self.seq)
        self.doc_firsts.append(doc_first)
        self.msns.append(msn)
        return lane_first, self.seq

    def to_doc(self, lane_seq: int) -> int:
        """Doc seq of one lane seq (total over (floor_lane, seq])."""
        import bisect
        if 1 <= lane_seq <= self.floor_lane:
            raise ValueError(
                f"lane seq {lane_seq} is below the trimmed combine-log "
                f"floor {self.floor_lane} (doc seq {self.floor_doc}); "
                "readers that far behind reload from a snapshot")
        i = bisect.bisect_right(self.lane_firsts, lane_seq) - 1
        if i < 0 or lane_seq > self.lane_lasts[i]:
            raise ValueError(f"lane seq {lane_seq} outside combined "
                             f"windows (high water {self.seq})")
        return self.doc_firsts[i] + (lane_seq - self.lane_firsts[i])

    def to_doc_array(self, lane_seqs: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`to_doc` for a SLOT-ALIGNED vseq plane;
        entries < 1 (absent slots / unset cleared_seq) pass through
        unchanged. Entries at or below a trimmed floor resolve through
        the slot-aligned floor captured at trim time (exact: it was
        translated while the segments were still live)."""
        out = np.asarray(lane_seqs, np.int64).copy()
        low = (out >= 1) & (out <= self.floor_lane)
        if low.any():
            assert self._vseq_floor is not None, "floor without capture"
            out[low] = self._vseq_floor[low]
        mask = out > self.floor_lane
        # NB ``mask`` re-reads OUT, so floor-resolved doc seqs (already
        # > floor_lane numerically) must not re-translate: restrict to
        # the untouched entries.
        mask &= ~low
        if mask.any():
            firsts = np.asarray(self.lane_firsts, np.int64)
            idx = np.searchsorted(firsts, out[mask], side="right") - 1
            docs = np.asarray(self.doc_firsts, np.int64)
            out[mask] = docs[idx] + (out[mask] - firsts[idx])
        return out

    def translate_cleared(self, cleared_seq: int) -> int:
        """Doc-space cleared_seq: < 1 passes through; at/below the floor
        resolves to the cleared translation captured at trim time."""
        if cleared_seq < 1:
            return cleared_seq
        if cleared_seq <= self.floor_lane:
            return self._cleared_floor
        return self.to_doc(cleared_seq)

    def trim_below(self, lane_horizon: int,
                   vseq_plane: np.ndarray | None = None,
                   cleared_seq: int = -1) -> int:
        """Retire segments wholly at/below ``lane_horizon`` (the lane
        floor of the translated doc MSN). ``vseq_plane`` is the lane's
        live map-row vseq plane (lane seqs, slot-aligned); its entries
        at/below the new floor are translated NOW — while the segments
        still exist — into the slot floor future translations read.
        Returns the number of segments dropped. New lane seqs are always
        above the high water (hence above any floor), so a trimmed entry
        can only go stale by being overwritten, never resurrected."""
        import bisect
        cut = bisect.bisect_right(self.lane_lasts, lane_horizon)
        if cut == 0:
            return 0
        if vseq_plane is not None:
            plane = np.asarray(vseq_plane, np.int64)
            translated = self.to_doc_array(plane)
            new_floor = self.lane_lasts[cut - 1]
            capture = (plane >= 1) & (plane <= new_floor)
            if self._vseq_floor is None:
                self._vseq_floor = np.full(plane.shape[0], -1, np.int64)
            self._vseq_floor[capture] = translated[capture]
        if 1 <= cleared_seq <= self.lane_lasts[cut - 1]:
            self._cleared_floor = self.translate_cleared(cleared_seq)
        self.floor_lane = self.lane_lasts[cut - 1]
        self.floor_doc = (self.doc_firsts[cut - 1]
                          + (self.lane_lasts[cut - 1]
                             - self.lane_firsts[cut - 1]))
        del self.lane_firsts[:cut]
        del self.lane_lasts[:cut]
        del self.doc_firsts[:cut]
        del self.msns[:cut]
        return cut

    def to_lane_floor(self, doc_seq: int) -> int:
        """Largest lane seq whose doc seq is <= ``doc_seq`` (0 when the
        lane has none) — the doc→lane window bound for catch-up reads.
        At/above a trimmed floor but below the first live segment the
        answer is exactly ``floor_lane``; BELOW the trimmed floor the
        exact lane seq is gone and -1 is returned (callers detect the
        reload-from-snapshot case against ``floor_lane``)."""
        import bisect
        i = bisect.bisect_right(self.doc_firsts, doc_seq) - 1
        if i < 0:
            if doc_seq >= self.floor_doc:
                return self.floor_lane
            return -1 if self.floor_lane else 0
        span = self.lane_lasts[i] - self.lane_firsts[i]
        return self.lane_firsts[i] + min(
            max(doc_seq - self.doc_firsts[i], 0), span)

    def segment_at(self, lane_first: int) -> tuple[int, int]:
        """(doc_first, msn_after) of the combined batch whose window
        STARTS at ``lane_first`` (records translation: one WAL record ==
        one combined batch)."""
        import bisect
        i = bisect.bisect_left(self.lane_firsts, lane_first)
        if i >= len(self.lane_firsts) or self.lane_firsts[i] != lane_first:
            raise ValueError(f"no combined batch starts at lane seq "
                             f"{lane_first}")
        return self.doc_firsts[i], self.msns[i]

    def export(self) -> dict:
        out = {"seq": self.seq, "lf": self.lane_firsts,
               "ll": self.lane_lasts, "df": self.doc_firsts,
               "msn": self.msns}
        if self.floor_lane:
            out["floor"] = [self.floor_lane, self.floor_doc,
                            self._cleared_floor]
            if self._vseq_floor is not None:
                out["vfloor"] = [int(v) for v in self._vseq_floor]
        return out

    @classmethod
    def load(cls, snap: dict) -> "LaneCombineLog":
        log = cls()
        log.seq = snap["seq"]
        log.lane_firsts = list(snap["lf"])
        log.lane_lasts = list(snap["ll"])
        log.doc_firsts = list(snap["df"])
        log.msns = list(snap["msn"])
        floor = snap.get("floor")
        if floor:
            log.floor_lane, log.floor_doc, log._cleared_floor = floor
            if snap.get("vfloor") is not None:
                log._vseq_floor = np.asarray(snap["vfloor"], np.int64)
        return log


def fold_map_rows(sources: list[dict]) -> dict[str, np.ndarray]:
    """Cross-lane LWW fold — per-range summaries rolled up to the doc:
    each source is one range's map planes with vseq/cleared ALREADY in
    doc seq space ({"present", "value", "vseq", "cleared_seq"}). The
    map kernel keeps ``vseq`` on DELETED slots (present=False, vseq =
    the delete's seq — map_kernel._apply_doc), so delete tombstones are
    real candidates: a slot's winner is the max-doc-vseq EVENT (set or
    delete) across sources, and it renders present iff it was a set
    that post-dates the latest clear across sources. Doc seqs are
    globally distinct, so this is exactly LWW by the doc's total
    order — the same law the single-lane kernel fold applies."""
    slots = sources[0]["present"].shape[0]
    best_vseq = np.full(slots, -1, np.int64)
    best_value = np.zeros(slots, np.int64)
    best_present = np.zeros(slots, np.bool_)
    clear = max(int(s["cleared_seq"]) for s in sources)
    for s in sources:
        vseq = np.asarray(s["vseq"], np.int64)
        take = vseq > best_vseq
        best_vseq = np.where(take, vseq, best_vseq)
        best_value = np.where(take, np.asarray(s["value"], np.int64),
                              best_value)
        best_present = np.where(take, np.asarray(s["present"], np.bool_),
                                best_present)
    # clear defaults to -1 (never cleared), so ``> clear`` is exactly
    # "an event happened" then, and "post-dates the latest clear"
    # otherwise; a delete winner renders absent either way.
    present = best_present & (best_vseq > clear)
    return {"present": present,
            "value": np.where(present, best_value, 0).astype(np.int32),
            # vseq keeps delete tombstones (the kernel does too): a
            # demoted row's future LWW compares stay exact.
            "vseq": best_vseq,
            "cleared_seq": np.int64(clear)}


class _MegaDoc:
    """Per-doc promotion state for ONE promotion epoch (mirror +
    per-lane combine logs). Retained after demotion with
    ``promoted=False`` — the lane combine logs keep translating the
    doc's lane-era WAL records. Re-promotion pushes the retired state
    into the manager's past-epoch list and starts a fresh epoch with
    EPOCHED lane ids, so the new cycle's lane seq spaces never alias
    the old cycle's records."""

    __slots__ = ("lanes", "mirror", "logs", "promoted", "epoch")

    def __init__(self, lanes: int, mirror: DocSequencerMirror,
                 epoch: int = 0) -> None:
        self.lanes = lanes
        self.mirror = mirror
        self.logs = [LaneCombineLog() for _ in range(lanes)]
        self.promoted = True
        self.epoch = epoch


class _FramePlanItem(NamedTuple):
    """One ORIGINAL frame entry's ack source after the mega transform:
    either a synthesized doc-space row (zero-op outcome) or the index of
    the kept desc whose harvested row (rewritten to doc space) it is."""

    synth: tuple | None   # (n_seq, first, last, msn) or None
    desc_rel: int         # index within the frame's kept descs (-1)


class MegaDocManager:
    """The storm controller's mega-doc plane. Attach once::

        manager = MegaDocManager(storm, default_lanes=4)

    ``storm.megadoc`` is set; submit/flush/harvest call back into the
    manager only when it is attached (a controller without one pays a
    single ``is None`` check per hook). ``writer_threshold`` /
    ``demote_idle_ticks`` arm automatic promotion/demotion from the
    observed distinct-writer rate; ``promote()``/``demote()`` are the
    explicit pins."""

    def __init__(self, storm, default_lanes: int = 4,
                 writer_threshold: int | None = None,
                 demote_idle_ticks: int | None = None,
                 writer_window_ticks: int = 64,
                 trim_combine_logs: bool = False) -> None:
        self.storm = storm
        self.default_lanes = max(1, default_lanes)
        self.writer_threshold = writer_threshold
        self.demote_idle_ticks = demote_idle_ticks
        self.writer_window_ticks = max(1, writer_window_ticks)
        # Opt-in combine-log retention (the doc_index_retention_ticks
        # contract): trim each promoted doc's per-lane segments below
        # the translated MSN horizon on the flush-cadence maintenance
        # pass. Catch-up reads below the horizon then raise a clear
        # reload-from-snapshot error; converged reads stay exact via
        # the slot-aligned vseq floors.
        self.trim_combine_logs = trim_combine_logs
        self.docs: dict[str, _MegaDoc] = {}
        #: Retired promotion epochs per doc (re-promotion pushes the
        #: previous cycle here) — their combine logs keep translating
        #: that epoch's WAL records forever.
        self.past_epochs: dict[str, list[_MegaDoc]] = {}
        #: doc -> {client, ...} seen in the current observation window
        #: (auto-promotion signal) and doc -> idle harvests (demotion).
        self._writers_seen: dict[str, set[str]] = {}
        self._window_ticks = 0
        self._idle_ticks: dict[str, int] = {}
        self._in_replay_control = False
        # Promotion-window membership ops that arrived INSIDE a storm
        # round (the pump the round runs drains the idle-eject path):
        # the pipeline cannot settle mid-round, so the op parks here and
        # the flush maintenance cadence orders it through the FULL
        # mirror path once the round completes — no more falling back to
        # legacy adopt-at-decide for promotion-window joins/leaves.
        self._deferred_members: list[tuple[str, Any]] = []
        self._draining_members = False
        # promote() settles via storm.flush(), whose tail calls
        # maybe_adapt() — the guard keeps the cycle from re-entering.
        self._adapting = False
        m = storm.merge_host.metrics
        self._g_promoted = m.gauge("megadoc.promoted_docs")
        self._g_lanes = m.gauge("megadoc.total_lanes")
        self._g_occupancy = m.gauge("megadoc.combiner_occupancy")
        self._c_promotions = m.counter("megadoc.promotions")
        self._c_demotions = m.counter("megadoc.demotions")
        self._c_combined_ops = m.counter("megadoc.combined_ops")
        self._c_combined_batches = m.counter("megadoc.combined_batches")
        self._c_synth = m.counter("megadoc.synth_acks")
        self._c_deferred = m.counter("megadoc.deferred_members")
        storm.megadoc = self

    # -- directory -------------------------------------------------------------

    def is_promoted(self, doc: str) -> bool:
        st = self.docs.get(doc)
        return st is not None and st.promoted

    def has_history(self, doc: str) -> bool:
        return doc in self.docs

    def parent_of(self, doc_id: str) -> str | None:
        """Parent doc of a lane id known to this manager (else None)."""
        parsed = parse_lane_full(doc_id)
        if parsed is not None and parsed[0] in self.docs:
            return parsed[0]
        return None

    def _state_for(self, doc: str, epoch: int) -> "_MegaDoc | None":
        """The promotion-epoch state a lane id's records translate
        through: the current epoch or a retired one."""
        st = self.docs.get(doc)
        if st is not None and st.epoch == epoch:
            return st
        for past in self.past_epochs.get(doc, ()):
            if past.epoch == epoch:
                return past
        return None

    def lane_ids(self, doc: str) -> list[str]:
        st = self.docs[doc]
        return [lane_id(doc, i, st.epoch) for i in range(st.lanes)]

    # -- lifecycle -------------------------------------------------------------

    def promote(self, doc: str, lanes: int | None = None) -> None:
        """Pin a doc into the mega class. Idempotent; settles the
        pipeline first; journals a WAL control record so replay
        re-promotes at the identical point. A doc demoted earlier this
        life RE-promotes into a fresh EPOCH: new lane ids
        (``::~mg<e>.<i>``), fresh sub-sequencer seq spaces, the retired
        cycle's combine logs kept for its records' translation — replay
        re-decides both cycles identically."""
        if self.is_promoted(doc):
            return
        lanes = max(1, lanes or self.default_lanes)
        storm = self.storm
        if doc in storm.quarantined:
            raise RuntimeError(f"cannot promote quarantined doc {doc!r}")
        prior = self.docs.get(doc)
        epoch = prior.epoch + 1 if prior is not None else 0
        storm.flush()
        now = int(storm.service._clock())
        event = {"op": "promote", "doc": doc, "lanes": lanes}
        if epoch:
            event["epoch"] = epoch
        self._append_control(event, now)
        # Kill window: control journaled, lane rows NOT yet seeded —
        # recovery replays the control and re-seeds from the identical
        # recovered doc checkpoint.
        faults.crashpoint("megadoc.mid_promotion")
        self._apply_promote(doc, lanes, epoch)

    def _apply_promote(self, doc: str, lanes: int, epoch: int = 0) -> None:
        prior = self.docs.get(doc)
        if prior is not None:
            assert not prior.promoted and epoch == prior.epoch + 1, (
                doc, epoch, prior.epoch, prior.promoted)
            self.past_epochs.setdefault(doc, []).append(prior)
        seq_host = self.storm.seq_host
        seq_host._row(doc)  # a never-served doc promotes from an empty row
        cp = seq_host.checkpoint(doc)
        st = _MegaDoc(lanes, DocSequencerMirror.from_checkpoint(cp, lanes),
                      epoch=epoch)
        self.docs[doc] = st
        for i in range(lanes):
            self._sync_lane_row(doc, i)
        self._c_promotions.inc()
        self._export_gauges()
        # Text channels ride the merge-host promotion seam when present
        # (block row -> segment-sharded flat layout across device lanes).
        mh = self.storm.merge_host
        if getattr(mh, "seg_mesh", None) is not None:
            for key in list(mh._merge_rows):
                if key.doc_id == doc and not mh.is_mega_row(key):
                    mh.promote_merge_row(key)

    def demote(self, doc: str) -> None:
        """Fold the lanes back into the single-lane doc: doc map row :=
        cross-lane fold (doc-space vseqs), doc sequencer row := the
        mirror's checkpoint, lane rows released. The combine logs stay
        (they translate the doc's lane-era records forever)."""
        st = self.docs.get(doc)
        assert st is not None and st.promoted, f"{doc!r} not promoted"
        storm = self.storm
        storm.flush()
        now = int(storm.service._clock())
        self._append_control({"op": "demote", "doc": doc}, now)
        # Kill window: control journaled, fold NOT yet applied —
        # recovery replays promote + every lane tick + this control and
        # re-folds the identical lane states.
        faults.crashpoint("megadoc.mid_demotion")
        self._apply_demote(doc)

    def _apply_demote(self, doc: str) -> None:
        st = self.docs[doc]
        storm = self.storm
        fold = self._fold_doc(doc)
        self._write_doc_map_row(doc, fold)
        storm.seq_host.restore(
            doc, st.mirror.checkpoint(
                storm.seq_host.DEFAULT_TIMEOUT_MS))
        from .merge_host import ChannelKey
        for lid in self.lane_ids(doc):
            if lid in storm.seq_host._rows:
                storm.seq_host.release_doc(lid)
            key = ChannelKey(lid, storm.datastore, storm.channel)
            if key in storm.merge_host._map_rows:
                storm.merge_host.release_map_row(key)
        st.promoted = False
        self._idle_ticks.pop(doc, None)
        self._c_demotions.inc()
        self._export_gauges()
        mh = storm.merge_host
        for key in list(mh._merge_rows):
            if key.doc_id == doc and mh.is_mega_row(key):
                mh.demote_merge_row(key)

    def _export_gauges(self) -> None:
        promoted = [d for d, s in self.docs.items() if s.promoted]
        self._g_promoted.set(len(promoted))
        self._g_lanes.set(sum(self.docs[d].lanes for d in promoted))

    # -- WAL control records ---------------------------------------------------

    def _append_control(self, event: dict, now: int) -> None:
        """Journal one lifecycle event as a docs-less tick record (the
        ``"mg"`` header field): tick ids stay 1:1 with WAL record
        indices and replay re-applies the event at the same point."""
        if self._in_replay_control:
            return  # the record being replayed IS the journal entry
        storm = self.storm
        # Replay applies controls strictly by WAL position, so every
        # tick DISPATCHED before this control must have its record (and
        # tick id) in the WAL first. promote/demote settle via flush();
        # a refseq mark fires inside a cohort, where the harvest-first
        # loop has settled only the DUE tick — at pipeline_depth >= 2 a
        # later tick can still be in flight, and appending past it
        # would replay the mark ahead of ops it logically followed.
        storm._harvest()
        from .storm import STORM_WAL_VERSION
        header = json.dumps(
            {"v": STORM_WAL_VERSION, "ts": now, "docs": [],
             "mg": event}, separators=(",", ":")).encode()
        blob = struct.pack("<I", len(header)) + header
        tick_id = storm._tick_counter
        storm._tick_counter += 1
        if storm._group_wal is not None:
            idx = storm._group_wal.append([blob])
            assert idx == tick_id, (idx, tick_id)
        elif storm._blob_log is not None:
            idx = storm._blob_log.append(blob)
            assert idx == tick_id, (idx, tick_id)
        else:
            storm._tick_blobs[tick_id] = blob

    def apply_control(self, event: dict, ts: int) -> None:
        """Replay one journaled lifecycle event (``_replay_wal``)."""
        self._in_replay_control = True
        try:
            op = event["op"]
            if op == "promote":
                self._apply_promote(event["doc"], event["lanes"],
                                    event.get("epoch", 0))
            elif op == "demote":
                self._apply_demote(event["doc"])
            elif op == "mark":
                # Re-apply a refseq-NACK client mark (the only zero-op
                # outcome with state effects — it never rode a tick).
                # The event is SELF-DESCRIBING: it carries the cref the
                # mark captured (the doc MSN at DECISION time), so its
                # effect is position-independent — the mark may replay
                # before or after same-cohort entries that move the MSN
                # and still land the exact live value. (Records from
                # before the field existed fall back to apply-time MSN.)
                st = self.docs[event["doc"]]
                w = st.mirror.writers.get(event["client"])
                if w is None:
                    w = st.mirror.adopt(event["client"], st.lanes, ts)
                w.cseq = event["cseq"]
                new_ref = event.get("ref", st.mirror.msn)
                st.mirror._track_ref(w.ref, new_ref)
                w.ref = new_ref
                w.clu = event["ts"]
                w.nack = True
            elif op == "member":
                # Re-apply a promotion-window CLIENT_JOIN/LEAVE at the
                # identical WAL position (the bus holds the op itself
                # for history; row/mirror state rebuilds from here — a
                # bus-side re-sequence of an already-active client is an
                # IGNORED dup-join, so the two replay domains compose).
                self._apply_member(event)
            else:
                raise ValueError(f"unknown megadoc control {op!r}")
        finally:
            self._in_replay_control = False

    # -- ingress (submit_frame) ------------------------------------------------

    def ingress_frame(self, docs: list[tuple]) -> list[dict] | None:
        """Map promoted-doc entries to their writers' lane ids (pure,
        stateless — decisions wait for cohort selection so doc-seq
        assignment order equals WAL order equals replay order). Returns
        the per-entry mega descriptors (None when nothing in the frame
        is promoted); entries are rewritten IN PLACE in ``docs``."""
        infos: list[dict] | None = None
        for i, (doc, client, cseq0, ref, count) in enumerate(docs):
            if not self.is_promoted(doc):
                continue
            st = self.docs[doc]
            w = st.mirror.writers.get(client)
            lane = (w.lane if w is not None
                    else lane_of_writer(client, st.lanes))
            if infos is None:
                infos = [None] * len(docs)  # type: ignore[list-item]
            infos[i] = {"doc": doc, "lane": lane}
            docs[i] = (lane_id(doc, lane, st.epoch), client, cseq0, ref,
                       count)
        return infos

    # -- promotion-window membership (round-17 satellite) ----------------------
    #
    # ROADMAP item 3 residue: a CLIENT_JOIN/LEAVE that lands while the
    # doc is promoted used to sequence on the FROZEN doc row — a stale
    # doc seq that collides with the lane-combined stream, discarded at
    # demotion (adopt-without-sequence). Routerlicious now routes
    # membership ops through this seam: the doc row is fast-forwarded to
    # the combiner mirror's head (seq/msn + every active writer's
    # doc-space cseq/ref), the op sequences at mirror.seq + 1 through
    # the NORMAL deli path (history, quorum and audience all see it),
    # and the mirror absorbs the outcome + journals a control record so
    # replay re-applies it at the identical WAL position — promoted ≡
    # single-lane holds for membership churn too (the join-mid-promotion
    # differential test pins it).

    def _sync_doc_row(self, doc: str) -> None:
        """Pin the (frozen) doc sequencer row to the mirror's doc-space
        head — the demotion restore, run early so a membership op
        sequences at the doc's TRUE head instead of the stale
        at-promotion seq."""
        st = self.docs[doc]
        self.storm.seq_host.restore(
            doc, st.mirror.checkpoint(
                self.storm.seq_host.DEFAULT_TIMEOUT_MS))

    def intercept_membership(self, doc: str, raw):
        """Pre-order hook for one CLIENT_JOIN/LEAVE: False for
        unpromoted docs (the caller proceeds unintercepted). For a
        promoted doc: settle the pipeline (the mirror's head must be
        final, and the control journaled later must land after every
        already-composed tick's record), then fast-forward the doc row
        so the deli path stamps the op the correct doc seq. Returns the
        string ``"deferred"`` when the op arrived INSIDE a storm round:
        the pipeline cannot settle mid-round, so the op parks on the
        deferred-membership queue and the flush maintenance cadence
        orders it through this same mirror path right after the round —
        the caller must NOT order it now."""
        if not self.is_promoted(doc):
            return False
        if self.storm._in_round:
            # Idle-eject cadence firing inside a round (the round's pump
            # drains the eject path): defer — never legacy-adopt, never
            # recurse into the cohort being assembled.
            self._deferred_members.append((doc, raw))
            self._c_deferred.inc()
            return "deferred"
        self.storm.flush()
        self._sync_doc_row(doc)
        return True

    def _drain_deferred_membership(self) -> None:
        """Order the membership ops a storm round deferred — now at top
        level, so the full intercept path (settle + fast-forward +
        mirror absorb + "member" control) runs for each. A doc demoted
        meanwhile just orders through the normal deli path."""
        if self._draining_members or not self._deferred_members:
            return
        if self.storm._in_round or self.storm._replay:
            return
        self._draining_members = True
        try:
            while self._deferred_members:
                doc, raw = self._deferred_members.pop(0)
                self.storm.service._order_membership(doc, raw)
        finally:
            self._draining_members = False

    def complete_membership(self, doc: str, raw) -> None:
        """Post-sequence hook (the service pumped the intercepted op):
        absorb the outcome into the mirror + lane rows and journal the
        ``"member"`` control so recovery re-applies it identically."""
        from ..protocol.messages import MessageType
        storm = self.storm
        cp = storm.seq_host.checkpoint(doc)
        join = raw.type == MessageType.CLIENT_JOIN
        client = (getattr(raw.data, "client_id", raw.data) if join
                  else raw.data)
        event = {"op": "member", "doc": doc, "client": str(client),
                 "join": bool(join), "ts": raw.timestamp,
                 "seq": cp.sequence_number,
                 "msn": cp.minimum_sequence_number,
                 "lsm": cp.last_sent_msn}
        if join:
            event["can_summarize"] = bool(raw.can_summarize)
            event["can_evict"] = bool(raw.can_evict)
        self._append_control(event, raw.timestamp)
        self._apply_member(event)

    def _apply_member(self, event: dict) -> None:
        """One journaled membership event into the mirror (+ the lane
        and doc rows) — shared by the live path and WAL replay, so both
        converge on identical state. The doc-space scalars come from the
        RECORD (the sequenced outcome), never recomputed."""
        st = self.docs[event["doc"]]
        m = st.mirror
        client = event["client"]
        m.seq = event["seq"]
        m.msn = event["msn"]
        m.last_sent_msn = event["lsm"]
        w = m.writers.get(client)
        if event["join"]:
            if w is None or not w.active:
                w = m.adopt(client, st.lanes, event["ts"])
            w.summarize = bool(event.get("can_summarize", True))
            w.evict = bool(event.get("can_evict", True))
            w.clu = event["ts"]
            self._sync_lane_row(event["doc"], w.lane)
        elif w is not None and w.active:
            # Retire: drop the writer's cref from the MSN tracking (the
            # removal half of _track_ref) — the recorded msn above
            # already reflects the post-leave minimum.
            w.active = False
            m._ref_counts[w.ref] = m._ref_counts.get(w.ref, 1) - 1
            self._sync_lane_row(event["doc"], w.lane)
        # Pin the doc row to the post-membership mirror state: the live
        # path just sequenced on it, replay never did — the restore
        # makes both byte-identical.
        self._sync_doc_row(event["doc"])

    def observe_writers(self, docs: list[tuple]) -> None:
        """Auto-promotion signal: distinct writers per doc over a
        sliding tick window (called from submit_frame BEFORE the lane
        rewrite, so the ids are parent doc ids)."""
        if self.writer_threshold is None:
            return
        for doc, client, *_ in docs:
            self._writers_seen.setdefault(doc, set()).add(client)

    # -- cohort transform (the combiner) ---------------------------------------

    def decide_frame(self, frame, now: int):
        """Run the doc-space ticket over one selected frame's promoted
        entries (cohort admission order == doc seq order), trim dup
        prefixes out of the words, and return the transformed cohort
        contribution::

            (docs', words', counts', meta', plan, desc_rows)

        ``plan`` aligns with the ORIGINAL entries (ack reconstruction);
        ``desc_rows`` aligns with the KEPT descs — the doc-space ack
        quad for lane descs, None for pass-through descs (harvest
        rewrites the device ack matrix rows to the quads). Entries whose
        outcome is zero-op (dup/gap/refseq/inactive) are dropped from
        the cohort entirely — their ack rows are synthesized."""
        st_by_idx: list[dict | None] = frame.mega
        kept_docs: list[tuple] = []
        kept_words: list[np.ndarray] = []
        plan: list[_FramePlanItem] = []
        desc_rows: list[tuple | None] = []
        words = frame.words
        off = 0
        changed = False
        combined = 0
        for i, entry in enumerate(frame.docs):
            doc_id, client, cseq0, ref, count = entry
            chunk = words[off:off + count]
            off += count
            info = st_by_idx[i]
            if info is None:
                plan.append(_FramePlanItem(None, len(kept_docs)))
                kept_docs.append(entry)
                kept_words.append(chunk)
                desc_rows.append(None)
                continue
            st = self.docs[info["doc"]]
            mirror = st.mirror
            w = mirror.writers.get(client)
            if w is None:
                seq_row = self.storm.seq_host._rows.get(info["doc"])
                if seq_row is not None and client in \
                        self.storm.seq_host._slots[seq_row]:
                    # Joined the (frozen) doc row after promotion:
                    # adopt with join-at-MSN semantics.
                    w = mirror.adopt(client, st.lanes, now)
                    self._sync_lane_row(info["doc"], w.lane)
            dec = mirror.decide(client, cseq0, ref, count, now)
            if dec.n_seq == 0:
                changed = True
                self._c_synth.inc()
                if dec.refnack:
                    # Journal the refseq mark (the only state-bearing
                    # zero-op outcome) so replay re-marks identically.
                    # The captured cref (the MSN at this decision) rides
                    # the event, making its replay position-independent;
                    # journaling BEFORE this cohort's tick record keeps
                    # the mark under the tick's durability watermark, so
                    # the frame's withheld nack ack never outruns it.
                    self._append_control(
                        {"op": "mark", "doc": info["doc"],
                         "client": client, "cseq": w.cseq,
                         "ref": w.ref, "ts": now},
                        now)
                plan.append(_FramePlanItem(dec.ack_row, -1))
                continue
            lane = w.lane  # a sequenced decision implies a known writer
            log = st.logs[lane]
            log.append(dec.n_seq, dec.first, dec.msn)
            lane_cseq0 = (cseq0 + dec.dups) - w.offset
            if dec.dups or lane_cseq0 != cseq0:
                # A trim or an offset-shifted lane cseq invalidates the
                # frame's own meta columns.
                changed = True
            if dec.dups:
                chunk = chunk[dec.dups:]
            plan.append(_FramePlanItem(None, len(kept_docs)))
            desc_rows.append(dec.ack_row)
            kept_docs.append((lane_id(info["doc"], lane, st.epoch),
                              client, lane_cseq0, ref, dec.n_seq))
            kept_words.append(chunk)
            combined += dec.n_seq
        if combined:
            self._c_combined_ops.inc(combined)
            self._c_combined_batches.inc(
                sum(1 for row in desc_rows if row is not None))
            # Kill window: combiner state advanced (doc seqs assigned,
            # mirrors moved), device tick NOT yet dispatched and the
            # tick's WAL record NOT yet appended — everything here is
            # volatile; clients resend and the re-decide is identical.
            faults.crashpoint("megadoc.mid_combine")
        if not changed and len(kept_docs) == len(frame.docs):
            # Pure pass-through (clean batches, zero lane-cseq offsets —
            # the steady-state shape): reuse the frame's zero-copy views
            # AND its meta/counts columns verbatim. The meta ref column
            # still carries doc refs for the lane descs; _flush_round
            # force-zeroes the device feed for lane rows either way
            # (the cached lane_seq_rows store), so the device contract
            # holds without a per-entry rebuild on the hot path.
            return (kept_docs, frame.words, frame.counts, frame.meta,
                    plan, desc_rows)
        counts = np.array([d[4] for d in kept_docs], np.int32)
        flat = (np.concatenate(kept_words) if kept_words
                else np.empty(0, np.uint32))
        meta = self._meta_for(kept_docs)
        return kept_docs, flat, counts, meta, plan, desc_rows

    @staticmethod
    def _meta_for(docs: list[tuple]) -> np.ndarray:
        """Device-feed columns for transformed descs. Lane rows take
        ref 0 — their cref planes stay pinned at 0 so the device's
        refseq/MSN law never fires on a lane (the doc-space law already
        ran in the mirror); the DESC tuple keeps the doc-space ref for
        the WAL header and records translation."""
        meta = np.zeros((len(docs), 3), np.int32)
        for i, (doc, _c, cseq0, ref, count) in enumerate(docs):
            meta[i, 0] = cseq0
            meta[i, 1] = 0 if parse_lane(doc) else ref
            meta[i, 2] = count
        return meta

    def replay_decide(self, descs: list[tuple], now: int) -> None:
        """WAL replay twin of :meth:`decide_frame`: lane entries in a
        replayed tick are already cleaned (all-sequenced), so re-apply
        the sequenced branch of the algebra to rebuild mirrors and
        combine logs deterministically."""
        for doc_id, client, lane_cseq0, ref, count in descs:
            parsed = parse_lane_full(doc_id)
            if parsed is None or parsed[0] not in self.docs:
                continue
            doc, epoch, lane = parsed
            st = self.docs[doc]
            # Controls replay strictly by WAL position, so the current
            # epoch at any lane entry's replay equals its live epoch.
            assert st.epoch == epoch, (doc_id, st.epoch)
            mirror = st.mirror
            w = mirror.writers.get(client)
            if w is None:
                w = mirror.adopt(client, st.lanes, now)
            cseq0 = lane_cseq0 + w.offset
            n = count
            seq2 = mirror.seq + n
            ref_eff = seq2 if ref == -1 else ref
            w.cseq = cseq0 + n - 1
            mirror._track_ref(w.ref, ref_eff)
            w.ref = ref_eff
            w.clu = now
            w.nack = False
            mirror.seq = seq2
            mirror.msn = mirror._min_ref()
            mirror.last_sent_msn = mirror.msn
            st.logs[lane].append(n, seq2 - n + 1, mirror.msn)

    def finish_cohort(self, descs: list[tuple]) -> None:
        """Combiner occupancy gauge: lane descs this tick / total lanes
        of currently promoted docs."""
        total = sum(s.lanes for s in self.docs.values() if s.promoted)
        if not total:
            return
        active = sum(1 for d, *_ in descs if parse_lane(d) is not None)
        self._g_occupancy.set(active / total)

    def lane_seq_rows(self, descs: list[tuple], seq_rows: np.ndarray
                      ) -> np.ndarray:
        """Sequencer rows of the lane descs in a cohort (the device-feed
        ref column is force-zeroed for exactly these rows — replay feeds
        metas rebuilt from WAL entries, whose ref column carries the
        doc-space ref)."""
        idx = [i for i, (d, *_r) in enumerate(descs)
               if parse_lane(d) is not None]
        return seq_rows[np.asarray(idx, np.int32)] if idx else \
            np.empty(0, np.int32)

    # -- lane row maintenance --------------------------------------------------

    def _sync_lane_row(self, doc: str, lane: int) -> None:
        """(Re)install one lane's device sequencer row from the mirror:
        every writer assigned to the lane, active, cseq in LANE space,
        cref pinned 0 (see :meth:`_meta_for`), lane seq = the combine
        log's high water. Deterministic in the mirror, so promotion,
        post-promotion adoption and replay all converge on the same
        row."""
        from .sequencer import SequencerCheckpoint
        st = self.docs[doc]
        clients = [{
            "client_id": cid, "client_seq": w.cseq - w.offset,
            "ref_seq": 0, "last_update": w.clu, "can_evict": w.evict,
            "can_summarize": w.summarize, "nack": False,
        } for cid, w in sorted(st.mirror.writers.items())
            if w.active and w.lane == lane]
        self.storm.seq_host.restore(
            lane_id(doc, lane, st.epoch), SequencerCheckpoint(
            sequence_number=st.logs[lane].seq,
            minimum_sequence_number=0,
            last_sent_msn=0,
            no_active_clients=not clients,
            clients=clients,
            nack_future=False,
            client_timeout_ms=self.storm.seq_host.DEFAULT_TIMEOUT_MS,
            log_offset=-1,
        ))

    # -- reads -----------------------------------------------------------------

    def _lane_map_sources(self, doc: str) -> list[dict]:
        """Doc-space map planes of every range: the frozen pre-promotion
        row (already doc-space) + each lane row translated through its
        combine log. The baseline and lane rows come back in ONE device
        read."""
        storm = self.storm
        mh = storm.merge_host
        st = self.docs[doc]
        from .merge_host import ChannelKey
        rows: list[int] = []
        logs: list = []
        base_key = ChannelKey(doc, storm.datastore, storm.channel)
        if base_key in mh._map_rows:
            rows.append(mh._map_rows[base_key].row)
            logs.append(None)
        for i in range(st.lanes):
            key = ChannelKey(lane_id(doc, i, st.epoch), storm.datastore,
                             storm.channel)
            mrow = mh._map_rows.get(key)
            if mrow is None:
                continue
            rows.append(mrow.row)
            logs.append(st.logs[i])
        if not rows:
            return []
        planes = mh.read_map_rows(rows)
        sources = []
        for j, log in enumerate(logs):
            src = {"present": planes["present"][j],
                   "value": planes["value"][j],
                   "vseq": planes["vseq"][j].astype(np.int64),
                   "cleared_seq": int(planes["cleared_seq"][j])}
            if log is not None:
                src["vseq"] = log.to_doc_array(src["vseq"])
                src["cleared_seq"] = log.translate_cleared(
                    src["cleared_seq"])
            sources.append(src)
        return sources

    def _fold_doc(self, doc: str) -> dict[str, np.ndarray]:
        sources = self._lane_map_sources(doc)
        if not sources:
            s = self.storm.merge_host._map_slots
            return {"present": np.zeros(s, np.bool_),
                    "value": np.zeros(s, np.int32),
                    "vseq": np.full(s, -1, np.int64),
                    "cleared_seq": np.int64(-1)}
        return fold_map_rows(sources)

    def map_entries(self, doc: str) -> dict[str, int]:
        """Converged doc map of a promoted doc (the cross-lane fold) in
        the storm literal-value shape — byte-comparable to an unpromoted
        twin's ``merge_host.map_entries``."""
        self.storm.flush()
        fold = self._fold_doc(doc)
        return {f"k{s}": int(fold["value"][s])
                for s in np.flatnonzero(fold["present"])}

    def _write_doc_map_row(self, doc: str,
                           fold: dict[str, np.ndarray]) -> None:
        """Demotion: materialize the fold into the doc's live map row
        (vseq in DOC space, so single-lane serving resumes exact LWW)."""
        storm = self.storm
        row = storm._storm_map_row(doc)
        s_live = storm.merge_host._map_slots
        vseq = np.full(s_live, -1, np.int32)
        value = np.zeros(s_live, np.int32)
        present = np.zeros(s_live, np.bool_)
        n = fold["present"].shape[0]
        present[:n] = fold["present"]
        value[:n] = fold["value"]
        vseq[:n] = np.clip(fold["vseq"], -1, INT32_MAX).astype(np.int32)
        storm.merge_host.write_map_row(
            row, present, value, vseq,
            min(int(fold["cleared_seq"]), INT32_MAX))

    def records(self, doc: str, from_seq: int, to_seq: int | None,
                base_fn: Callable) -> list[dict]:
        """Doc-space catch-up records of a (once-)promoted doc: the
        doc's own tick records (pre-promotion / post-demotion, already
        doc-space) merged with every lane's records translated through
        its combine log, sorted by doc first_seq. ``base_fn`` is the
        controller's untranslated per-id record resolver."""
        out = list(base_fn(doc, from_seq, to_seq))
        epochs = (*self.past_epochs.get(doc, ()), self.docs[doc])
        for st in epochs:
            for i in range(st.lanes):
                log = st.logs[i]
                # Bound the lane query to the requested doc window
                # (floor translation) — an incremental catch-up read
                # must not scan a long-lived promoted doc's full lane
                # history per call.
                lane_from = log.to_lane_floor(from_seq)
                if lane_from < log.floor_lane:
                    raise ValueError(
                        f"{doc!r} catch-up from doc seq {from_seq} is "
                        f"below the trimmed combine-log horizon (doc "
                        f"seq {log.floor_doc}); reload from a snapshot")
                lane_to = (None if to_seq is None
                           else log.to_lane_floor(to_seq))
                for rec in base_fn(lane_id(doc, i, st.epoch), lane_from,
                                   lane_to):
                    if rec["n_seq"] <= 0:
                        continue
                    doc_first, msn = log.segment_at(rec["first_seq"])
                    w = st.mirror.writers.get(rec["client"])
                    offset = w.offset if w is not None else 0
                    doc_rec = dict(rec)
                    doc_rec["first_seq"] = doc_first
                    doc_rec["last_seq"] = doc_first + rec["n_seq"] - 1
                    doc_rec["msn"] = msn
                    doc_rec["first_cseq"] = rec["first_cseq"] + offset
                    if doc_rec["last_seq"] <= from_seq or (
                            to_seq is not None and doc_first > to_seq):
                        continue
                    out.append(doc_rec)
        out.sort(key=lambda r: (r["first_seq"], r["tick"]))
        return out

    # -- harvest hooks ---------------------------------------------------------

    def note_harvest(self, descs: list[tuple]) -> None:
        """Demotion idleness: promoted docs absent from this harvest's
        cohort age toward ``demote_idle_ticks``; present ones reset."""
        self._window_ticks += 1
        touched: set[str] = set()
        for d, *_ in descs:
            parsed = parse_lane(d)
            if parsed is not None:
                touched.add(parsed[0])
        for doc, st in self.docs.items():
            if not st.promoted:
                continue
            if doc in touched:
                self._idle_ticks[doc] = 0
            else:
                self._idle_ticks[doc] = self._idle_ticks.get(doc, 0) + 1

    def maybe_adapt(self) -> None:
        """Flush-cadence auto promotion/demotion (thresholds armed in
        the constructor; explicit pins always win)."""
        self._drain_deferred_membership()
        if self._adapting:
            return
        self._adapting = True
        try:
            self._maybe_adapt_locked()
        finally:
            self._adapting = False

    def _maybe_adapt_locked(self) -> None:
        if self.writer_threshold is not None \
                and self._window_ticks >= self.writer_window_ticks:
            for doc, writers in list(self._writers_seen.items()):
                # A doc demoted earlier this life may RE-promote: lane
                # epoching forks the new cycle's seq spaces away from
                # the retired one's records.
                if (len(writers) >= self.writer_threshold
                        and not self.is_promoted(doc)
                        and doc not in self.storm.quarantined):
                    self.promote(doc)
            self._writers_seen.clear()
            self._window_ticks = 0
        if self.demote_idle_ticks is not None:
            for doc in [d for d, n in self._idle_ticks.items()
                        if n >= self.demote_idle_ticks
                        and self.is_promoted(d)]:
                self.demote(doc)
        if self.trim_combine_logs:
            self.trim_logs()

    def trim_logs(self, doc: str | None = None) -> int:
        """Bounded-memory maintenance for promoted docs' combine logs
        (ROADMAP mega-doc residue): retire each lane's segments below
        the lane floor of the doc MSN — the collab-window floor below
        which no active writer can reference — capturing the lane map
        row's live vseq plane translations first so the cross-lane LWW
        fold stays exact. Returns segments dropped."""
        from .merge_host import ChannelKey
        storm = self.storm
        mh = storm.merge_host
        dropped = 0
        for d, st in self.docs.items():
            if (doc is not None and d != doc) or not st.promoted:
                continue
            msn = st.mirror.msn
            for i in range(st.lanes):
                log = st.logs[i]
                horizon = log.to_lane_floor(msn)
                if horizon <= log.floor_lane:
                    continue
                key = ChannelKey(lane_id(d, i, st.epoch),
                                 storm.datastore, storm.channel)
                mrow = mh._map_rows.get(key)
                plane = cleared = None
                if mrow is not None:
                    planes = mh.read_map_rows([mrow.row])
                    plane = planes["vseq"][0]
                    cleared = int(planes["cleared_seq"][0])
                dropped += log.trim_below(horizon, plane,
                                          -1 if cleared is None
                                          else cleared)
        return dropped

    # -- snapshot --------------------------------------------------------------

    @staticmethod
    def _export_epoch(st: _MegaDoc) -> dict:
        out = {"lanes": st.lanes, "promoted": st.promoted,
               "mirror": st.mirror.export(),
               "logs": [log.export() for log in st.logs]}
        if st.epoch:
            out["epoch"] = st.epoch
        return out

    @staticmethod
    def _load_epoch(rec: dict) -> _MegaDoc:
        st = _MegaDoc(rec["lanes"],
                      DocSequencerMirror.load(rec["mirror"]),
                      epoch=rec.get("epoch", 0))
        st.logs = [LaneCombineLog.load(s) for s in rec["logs"]]
        st.promoted = rec["promoted"]
        return st

    def export_state(self) -> dict:
        out: dict = {"docs": {}}
        for doc, st in self.docs.items():
            rec = self._export_epoch(st)
            past = self.past_epochs.get(doc)
            if past:
                rec["past"] = [self._export_epoch(p) for p in past]
            out["docs"][doc] = rec
        return out

    def import_state(self, snap: dict | None) -> None:
        if not snap:
            return
        assert not self.docs, "import_state needs a fresh manager"
        for doc, rec in snap["docs"].items():
            self.docs[doc] = self._load_epoch(rec)
            if rec.get("past"):
                self.past_epochs[doc] = [self._load_epoch(p)
                                         for p in rec["past"]]
        self._export_gauges()


__all__ = ["MegaDocManager", "DocSequencerMirror", "LaneCombineLog",
           "fold_map_rows", "lane_id", "parse_lane", "parse_lane_full",
           "lane_of_writer", "LANE_SEP"]
