"""History plane — time-travel reads, named branches, and summarization
compaction over the storm tier's durable record.

Port of ``fluidframework_tpu/server/history.py``: the bookkeeping, the
summary records, the ``"hp"`` WAL controls and the scalar fold are the
reference's line for line. The one place that touches the device is a
fork without a residency tier: the branch's map row is written in place
on its device (``KernelMergeHost.write_map_row``, a blocking copy on the
current stream after every dispatched tick), as residency's hydration
writes one. With a residency tier the seed is a cold-doc record and the
branch's first frame hydrates it.

Reference parity: the reference's summary contract (``ISummaryTree``,
PAPER.md layer 0) makes rolled-up summaries a first-class protocol
plane — catch-up cost is bounded by the distance to the nearest summary
while the op log keeps intermediate states addressable. Here the same
contract is productized over what the serving tier already journals:
the content-addressed snapshot store (``GitSnapshotStore``/``Historian``
with refcount GC), the per-doc WAL tick index, and the cold-read
``records_overlapping``/``get_deltas`` machinery. Three capabilities:

* **time travel** — :meth:`HistoryPlane.read_at` materializes a doc's
  converged map state at ANY historical sequence number entirely from
  the cold path: nearest history summary at-or-below ``seq`` + a scalar
  fold of the WAL records in ``(summary.seq, seq]``. No device row is
  hydrated, no pool slot churns — a read is a read. The scalar fold is
  an EXACT twin of the device LWW kernel (``ops/map_kernel._apply_doc``
  collapsed to sequential per-op application), pinned by the
  materialize-at-N ≡ replay-to-N differential in tests/test_history.py.
* **named branches** — :meth:`fork` seeds a NEW doc from the parent's
  state at ``seq``: the branch's first history summary IS the seeded
  state (so time travel below the fork seq delegates to the parent and
  above it folds the branch's own records), and the serving seed is a
  normal cold-doc record hydrated through the ordinary residency
  recovery path (or installed directly into live rows when no residency
  tier is attached). Branch metadata (parent, fork seq, name) journals
  as a docs-less WAL CONTROL record (the ``"hp"`` header field — the
  mega-doc ``"mg"`` pattern) and rides the storm snapshot, so recovery
  re-seeds a forked branch at the identical point in the total order.
  Forked docs are FULL citizens: residency, migration, QoS and viewers
  see an ordinary doc. :meth:`merge_back` re-submits the branch's delta
  ops (records above the fork seq) through the ordinary sequencer as a
  fresh client's frames — convergence needs no new merge machinery.
* **summarization compaction** — :meth:`maybe_compact` (driven from the
  storm flush maintenance cadence) rolls long WAL tails into fresh
  summaries on op-count/byte thresholds, flips heads atomically through
  the existing ``Historian.set_head``/``release`` refcount GC, and —
  with ``tail_retention_summaries`` set — trims superseded tail
  prefixes: the per-doc tick index drops entries below the floor and
  the superseded WAL tick blobs rewrite to tiny filler records
  (``StormController.trim_tick_blobs``), so a long-tail churn doc's
  disk cost collapses to its summary instead of its whole edit history.
  Reads below the trim floor raise :class:`HistoryError` (the same
  retention trade ``doc_index_retention_ticks`` and scriptorium
  ``retention_ops`` already make); with retention None (the default)
  every intermediate state stays addressable forever.

Safety invariants (chaos-proven, ``history.mid_compaction`` /
``history.mid_fork`` crashpoints, tools/chaos.py ``--history``):

* a kill mid-compaction leaves the previous summary head intact (the
  upload-then-flip order every head in this codebase uses) — the next
  cadence pass re-compacts; nothing acked-durable is touched;
* a kill mid-fork (control journaled, branch not yet seeded) replays
  the control and re-derives the identical seed — the fold is a pure
  function of the records below the control's WAL position;
* compaction + trim never change converged state: the never-compacted
  twin digests byte-identical (state lives in summaries exactly when it
  leaves the tail, and only ticks below the storm checkpoint watermark
  — which recovery never replays — are ever rewritten).

Chain re-anchoring and retention pins: the inline summary chain
re-anchors past ``chain_reanchor_depth`` — the oldest entries roll into
linked content-addressed anchor pages so ``__hist__`` head records stay
O(depth) forever while every anchored exact state remains addressable
through :meth:`_base_for`'s anchor walk — and paid-tier tenants
(riddler weight > 1.0 via ``tenant_source``) can :meth:`pin_range` seq
ranges against the tail-trim and chain-release retention trades; pins
journal as ``"hp"`` controls and ride the storm snapshot like branch
metadata, so they survive recovery and leader failover.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import time
from typing import Any

import numpy as np

from ..ops import map_kernel as mk
from ..utils import faults

#: Format version stamped on every history summary record. Readers
#: accept 0..CURRENT and refuse anything newer.
HISTORY_SUMMARY_VERSION = 1

#: Snapshot-store key prefix for per-doc history summary heads.
HIST_KEY_PREFIX = "__hist__::"


class HistoryError(RuntimeError):
    """A historical read cannot be served: the requested seq is beyond
    the doc's head, or below a compaction trim floor (the retention
    trade — reload from a summary instead)."""


class _FoldState:
    """Scalar twin of one doc's device map row: the EXACT sequential
    equivalent of ``map_kernel._apply_doc`` (set → present/value/vseq,
    delete → absent + vseq, clear → wipe present/vseq, value planes
    untouched — last-writer-wins per slot with clear barriers)."""

    __slots__ = ("present", "value", "vseq", "cleared_seq", "seq")

    def __init__(self, seq: int = 0) -> None:
        self.present: set[int] = set()
        self.value: dict[int, int] = {}
        self.vseq: dict[int, int] = {}
        self.cleared_seq = -1
        self.seq = seq  # the fold frontier this state reflects

    def apply_batch(self, ops: list[tuple[int, int]]) -> None:
        """One TICK's applied ``(word, seq)`` ops for this doc, with the
        device kernel's intra-tick winner rule: ops before the tick's
        last clear are dead (they never touch any plane — a sequential
        fold would leave their values behind on the value plane, which
        the byte-identity bar forbids), and per slot only the LAST
        surviving key-op lands — set writes present/value/vseq, delete
        clears presence and stamps vseq with the value plane untouched.
        For a single op (or a mid-tick prefix) this reduces to the
        sequential rules on every ENTRIES-visible plane."""
        last_clear = -1
        for idx, (word, _seq) in enumerate(ops):
            if (word & 3) == mk.MAP_CLEAR:
                last_clear = idx
        if last_clear >= 0:
            self.present.clear()
            self.vseq.clear()  # device: vseq := -1 everywhere
            self.cleared_seq = ops[last_clear][1]
        winners: dict[int, tuple[int, int]] = {}
        for word, seq in ops[last_clear + 1:]:
            winners[(word >> 2) & 0x3FF] = (word, seq)
        for slot, (word, seq) in winners.items():
            if (word & 3) == mk.MAP_SET:
                self.present.add(slot)
                self.value[slot] = (word >> 12) & 0xFFFFF
                self.vseq[slot] = seq
            else:  # MAP_DELETE
                self.present.discard(slot)
                self.vseq[slot] = seq

    def entries(self) -> dict[str, int]:
        """Converged entries in the canonical ``k<slot>`` key space —
        the same shape ``KernelMergeHost.map_entries`` serves."""
        return {f"k{s}": self.value[s] for s in sorted(self.present)}

    def planes(self, s_live: int
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Full-width device planes (present/value/vseq) — the fork
        seed; byte-identical to a row that replayed the same stream."""
        present = np.zeros(s_live, np.bool_)
        value = np.zeros(s_live, np.int32)
        vseq = np.full(s_live, -1, np.int32)
        for slot in self.present:
            present[slot] = True
        for slot, v in self.value.items():
            value[slot] = v
        for slot, sq in self.vseq.items():
            vseq[slot] = sq
        return present, value, vseq

    def to_wire(self) -> dict:
        return {"present": sorted(self.present),
                "value": sorted(self.value.items()),
                "vseq": sorted(self.vseq.items()),
                "cleared_seq": self.cleared_seq, "seq": self.seq}

    @classmethod
    def from_wire(cls, snap: dict) -> "_FoldState":
        st = cls(int(snap["seq"]))
        st.present = {int(s) for s in snap["present"]}
        st.value = {int(s): int(v) for s, v in snap["value"]}
        st.vseq = {int(s): int(v) for s, v in snap["vseq"]}
        st.cleared_seq = int(snap["cleared_seq"])
        return st

    def copy(self) -> "_FoldState":
        st = _FoldState(self.seq)
        st.present = set(self.present)
        st.value = dict(self.value)
        st.vseq = dict(self.vseq)
        st.cleared_seq = self.cleared_seq
        return st


# -- off-leader fold reuse -----------------------------------------------------
#
# The read-replica tier (server/read_replica.py) serves read_at/branch
# reads with NO HistoryPlane instance and NO storm controller — just the
# shared snapshot store and a tailed copy of the WAL. These module-level
# functions are the exact read path the plane itself uses, factored so
# both callers fold the same records through the same code and stay
# byte-identical by construction.


def load_summary_record(snapshots, doc: str) -> dict | None:
    """The doc's head summary record from the shared store (version-
    checked), or None when the doc has never been compacted."""
    handle = snapshots.head(HIST_KEY_PREFIX + doc)
    if handle is None:
        return None
    rec = snapshots.get(HIST_KEY_PREFIX + doc, handle)
    if rec is None:
        return None
    version = rec.get("format_version", 0)
    if not 0 <= version <= HISTORY_SUMMARY_VERSION:
        raise ValueError(
            f"history summary format v{version} is newer than this "
            f"reader (max v{HISTORY_SUMMARY_VERSION})")
    return rec


def summary_base_for(snapshots, doc: str, seq: int,
                     rec: dict | None) -> _FoldState:
    """Nearest exact summary state at-or-below ``seq`` given the doc's
    head summary record ``rec`` (empty state at 0 when nothing covers):
    head state, then the inline chain newest-first, then the linked
    anchor pages of re-anchored older states."""
    if rec is None:
        return _FoldState(0)
    if rec["seq"] <= seq:
        return _FoldState.from_wire(rec["state"])
    key = HIST_KEY_PREFIX + doc
    for s, handle in reversed(rec.get("chain", ())):
        if s <= seq:
            old = snapshots.get(key, handle)
            if old is None:
                return _FoldState(0)  # GC'd: fall to the floor check
            return _FoldState.from_wire(old["state"])
    anchor_handle = (rec.get("anchor") or {}).get("handle")
    while anchor_handle is not None:
        page = snapshots.get(key, anchor_handle)
        if page is None:
            break  # anchor GC'd: fall through to the floor check
        for s, handle in reversed(page.get("entries", ())):
            if s <= seq:
                old = snapshots.get(key, handle)
                if old is None:
                    return _FoldState(0)
                return _FoldState.from_wire(old["state"])
        anchor_handle = page.get("prev_anchor")
    return _FoldState(0)


def fold_storm_records(state: _FoldState, records, to_seq: int,
                       read_tick_words) -> None:
    """Fold storm-shaped doc records in ``(state.seq, to_seq]`` onto
    ``state`` — the scalar twin of the device LWW kernel.
    ``read_tick_words(tick)`` resolves a tick id to its raw op-word
    bytes (leader: the storm's blob log; replica: its tailed WAL)."""
    import base64
    blob_cache: dict[int, bytes] = {}
    for rec in sorted(records, key=lambda r: r["first_seq"]):
        n_seq = rec["n_seq"]
        if n_seq <= 0 or rec["last_seq"] <= state.seq:
            continue
        if "words" in rec:
            words = np.frombuffer(base64.b64decode(rec["words"]),
                                  np.uint32, rec["count"])
        else:
            tick = rec["tick"]
            blob = blob_cache.get(tick)
            if blob is None:
                blob = read_tick_words(tick)
                blob_cache[tick] = blob
            words = np.frombuffer(blob, np.uint32, rec["count"],
                                  rec["w_off"])
        skip = rec["count"] - n_seq  # rejected prefix (dup resend)
        first = rec["first_seq"]
        batch: list[tuple[int, int]] = []
        for j in range(n_seq):
            seq = first + j
            if seq <= state.seq:
                continue
            if seq > to_seq:
                break
            batch.append((int(words[skip + j]), seq))
        if batch:
            # One record = one tick's doc batch: the intra-tick
            # winner rule applies per record.
            state.apply_batch(batch)
        if first + n_seq - 1 > to_seq:
            return


class HistoryPlane:
    """The history subsystem over one :class:`~.storm.StormController`.
    Attaches itself as ``storm.history``; the controller replays its
    ``"hp"`` WAL control records, carries its branch metadata in the
    storm snapshot, and drives :meth:`maybe_compact` from the flush
    maintenance cadence."""

    def __init__(self, storm, snapshots=None,
                 summary_interval_ops: int | None = None,
                 summary_interval_bytes: int | None = None,
                 tail_retention_summaries: int | None = None,
                 max_chain_summaries: int | None = None,
                 chain_reanchor_depth: int | None = 64,
                 tenant_source=None,
                 compact_docs_per_pass: int = 8,
                 compact_check_every: int = 16,
                 trim_batch_ticks: int = 64) -> None:
        self.storm = storm
        self.snapshots = (snapshots if snapshots is not None
                          else storm.snapshots)
        if self.snapshots is None:
            raise ValueError(
                "HistoryPlane needs a snapshot store — summaries and "
                "branch seeds live there (pass snapshots= here or on "
                "the controller)")
        #: None disables the background summarizer (explicit compact()
        #: still works); with a value, maybe_compact() rolls any doc
        #: whose tail is at least this many ops behind its summary.
        self.summary_interval_ops = summary_interval_ops
        self.summary_interval_bytes = summary_interval_bytes
        #: None = never trim (every intermediate state addressable
        #: forever); K = keep the WAL tail for the newest K summary
        #: intervals, trim below (0 = trim everything under the head
        #: summary — maximum disk win, summary-state-only time travel
        #: below it).
        self.tail_retention_summaries = tail_retention_summaries
        #: None = the summary chain keeps EVERY prior summary (each is
        #: tiny — exact states stay addressable forever, the contract
        #: the trim-floor error message promises); K = keep the newest
        #: K chain entries and release older ones through the store's
        #: refcount GC (reads at their seqs then fail like any
        #: compacted-away state).
        self.max_chain_summaries = max_chain_summaries
        #: Inline-chain depth cap (ROADMAP 5c): when the head record's
        #: chain grows past this, compact() rolls the OLDEST entries
        #: into a content-addressed anchor page (a linked list under
        #: the same hist key) and keeps only the newest half inline —
        #: head records stay O(depth) while anchored exact states stay
        #: addressable. None disables re-anchoring (unbounded chain).
        self.chain_reanchor_depth = chain_reanchor_depth
        #: Paid-tier authority for retention pins (ROADMAP 5d): any
        #: object with riddler's ``weight_for(tenant_id)`` surface;
        #: weight > 1.0 (pro/premium) may pin. None = pins ungated
        #: (embedders with their own auth story).
        self.tenant_source = tenant_source
        #: (tenant, doc) -> (lo, hi): seq ranges pinned against the
        #: tail trim and chain release — journaled as "hp" controls
        #: and carried in the storm snapshot like branch metadata.
        self.pins: dict[tuple[str, str], tuple[int, int]] = {}
        self.compact_docs_per_pass = max(1, compact_docs_per_pass)
        self.compact_check_every = max(1, compact_check_every)
        self.trim_batch_ticks = max(1, trim_batch_ticks)
        #: branch doc -> {"parent", "seq", "name"} (journaled as "hp"
        #: controls + the storm snapshot's "history" field).
        self.branches: dict[str, dict] = {}
        self.children: dict[str, list[str]] = {}
        # Summary head cache: doc -> (handle, record). The store stays
        # the authority (heads re-read on miss); compact() refreshes.
        self._summary_cache: dict[str, tuple[str, dict]] = {}
        self._trim_candidates: set[int] = set()
        self._in_replay_control = False
        self._busy = False  # compaction reentrancy (flush-inside-evict)
        self._checks = 0
        m = storm.merge_host.metrics
        self._metrics = m
        self._g_branches = m.gauge("history.branches")
        self._g_branches.set(0)
        self._g_tail = m.gauge("history.tail_ops")
        self._g_tail.set(0)
        self._c_compactions = m.counter("history.compactions")
        self._c_trimmed = m.counter("history.trimmed_ticks")
        self._c_reads = m.counter("history.reads")
        self._c_merges = m.counter("history.merges")
        self._h_read = m.histogram("history.read_s")
        self.stats = {"compactions": 0, "trimmed_ticks": 0, "forks": 0,
                      "merges": 0, "reads": 0, "reanchors": 0,
                      "pins": 0}
        storm.history = self

    # -- store keys ------------------------------------------------------------

    @staticmethod
    def _hist_key(doc_id: str) -> str:
        return HIST_KEY_PREFIX + doc_id

    # -- summary chain ---------------------------------------------------------

    def _summary_record(self, doc: str) -> dict | None:
        cached = self._summary_cache.get(doc)
        handle = self.snapshots.head(self._hist_key(doc))
        if handle is None:
            return None
        if cached is not None and cached[0] == handle:
            return cached[1]
        rec = self.snapshots.get(self._hist_key(doc), handle)
        if rec is None:
            return None
        version = rec.get("format_version", 0)
        if not 0 <= version <= HISTORY_SUMMARY_VERSION:
            raise ValueError(
                f"history summary format v{version} is newer than this "
                f"reader (max v{HISTORY_SUMMARY_VERSION})")
        self._summary_cache[doc] = (handle, rec)
        return rec

    def has_summary(self, doc: str) -> bool:
        return self._summary_record(doc) is not None

    def summary_seq(self, doc: str) -> int:
        rec = self._summary_record(doc)
        return int(rec["seq"]) if rec is not None else 0

    def tail_floor(self, doc: str) -> int:
        """Seqs at-or-below this are served only by exact summary
        states (0 = the full tail is retained)."""
        rec = self._summary_record(doc)
        return int(rec.get("tail_floor", 0)) if rec is not None else 0

    def _base_for(self, doc: str, seq: int) -> _FoldState:
        """Nearest summary state at-or-below ``seq`` (empty state at 0
        when the doc has no covering summary)."""
        return summary_base_for(self.snapshots, doc, seq,
                                self._summary_record(doc))

    # -- tenant retention pins -------------------------------------------------

    def _pin_floor(self, doc: str) -> int | None:
        """Lowest pinned start seq for ``doc`` (None = unpinned)."""
        los = [lo for (_t, d), (lo, _hi) in self.pins.items()
               if d == doc]
        return min(los) if los else None

    def _pinned_at(self, doc: str, seq: int) -> bool:
        return any(d == doc and lo <= seq <= hi
                   for (_t, d), (lo, hi) in self.pins.items())

    def _pin_overlaps(self, doc: str, fs: int, ls: int) -> bool:
        return any(d == doc and lo <= ls and fs <= hi
                   for (_t, d), (lo, hi) in self.pins.items())

    def pin_range(self, tenant_id: str, doc: str, from_seq: int,
                  to_seq: int) -> dict:
        """Pin ``doc``'s seq range ``[from_seq, to_seq]`` against WAL
        tick-blob trimming and summary-chain release on behalf of
        ``tenant_id`` — the paid-tier retention knob (ROADMAP 5d).
        Gated on the riddler tier column when a ``tenant_source`` is
        attached: weight must be > 1.0 (pro/premium); free/standard
        tenants take the plane's default retention trade. One pin per
        (tenant, doc) — re-pinning replaces the range. Journaled as an
        ``"hp"`` control and carried in the storm snapshot, so pins
        survive recovery and failover. Pins protect history from NOW
        on: records a past compaction already trimmed stay trimmed."""
        lo, hi = int(from_seq), int(to_seq)
        if not 0 <= lo <= hi:
            raise ValueError(f"bad pin range [{lo}, {hi}]")
        if self.tenant_source is not None:
            weight = self.tenant_source.weight_for(tenant_id)
            if weight is None or weight <= 1.0:
                raise HistoryError(
                    f"tenant {tenant_id!r} (weight {weight}) cannot "
                    "pin retention: pins are a paid-tier feature "
                    "(riddler weight > 1.0 — pro/premium)")
        now = int(self.storm.service._clock())
        self._append_control({"op": "pin", "tenant": tenant_id,
                              "doc": doc, "lo": lo, "hi": hi}, now)
        self.pins[(tenant_id, doc)] = (lo, hi)
        self.stats["pins"] = len(self.pins)
        return {"tenant": tenant_id, "doc": doc, "lo": lo, "hi": hi}

    def unpin_range(self, tenant_id: str, doc: str) -> bool:
        """Drop the tenant's pin on ``doc`` (journaled); the next
        compaction cadence reclaims what the pin was holding."""
        if (tenant_id, doc) not in self.pins:
            return False
        now = int(self.storm.service._clock())
        self._append_control({"op": "unpin", "tenant": tenant_id,
                              "doc": doc}, now)
        del self.pins[(tenant_id, doc)]
        self.stats["pins"] = len(self.pins)
        return True

    # -- time travel (the read path) -------------------------------------------

    def head_seq(self, doc: str) -> int:
        """The doc's newest addressable seq, cold-path only: the tick
        index frontier (in-RAM or cold-snapshot) or the summary head,
        whichever is newer."""
        storm = self.storm
        last = 0
        ticks = storm._doc_ticks.get(doc)
        if ticks is None and storm.residency is not None \
                and not storm.residency.is_resident(doc):
            ticks = storm.residency.cold_doc_ticks(doc)
        if ticks:
            last = max(ls for _fs, ls, _t in ticks)
        mega = storm.megadoc
        if mega is not None and mega.has_history(doc):
            # A promoted doc's doc-space frontier lives in the combiner
            # mirror (its ticks index under LANE ids, so the scan above
            # stops at the promotion seq). This is what lets fork() and
            # read_at() address a mega-promoted doc directly — the fold
            # below translates lane-era records through the combine
            # logs via records_overlapping (ROADMAP 5b).
            st = mega.docs.get(doc)
            if st is not None and st.mirror is not None:
                last = max(last, int(st.mirror.seq))
        rec = self._summary_record(doc)
        if rec is not None:
            last = max(last, int(rec["seq"]))
        meta = self.branches.get(doc)
        if meta is not None:
            last = max(last, int(meta["seq"]))
        return last

    def read_at(self, doc: str, seq: int) -> dict:
        """Materialize ``doc``'s converged map state at historical
        ``seq`` — entirely from summaries + durable records (no device
        row is touched, cold docs stay cold)."""
        t0 = time.perf_counter()
        seq = int(seq)
        head = self.head_seq(doc)
        if seq > head:
            raise HistoryError(
                f"seq {seq} is beyond the head ({head}) of {doc!r}")
        state = self._state_at(doc, seq)
        self._c_reads.inc()
        self.stats["reads"] += 1
        self._h_read.observe(time.perf_counter() - t0)
        return {"doc": doc, "seq": seq, "head_seq": head,
                "entries": state.entries()}

    def _state_at(self, doc: str, seq: int) -> _FoldState:
        meta = self.branches.get(doc)
        if meta is not None and seq < meta["seq"]:
            # History below the fork lives with the parent.
            return self._state_at(meta["parent"], seq)
        if seq < 0:
            raise HistoryError(f"negative seq {seq}")
        base = self._base_for(doc, seq)
        if base.seq == seq:
            return base
        floor = self.tail_floor(doc)
        if base.seq < floor and seq > base.seq:
            raise HistoryError(
                f"history of {doc!r} below seq {floor} is compacted "
                f"away (tail retention); only the summary chain's "
                f"exact states remain addressable there")
        state = base.copy()
        self._fold_records(doc, state, seq)
        state.seq = seq
        return state

    def _fold_records(self, doc: str, state: _FoldState,
                      to_seq: int) -> None:
        """Fold the doc's durable records in ``(state.seq, to_seq]``
        onto ``state`` — the scalar twin of the device LWW kernel."""
        storm = self.storm
        fold_storm_records(
            state, storm.records_overlapping(doc, state.seq, to_seq),
            to_seq, storm.read_tick_words)

    # -- summarization compaction ----------------------------------------------

    def maybe_compact(self, max_docs: int | None = None) -> list[str]:
        """Background summarizer pass (the storm flush maintenance
        hook): roll any resident doc whose tail is past the op/byte
        thresholds into a fresh summary, bounded docs per pass. No-op
        while thresholds are unset."""
        if self.summary_interval_ops is None \
                and self.summary_interval_bytes is None:
            return []
        self._checks += 1
        if self._checks % self.compact_check_every:
            return []
        if self._busy:
            return []
        budget = max_docs if max_docs is not None \
            else self.compact_docs_per_pass
        compacted: list[str] = []
        worst_tail = 0
        for doc, dt in list(self.storm._doc_ticks.items()):
            if not dt:
                continue
            tail = dt[-1][1] - self.summary_seq(doc)
            worst_tail = max(worst_tail, tail)
            due = (self.summary_interval_ops is not None
                   and tail >= self.summary_interval_ops) or (
                self.summary_interval_bytes is not None
                and tail * 4 >= self.summary_interval_bytes)
            if due and len(compacted) < budget:
                if self.compact(doc) is not None:
                    compacted.append(doc)
        self._g_tail.set(worst_tail)
        return compacted

    def compact(self, doc: str) -> str | None:
        """Roll ``doc``'s WAL tail into a fresh summary: fold records
        above the current summary, upload, flip the head atomically
        (crashpoint between — a kill keeps the previous head), then GC
        superseded chain summaries and trim the tail per the retention
        policy. Returns the new summary handle, or None when there is
        nothing to roll."""
        storm = self.storm
        if self._busy:
            return None
        if storm.wal_degraded:
            # Fsync breaker open: record reads barrier on the group
            # commit, and the trim rewrite needs a durability barrier —
            # neither is coming on a bounded schedule. Skip the cadence
            # pass; the plane compacts once the WAL heals (the
            # residency-eviction refusal pattern).
            return None
        if doc in storm.quarantined:
            return None  # frozen rows; readmit first
        mega = storm.megadoc
        if mega is not None and (mega.is_promoted(doc)
                                 or mega.parent_of(doc)):
            return None  # lane-era records translate on demotion
        self._busy = True
        try:
            rec = self._summary_record(doc)
            base_seq = int(rec["seq"]) if rec is not None else \
                int(self.branches.get(doc, {}).get("seq", 0))
            head_seq = self.head_seq(doc)
            if head_seq <= base_seq:
                return None
            state = self._state_at(doc, head_seq)
            old_handle = self.snapshots.head(self._hist_key(doc))
            chain = [list(e) for e in (rec or {}).get("chain", ())]
            if rec is not None and old_handle is not None:
                chain.append([int(rec["seq"]), old_handle])
            prev_floor = int((rec or {}).get("tail_floor", 0))
            floor = prev_floor
            if self.tail_retention_summaries is not None:
                # Interval boundaries oldest→newest; keep the newest K.
                bounds = [0] + [s for s, _h in chain] + [head_seq]
                cut = max(0, len(bounds) - 1
                          - self.tail_retention_summaries)
                floor = max(prev_floor, bounds[cut])
            # Retention pins: the floor never passes the last chain
            # boundary at-or-below the lowest pinned start, so every
            # pinned seq keeps a reachable fold base above the floor.
            # A pin created after a trim cannot resurrect records
            # (prev_floor wins) — pins protect from now on.
            pin_lo = self._pin_floor(doc)
            if pin_lo is not None and floor > prev_floor:
                bound = max([b for b in [0] + [s for s, _h in chain]
                             if b <= pin_lo], default=0)
                floor = max(prev_floor, min(floor, bound))
            # The chain keeps prior summaries ADDRESSABLE below the
            # floor (exact states; the per-op records between them are
            # what the trim drops). Only the optional chain cap ever
            # releases one — and never a state inside a pinned range.
            released: list = []
            if self.max_chain_summaries is not None \
                    and len(chain) > self.max_chain_summaries:
                cut_n = len(chain) - self.max_chain_summaries
                released, chain = chain[:cut_n], chain[cut_n:]
                if self.pins:
                    keep = [e for e in released
                            if self._pinned_at(doc, int(e[0]))]
                    if keep:
                        released = [e for e in released
                                    if e not in keep]
                        chain = keep + chain
            # Re-anchoring (ROADMAP 5c): past the depth cap, roll the
            # oldest inline entries into a content-addressed anchor
            # page (linked to its predecessor) so the head record
            # stays bounded; _base_for walks the pages for reads below
            # the inline chain.
            anchor = dict((rec or {}).get("anchor") or {}) or None
            if self.chain_reanchor_depth is not None \
                    and len(chain) > self.chain_reanchor_depth:
                keep_n = max(1, self.chain_reanchor_depth // 2)
                rolled, chain = chain[:-keep_n], chain[-keep_n:]
                page = {"kind": "history-anchor",
                        "format_version": HISTORY_SUMMARY_VERSION,
                        "doc": doc,
                        "entries": [list(e) for e in rolled],
                        "prev_anchor": (anchor or {}).get("handle")}
                page_handle = self.snapshots.upload(
                    self._hist_key(doc), page)
                anchor = {"handle": page_handle,
                          "top_seq": int(rolled[-1][0])}
                self.stats["reanchors"] += 1
            new_rec: dict[str, Any] = {
                "kind": "history-summary",
                "format_version": HISTORY_SUMMARY_VERSION,
                "doc": doc, "seq": head_seq, "state": state.to_wire(),
                "chain": chain, "tail_floor": floor,
            }
            if anchor is not None:
                new_rec["anchor"] = anchor
            if doc in self.branches:
                new_rec["branch"] = dict(self.branches[doc])
            key = self._hist_key(doc)
            handle = self.snapshots.upload(key, new_rec)
            # Chaos kill class "mid-compaction": summary uploaded, head
            # NOT yet flipped — the previous summary stays authoritative
            # and the orphan upload is a bounded leak, never a wrong
            # read.
            faults.crashpoint("history.mid_compaction")
            self.snapshots.set_head(key, handle)
            self._summary_cache[doc] = (handle, new_rec)
            # GC chain summaries beyond the cap through the store's
            # refcount release (shared chunks survive).
            release = getattr(self.snapshots, "release", None)
            if release is not None:
                for _s, h in released:
                    try:
                        release(key, h)
                    except Exception:
                        pass  # GC is best-effort
            if floor > prev_floor:
                self._trim_tail(doc, floor)
            self._c_compactions.inc()
            self.stats["compactions"] += 1
            return handle
        finally:
            self._busy = False

    def _trim_tail(self, doc: str, floor: int) -> None:
        """Drop the doc's tick-index entries at-or-below ``floor`` and
        queue the superseded WAL blobs for the filler rewrite. Cold
        docs are skipped (their index rides the cold snapshot — the
        next eviction after a hydrated compaction re-exports)."""
        storm = self.storm
        dt = storm._doc_ticks.get(doc)
        if dt is None:
            return
        removed = [t for _fs, ls, t in dt if ls <= floor]
        storm._doc_ticks[doc] = [e for e in dt if e[1] > floor]
        self._trim_candidates.update(removed)
        if len(self._trim_candidates) >= self.trim_batch_ticks:
            self.trim_now()

    def trim_now(self) -> int:
        """Flush the queued tail trim: rewrite every candidate WAL tick
        that (a) sits below the storm checkpoint watermark (recovery
        never replays it), and (b) is referenced by NO doc's live tick
        index and names only docs whose index is in RAM (a cold doc's
        snapshot-held index must keep its blobs) — to a tiny filler
        record. Indices stay 1:1 with WAL positions; only the bytes
        shrink."""
        storm = self.storm
        if not self._trim_candidates:
            return 0
        cutoff = storm._last_checkpoint_tick
        live: set[int] = set()
        for entries in storm._doc_ticks.values():
            live.update(t for _fs, _ls, t in entries)
        ticks: set[int] = set()
        for t in sorted(self._trim_candidates):
            if t >= cutoff or t in live:
                continue
            try:
                header, _off = storm._parse_header(storm._read_blob(t))
            except Exception:
                continue
            if any(entry[0] not in storm._doc_ticks
                   for entry in header.get("docs", ())):
                continue  # names a doc whose index we cannot see (cold)
            if header.get("mg") is not None \
                    or header.get("hp") is not None:
                continue  # lifecycle controls are never trimmed
            if self.pins and any(
                    self._pin_overlaps(entry[0], int(entry[6]),
                                       int(entry[7]))
                    for entry in header.get("docs", ())):
                continue  # a tenant retention pin covers this tick
            ticks.add(t)
        if not ticks:
            return 0
        from .durable_store import WalDegradedError
        try:
            trimmed = storm.trim_tick_blobs(ticks)
        except WalDegradedError:
            # Breaker opened under us: candidates stay queued; the next
            # healthy cadence pass retries. Never let a sick disk turn
            # maintenance into a serving-thread crash.
            return 0
        self._trim_candidates -= ticks
        self._c_trimmed.inc(trimmed)
        self.stats["trimmed_ticks"] += trimmed
        return trimmed

    # -- named branches --------------------------------------------------------

    def is_branch(self, doc: str) -> bool:
        return doc in self.branches

    def branch_info(self, doc: str) -> dict | None:
        meta = self.branches.get(doc)
        return dict(meta) if meta is not None else None

    def fork(self, doc: str, seq: int, name: str | None = None,
             writer: str | None = None) -> str:
        """Fork ``doc`` at historical ``seq`` into a new branch doc.
        The seed is journaled as a WAL CONTROL record BEFORE it is
        applied (replay re-derives the identical state), the branch's
        first history summary is the seeded state, and the serving seed
        is an ordinary cold-doc record (hydrated through the normal
        residency path) — or a direct live-row install when no
        residency tier is attached. ``writer`` pre-joins one client
        identity in the seed itself (rides the control record, so the
        branch serves deterministically across recoveries without a
        bus-ordered join); ordinary connects work either way. Returns
        the branch doc id."""
        storm = self.storm
        seq = int(seq)
        branch = name if name else f"{doc}@{seq}"
        if branch == doc or branch in self.branches:
            raise ValueError(f"branch id {branch!r} already exists")
        if branch in storm.seq_host._rows:
            raise ValueError(f"doc id {branch!r} is already served")
        residency = storm.residency
        if residency is not None and residency.cold_handle(branch):
            raise ValueError(f"doc id {branch!r} has cold history")
        storm.flush()  # settle: records must cover seq at the head
        head = self.head_seq(doc)
        if not 0 <= seq <= head:
            raise HistoryError(
                f"fork seq {seq} outside [0, {head}] for {doc!r}")
        state = self._state_at(doc, seq)  # raises below a trim floor
        now = int(storm.service._clock())
        event = {"op": "fork", "parent": doc, "seq": seq,
                 "branch": branch, "name": name or branch}
        if writer is not None:
            event["writer"] = writer
        self._append_control(event, now)
        # Durability barrier BEFORE any seed is written: the branch
        # summary and cold record go to the snapshot store durably, and
        # a lost (unfsynced) control would strand them — the cold head
        # would block any re-fork of the name forever. A fork is a
        # control-plane op; one commit latency is the _push_synth_acks
        # precedent. A degraded WAL fails the fork cleanly here, before
        # anything was seeded. (durability="none" keeps no fsync
        # promise anywhere — nothing to barrier on.)
        if storm._group_wal is not None:
            storm._group_wal.sync()
        elif storm._blob_log is not None and storm.durability == "sync":
            storm._blob_log.sync()
        # Chaos kill class "mid-fork": control DURABLE, branch NOT yet
        # seeded — recovery replays the control and re-derives the
        # identical seed from the records below it.
        faults.crashpoint("history.mid_fork")
        self._apply_fork(branch, doc, seq, name or branch, writer, state)
        self.stats["forks"] += 1
        return branch

    def _apply_fork(self, branch: str, parent: str, seq: int,
                    name: str, writer: str | None = None,
                    state: _FoldState | None = None) -> None:
        """Seed one branch (shared by the live path and WAL-control
        replay — both derive the same state, so both converge)."""
        storm = self.storm
        if state is None:
            # Replay path: the branch's own summary head (written by the
            # pre-crash life's apply) is the durable seed — prefer it
            # over re-deriving from the parent, whose tail a LATER
            # compaction may have trimmed past the fork seq by now.
            rec = self._summary_record(branch)
            if rec is not None and int(rec["seq"]) == int(seq):
                state = _FoldState.from_wire(rec["state"])
            else:
                state = self._state_at(parent, seq)
        meta = {"parent": parent, "seq": int(seq), "name": name}
        self.branches[branch] = meta
        self.children.setdefault(parent, []).append(branch)
        # The branch's first history summary IS the seed: reads at the
        # fork seq are exact, reads above fold the branch's own records.
        rec = {"kind": "history-summary",
               "format_version": HISTORY_SUMMARY_VERSION,
               "doc": branch, "seq": int(seq),
               "state": state.to_wire(), "chain": [], "tail_floor": 0,
               "branch": meta}
        key = self._hist_key(branch)
        handle = self.snapshots.upload(key, rec)
        self.snapshots.set_head(key, handle)
        self._summary_cache[branch] = (handle, rec)
        s_live = storm.merge_host._xstate.present.shape[1]
        present, value, vseq = state.planes(s_live)
        cp = self._fresh_checkpoint(seq, writer)
        residency = storm.residency
        if residency is not None:
            # Serving seed = an ordinary cold-doc record: the first
            # connect/frame hydrates it through the NORMAL recovery
            # path — the branch is a full residency citizen from birth.
            from .merge_host import _nd_pack
            from .residency import COLD_DOC_VERSION
            cold: dict[str, Any] = {
                "kind": "cold-doc",
                "format_version": COLD_DOC_VERSION,
                "doc": branch,
                "tick_watermark": storm._tick_counter,
                "sequencer": dataclasses.asdict(cp),
                "map_row": {
                    "present": _nd_pack(present),
                    "value": _nd_pack(value),
                    "vseq": _nd_pack(vseq),
                    "cleared_seq": int(state.cleared_seq),
                    "last_seq": int(seq),
                },
                "doc_ticks": [], "tick_count": 0,
            }
            if residency.host_label is not None:
                cold["home"] = residency.host_label
            ckey = residency._cold_key(branch)
            chandle = self.snapshots.upload(ckey, cold)
            self.snapshots.set_head(ckey, chandle)
            residency.adopt_cold(branch, chandle)
        else:
            # No residency tier: install straight into live rows (the
            # in-process serving shape). The row is allocated first (it
            # may grow the pool into new tensors), then written in place
            # into the grown planes.
            storm.seq_host.restore(branch, cp)
            mrow = storm._storm_mrow(branch)
            storm.merge_host.write_map_row(mrow.row, present, value, vseq,
                                           state.cleared_seq)
            mrow.last_seq = int(seq)
        self._g_branches.set(len(self.branches))

    @staticmethod
    def _fresh_checkpoint(seq: int, writer: str | None = None):
        from .sequencer import SequencerCheckpoint
        clients = []
        if writer is not None:
            # Deterministic seeded writer: joined at the fork point with
            # no ops seen (cseq 0) — clock-free (last_update 0) so the
            # seed is identical in every life.
            clients.append({"client_id": writer, "client_seq": 0,
                            "ref_seq": int(seq), "last_update": 0,
                            "can_evict": True, "can_summarize": True,
                            "nack": False})
        return SequencerCheckpoint(
            sequence_number=int(seq), minimum_sequence_number=int(seq),
            last_sent_msn=int(seq), no_active_clients=not clients,
            clients=clients)

    def merge_back(self, branch: str) -> dict:
        """Re-submit the branch's delta ops (records above its fork
        seq) into the PARENT through the ordinary sequencer — a fresh
        client's frames, so convergence is the normal total-order story
        and the merge is journaled/replayed like any other traffic."""
        meta = self.branches.get(branch)
        if meta is None:
            raise KeyError(f"{branch!r} is not a branch")
        storm = self.storm
        storm.flush()
        parent, fork_seq = meta["parent"], meta["seq"]
        floor = self.tail_floor(branch)
        if floor > fork_seq:
            # The branch's own tail compaction trimmed per-op records
            # the merge needs (a summary is a rollup — the individual
            # delta ops are gone). Failing loudly beats silently
            # merging a suffix (the read_at floor contract).
            raise HistoryError(
                f"cannot merge back {branch!r}: its records below seq "
                f"{floor} were compacted away (fork seq {fork_seq}) — "
                "exempt branches from tail trim before merging")
        records = sorted(storm.records_overlapping(branch, fork_seq),
                         key=lambda r: r["first_seq"])
        parts: list[bytes] = []
        blob_cache: dict[int, bytes] = {}
        for rec in records:
            n_seq = rec["n_seq"]
            if n_seq <= 0:
                continue
            tick = rec["tick"]
            blob = blob_cache.get(tick)
            if blob is None:
                blob = storm.read_tick_words(tick)
                blob_cache[tick] = blob
            words = np.frombuffer(blob, np.uint32, rec["count"],
                                  rec["w_off"])
            skip = rec["count"] - n_seq
            parts.append(words[skip:skip + n_seq].tobytes())
        payload = b"".join(parts)
        total = len(payload) // 4
        result = {"branch": branch, "parent": parent,
                  "fork_seq": fork_seq, "merged_ops": total}
        if total == 0:
            return result
        errors: list[dict] = []

        def sink(ack: dict) -> None:
            if isinstance(ack, dict) and ack.get("error"):
                errors.append(ack)

        conn = storm.service.connect(parent, lambda _m: None)
        try:
            storm.service.pump()
            ref = storm.seq_host.checkpoint(parent).sequence_number
            cseq0, off = 1, 0
            chunk = storm.MAX_COUNT
            while off < total:
                n = min(chunk, total - off)
                storm.submit_frame(
                    sink,
                    {"rid": ("merge", branch, cseq0),
                     "docs": [[parent, conn.client_id, cseq0, ref, n]]},
                    memoryview(payload)[off * 4:(off + n) * 4])
                storm.flush()
                cseq0 += n
                off += n
        finally:
            conn.close()
            storm.service.pump()
        if errors:
            raise RuntimeError(
                f"merge_back of {branch!r} shed: {errors[0]}")
        self._c_merges.inc()
        self.stats["merges"] += 1
        result["parent_seq"] = \
            storm.seq_host.checkpoint(parent).sequence_number
        return result

    # -- WAL control records ---------------------------------------------------

    def _append_control(self, event: dict, now: int) -> None:
        """Journal one history lifecycle event as a docs-less tick
        record (the ``"hp"`` header field — the mega-doc ``"mg"``
        pattern): tick ids stay 1:1 with WAL record indices and replay
        re-applies the event at the same point in the total order."""
        if self._in_replay_control:
            return
        storm = self.storm
        storm._harvest()  # every dispatched tick's record lands first
        from .storm import STORM_WAL_VERSION
        header = json.dumps(
            {"v": STORM_WAL_VERSION, "ts": now, "docs": [],
             "hp": event}, separators=(",", ":")).encode()
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
        """Replay one journaled history event (``_replay_wal``)."""
        self._in_replay_control = True
        try:
            op = event.get("op")
            if op == "fork":
                if event["branch"] not in self.branches:
                    self._apply_fork(event["branch"], event["parent"],
                                     event["seq"], event["name"],
                                     event.get("writer"))
            elif op == "pin":
                self.pins[(event["tenant"], event["doc"])] = (
                    int(event["lo"]), int(event["hi"]))
                self.stats["pins"] = len(self.pins)
            elif op == "unpin":
                self.pins.pop((event["tenant"], event["doc"]), None)
                self.stats["pins"] = len(self.pins)
            elif op in (None, "trimmed"):
                pass  # filler record of a trimmed tick — stateless
            else:
                raise ValueError(f"unknown history control {op!r}")
        finally:
            self._in_replay_control = False

    # -- snapshot state --------------------------------------------------------

    def export_state(self) -> dict:
        """Branch metadata + retention pins for the storm snapshot
        (summaries and seeds are store-resident already — only the
        registries ride here)."""
        return {"branches": {b: dict(m)
                             for b, m in sorted(self.branches.items())},
                "pins": [[t, d, lo, hi] for (t, d), (lo, hi)
                         in sorted(self.pins.items())]}

    def import_state(self, snap: dict) -> None:
        for branch, meta in snap.get("branches", {}).items():
            if branch not in self.branches:
                self.branches[branch] = dict(meta)
                self.children.setdefault(meta["parent"],
                                         []).append(branch)
        for t, d, lo, hi in snap.get("pins", ()):
            self.pins.setdefault((t, d), (int(lo), int(hi)))
        self.stats["pins"] = len(self.pins)
        self._g_branches.set(len(self.branches))


__all__ = ["HistoryPlane", "HistoryError", "HISTORY_SUMMARY_VERSION",
           "HIST_KEY_PREFIX", "load_summary_record", "summary_base_for",
           "fold_storm_records"]
