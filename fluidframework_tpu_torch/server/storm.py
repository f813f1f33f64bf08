"""Columnar op-storm fast path — the batched-cadence deployment of the
deli → scriptorium/broadcaster → merger pipeline in ONE device tick.

Port of the map-only half of ``fluidframework_tpu/server/storm.py``.
Reference parity: the reference reaches throughput by batching at every
hop — socket.io message arrays, Kafka produce batches, Mongo batch
inserts (scriptorium lambda.ts:95) — while each document's ticket loop
stays per-op JavaScript (deli/lambda.ts:236). Here the batching goes all
the way through the sequencer: a storm frame carries a whole op batch as
packed u32 words (4 bytes/op, protocol/codec.py storm framing). One
flush =

  1. deli      — the CLOSED-FORM storm ticket sequences every doc's
                 batch (ops/sequencer.py storm_tickets, plain tensor math),
  2. merger    — the CUDA map-fold kernel (ops/map_fold_cuda.py) applies
                 the sequenced ops using the ticket windows without a host
                 round trip,
  3. scriptorium — one columnar record per (doc, tick), kept in process
                 memory (per-op messages are materialized lazily on the
                 read path, see :func:`materialize_storm_records`),
  4. broadcaster — one compact frame per doc into the fan-out hop,
  5. alfred    — per-frame acks pushed back to the submitting session.

Delivery contract: at-least-once with kernel-side dedup — an un-acked
frame may be resent verbatim; ops whose client_seq the sequencer has
already seen come back OUT_IGNORED (deli/lambda.ts:257).

Scope of this port: the WAL-less mode (``durability="none"`` with no
``spill_dir``), pipeline depths 0 and 1, single- and
multi-tenant composition, and the per-doc quarantine freeze: a doc whose
device sentinel trips is frozen alone while its batch peers keep
serving. The disk WAL, snapshot checkpoint/recover, the quarantine's
read and readmit halves (they need the durable records and a snapshot
store) and the mega-doc, residency, history, replication and placement
planes are not ported: the controller raises ``NotImplementedError``
when asked for them.
"""

from __future__ import annotations

import base64
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..ops import map_fold_cuda as mfc
from ..ops import map_kernel as mk
from ..ops import opcodes as oc
from ..ops import sequencer as seqk
from ..protocol.codec import TRACE_KEY, trace_context
from ..protocol.messages import MessageType, SequencedDocumentMessage
from ..utils import faults
from .kernel_host import KernelSequencerHost, _next_pow2
from .merge_host import ChannelKey, KernelMergeHost

I32 = torch.int32


_libc = None


def _malloc_trim() -> None:
    """Release retained glibc arena pages back to the OS (no-op where
    unavailable)."""
    global _libc
    if _libc is None:
        import ctypes

        try:
            _libc = ctypes.CDLL("libc.so.6")
        except OSError:
            _libc = False
    if _libc:
        try:
            _libc.malloc_trim(0)
        except Exception:
            pass


class _TrimGate:
    """Rate limiter for the RSS-hygiene ``malloc_trim``: at most once per
    :meth:`due` poll and only when BOTH gates open: every ``every`` ticks
    AND at least ``floor_s`` of wall clock since the last trim."""

    def __init__(self, every: int = 32, floor_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.every = max(1, every)
        self.floor_s = floor_s
        self._clock = clock
        self._last_trim = clock()
        self._trimmed_at_tick = 0

    def due(self, ticks: int) -> bool:
        if ticks - self._trimmed_at_tick < self.every:
            return False
        now = self._clock()
        if now - self._last_trim < self.floor_s:
            return False
        self._last_trim = now
        self._trimmed_at_tick = ticks
        return True


class _Frame(NamedTuple):
    push: Callable[[dict], None] | None
    rid: Any
    docs: list[tuple[str, str, int, int, int]]  # (doc, client, cseq0, ref, n)
    words: np.ndarray   # u32[sum(counts)] VIEW aliasing the receive buffer
    counts: np.ndarray  # i32[n_docs] per-doc op counts
    meta: np.ndarray    # i32[n_docs, 3] (cseq0, ref, count) columns
    trace: Any = None   # (client tc, session scope) tracer key or None
    staged_ns: tuple = (0, 0)  # (decode, admit) ns refunded on shed
    mega: Any = None    # mega-doc descriptors (not ported: always None)
    tenant: str = "default"  # session-validated tenant (QoS composition)
    t0: int = 0         # ingress monotonic ns (per-tenant ack latency)


def _map_leg(map_state: mk.MapState, words, lo, hi, seq0_for):
    """Windowed map LWW fold: the merger leg of the tick. ``lo``/``hi``
    bound each row's sequenced op window within ``words``; ``seq0_for``
    is the row's doc seq before the first windowed op. CUDA tensors go
    through the map-fold kernel, CPU tensors through its plain version."""
    return mfc.fold_words(map_state, words, lo, hi, seq0_for)


# Device kernel-stats plane: one tiny i32[KSTATS_WIDTH] vector riding the
# tick's readback. Indices match the reference (the rebalance cells stay 0
# on the map-only tick).
KSTAT_SEQUENCED = 0
KSTAT_DUP_OPS = 1
KSTAT_SENTINEL_DOCS = 2
KSTAT_REBALANCE_FIRED = 3
KSTAT_BLOCKS_TOUCHED = 4
KSTATS_WIDTH = 5


def _storm_tick(seq_state: seqk.SequencerState, map_state: mk.MapState,
                slot, cseq0, ref, ts, seq_counts,
                map_gather, words, map_counts):
    """deli ticket + merger fold as one device program (no host sync).

    seq inputs are [B_seq] vectors; ``words`` i32[B_map, K] is the only
    [B, K] transfer. ``map_gather`` maps each map row to its document's
    sequencer row so the ticket seqs feed the map fold on the device.
    """
    seq_before = seq_state.seq
    seq_state, dups, n_seq_doc, msn_doc = seqk.storm_tickets(
        seq_state, slot, cseq0, ref, ts, seq_counts)

    g = map_gather.long()
    dups_for = dups[g]
    nseq_for = n_seq_doc[g]
    seq0_for = seq_before[g]
    lo = dups_for
    hi = torch.minimum(dups_for + nseq_for, map_counts)
    map_state = _map_leg(map_state, words, lo, hi, seq0_for)

    n_seq = nseq_for
    first = torch.where(n_seq > 0, seq0_for + 1, int(oc.INT32_MAX))
    last = torch.where(n_seq > 0, seq0_for + n_seq, 0)
    msn = torch.where(map_counts > 0, msn_doc[g], 0)
    # Per-doc poison sentinel (summary drift / invariant violation): a
    # healthy map row never carries a vseq above its doc's post-tick seq,
    # and present slots never hold negative vseq/value.
    seq_after = seq_state.seq[g]
    drift = torch.where(map_state.present, map_state.vseq,
                        -1).amax(dim=1) > seq_after
    corrupt = (map_state.present
               & ((map_state.vseq < 0) | (map_state.value < 0))).any(dim=1)
    bad = drift | corrupt
    # Rows with no batch this tick gather row 0's ticket values, so every
    # reduce masks on map_counts > 0.
    live = map_counts > 0
    zero = torch.zeros((), dtype=I32, device=words.device)
    kstats = torch.stack((
        torch.where(live, n_seq, 0).sum(dtype=I32),
        torch.where(live, torch.minimum(dups_for, map_counts),
                    0).sum(dtype=I32),
        (live & bad).sum(dtype=I32),
        zero, zero))
    return seq_state, map_state, n_seq, first, last, msn, bad, kstats


#: Format version stamped on every storm tick header ("v") — the
#: reference's current version, so tick blobs stay byte-identical.
STORM_WAL_VERSION = 3


class _Readback:
    """The tick's outputs on their way to the host. On a CUDA device the
    copies run non-blocking into pinned buffers owned by the tick's
    staging generation and an event marks their completion; on the CPU
    the outputs are already host tensors."""

    def __init__(self, outs: tuple, host: list | None) -> None:
        self.event = None
        if host is None:
            self.arrays = [t.numpy() for t in outs]
            return
        for dst, src in zip(host, outs):
            dst.copy_(src, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()
        self.arrays = [t.numpy() for t in host]

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return self.arrays


class StormController:
    """Buffers storm frames and runs the device tick over the REAL hosts:
    the service's batched deli (KernelSequencerHost) and merge host
    (KernelMergeHost map rows) — the storm path and the per-op path share
    one sequencer state and one map state per document.

    Overload behavior: the inbound frame queue is bounded
    (``max_pending_docs``) and an optional admission controller gates the
    tick ingress; refused frames get a busy-nack carrying
    ``retry_after_s`` instead of queueing without bound."""

    #: Per-op count sanity bound (one doc's batch within one frame).
    MAX_COUNT = 1 << 16

    def __init__(self, service, seq_host: KernelSequencerHost,
                 merge_host: KernelMergeHost, datastore: str = "default",
                 channel: str = "root",
                 flush_threshold_docs: int = 4096,
                 max_key_slots: int = 64,
                 pipeline_depth: int = 1,
                 spill_dir: str | None = None,
                 durability: str | None = None,
                 snapshots=None,
                 snapshot_interval_ticks: int | None = None,
                 admission=None,
                 max_pending_docs: int | None = None,
                 busy_retry_s: float = 0.05,
                 doc_index_retention_ticks: int | None = None,
                 wal_commit_latency_s: float = 0.0,
                 tenant_weights: dict[str, float] | None = None,
                 tenant_weight_source=None,
                 tick_slot_budget: int | None = None,
                 qos_borrow_fraction: float = 0.5,
                 logger=None) -> None:
        if durability not in ("group", "sync", "none", None):
            raise ValueError(f"unknown durability mode {durability!r}")
        if spill_dir is not None or durability in ("group", "sync") \
                or wal_commit_latency_s:
            raise NotImplementedError(
                "the storm WAL (spill_dir / durability='group'|'sync') is "
                "not ported yet; serve with durability='none' and no "
                "spill_dir")
        if snapshots is not None or snapshot_interval_ticks is not None:
            raise NotImplementedError(
                "storm checkpoint/recover (snapshots=) is not ported yet")
        if pipeline_depth not in (0, 1):
            raise NotImplementedError(
                f"pipeline_depth {pipeline_depth!r} is not ported yet "
                "(0 and 1 are)")
        self.service = service
        self.seq_host = seq_host
        self.merge_host = merge_host
        if seq_host.device != merge_host.device:
            raise ValueError(
                f"sequencer host on {seq_host.device} but merge host on "
                f"{merge_host.device}: one tick runs on one device")
        self.device = seq_host.device
        self.datastore = datastore
        self.channel = channel
        self.flush_threshold_docs = flush_threshold_docs
        # Storm words address key slots directly; the map state must be
        # wide enough BEFORE any tick.
        self.max_key_slots = min(1024, max_key_slots)  # 10-bit slot field
        if merge_host._map_slots < self.max_key_slots:
            merge_host._grow_map_slots(self.max_key_slots)
        self._frames: list[_Frame] = []
        self._pending_docs = 0
        # Bounded cohort LRU: (membership_gen, ((doc, client), ...)) ->
        # resolved (seq_rows, slots, map_rows) arrays.
        from ..utils import CountedLRU
        self._cohort_cache = CountedLRU(
            8, registry=merge_host.metrics, prefix="storm.cohort_cache")
        self._tick_counter = 0  # tick blob index
        # Tick words blobs (the scriptorium payload), in process memory.
        self._tick_blobs: dict[int, bytes] = {}
        # doc -> [(first_seq, last_seq, tick_id)] for ticks that
        # sequenced ops — the compact in-RAM index over the tick blobs.
        self._doc_ticks: dict[str, list[tuple[int, int, int]]] = {}
        self.durability = "none"
        self.snapshots = None
        self._trim_gate = _TrimGate()
        self.admission = admission
        self.max_pending_docs = max_pending_docs
        self.busy_retry_s = busy_retry_s
        if admission is not None and max_pending_docs is not None:
            admission.add_pressure_probe(
                lambda: self._pending_docs / max(1, self.max_pending_docs))
        # Multi-tenant QoS plane (server/qos.py): deficit-weighted fair
        # tick composition over per-tenant pending queues. A single-tenant
        # compose with no slot budget reduces to the first-come scan.
        from .qos import TenantScheduler
        self.qos = TenantScheduler(weights=tenant_weights,
                                   weight_source=tenant_weight_source,
                                   registry=merge_host.metrics)
        self.tick_slot_budget = tick_slot_budget
        self.qos_borrow_fraction = qos_borrow_fraction
        #: Frozen docs: doc -> {"reason", "tick"} (see _quarantine_doc).
        self.quarantined: dict[str, dict] = {}
        # Planes of the reference controller that are not ported; kept as
        # None so code that probes them (routerlicious) sees them absent.
        self.residency = None
        self.megadoc = None
        self.history = None
        self.placement = None
        self.replication = None
        self._in_round = False
        # Opt-in retention for the per-doc (first, last, tick) index.
        self.doc_index_retention_ticks = doc_index_retention_ticks
        #: Ticks each doc participated in.
        self.doc_tick_counts: dict[str, int] = {}
        self.stats = {"ticks": 0, "sequenced_ops": 0, "submitted_ops": 0,
                      "nacked_or_ignored_ops": 0,
                      "shed_frames": 0, "shed_ops": 0,
                      "quarantined_docs": 0, "readmitted_docs": 0,
                      "degraded_rejects": 0, "quorum_rejects": 0}
        self.tick_seconds: list[float] = []  # submit→harvest per round
        self.harvest_intervals: list[float] = []  # completion cadence
        # Observability: one fixed-shape stage record per tick into a ring
        # buffer + per-stage Histograms, and a per-op trace joiner for
        # frames that carry a sampled trace id ("tc" header field).
        from ..utils import NullLogger, StageLedger, TraceSpans
        self.logger = logger if logger is not None else NullLogger()
        self.ledger = StageLedger(registry=merge_host.metrics,
                                  prefix="storm.stage")
        self.tracer = TraceSpans(logger=self.logger)
        self._trace_seq = 0
        self.max_traces_per_tick = 64
        self._traced_pending = 0
        self._staged_ns = {"ingress_decode": 0, "admission": 0}
        # Depth-N pipeline: up to N ticks stay in flight; each round
        # HARVESTS the due tick BEFORE staging the next one. Depth 0 is
        # the serial shape (dispatch → readback → ack per round).
        self.pipeline_depth = pipeline_depth
        self._inflight: list[dict] = []
        self._last_harvest: float | None = None
        self._last_harvest_done_ns: int | None = None
        # Host staging generations: ``pipeline_depth + 1`` rotate, so the
        # buffers a still-in-flight tick's copies read or write are never
        # the ones the next round scatters into (see _staging_gen).
        self._staging: list[dict | None] = [None] * (self.pipeline_depth
                                                     + 1)
        self._staging_idx = 0
        merge_host.metrics.gauge("storm.pipeline.depth").set(
            self.pipeline_depth)
        service.storm = self

    # -- front-door entry ------------------------------------------------------

    def submit_frame(self, push: Callable[[dict], None] | None,
                     header: dict, payload: memoryview,
                     tenant_id: str = "default",
                     client_id: str | None = None,
                     ingress_ns: int | None = None) -> None:
        """One decoded storm frame from a session; ack is pushed after the
        tick that sequences it. Malformed frames raise ValueError BEFORE
        anything is buffered — a bad frame must fail alone.

        ``tenant_id``/``client_id`` are the admission identities and must
        come from the SESSION, never from the frame header."""
        if ingress_ns is None:
            ingress_ns = time.monotonic_ns()
        entries = header.get("docs")
        if not isinstance(entries, list) or not entries:
            raise ValueError("storm frame without docs")
        docs: list[tuple[str, str, int, int, int]] = []
        seen: set[str] = set()
        for entry in entries:
            if not (isinstance(entry, (list, tuple)) and len(entry) == 5):
                raise ValueError(f"bad storm doc entry: {entry!r}")
            doc_id, doc_client, cseq0, ref_seq, count = entry
            count = int(count)
            if not 0 < count <= self.MAX_COUNT:
                raise ValueError(f"bad storm count {count} for {doc_id!r}")
            if doc_id in seen:
                # One sequencer row per doc per tick.
                raise ValueError(f"doc {doc_id!r} repeats within one frame")
            seen.add(doc_id)
            docs.append((str(doc_id), str(doc_client), int(cseq0),
                         int(ref_seq), count))
        # Columnar from here down: ONE payload view + per-doc count/meta
        # arrays (the words view aliases the receive buffer all the way
        # into the tick scatter).
        meta = np.array([entry[2:] for entry in docs], np.int32)
        counts = meta[:, 2]
        offset = int(counts.sum())
        if offset * 4 > len(payload):
            raise ValueError("storm payload shorter than doc counts")
        words = np.frombuffer(payload, np.uint32, offset)
        max_slot = int((words & np.uint32(0xFFC)).max()) >> 2 \
            if offset else 0
        if max_slot >= self.max_key_slots:
            raise ValueError(
                f"storm key slot {max_slot} >= max_key_slots "
                f"{self.max_key_slots}")
        tc = trace_context(header)
        if not isinstance(tc, (int, str)):
            tc = None  # client-opaque JSON; unhashable shapes are ignored
        trace = None
        t_validated = time.monotonic_ns()
        retry = self._admit(push, header, docs, offset, tenant_id, client_id)
        t_admitted = time.monotonic_ns()
        if retry is not None:
            return  # shed: its decode/admit ns never reaches a tick
        staged = (t_validated - ingress_ns, t_admitted - t_validated)
        self._staged_ns["ingress_decode"] += staged[0]
        self._staged_ns["admission"] += staged[1]
        if tc is not None \
                and self._traced_pending < self.max_traces_per_tick:
            trace = (tc, self._trace_seq)
            self._trace_seq += 1
            self._traced_pending += 1
            self.tracer.mark(trace, "ingress", ingress_ns)
            self.tracer.mark(trace, "admit", t_admitted)
        self._frames.append(_Frame(push, header.get("rid"), docs, words,
                                   counts, meta, trace, staged, None,
                                   tenant_id, ingress_ns))
        self._pending_docs += len(docs)
        self.stats["submitted_ops"] += offset
        self.qos.note_submitted(tenant_id, offset)
        self.qos.note_buffered(tenant_id, len(docs))
        if tenant_id != "default":
            self.qos.note_doc_tenants(tenant_id, (d for d, *_ in docs))
        if self._pending_docs >= self.flush_threshold_docs:
            # Threshold-triggered: only run FULL rounds.
            self.flush(force=False)

    def _admit(self, push, header: dict, docs: list, n_ops: int,
               tenant_id: str, client_id: str | None) -> float | None:
        """Shed checks for one validated frame, in deterministic order:
        quarantine, bounded queue, token buckets. A refusal pushes ONE
        busy-nack with ``retry_after_s`` and returns the hint; None
        admits."""
        qdocs = [d for d, *_ in docs if d in self.quarantined]
        if qdocs:
            # The WHOLE frame is refused (acks are positional per frame,
            # so it cannot be split): "docs" lists everything dropped,
            # "quarantined" the offending subset — the client resubmits
            # the healthy docs in their own frame immediately.
            return self._shed(push, header, n_ops, "quarantined",
                              self.busy_retry_s,
                              docs=[d for d, *_ in docs],
                              quarantined=qdocs)
        if self.max_pending_docs is not None:
            n = len(docs)
            cap = self.qos.pending_cap(tenant_id, self.max_pending_docs)
            # Shed when the GLOBAL bound is hit, or — weighted shed — when
            # THIS tenant is past its weighted pending share while the
            # global queue is past the borrow threshold.
            over_global = self._pending_docs + n > self.max_pending_docs
            over_share = (
                cap is not None
                and self.qos.pending_docs.get(tenant_id, 0) + n > cap
                and self._pending_docs + n > self.max_pending_docs
                * self.qos_borrow_fraction)
            if over_global or over_share:
                self.qos.note_shed(tenant_id, n_ops)
                return self._shed(
                    push, header, n_ops, "busy",
                    self.qos.shed_hint(tenant_id, self.busy_retry_s,
                                       self.max_pending_docs),
                    tenant=tenant_id)
        if self.admission is not None:
            retry = self.admission.admit_write(tenant_id, client_id,
                                               weight=n_ops)
            if retry is not None:
                return self._shed(push, header, n_ops, "throttled", retry)
        return None

    def _shed(self, push, header: dict, n_ops: int, code: str,
              retry_after_s: float, docs: list | None = None,
              quarantined: list | None = None,
              retryable: bool = True,
              tenant: str | None = None) -> float:
        self.stats["shed_frames"] += 1
        self.stats["shed_ops"] += n_ops
        self.merge_host.metrics.counter("storm.shed_ops").inc(n_ops)
        if tenant is not None:
            self.merge_host.metrics.counter(
                f"storm.tenant.{tenant}.shed_frames").inc()
        if push is not None:
            nack = {"rid": header.get("rid"), "storm": True,
                    "error": code, "retryable": retryable,
                    "retry_after_s": retry_after_s}
            if docs:
                nack["docs"] = docs  # EVERY doc whose ops were dropped
            if quarantined:
                nack["quarantined"] = quarantined
            push(nack)
        return retry_after_s

    # -- the tick --------------------------------------------------------------

    def flush(self, force: bool = True) -> None:
        while self._frames and (
                force or self._pending_docs >= self.flush_threshold_docs):
            if not self._flush_round(require_full=not force):
                break
        if force:
            self._harvest()
        # RSS hygiene OFF the per-tick path (see _TrimGate).
        if self._trim_gate.due(self.stats["ticks"]):
            _malloc_trim()

    @property
    def durable_watermark(self) -> int | None:
        """None: serving without a WAL."""
        return None

    @property
    def acked_watermark(self) -> int | None:
        """The watermark client acks carry (None without a WAL)."""
        return None

    def _push_synth_acks(self, acks: list, mega_plans: dict) -> None:
        """Deliver acks for a cohort that resolved to zero descs: nothing
        sequenced, so each frame's ack carries the rows its plan
        synthesized (none without the mega-doc plane)."""
        from ..protocol.codec import StormAck
        dw = self.acked_watermark
        for ack_i, (frame, _i0, _i1) in enumerate(acks):
            if frame.push is None:
                continue
            plan = mega_plans.get(ack_i) or []
            rows = np.asarray([v for kind, v in plan if kind == "s"],
                              np.int32).reshape(-1, 4)
            payload = StormAck(frame.rid, rows)
            payload["dw"] = dw
            if frame.trace is not None:
                self._stamp_trace_ack(frame, payload)
            frame.push(payload)

    def _stamp_trace_ack(self, frame: _Frame, payload: dict) -> None:
        """Finish a sampled frame's span at ack transmit: the joined hop
        marks ride the ack header ("tc" + "hops"), the hop deltas feed
        ``storm.hop.*`` histograms."""
        self.tracer.mark(frame.trace, "ack_tx")
        span = self.tracer.finish(frame.trace)
        if span is None:
            return
        payload[TRACE_KEY] = frame.trace[0]  # the client's raw id
        payload["hops"] = span["hops"]
        metrics = self.merge_host.metrics
        for name, ms in span["deltas_ms"].items():
            metrics.histogram(f"storm.hop.{name}").observe(ms / 1000.0)

    def _flush_round(self, require_full: bool = False) -> bool:
        """One device tick over every buffered frame, deferring repeat
        frames for the same document to the next round (one descriptor
        per doc row per tick). With ``require_full``, a round whose
        DISJOINT doc set falls short of the tick threshold declines
        (returns False)."""
        round_start = time.perf_counter()
        queue_depth = self._pending_docs
        frames, self._frames, self._pending_docs = self._frames, [], 0
        # Bus-path ops already admitted must sequence first (per-doc total
        # order is shared between the storm and per-op paths).
        self._in_round = True
        try:
            self.service.pump()
            self.seq_host._flush_pending()
        finally:
            self._in_round = False

        # Tick composition is the QoS seam (server/qos.py): one frame per
        # doc per tick (per-doc FIFO — a colliding frame stays buffered).
        qplan = self.qos.compose(frames, self.tick_slot_budget)
        selected: list[_Frame] = qplan["selected"]
        kept: list[_Frame] = qplan["kept"]
        full_bar = self.flush_threshold_docs \
            if self.tick_slot_budget is None \
            else min(self.flush_threshold_docs, self.tick_slot_budget)
        if require_full and sum(len(f.docs) for f in selected) \
                < full_bar:
            # Undersized cohort: put everything back (the plan was NOT
            # committed, so re-buffering is side-effect free).
            self._frames = frames + self._frames
            self._pending_docs += sum(len(f.docs) for f in frames)
            return False
        self.qos.commit(qplan)
        faults.crashpoint("storm.qos_mid_compose")
        self._frames.extend(f._replace(staged_ns=(0, 0))
                            for f in kept)
        self._pending_docs += sum(len(f.docs) for f in kept)
        self.qos.reset_pending(self._frames)
        # HARVEST-FIRST: settle the due tick BEFORE staging this one; this
        # also frees the harvested tick's staging generation for reuse.
        while len(self._inflight) >= max(1, self.pipeline_depth):
            self._harvest_one(self._inflight.pop(0))
        now = self.service._clock()
        descs: list[tuple[str, str, int, int, int]] = []
        frame_words: list[np.ndarray] = []   # one payload view per frame
        frame_counts: list[np.ndarray] = []
        metas: list[np.ndarray] = []
        acks: list[tuple[_Frame, int, int]] = []  # frame -> desc [i0, i1)
        for frame in selected:
            i0 = len(descs)
            descs.extend(frame.docs)
            frame_words.append(frame.words)
            frame_counts.append(frame.counts)
            metas.append(frame.meta)
            acks.append((frame, i0, len(descs)))
        if not descs:
            self._push_synth_acks(acks, {})
            return True
        stage_ns = dict(self._staged_ns)
        self._staged_ns = {"ingress_decode": 0, "admission": 0}
        self._traced_pending = 0  # next round gets a fresh cap
        t_scatter0 = time.monotonic_ns()

        seq_host, merge_host = self.seq_host, self.merge_host
        desc_arr = metas[0] if len(metas) == 1 else np.concatenate(metas)
        counts_col = desc_arr[:, 2]
        k = _next_pow2(int(counts_col.max()))

        # Rows + slots (the only per-doc Python work on the hot path),
        # cached keyed on the exact (doc, client) sequence and the
        # sequencer's membership generation.
        cohort_key = (seq_host.membership_gen,
                      tuple((d, c) for d, c, *_ in descs))
        cached = self._cohort_cache.get(cohort_key)
        if cached is not None:
            seq_rows, slots, map_rows, mrows = cached
        else:
            seq_rows = np.empty(len(descs), np.int32)
            slots = np.empty(len(descs), np.int32)
            map_rows = np.empty(len(descs), np.int32)
            mrows = []
            for i, (doc, client, _cseq0, _ref, _count) in enumerate(descs):
                row = seq_host._row(doc)
                seq_rows[i] = row
                slots[i] = seq_host._slots[row].get(client,
                                                    seq_host._ghost)
                mrow = self._storm_mrow(doc)
                map_rows[i] = mrow.row
                mrows.append(mrow)
            self._cohort_cache.put(cohort_key,
                                   (seq_rows, slots, map_rows, mrows))

        b_seq = seq_host._capacity
        b_map = merge_host._map_capacity
        # Staging generations: this round scatters into the IDLE
        # generation. Its pinned buffers feed non-blocking copies, so a
        # generation may not be rewritten while a copy from it (or into
        # its readback buffers) is in flight — the harvest-first loop
        # above guarantees the generation coming up for reuse belongs to
        # a harvested tick. The [B, K] words plane is not re-zeroed: every
        # window the tick consumes lies inside the [0, count) prefix
        # freshly scattered for its row this round.
        gen = self._staging_gen(b_seq, b_map, k)
        host = gen["np"]
        host["ts"].fill(now)
        host["slot"][seq_rows] = slots
        host["cseq0"][seq_rows] = desc_arr[:, 0]
        host["ref"][seq_rows] = desc_arr[:, 1]
        host["seq_counts"][seq_rows] = desc_arr[:, 2]
        host["map_counts"][map_rows] = desc_arr[:, 2]
        host["gather"][map_rows] = seq_rows
        words_full = host["words"]
        if counts_col.min() == counts_col.max() == k:
            # Uniform storm: one fancy-index scatter PER FRAME, straight
            # from each frame's receive buffer.
            pos = 0
            for fw, fc in zip(frame_words, frame_counts):
                n = len(fc)
                words_full[map_rows[pos:pos + n]] = fw.reshape(n, k)
                pos += n
        else:
            pos = 0
            for fw, fc in zip(frame_words, frame_counts):
                off = 0
                for n in fc.tolist():
                    words_full[map_rows[pos], :n] = fw[off:off + n]
                    off += n
                    pos += 1

        seq_host._host_state = None  # device state is about to move
        t_dispatch0 = time.monotonic_ns()
        dev = self.device
        fed = {name: t.to(dev, non_blocking=True)
               for name, t in gen["t"].items()}
        (seq_host._state, merge_host._xstate, n_seq, first, last,
         msn, bad, kstats) = _storm_tick(
            seq_host._state, merge_host._xstate,
            fed["slot"], fed["cseq0"], fed["ref"], fed["ts"],
            fed["seq_counts"], fed["gather"], fed["words"],
            fed["map_counts"])
        # Chaos kill class "mid-tick": device state mutated, record not
        # yet built.
        faults.crashpoint("storm.mid_tick")
        readback = _Readback((n_seq, first, last, msn, bad, kstats),
                             gen["out"])
        rec = dict(
            descs=descs, frame_words=frame_words, counts=counts_col,
            map_rows=map_rows, mrows=mrows,
            acks=acks, now=now, submitted=int(counts_col.sum()),
            out=readback, start=round_start,
            start_ns=t_scatter0, depth=self.pipeline_depth,
            stage_ns=stage_ns, queue_depth=queue_depth,
            # Scheduler state AS OF this tick's composition (the tick
            # header journals the state the tick was composed against).
            qos_state=(None if self.qos.is_trivial()
                       else self.qos.export_state()),
            qos_slices=qplan["slices"] or None)
        t_dispatched = time.monotonic_ns()
        stage_ns["scatter"] = t_dispatch0 - t_scatter0
        stage_ns["device_dispatch"] = t_dispatched - t_dispatch0
        for frame, _i0, _i1 in acks:
            if frame.trace is not None:
                self.tracer.mark(frame.trace, "dispatch", t_dispatched)
        self._inflight.append(rec)
        if self.pipeline_depth == 0:
            # Serial: settle this tick NOW — readback and acks — before
            # anything else may stage.
            self._harvest_one(self._inflight.pop(0))
        return True

    def _staging_gen(self, b_seq: int, b_map: int, k: int) -> dict:
        """The next idle host staging generation. ``pipeline_depth + 1``
        generations rotate round-robin, so the buffers this round writes
        are NEVER ones a still-in-flight tick's copies read or write. A
        geometry change reallocates just the generation it lands on."""
        n = self.pipeline_depth + 1
        self._staging_idx = (self._staging_idx + 1) % n
        gen = self._staging[self._staging_idx]
        if gen is None or gen["shape"] != (b_seq, b_map, k):
            pin = self.device.type == "cuda"

            def buf(shape, dtype=I32):
                return torch.zeros(shape, dtype=dtype, pin_memory=pin)

            t = {name: buf(b_seq) for name in
                 ("slot", "cseq0", "ref", "ts", "seq_counts")}
            t.update(words=buf((b_map, k)), map_counts=buf(b_map),
                     gather=buf(b_map))
            views = {name: a.numpy() for name, a in t.items()}
            views["words"] = views["words"].view(np.uint32)
            out = None
            if pin:
                out = [buf(b_map) for _ in range(4)] \
                    + [buf(b_map, torch.bool), buf(KSTATS_WIDTH)]
            gen = {"shape": (b_seq, b_map, k), "t": t, "np": views,
                   "out": out}
            self._staging[self._staging_idx] = gen
        else:
            # Re-zero the per-doc vectors only — the words plane's stale
            # content is unreachable (see _flush_round).
            for f in ("slot", "cseq0", "ref", "seq_counts", "map_counts",
                      "gather"):
                gen["np"][f].fill(0)
        return gen

    def idle_drain(self) -> bool:
        """Bounded, NON-blocking idle-path service: run buffered
        partial-cohort tails, and harvest an in-flight tick whose device
        results have already landed. Returns True when anything
        progressed."""
        if self._frames:
            # A partial tail below the tick threshold: the senders are
            # BLOCKED on these acks — settle fully.
            self.flush()
            return True
        if self._inflight and self._inflight[0]["out"].ready():
            self._harvest_one(self._inflight.pop(0))
            return True
        return False

    def _harvest(self) -> None:
        while self._inflight:
            self._harvest_one(self._inflight.pop(0))

    def _harvest_one(self, rec: dict) -> None:
        t_read0 = time.monotonic_ns()
        n_seq, first, last, msn, bad, kstats = rec["out"].wait()
        kstats = kstats.tolist()
        t_readback = time.monotonic_ns()
        stage_ns = rec.get("stage_ns", {})
        stage_ns["readback"] = t_readback - t_read0
        map_rows = rec["map_rows"]
        # ONE batched gather+pack builds the tick's per-doc ack matrix
        # (n_seq, first, last, msn); the tick-header lists and every
        # frame's ack derive from it.
        ack_rows = np.stack(
            (n_seq[map_rows], first[map_rows], last[map_rows],
             msn[map_rows]), axis=1).astype(np.int32, copy=False)
        ns_l = ack_rows[:, 0].tolist()
        fs_l = ack_rows[:, 1].tolist()
        ls_l = ack_rows[:, 2].tolist()
        m_l = ack_rows[:, 3].tolist()
        bad_rows = bad[map_rows]
        any_bad = bool(bad_rows.any())
        bad_l = bad_rows.tolist()
        for frame, _i0, _i1 in rec["acks"]:
            if frame.trace is not None:
                self.tracer.mark(frame.trace, "sequenced", t_readback)
        fanout = self.service.fanout
        now = rec["now"]
        mrows = rec["mrows"]
        # scriptorium tick record: ONE blob per tick — a json header of
        # every document's columnar record followed by the raw words.
        tick_id = self._tick_counter
        self._tick_counter += 1
        counts_col = rec["counts"]
        word_parts: list = rec["frame_words"]
        total_seq = int(sum(ns_l))
        w_offs = np.zeros(len(counts_col), np.int64)
        w_offs[1:] = np.cumsum(counts_col[:-1].astype(np.int64) * 4)
        offsets = w_offs.tolist()
        header_docs = []
        doc_tick_counts = self.doc_tick_counts
        pubs: list = [] if fanout is not None else None
        for i, (doc, client, cseq0, ref, count) in enumerate(rec["descs"]):
            ns, fs, ls, m = ns_l[i], fs_l[i], ls_l[i], m_l[i]
            mrow = mrows[i]
            if ls > mrow.last_seq:
                mrow.last_seq = ls
            header_docs.append([doc, client, cseq0, ref, count,
                                ns, fs, ls, m, offsets[i]])
            if ns > 0:
                dt = self._doc_ticks.setdefault(doc, [])
                dt.append((fs, ls, tick_id))
                retention = self.doc_index_retention_ticks
                if retention is not None and dt[0][2] < (
                        tick_id - retention):
                    # Opt-in index retention: ticks are appended in
                    # order, so the trim is a prefix cut.
                    horizon = tick_id - retention
                    keep = 0
                    while keep < len(dt) and dt[keep][2] < horizon:
                        keep += 1
                    del dt[:keep]
            # Telemetry for the quarantine blast-radius invariant:
            # batch peers of a quarantined doc lose zero ticks.
            doc_tick_counts[doc] = doc_tick_counts.get(doc, 0) + 1
            if any_bad and bad_l[i] and doc not in self.quarantined:
                self._quarantine_doc(doc, "sentinel", tick_id)
            # broadcaster: compact tick frame into the pub/sub hop.
            if pubs is not None:
                pubs.append((doc, b"\x00storm%d:%d:%d" % (fs, ls, m)))
        t_assembled = time.monotonic_ns()
        stage_ns["ack_pack"] = t_assembled - t_readback
        if pubs:
            batch_pub = getattr(fanout, "publish_batch", None)
            if batch_pub is not None:
                batch_pub(pubs)
            else:  # duck-typed fanout without the batch surface
                for room, body in pubs:
                    fanout.publish(room, body)
        t_fanout = time.monotonic_ns()
        stage_ns["fanout_publish"] = t_fanout - t_assembled
        import json as _json
        import struct as _struct

        hdr: dict = {"v": STORM_WAL_VERSION, "ts": now,
                     "docs": header_docs}
        if rec.get("qos_state") is not None:
            # Multi-tenant scheduler state as of this tick's composition.
            hdr["qos"] = rec["qos_state"]
        header = _json.dumps(hdr, separators=(",", ":")).encode()
        prefix = _struct.pack("<I", len(header)) + header
        self._tick_blobs[tick_id] = prefix + b"".join(
            bytes(memoryview(p)) for p in word_parts)
        t_wal = time.monotonic_ns()
        stage_ns["wal_append"] = t_wal - t_fanout
        # Stats BEFORE acks: once an ack leaves the process, this host's
        # bookkeeping must already reflect the tick.
        self.stats["ticks"] += 1
        self.stats["sequenced_ops"] += total_seq
        self.stats["nacked_or_ignored_ops"] += rec["submitted"] - total_seq
        self.merge_host.stats["device_ops"] += total_seq
        self.merge_host.metrics.counter("storm.sequenced_ops").inc(total_seq)
        # Device-true counters from the kstats plane.
        kmetrics = self.merge_host.metrics
        kmetrics.counter("storm.device.sequenced_ops").inc(kstats[0])
        kmetrics.counter("storm.device.dup_ops").inc(kstats[1])
        kmetrics.counter("storm.device.sentinel_docs").inc(kstats[2])
        kmetrics.counter("storm.device.rebalance_fired").inc(
            kstats[KSTAT_REBALANCE_FIRED])
        kmetrics.counter("storm.device.blocks_touched").inc(
            kstats[KSTAT_BLOCKS_TOUCHED])
        if rec.get("qos_slices"):
            seq_by_t: dict[str, int] = {}
            for frame, i0, i1 in rec["acks"]:
                seq_by_t[frame.tenant] = seq_by_t.get(frame.tenant, 0) \
                    + int(sum(ns_l[i0:i1]))
            self.qos.note_tick(tick_id, rec["qos_slices"], seq_by_t)
        done = time.perf_counter()
        self.tick_seconds.append(done - rec["start"])
        if self._last_harvest is not None:
            self.harvest_intervals.append(done - self._last_harvest)
        self._last_harvest = done
        # Each frame's ack is a contiguous row slice of the tick's ack
        # matrix — a StormAck that session push paths binary-encode.
        from ..protocol.codec import StormAck
        t_ack0 = time.monotonic_ns()
        acks = []
        for frame, i0, i1 in rec["acks"]:
            if frame.push is None:
                continue
            payload = StormAck(frame.rid, ack_rows[i0:i1])
            if any_bad and bad_rows[i0:i1].any():
                # The tick's sequencing is correct (the ticket is exact;
                # the poison is in the served planes) — the ack stands,
                # but the client learns its doc is frozen: further
                # submits nack until readmission.
                payload["quarantined"] = [
                    rec["descs"][i][0] for i in range(i0, i1) if bad_l[i]]
                payload["retry_after_s"] = self.busy_retry_s
            acks.append((frame, payload))
        t_harvest_done = time.monotonic_ns()
        stage_ns["ack_pack"] += t_harvest_done - t_ack0
        start_ns = rec.get("start_ns", t_harvest_done)
        wall_ns = t_harvest_done - start_ns
        if self._last_harvest_done_ns is not None:
            wall_ns = min(wall_ns,
                          t_harvest_done - self._last_harvest_done_ns)
        self._last_harvest_done_ns = t_harvest_done
        self.ledger.record(tick_id, rec.get("queue_depth", 0),
                           len(rec["descs"]), rec["submitted"],
                           stage_ns, wall_ns=max(0, wall_ns),
                           depth=rec.get("depth", self.pipeline_depth))
        dw = self.durable_watermark
        t_ack_tx = time.monotonic_ns()
        for frame, payload in acks:
            faults.crashpoint("storm.pre_ack")
            payload["dw"] = dw
            if frame.trace is not None:
                self._stamp_trace_ack(frame, payload)
            if frame.t0:
                self.qos.observe_ack(frame.tenant,
                                     (t_ack_tx - frame.t0) / 1e9)
            frame.push(payload)

    # -- per-doc quarantine ----------------------------------------------------
    #
    # One poisoned document must never take its batch down. Detection is
    # the device sentinel in _storm_tick (vseq drift / negative planes);
    # _quarantine_doc freezes ONLY the flagged doc: buffered frames
    # touching it nack retryable and new submits shed at _admit, while
    # every other row keeps full-rate serving.

    def _quarantine_doc(self, doc_id: str, reason: str,
                        tick_id: int) -> None:
        self.quarantined[doc_id] = {"reason": reason, "tick": tick_id}
        self.stats["quarantined_docs"] += 1
        self.merge_host.metrics.counter("storm.quarantines").inc()
        # Nack every BUFFERED frame touching the doc with a retryable
        # code; a frame sharing it is dropped whole (acks are positional
        # per frame) with every dropped doc listed. Frames not touching
        # the doc stay queued.
        kept: list[_Frame] = []
        for frame in self._frames:
            if not any(d == doc_id for d, *_ in frame.docs):
                kept.append(frame)
                continue
            self._pending_docs -= len(frame.docs)
            # Refund the shed frame's staged ledger ns and trace slot: a
            # tick that never served it must not inherit its attribution.
            self._staged_ns["ingress_decode"] -= frame.staged_ns[0]
            self._staged_ns["admission"] -= frame.staged_ns[1]
            if frame.trace is not None:
                self._traced_pending = max(0, self._traced_pending - 1)
            self._shed(frame.push, {"rid": frame.rid},
                       sum(n for *_, n in frame.docs), "quarantined",
                       self.busy_retry_s,
                       docs=[d for d, *_ in frame.docs],
                       quarantined=[doc_id], tenant=frame.tenant)
        self._frames = kept
        self.qos.reset_pending(self._frames)

    def quarantined_map_entries(self, doc_id: str) -> dict:
        """Serving a frozen doc's map by folding its durable records needs
        the storm WAL, which is not ported (ROADMAP Queue A 6)."""
        raise NotImplementedError(
            "quarantined_map_entries needs the storm WAL's durable records "
            "(not ported; ROADMAP Queue A 6)")

    def readmit_doc(self, doc_id: str, verify: bool = True) -> dict:
        """Rebuilding a frozen doc from the snapshot head and its WAL tail
        needs the storm WAL and a snapshot store, which are not ported
        (ROADMAP Queue A 6)."""
        raise NotImplementedError(
            "readmit_doc needs the storm WAL and a snapshot store (not "
            "ported; ROADMAP Queue A 6)")

    # -- read path -------------------------------------------------------------

    @staticmethod
    def _parse_header(blob: bytes) -> tuple[dict, int]:
        """(header, words byte offset) — no copy of the words region. A
        version NEWER than this reader refuses loudly."""
        import json as _json
        import struct as _struct

        hlen = _struct.unpack_from("<I", blob)[0]
        header = _json.loads(blob[4:4 + hlen].decode())
        version = header.get("v", 0)
        if not 0 <= version <= STORM_WAL_VERSION:
            raise ValueError(
                f"storm WAL tick format v{version} is newer than this "
                f"reader (max v{STORM_WAL_VERSION})")
        return header, 4 + hlen

    def _read_blob(self, tick_id: int) -> bytes:
        return self._tick_blobs[tick_id]

    def read_tick_words(self, tick_id: int) -> bytes:
        """Raw words of one harvested tick (scriptorium read path)."""
        blob = self._read_blob(tick_id)
        _header, off = self._parse_header(blob)
        return blob[off:]

    def records_overlapping(self, doc_id: str, from_seq: int,
                            to_seq: int | None = None) -> list[dict]:
        """Columnar scriptorium records of ``doc_id`` whose seq windows
        overlap (from_seq, to_seq] — resolved from the per-tick blobs via
        the compact in-RAM (first, last, tick) index. The shape matches
        what :func:`materialize_storm_records` consumes."""
        return self._records_for(doc_id, from_seq, to_seq)

    def _records_for(self, doc_id: str, from_seq: int,
                     to_seq: int | None = None) -> list[dict]:
        out = []
        for fs, ls, tick in self._doc_ticks.get(doc_id) or ():
            if ls <= from_seq or (to_seq is not None and fs > to_seq):
                continue
            header, _off = self._parse_header(self._read_blob(tick))
            for (doc, client, cseq0, ref, count,
                 ns, hfs, hls, m, w_off) in header["docs"]:
                if doc == doc_id:
                    out.append({
                        "client": client, "first_cseq": cseq0,
                        "ref_seq": ref, "count": count, "n_seq": ns,
                        "first_seq": hfs, "last_seq": hls, "msn": m,
                        "timestamp": header["ts"], "tick": tick,
                        "w_off": w_off,
                    })
                    break
        return out

    def _storm_mrow(self, doc_id: str):
        """The doc's map-row OBJECT (cohort resolution caches it)."""
        key = ChannelKey(doc_id, self.datastore, self.channel)
        mrow = self.merge_host._map_rows.get(key)
        if mrow is None:
            mrow = self.merge_host._map_row(key)
            mrow.literal_values = True
            # Storm words address keys BY SLOT; pin the canonical names so
            # map_entries/materialization agree (10-bit slot space).
            mrow.key_slots = {f"k{s}": s
                              for s in range(self.merge_host._map_slots)}
        elif not getattr(mrow, "literal_values", False):
            raise ValueError(
                f"channel {key} already serves dict-path ops; storm and "
                "dict traffic cannot mix on one channel")
        return mrow


def materialize_storm_records(records: list[dict], datastore: str,
                              channel: str,
                              blob_reader=None
                              ) -> list[SequencedDocumentMessage]:
    """Per-op messages for catch-up readers (the lazy read path of the
    columnar scriptorium records). NACKed/IGNORED ops are omitted — only
    sequenced ops exist in the document's history.

    Records either embed their words (``"words"`` b64) or reference a
    per-tick blob (``"tick"`` + ``"w_off"``); pass the controller's
    :meth:`StormController.read_tick_words` as ``blob_reader`` to resolve
    the latter. A tick whose ops were partially rejected materializes its
    sequenced ops with consecutive seqs from first_seq (exact when
    rejections are a prefix — the dup-resend shape)."""
    out: list[SequencedDocumentMessage] = []
    blob_cache: dict[int, bytes] = {}
    for rec in records:
        if rec["n_seq"] <= 0:
            continue
        if "words" in rec:
            words = np.frombuffer(base64.b64decode(rec["words"]),
                                  np.uint32, rec["count"])
        else:
            tick = rec["tick"]
            blob = blob_cache.get(tick)
            if blob is None:
                assert blob_reader is not None, (
                    "tick-blob record needs a blob_reader")
                blob = blob_reader(tick)
                blob_cache[tick] = blob
            words = np.frombuffer(blob, np.uint32, rec["count"],
                                  rec["w_off"])
        skip = rec["count"] - rec["n_seq"]  # rejected prefix (dup resend)
        for j in range(rec["n_seq"]):
            word = int(words[skip + j])
            kind = word & 3
            slot = (word >> 2) & 0x3FF
            value = (word >> 12) & 0xFFFFF
            if kind == mk.MAP_SET:
                contents = {"type": "set", "key": f"k{slot}",
                            "value": value}
            elif kind == mk.MAP_DELETE:
                contents = {"type": "delete", "key": f"k{slot}"}
            else:
                contents = {"type": "clear"}
            out.append(SequencedDocumentMessage(
                client_id=rec["client"],
                sequence_number=rec["first_seq"] + j,
                minimum_sequence_number=rec["msn"],
                client_sequence_number=rec["first_cseq"] + skip + j,
                reference_sequence_number=rec["ref_seq"],
                type=MessageType.OPERATION,
                contents={"address": datastore,
                          "contents": {"address": channel,
                                       "contents": contents}},
                timestamp=rec["timestamp"],
                data=None,
            ))
    return out


__all__ = ["StormController", "materialize_storm_records"]
