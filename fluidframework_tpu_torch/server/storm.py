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
  3. scriptorium — one columnar record per (doc, tick): the tick WAL
                 with a spill dir, process memory without one (per-op
                 messages are materialized lazily on the read path, see
                 :func:`materialize_storm_records`),
  4. broadcaster — one compact frame per doc into the fan-out hop,
  5. alfred    — per-frame acks pushed back to the submitting session.

Delivery contract: at-least-once with kernel-side dedup — an un-acked
frame may be resent verbatim; ops whose client_seq the sequencer has
already seen come back OUT_IGNORED (deli/lambda.ts:257).

Durability: with a ``spill_dir`` every harvested tick is one CRC-framed
record of the tick WAL (``storm_tick_words.log``, the same bytes the
reference writes). ``durability="group"`` hands it to the group-commit
writer thread and withholds each frame's ack until the fsync watermark
passes its tick (acks carry it as ``dw``); ``"sync"`` fsyncs inline per
tick; ``"none"`` appends without fsync. ``checkpoint()`` publishes the
sequencer rows and merge-host planes to a content-addressed snapshot
store; ``recover()`` restores the head on a fresh stack and replays the
WAL tail through the serving tick itself, on the same device and
kernels. Pipeline depth is any N >= 0, or ``"auto"`` (re-decided from
the stage ledger's commit-wait against dispatch time).

Scope of this port: the map-only storm tick with its WAL, snapshot and
recovery, single- and multi-tenant composition, the per-doc quarantine
(freeze, read through the durable records, readmit from the snapshot),
and two planes that attach themselves: tiered hot/cold residency
(``server/residency.py``: hydrate at admission and on first replayed
touch, evict through the cold snapshot tier) and mega-doc write
scale-out (``server/megadoc.py``: lane rewrite at ingress, the doc-space
combiner in the round, doc-space acks at harvest, ``mg`` WAL controls
and the ``megadoc`` snapshot field). The history plane
(``server/history.py``) attaches itself too: compaction on the flush
maintenance cadence, ``hp`` WAL controls, the ``history`` snapshot field
and the trim-floor read of a quarantined doc. Two fleet planes attach
themselves too: cluster placement (``parallel/placement.py``: a per-host
router sheds frames for a doc another host owns with ``moved`` and its
``moved_to`` owner, and frames for a doc mid-migration with
``migrating``) and quorum replication (``server/replication.py``: acks
gate on ``min(durable, replicated)``, a lost quorum parks writes and
declines rounds, a fenced ex-leader sheds every frame ``moved`` and
refuses to checkpoint, and each published snapshot ships its tick
watermark as the followers' retention floor). The viewer plane is not
ported (ROADMAP Queue A 5).
"""

from __future__ import annotations

import base64
import time
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..ops import map_fold_cuda as mfc
from ..ops import map_kernel as mk
from ..ops import matrix_cuda as mxc
from ..ops import matrix_kernel as mxk
from ..ops import mergetree_blocks as mtb
from ..ops import mergetree_blocks_cuda as mtbc
from ..ops import mergetree_kernel as mtk
from ..ops import opcodes as oc
from ..ops import sequencer as seqk
from ..ops import tree_kernel as tk
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
    mega: Any = None    # per-entry mega-doc descriptors (megadoc.py)
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


def _ticket_window(counts, k: int, dups, n_seq_doc, seq_before):
    """Per-op (in_window, seq) planes from the closed-form ticket: ops
    [dups, dups+n_seq) of each row's batch sequence as seq_before+1…"""
    lo = dups
    hi = torch.minimum(dups + n_seq_doc, counts)
    iota = torch.arange(k, dtype=I32, device=counts.device)[None, :]
    in_win = (iota >= lo[:, None]) & (iota < hi[:, None])
    seq = seq_before[:, None] + 1 + iota - lo[:, None]
    return in_win, seq


# Packed-plane field orders for the mixed tick's one-array-per-family feed
# (index 0 is always the submission-valid plane; ``seq`` planes are
# OMITTED — the device ticket assigns them).
TEXT_PACK = ("valid", "kind", "pos", "end", "ref_seq", "client",
             "pool_start", "text_len", "prop_key", "prop_val")
MATRIX_PACK = ("valid", "target", "kind", "pos", "end", "count",
               "handle_base", "row", "col", "value", "ref_seq", "client")
TREE_PACK = ("valid", "kind", "node", "parent", "trait", "payload")
#: Columns of the [B, 6] per-doc scalar pack.
SCALAR_PACK = ("slot", "cseq0", "ref", "ts", "seq_counts", "map_counts")


def _unpack(pack, names, dups, n_seq_doc, seq_before):
    """A family's [B, F, K] pack as op planes: the valid plane masked to
    the ticket window, and the window's seqs."""
    fields = {name: pack[:, i].contiguous() for i, name in enumerate(names)}
    valid = fields.pop("valid") != 0
    counts = valid.sum(dim=1, dtype=I32)
    win, seqs = _ticket_window(counts, pack.shape[2], dups, n_seq_doc,
                               seq_before)
    return fields, valid & win, seqs


def _mixed_tick(seq_state: seqk.SequencerState, map_state, merge_state,
                matrix_state, tree_state, scalars, map_words, text_pack,
                matrix_pack, tree_pack, tree_steps=None, mark=None):
    """ALL-FAMILY tick: one closed-form deli ticket sequences every
    document's batch, then EACH channel family applies its rows' windowed
    ops — map (the map-fold kernel), merge-tree (the block merge tick
    kernel, then the block-table maintenance ladder at the tick's msn),
    matrix (the matrix op tick kernel) and tree (the plain tree tick) —
    the reference's one-deltas-stream-for-all-op-types contract
    (deli/lambda.ts:82, scriptorium/lambda.ts:16), with the family routing
    done by per-family valid planes.

    Family rows share the document axis (row i of every family state IS
    document i); a family whose valid-plane row is empty no-ops on that
    document; a family not configured passes ``None``. Per family, ALL op
    planes arrive as ONE packed i32[B, F, K] tensor (field order
    ``*_PACK``) and the per-doc sequencer inputs as one i32[B, 6]
    (``SCALAR_PACK``); map words are the u32 words' bits as i32[B, K].
    ``tree_steps`` ([K] flags from the host's copy of the tree pack,
    ``tree_kernel.subtree_steps``) lets the tree tick skip the subtree
    sweep where no op can detach or move; None sweeps every step.
    ``mark(leg)`` is called after each leg (deli, map, text, rebalance,
    matrix, tree) — a timing hook.

    The legs are one sequence of launches; the only host read is the
    block table's ladder decision (three flags). Returns the reference's
    12-tuple: (seq', map', merge', matrix', tree', n_seq, first, last,
    msn, tree_overflow, text_overflow, kstats)."""
    return _mixed_tick_shards(
        [(seq_state, map_state, merge_state, matrix_state, tree_state,
          scalars, map_words, text_pack, matrix_pack, tree_pack)],
        tree_steps=tree_steps, mark=mark)[0]


def _mixed_tick_shards(shards: list, tree_steps=None, mark=None,
                       mesh=None) -> list:
    """:func:`_mixed_tick` over the shards of one docs-sharded batch
    (each entry its ten inputs, on its own device): every leg is issued
    for every shard before the next leg, so shards on different devices
    overlap. The block-table ladder decides once for the WHOLE batch — its
    flags are any/all reductions over every document, combined across the
    shards and, for a process-spanning ``mesh``, across its processes — so
    a sharded run lays text rows out exactly as an unsharded one. Returns
    one 12-tuple per shard."""
    mark = mark or (lambda _leg: None)
    st = []
    for (seq_state, map_state, merge_state, matrix_state, tree_state,
         scalars, map_words, text_pack, matrix_pack, tree_pack) in shards:
        slot, cseq0, ref, ts, seq_counts, map_counts = (
            scalars[:, i] for i in range(6))
        seq_before = seq_state.seq
        seq_state, dups, n_seq_doc, msn_doc = seqk.storm_tickets(
            seq_state, slot, cseq0, ref, ts, seq_counts)
        st.append(dict(
            seq=seq_state, map=map_state, text=merge_state,
            matrix=matrix_state, tree=tree_state, map_words=map_words,
            text_pack=text_pack, matrix_pack=matrix_pack,
            tree_pack=tree_pack, seq_counts=seq_counts,
            map_counts=map_counts, seq_before=seq_before, dups=dups,
            n_seq=n_seq_doc, msn=msn_doc, text_overflow=None,
            tree_overflow=None))
    mark("deli")

    for s in st:
        if s["map_words"] is not None:
            lo = s["dups"]
            hi = torch.minimum(s["dups"] + s["n_seq"], s["map_counts"])
            s["map"] = _map_leg(s["map"], s["map_words"], lo, hi,
                                s["seq_before"])
    mark("map")

    rstats = (0, 0)
    if st[0]["text_pack"] is not None:
        for s in st:
            fields, valid, seqs = _unpack(s["text_pack"], TEXT_PACK,
                                          s["dups"], s["n_seq"],
                                          s["seq_before"])
            ops = mtk.MergeOpBatch(valid=valid, seq=seqs, **fields)
            s["text"], s["text_overflow"] = mtbc.apply_tick_blocks_best(
                s["text"], ops)
        mark("text")
        rstats = _rebalance_shards(st, mesh)
        mark("rebalance")

    if st[0]["matrix_pack"] is not None:
        for s in st:
            fields, valid, seqs = _unpack(s["matrix_pack"], MATRIX_PACK,
                                          s["dups"], s["n_seq"],
                                          s["seq_before"])
            ops = mxk.MatrixOpBatch(valid=valid, seq=seqs, **fields)
            s["matrix"] = mxc.apply_tick_best(s["matrix"], ops)
        mark("matrix")

    if st[0]["tree_pack"] is not None:
        for s in st:
            fields, valid, _seqs = _unpack(s["tree_pack"], TREE_PACK,
                                           s["dups"], s["n_seq"],
                                           s["seq_before"])
            ops = tk.TreeOpBatch(valid=valid, **fields)
            s["tree"], out = tk.apply_tick(s["tree"], ops, tree_steps)
            s["tree_overflow"] = out.overflow.sum(dim=1, dtype=I32)
        mark("tree")

    outs = []
    for s in st:
        n_seq, seq_before = s["n_seq"], s["seq_before"]
        first = torch.where(n_seq > 0, seq_before + 1, int(oc.INT32_MAX))
        last = torch.where(n_seq > 0, seq_before + n_seq, 0)
        # kstats (the reference's indices): sequenced / dup-dropped totals
        # over this shard's rows that submitted a batch, no sentinel leg,
        # and the batch-wide rebalance counters.
        live = s["seq_counts"] > 0
        zero = torch.zeros((), dtype=I32, device=n_seq.device)
        kstats = torch.stack((
            torch.where(live, n_seq, 0).sum(dtype=I32),
            torch.where(live, torch.minimum(s["dups"], s["seq_counts"]),
                        0).sum(dtype=I32),
            zero, zero + rstats[0], zero + rstats[1]))
        outs.append((s["seq"], s["map"], s["text"], s["matrix"], s["tree"],
                     n_seq, first, last, s["msn"], s["tree_overflow"],
                     s["text_overflow"], kstats))
    return outs


def _rebalance_shards(st: list, mesh) -> tuple[int, int]:
    """The block-table ladder once for the whole batch: each shard's flags
    combine with a max (and across the mesh's processes), each shard runs
    the one branch at its rows' msn. Returns (fired, blocks touched) for
    the batch."""
    from ..parallel.mesh import all_reduce
    tick_k = st[0]["text_pack"].shape[2]
    flags = torch.stack([mtb.rebalance_flags(s["text"], tick_k).cpu()
                         for s in st]).amax(dim=0)
    rows = sum(s["text"].count.shape[0] for s in st)
    if mesh is not None:
        flags = all_reduce(mesh, flags, "max")
        rows *= mesh.world
    branch = mtb.rebalance_branch(flags.tolist())
    touched = 0
    for s in st:
        s["text"], t = mtb.apply_rebalance(s["text"], s["msn"], tick_k,
                                           branch, batch_rows=rows)
        touched = t if branch == 2 else touched + t
    if branch == 1 and mesh is not None:
        touched = int(all_reduce(mesh, torch.tensor([touched],
                                                    dtype=torch.int64)))
    return int(branch > 0), touched


#: Format version stamped on every storm tick header ("v") and on storm
#: snapshot records ("format_version") — the reference's current
#: versions, so tick blobs and snapshots stay byte-identical. Readers
#: accept 0..CURRENT and refuse anything newer.
STORM_WAL_VERSION = 3
STORM_SNAPSHOT_VERSION = 3


def choose_pipeline_depth(attribution: dict, current: int = 1) -> int:
    """Pick the serving pipeline depth from OBSERVED stage attribution:
    commit-wait under a quarter of the dispatch time -> depth 0 (serial:
    the fsync is cheap, pipelining pays a staging generation and lagged
    acks for nothing); at least half -> depth >= 1 (overlap the group
    commit with the next dispatch); the band between is hysteresis
    (keep the current depth). Needs >= 8 ticks of ledger window to act;
    returns ``current`` until then. The thresholds are the reference's;
    what a device's ratio is comes from its own stage ledger."""
    win = attribution.get("_window", {})
    if win.get("ticks", 0) < 8:
        return current
    commit = attribution.get("wal_commit_wait", {}).get("total_ms", 0.0)
    dispatch = attribution.get("device_dispatch", {}).get("total_ms", 0.0)
    if dispatch <= 0.0:
        return current
    ratio = commit / dispatch
    if ratio < 0.25:
        return 0
    if ratio >= 0.5:
        return max(current, 1)
    return current


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
    ``retry_after_s`` instead of queueing without bound. A per-doc poison
    (device sentinel tripping on a tick output) quarantines ONLY that
    document: its in-flight ops nack retryable, catch-up reads keep
    serving from the durable records with :meth:`quarantined_map_entries`
    as the scalar fold, and :meth:`readmit_doc` rebuilds it from snapshot
    + WAL replay while every other doc keeps serving. A WAL whose fsync
    breaker opens degrades the controller to read-only until the
    half-open probes heal it."""

    #: Per-op count sanity bound (one doc's batch within one frame).
    MAX_COUNT = 1 << 16

    def __init__(self, service, seq_host: KernelSequencerHost,
                 merge_host: KernelMergeHost, datastore: str = "default",
                 channel: str = "root",
                 flush_threshold_docs: int = 4096,
                 max_key_slots: int = 64,
                 pipeline_depth: int | str = 1,
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
        # Tick words blobs (the scriptorium payload): with a spill dir they
        # ride the disk WAL; without one they stay in process memory.
        self._tick_blobs: dict[int, bytes] = {}
        # doc -> [(first_seq, last_seq, tick_id)] for ticks that
        # sequenced ops — the compact in-RAM index over the tick blobs.
        self._doc_ticks: dict[str, list[tuple[int, int, int]]] = {}
        # Durability mode of the tick WAL (CRC-framed OpLog either way):
        #   "group" — group-commit writer thread (durable_store.
        #             GroupCommitLog): the harvest pays a queue put, fsyncs
        #             batch on the writer thread, and ACKS ARE WITHHELD
        #             until the durability watermark passes the tick;
        #   "sync"  — append + fdatasync inline per tick;
        #   "none"  — append only, no fsync.
        # None (default) = "group" with a spill dir, else no WAL. An
        # explicit "group"/"sync" without a spill dir fails loudly.
        if durability not in ("group", "sync", "none", None):
            raise ValueError(f"unknown durability mode {durability!r}")
        if durability in ("group", "sync") and spill_dir is None:
            raise ValueError(
                f"durability={durability!r} needs a spill_dir (the WAL "
                "lives there); pass durability='none' for WAL-less "
                "serving")
        if durability is None:
            durability = "group" if spill_dir is not None else "none"
        self.durability = durability
        self._blob_log = None
        self._group_wal = None
        self._spill_path = None
        # (tick_id, [(frame, ack payload)], harvest_ns, ledger record)
        # awaiting the durability watermark — drained in tick order on
        # the serving thread.
        self._unacked: list[tuple[int, list, int, dict | None]] = []
        if spill_dir is not None:
            import pathlib

            from ..native import OpLog
            from .durable_store import GroupCommitLog
            root = pathlib.Path(spill_dir)
            root.mkdir(parents=True, exist_ok=True)
            path = root / "storm_tick_words.log"
            self._spill_path = path  # trim_tick_blobs rewrite target
            if durability == "group":
                # commit_latency_s models a replicated log's quorum round
                # trip; 0 = local disk.
                self._group_wal = GroupCommitLog(
                    path, commit_latency_s=wal_commit_latency_s)
                self._blob_log = self._group_wal
            else:
                self._blob_log = OpLog(path)
            # Restart/reuse: the RAM (first, last, tick) index and the
            # tick counter rebuild from the journaled blobs, so catch-up
            # reads survive a restart and a reused spill dir cannot alias
            # fresh tick ids onto stale blobs.
            for tick_id in range(len(self._blob_log)):
                header, _off = self._parse_header(
                    bytes(self._blob_log.read(tick_id)))
                for entry in header["docs"]:
                    doc, _c, _c0, _r, _n, ns, fs, ls, _m, _w = entry
                    if ns > 0:
                        self._doc_ticks.setdefault(doc, []).append(
                            (fs, ls, tick_id))
            self._tick_counter = len(self._blob_log)
        # Snapshot backend (GitSnapshotStore surface). With an interval,
        # flush() checkpoints every N ticks; recover() restores the head
        # and replays the WAL tail.
        self.snapshots = snapshots
        self.snapshot_interval_ticks = snapshot_interval_ticks
        self._last_checkpoint_tick = self._tick_counter
        self._in_checkpoint = False
        # WAL-replay mode (recover(), readmit_doc()): THE serving tick,
        # with timestamps pinned to the recorded ones and no re-persist.
        self._replay = False
        self._replay_ts: int | None = None
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
        # Tiered hot/cold residency (server/residency.py attaches itself):
        # _admit hydrates cold docs (or busy-nacks a stampede), WAL replay
        # hydrates on first touch, eviction trims per-doc bookkeeping.
        self.residency = None
        # Mega-doc write scale-out (server/megadoc.py attaches itself).
        self.megadoc = None
        # History plane (server/history.py attaches itself): time-travel
        # reads off the cold path, named branches journaled as "hp" WAL
        # controls, and the background summarization compactor driven
        # from the flush maintenance cadence.
        self.history = None
        # Cluster placement (parallel/placement.py attaches a per-host
        # router): when set, frames naming docs another host owns shed
        # with a "moved" nack carrying the owner as ``moved_to`` (the
        # client redials through the reconnect/backoff path), and docs
        # mid-migration shed "migrating" with a retry hint — never
        # sequenced on the wrong host, never silently dropped.
        self.placement = None
        # Replication plane (server/replication.py attaches itself):
        # when set, client acks gate on min(durable, REPLICATED)
        # watermarks — an acked op survived a follower quorum, not just
        # this host's disk — and a fenced (demoted) plane sheds every
        # frame with a "moved" nack naming the promoted incarnation.
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
        # HARVESTS the due tick BEFORE staging the next one, so tick N's
        # WAL append (and its group fsync, on the writer thread) runs
        # concurrent with tick N+1's scatter and dispatch. Acks stay
        # withheld on the durable watermark; they lag dispatch by at most
        # ``depth`` ticks. Depth 0 is the serial shape (dispatch →
        # readback → append → fsync barrier → ack per round).
        # "auto" starts overlapped and re-decides every
        # ``depth_adapt_every`` ticks from the ledger's observed
        # wal_commit_wait against device_dispatch (choose_pipeline_depth).
        self._auto_depth = pipeline_depth == "auto"
        self._depth_adapted_at = 0
        self.depth_adapt_every = 64  # ticks between adaptation checks
        self.pipeline_depth = 1 if self._auto_depth \
            else max(0, pipeline_depth)
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
        # Admission gates run AFTER validation and only on live traffic —
        # replay (recovery / readmit) re-runs already-admitted history.
        tc = None if self._replay else trace_context(header)
        if not isinstance(tc, (int, str)):
            tc = None  # client-opaque JSON; unhashable shapes are ignored
        trace = None
        staged = (0, 0)
        t_validated = time.monotonic_ns()
        if not self._replay:
            retry = self._admit(push, header, docs, offset, tenant_id,
                                client_id)
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
        # Mega-doc ingress: promoted-doc entries are rewritten to their
        # writers' LANE sub-doc ids (stateless hash), so up to L writer
        # frames of one doc serve in ONE tick. Doc-level sequencing waits
        # for cohort selection (decide_frame). Admission ran on the
        # PARENT ids.
        mega = None
        if self.megadoc is not None and not self._replay:
            self.megadoc.observe_writers(docs)
            mega = self.megadoc.ingress_frame(docs)
        self._frames.append(_Frame(push, header.get("rid"), docs, words,
                                   counts, meta, trace, staged, mega,
                                   tenant_id, ingress_ns))
        self._pending_docs += len(docs)
        self.stats["submitted_ops"] += offset
        if not self._replay:
            self.qos.note_submitted(tenant_id, offset)
            self.qos.note_buffered(tenant_id, len(docs))
            if tenant_id != "default":
                self.qos.note_doc_tenants(tenant_id,
                                          (d for d, *_ in docs))
        if self._pending_docs >= self.flush_threshold_docs:
            # Threshold-triggered: only run FULL rounds.
            self.flush(force=False)

    def _admit(self, push, header: dict, docs: list, n_ops: int,
               tenant_id: str, client_id: str | None) -> float | None:
        """Shed checks for one validated frame, in deterministic order:
        fencing, placement, quarantine, degraded (WAL breaker open),
        lost quorum, bounded queue, token buckets, residency. A refusal
        pushes ONE busy-nack with ``retry_after_s`` and returns the
        hint; None admits."""
        if self.replication is not None and self.replication.fenced:
            # Demoted ex-leader (a follower promoted over this
            # incarnation): EVERY frame sheds with the new leader as
            # ``moved_to`` — sequencing here would fork the history the
            # promoted incarnation is already extending. Same nack shape
            # as a placement move, so one client redial path handles
            # both.
            target = self.replication.moved_to
            return self._shed(
                push, header, n_ops, "moved", self.busy_retry_s,
                docs=[d for d, *_ in docs],
                moved_to={d: target for d, *_ in docs})
        if self.placement is not None:
            # Ownership first — the cheapest check, and a frame for a
            # foreign doc must never consume this host's quarantine /
            # queue / token state. Whole-frame refusal (acks are
            # positional per frame); ``moved_to`` names each moved doc's
            # owning host so the client redials it directly.
            moved: dict[str, str] = {}
            frozen = False
            for d, *_ in docs:
                code, owner = self.placement.route(d)
                if code == "moved":
                    moved[d] = owner
                elif code == "migrating":
                    frozen = True
            if frozen:
                # Mid-migration blackout: the doc is between hosts
                # (evict-to-cold → hydrate); the retry hint is the
                # expected blackout window, after which the route
                # resolves to "moved" (or back to this host).
                return self._shed(push, header, n_ops, "migrating",
                                  self.placement.retry_after_s,
                                  docs=[d for d, *_ in docs])
            if moved:
                return self._shed(push, header, n_ops, "moved",
                                  self.placement.retry_after_s,
                                  docs=[d for d, *_ in docs],
                                  moved_to=moved)
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
        if self.wal_degraded:
            self.stats["degraded_rejects"] += 1
            if self._group_wal.failed:
                # TERMINAL writer death (not a disk that may heal):
                # retrying is pointless; say so.
                return self._shed(push, header, n_ops, "wal-failed",
                                  self.busy_retry_s, retryable=False)
            cooldown = self._group_wal.breaker.cooldown_s
            return self._shed(push, header, n_ops, "degraded",
                              max(cooldown, self.busy_retry_s))
        if (self.replication is not None
                and not self.replication.quorum_ok):
            # Follower quorum lost (lease-based failure detector): writes
            # PARK — admitted and buffered FIFO, never acked, because
            # _flush_round declines rounds — while the outage is young.
            # Past ``park_max_s`` new frames shed with a retry hint
            # instead of growing the parked queue without bound. Either
            # way: never ack-without-quorum.
            deg = self.replication.quorum_degraded_s()
            if deg is not None and deg >= self.replication.park_max_s:
                self.stats["quorum_rejects"] += 1
                return self._shed(
                    push, header, n_ops, "quorum-lost",
                    max(self.busy_retry_s,
                        self.replication.park_max_s / 2))
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
        if self.residency is not None:
            cap = self.residency.max_resident
            if cap is not None and len(docs) > cap:
                # TERMINAL: a frame naming more distinct docs than the
                # pool holds can never be admitted (the frame itself
                # excludes every named doc from eviction).
                return self._shed(push, header, n_ops, "frame-too-wide",
                                  self.busy_retry_s,
                                  docs=[d for d, *_ in docs],
                                  retryable=False)
            # Tiered residency LAST — hydration is the one expensive gate
            # (snapshot read + row restore, and a full pool pays an
            # eviction's durability barrier). A hydration stampede or a
            # full pool busy-nacks the WHOLE frame with the bucket's
            # laddered retry hint.
            retry, code = self.residency.admit_docs(
                [d for d, *_ in docs])
            if retry is not None:
                return self._shed(push, header, n_ops, code, retry,
                                  docs=[d for d, *_ in docs])
        return None

    def _shed(self, push, header: dict, n_ops: int, code: str,
              retry_after_s: float, docs: list | None = None,
              quarantined: list | None = None,
              retryable: bool = True,
              moved_to: dict | None = None,
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
            if moved_to:
                nack["moved_to"] = moved_to  # doc -> owning host label
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
            if self._group_wal is not None and self._unacked:
                from .durable_store import WalDegradedError
                try:
                    # Drain barrier: a forced flush settles everything, so
                    # withheld acks go out now — after their fsync, never
                    # before (the acked-durable contract).
                    self._group_wal.sync()
                except WalDegradedError:
                    # Fsync breaker open: acks STAY withheld and the
                    # controller serves read-only until the half-open
                    # probes heal the WAL and a later flush drains here.
                    self.merge_host.metrics.counter(
                        "storm.degraded_flushes").inc()
                else:
                    self._drain_durable_acks()
        if (self.snapshot_interval_ticks is not None
                and self.snapshots is not None
                and not self._replay and not self._in_checkpoint
                and not self.wal_degraded and not self.quarantined
                and self._tick_counter - self._last_checkpoint_tick
                >= self.snapshot_interval_ticks):
            self.checkpoint()
        # Maintenance cadence OFF the per-tick path: mega-doc auto
        # promotion/demotion and the adaptive depth re-decide here (never
        # inside a round), then the arena trim.
        if self.megadoc is not None and not self._replay:
            self.megadoc.maybe_adapt()
        if self.history is not None and not self._replay \
                and not self._in_checkpoint:
            # Summarization compaction cadence (server/history.py): roll
            # long WAL tails into fresh summaries + trim per retention.
            self.history.maybe_compact()
        if self._auto_depth and not self._replay and (
                self.stats["ticks"] - self._depth_adapted_at
                >= self.depth_adapt_every):
            self._depth_adapted_at = self.stats["ticks"]
            self.set_pipeline_depth(choose_pipeline_depth(
                self.ledger.attribution(), self.pipeline_depth))
        if self._trim_gate.due(self.stats["ticks"]):
            _malloc_trim()

    def set_pipeline_depth(self, depth: int) -> None:
        """Change the serving pipeline depth between rounds: settle the
        in-flight ticks first (a shrink must not orphan them), then the
        staging-generation ring resizes on the next round."""
        depth = max(0, int(depth))
        if depth == self.pipeline_depth:
            return
        self._harvest()
        self.pipeline_depth = depth
        self.merge_host.metrics.gauge("storm.pipeline.depth").set(depth)

    @property
    def wal_degraded(self) -> bool:
        """True while the WAL writer's fsync circuit breaker is open: the
        controller serves reads and withholds acks, and _admit nacks
        every write with a retryable "degraded" code."""
        return (self._group_wal is not None
                and self._group_wal.breaker.is_open)

    @property
    def durable_watermark(self) -> int | None:
        """Ticks proven durable (fsynced): everything below this tick id
        survives a crash. None = serving without a WAL."""
        if self._group_wal is not None:
            return self._group_wal.durable_len
        if self._blob_log is not None:
            return len(self._blob_log) if self.durability == "sync" else 0
        return None

    @property
    def acked_watermark(self) -> int | None:
        """The watermark client acks gate on: local durability alone
        without a replication plane, ``min(durable, replicated)`` with
        one — an ack then proves the op survives the HOST, not just the
        process. The plane ships synchronously on the WAL writer thread,
        so in the healthy case the two watermarks move together; a
        partitioned quorum freezes the replicated side and acks stay
        withheld (clients resend)."""
        dw = self.durable_watermark
        if dw is not None and self.replication is not None:
            dw = min(dw, self.replication.replicated_len)
        return dw

    def _drain_durable_acks(self) -> None:
        """Push withheld acks whose tick the WAL has fsynced (and the
        follower quorum journaled, when replication is attached) — on
        the serving thread (harvest / forced flush), never the writer
        thread, so session pushes stay single-threaded."""
        dw = self._group_wal.durable_len
        if self.replication is not None:
            dw = min(dw, self.replication.replicated_len)
        if self._inflight and self._unacked and self._unacked[0][0] < dw:
            # Chaos kill class "fsync-complete-before-readback": tick N
            # is durable and about to ack while a later tick's device
            # work is still in flight.
            faults.crashpoint("storm.overlap_fsynced")
        while self._unacked and self._unacked[0][0] < dw:
            _tick, acks, t_harvested, led = self._unacked.pop(0)
            t_drain = time.monotonic_ns()
            if led is not None:
                # The tick's commit-wait: harvest done → fsync watermark
                # passed (the acked-durable latency the ledger attributes).
                self.ledger.amend(led, "wal_commit_wait",
                                  t_drain - t_harvested)
            faults.crashpoint("storm.pre_ack")
            for frame, payload in acks:
                payload["dw"] = dw
                if frame.trace is not None:
                    self.tracer.mark(frame.trace, "durable", t_drain)
                    self._stamp_trace_ack(frame, payload)
                if frame.t0:
                    self.qos.observe_ack(frame.tenant,
                                         (t_drain - frame.t0) / 1e9)
                frame.push(payload)

    def _push_synth_acks(self, acks: list, mega_plans: dict) -> None:
        """Deliver acks for a cohort that collapsed to zero descs (every
        entry decided zero-op by the mega combiner): each frame's ack
        carries the rows its plan synthesized. A refseq outcome journaled
        a state-bearing mark CONTROL record and the client acts on the
        nack, so the acked-before-durable discipline applies: barrier the
        group commit before pushing; a degraded WAL withholds them like
        tick acks."""
        from ..protocol.codec import StormAck
        if self._group_wal is not None and not self._replay:
            from .durable_store import WalDegradedError
            try:
                self._group_wal.sync()
            except WalDegradedError:
                return  # not durable: withhold (clients resend)
            if self.replication is not None \
                    and self.replication.replicated_len \
                    < self._group_wal.durable_len:
                # Durable locally but not on the follower quorum: the
                # same withhold discipline, one tier out.
                return
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
        if self.wal_degraded and not self._replay:
            # Breaker open: do NOT advance device state ahead of a WAL
            # that cannot journal it — frames stay queued (new ones are
            # already nacked at _admit).
            return False
        if (self.replication is not None and not self._replay
                and not self.replication.quorum_ok):
            # Quorum lost: a tick here would advance device state and
            # journal records no quorum can replicate — the acks would
            # park anyway, and history past the replicated watermark is
            # exactly what a promoted incarnation forks away. Frames stay
            # buffered in arrival order (per-doc FIFO preserved), so the
            # healed quorum sequences the identical history a
            # never-partitioned leader would have.
            self.merge_host.metrics.gauge("repl.parked_docs").set(
                self._pending_docs)
            return False
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
        if self._replay:
            # Replay never re-composes: the recorded cohort IS the
            # composition, and scheduler state comes from the tick
            # headers.
            qplan = {"selected": frames, "kept": [], "charge": {},
                     "slices": {}, "quantum": None}
        else:
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
        if not self._replay:
            faults.crashpoint("storm.qos_mid_compose")
        self._frames.extend(f._replace(staged_ns=(0, 0))
                            for f in kept)
        self._pending_docs += sum(len(f.docs) for f in kept)
        if not self._replay:
            self.qos.reset_pending(self._frames)
        # HARVEST-FIRST: settle the due tick BEFORE staging this one; this
        # also frees the harvested tick's staging generation for reuse.
        while len(self._inflight) >= max(1, self.pipeline_depth):
            self._harvest_one(self._inflight.pop(0))
        # WAL replay re-runs the tick with its RECORDED timestamp so the
        # sequencer planes (client last_update) rebuild identically.
        now = (self._replay_ts if self._replay_ts is not None
               else self.service._clock())
        descs: list[tuple[str, str, int, int, int]] = []
        frame_words: list[np.ndarray] = []   # one payload view per frame
        frame_counts: list[np.ndarray] = []
        metas: list[np.ndarray] = []
        acks: list[tuple[_Frame, int, int]] = []  # frame -> desc [i0, i1)
        mega_rows: dict[int, tuple] = {}   # desc idx -> doc-space quad
        mega_plans: dict[int, list] = {}   # ack idx -> per-entry plan
        for frame in selected:
            i0 = len(descs)
            if frame.mega is not None and not self._replay:
                # The combiner: doc-space tickets in cohort admission
                # order (== the single-lane interleaving), dup prefixes
                # trimmed out of the words, zero-op entries dropped with
                # synthesized ack rows.
                (fdesc, fwords, fcounts, fmeta, plan,
                 desc_rows) = self.megadoc.decide_frame(frame, now)
                descs.extend(fdesc)
                frame_words.append(fwords)
                frame_counts.append(fcounts)
                metas.append(fmeta)
                for rel, row in enumerate(desc_rows):
                    if row is not None:
                        mega_rows[i0 + rel] = row
                if len(fdesc) != len(frame.docs):
                    # Dropped entries: the ack is rebuilt positionally
                    # from this plan (synth row or kept-desc index).
                    mega_plans[len(acks)] = [
                        ("s", item.synth) if item.synth is not None
                        else ("l", i0 + item.desc_rel)
                        for item in plan]
            else:
                descs.extend(frame.docs)
                frame_words.append(frame.words)
                frame_counts.append(frame.counts)
                metas.append(frame.meta)
            acks.append((frame, i0, len(descs)))
        if not descs:
            # Every selected entry resolved to a zero-op outcome: deliver
            # the synthesized acks now.
            self._push_synth_acks(acks, mega_plans)
            return True
        if self._replay and self.megadoc is not None:
            # Replayed lane entries are already cleaned: rebuild the
            # combiner's mirrors and combine logs in desc order.
            self.megadoc.replay_decide(descs, now)
        if self.megadoc is not None and not self._replay:
            self.megadoc.finish_cohort(descs)
        if self._replay:
            # Replay rounds record nothing and must not steal ns staged by
            # live frames (readmit replays interleave with serving).
            stage_ns = {}
        else:
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
            seq_rows, slots, map_rows, mrows, lane_rows = cached
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
            # Lane sub-sequencer rows keep their cref planes pinned at 0
            # (the doc-space refseq/MSN law lives in the mega combiner).
            lane_rows = (self.megadoc.lane_seq_rows(descs, seq_rows)
                         if self.megadoc is not None
                         else np.empty(0, np.int32))
            self._cohort_cache.put(cohort_key,
                                   (seq_rows, slots, map_rows, mrows,
                                    lane_rows))

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
        if lane_rows.size:
            # Live metas already carry 0 here (megadoc._meta_for); replay
            # rebuilds metas from WAL entries, whose ref column is the
            # doc-space ref — force the device feed to the lane contract.
            host["ref"][lane_rows] = 0
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
            mega_rows=mega_rows or None, mega_plans=mega_plans or None,
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
        if not self._replay:
            for frame, _i0, _i1 in acks:
                if frame.trace is not None:
                    self.tracer.mark(frame.trace, "dispatch", t_dispatched)
        self._inflight.append(rec)
        if self._group_wal is not None and not self._replay:
            # Chaos kill class "mid-overlap dispatch": this tick's device
            # work is enqueued while the previous tick's group commit may
            # still be in flight on the writer thread.
            faults.crashpoint("storm.overlap_dispatch")
        if self.pipeline_depth == 0:
            # Serial: settle this tick NOW — readback, WAL append, the
            # full durability barrier and its acks — before anything else
            # may stage.
            self._harvest_one(self._inflight.pop(0))
        elif self._group_wal is not None and self._unacked \
                and not self._replay:
            # Opportunistic NON-blocking drain: a tick whose fsync
            # completed while this round staged and dispatched acks now.
            self._drain_durable_acks()
        return True

    def _staging_gen(self, b_seq: int, b_map: int, k: int) -> dict:
        """The next idle host staging generation. ``pipeline_depth + 1``
        generations rotate round-robin, so the buffers this round writes
        are NEVER ones a still-in-flight tick's copies read or write. A
        geometry change reallocates just the generation it lands on."""
        n = self.pipeline_depth + 1
        if len(self._staging) != n:
            # A depth change (set_pipeline_depth harvested every tick
            # first, so no generation is in flight) resizes the ring.
            self._staging = [None] * n
            self._staging_idx = 0
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
        """Bounded, NON-blocking idle-path service: release acks whose
        group commit completed, run buffered partial-cohort tails, and
        harvest an in-flight tick whose device results have already
        landed. Unlike :meth:`flush` it never blocks on the durability
        barrier while ticks are in flight. Returns True when anything
        progressed."""
        moved = False
        if self._group_wal is not None and self._unacked:
            before = len(self._unacked)
            self._drain_durable_acks()
            moved = len(self._unacked) != before
        if self._frames:
            # A partial tail below the tick threshold: the senders are
            # BLOCKED on these acks — settle fully.
            self.flush()
            return True
        if self._inflight and self._inflight[0]["out"].ready():
            self._harvest_one(self._inflight.pop(0))
            moved = True
        if not self._inflight and self._unacked \
                and self._group_wal is not None:
            # Pipeline EMPTY, only the group commit outstanding: a
            # lockstep sender is blocked on exactly this fsync — take it
            # and release the acks now instead of next poll.
            from .durable_store import WalDegradedError
            try:
                self._group_wal.sync()
            except WalDegradedError:
                pass  # degraded: acks stay withheld until healed
            else:
                self._drain_durable_acks()
                moved = True
        return moved

    def _harvest(self) -> None:
        while self._inflight:
            self._harvest_one(self._inflight.pop(0))

    def _harvest_one(self, rec: dict) -> None:
        t_read0 = time.monotonic_ns()
        n_seq, first, last, msn, bad, kstats = rec["out"].wait()
        kstats = kstats.tolist()
        t_readback = time.monotonic_ns()
        if self._group_wal is not None and not self._replay:
            # Chaos kill class "readback-before-fsync": this tick's
            # results are read back but its durable record has not yet
            # reached the writer thread — nothing of it was ever acked.
            faults.crashpoint("storm.readback_pre_wal")
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
        if not self._replay:
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
        replaying = self._replay
        doc_tick_counts = self.doc_tick_counts
        pubs: list = [] if fanout is not None and not replaying else None
        for i, (doc, client, cseq0, ref, count) in enumerate(rec["descs"]):
            ns, fs, ls, m = ns_l[i], fs_l[i], ls_l[i], m_l[i]
            mrow = mrows[i]
            if ls > mrow.last_seq:
                mrow.last_seq = ls
            header_docs.append([doc, client, cseq0, ref, count,
                                ns, fs, ls, m, offsets[i]])
            if replaying:
                continue  # the index already holds replayed ticks
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
        if replaying:
            pass  # the blob IS the replay source; never re-persist it
        elif self._group_wal is not None:
            # Group commit: the harvest pays ONE queue put; the join, CRC,
            # append and fsync run on the writer thread, which holds the
            # frames' receive-buffer views until the record is written.
            # The tick's acks wait for the watermark (_drain_durable_acks).
            idx = self._group_wal.append([prefix, *word_parts])
            assert idx == tick_id, (idx, tick_id)
            if self.pipeline_depth == 0:
                # Serial: the durability barrier is tick time ON this
                # thread, so it is measured directly as the commit-wait
                # stage (no amend at drain).
                from .durable_store import WalDegradedError
                t_sync0 = time.monotonic_ns()
                try:
                    self._group_wal.sync()
                except WalDegradedError:
                    # Breaker open: acks stay withheld (not durable);
                    # _admit is already shedding new writes.
                    self.merge_host.metrics.counter(
                        "storm.degraded_flushes").inc()
                stage_ns["wal_commit_wait"] = (time.monotonic_ns()
                                               - t_sync0)
        elif self._blob_log is not None:
            blob_bytes = prefix + b"".join(
                bytes(memoryview(p)) for p in word_parts)
            idx = self._blob_log.append(blob_bytes)
            assert idx == tick_id, (idx, tick_id)
            if self.durability == "sync":
                t_sync0 = time.monotonic_ns()
                self._blob_log.sync()
                stage_ns["wal_commit_wait"] = (time.monotonic_ns()
                                               - t_sync0)
        else:
            self._tick_blobs[tick_id] = prefix + b"".join(
                bytes(memoryview(p)) for p in word_parts)
        t_wal = time.monotonic_ns()
        stage_ns["wal_append"] = (t_wal - t_fanout
                                  - stage_ns.get("wal_commit_wait", 0))
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
        if not replaying and rec.get("qos_slices"):
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
        # Mega combiner egress: lane descs' device rows carry LANE-space
        # seqs (what the WAL header above recorded — reads translate);
        # the CLIENT sees doc-space quads, pre-decided by the combiner.
        # The device count must agree with the decision — a drift means
        # the lane contract broke, which must fail loudly, not misack.
        mega_rows_rec = rec.get("mega_rows")
        if mega_rows_rec:
            if not replaying:
                self.megadoc.note_harvest(rec["descs"])
            for gi, row in mega_rows_rec.items():
                if ns_l[gi] != row[0]:
                    raise AssertionError(
                        f"mega lane desc {rec['descs'][gi][:2]} sequenced "
                        f"{ns_l[gi]} ops on device, combiner decided "
                        f"{row[0]}")
                ack_rows[gi] = row
        elif self.megadoc is not None and not replaying:
            self.megadoc.note_harvest(rec["descs"])
        # Each frame's ack is a contiguous row slice of the tick's ack
        # matrix — a StormAck that session push paths binary-encode.
        # Frames the mega transform shrank rebuild their rows
        # positionally from the plan (synthesized zero-op quads
        # interleaved with harvested rows).
        from ..protocol.codec import StormAck
        t_ack0 = time.monotonic_ns()
        mega_plans = rec.get("mega_plans") or {}
        acks = []
        for ack_i, (frame, i0, i1) in enumerate(rec["acks"]):
            if frame.push is None:
                continue
            plan = mega_plans.get(ack_i)
            if plan is None:
                payload = StormAck(frame.rid, ack_rows[i0:i1])
            else:
                rows = np.empty((len(plan), 4), np.int32)
                for j, (kind, v) in enumerate(plan):
                    rows[j] = v if kind == "s" else ack_rows[v]
                payload = StormAck(frame.rid, rows)
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
        # The tick's ledger record (replay ticks are reconstruction, not
        # serving — they don't pollute attribution). Group-mode
        # commit-wait is unknown until the fsync watermark passes the
        # tick; the drain backfills it on the record object.
        led = None
        if not replaying:
            start_ns = rec.get("start_ns", t_harvest_done)
            wall_ns = t_harvest_done - start_ns
            if self._last_harvest_done_ns is not None:
                wall_ns = min(wall_ns,
                              t_harvest_done - self._last_harvest_done_ns)
            self._last_harvest_done_ns = t_harvest_done
            led = self.ledger.record(tick_id, rec.get("queue_depth", 0),
                                     len(rec["descs"]), rec["submitted"],
                                     stage_ns, wall_ns=max(0, wall_ns),
                                     depth=rec.get("depth",
                                                   self.pipeline_depth))
        if self._group_wal is not None and not replaying:
            # Withhold until fsynced — then deliver in tick order with the
            # durability watermark stamped on. The serial shape already
            # measured its inline barrier (led=None: no amend at drain).
            self._unacked.append((tick_id, acks, t_harvest_done,
                                  led if self.pipeline_depth > 0
                                  else None))
            self._drain_durable_acks()
        else:
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

    # -- snapshot / recovery ---------------------------------------------------
    #
    # The crash-consistency pair: checkpoint() writes a device-pool
    # snapshot (sequencer rows + merge-host planes + the WAL tick
    # watermark) to the content-addressed snapshot store; recover()
    # restores the head and replays the WAL tail THROUGH THE SERVING TICK
    # itself (same kernels, recorded timestamps), so a restarted
    # controller reconverges byte-identically with an uninterrupted twin.
    # tools/chaos.py kills the process at every dangerous point and
    # proves exactly that.

    SNAPSHOT_DOC = "__storm__"

    def checkpoint(self) -> str:
        """Settle everything (harvest + durability barrier), then publish
        one snapshot atomically: upload first, flip the head ref last —
        a crash mid-checkpoint leaves the previous head intact."""
        assert self.snapshots is not None, "no snapshot store attached"
        if self.replication is not None and self.replication.fenced:
            # A demoted leader's snapshot would clobber the promoted
            # incarnation's head — the zombie-writes hazard fencing
            # exists to stop.
            raise RuntimeError(
                "checkpoint() on a fenced (demoted) leader; the "
                f"promoted incarnation {self.replication.moved_to!r} "
                "owns the snapshot head")
        from .durable_store import WalDegradedError
        if self.wal_degraded:
            raise WalDegradedError(
                "checkpoint() while the WAL fsync breaker is open: the "
                "snapshot watermark cannot barrier on durability")
        if self.quarantined:
            # A snapshot now would capture the quarantined docs' POISONED
            # rows — and readmit_doc rebuilds from the snapshot head.
            raise RuntimeError(
                f"checkpoint() with quarantined docs "
                f"{sorted(self.quarantined)}: readmit them first (a "
                "snapshot would capture their poisoned rows)")
        self._in_checkpoint = True
        try:
            self.flush()
            if self.wal_degraded:
                # The breaker may have opened during the settle flush
                # (flush swallows the barrier failure to keep serving).
                raise WalDegradedError(
                    "WAL fsync breaker opened during the checkpoint "
                    "flush; snapshot watermark would not be durable")
            if self.quarantined:
                raise RuntimeError(
                    f"sentinel quarantined {sorted(self.quarantined)} "
                    "during the checkpoint flush; readmit before "
                    "snapshotting")
            import dataclasses
            snap = {
                "kind": "storm-checkpoint",
                "format_version": STORM_SNAPSHOT_VERSION,
                "tick_watermark": self._tick_counter,
                "sequencer": {
                    doc: dataclasses.asdict(cp)
                    for doc, cp in self.seq_host.checkpoint_all().items()},
                "merge_host": self.merge_host.export_state(),
            }
            if self.megadoc is not None and self.megadoc.docs:
                # Lane DEVICE rows already ride checkpoint_all (lane ids
                # are sequencer docs) and the merge-host export; this is
                # the combiner's host state (mirrors + combine logs).
                snap["megadoc"] = self.megadoc.export_state()
            if not self.qos.is_trivial():
                # Fair-composition state (deficits + rotation), rolled
                # forward at recover() by the WAL tail's "qos" headers.
                snap["qos"] = self.qos.export_state()
            if self.history is not None and self.history.branches:
                # Branch registry (summaries and cold seeds are already
                # store-resident under their own heads).
                snap["history"] = self.history.export_state()
            handle = self.snapshots.upload(self.SNAPSHOT_DOC, snap)
            faults.crashpoint("snapshot.pre_publish")
            self.snapshots.set_head(self.SNAPSHOT_DOC, handle)
            self._last_checkpoint_tick = self._tick_counter
            if self.replication is not None:
                # Replica-side WAL retention: the snapshot watermark is
                # the followers' trim floor (recovery never replays below
                # it); the plane names the sub-floor ticks still live here
                # so follower reads stay byte-identical.
                self.replication.ship_retention(self._last_checkpoint_tick)
            return handle
        finally:
            self._in_checkpoint = False

    def recover(self) -> dict:
        """Restore the snapshot head (when one exists) into the sequencer
        and merge hosts on this controller's device, then replay the WAL
        ticks past the snapshot's watermark. Call once on a FRESH
        controller stack, before serving."""
        assert not self._frames and not self._inflight, (
            "recover() on a controller already serving")
        restored_from = None
        start = 0
        if self.snapshots is not None:
            head = self.snapshots.head(self.SNAPSHOT_DOC)
            snap = self.snapshots.get(self.SNAPSHOT_DOC, head)
            if snap is not None:
                version = snap.get("format_version", 0)
                if not 0 <= version <= STORM_SNAPSHOT_VERSION:
                    raise ValueError(
                        f"storm snapshot format v{version} is newer than "
                        f"this reader (max v{STORM_SNAPSHOT_VERSION})")
                from .sequencer import SequencerCheckpoint
                for doc, cp in sorted(snap["sequencer"].items()):
                    self.seq_host.restore(doc, SequencerCheckpoint(**cp))
                self.merge_host.import_state(snap["merge_host"])
                if snap.get("megadoc") is not None:
                    if self.megadoc is None:
                        raise RuntimeError(
                            "snapshot holds mega-doc combiner state but "
                            "no MegaDocManager is attached")
                    self.megadoc.import_state(snap["megadoc"])
                if snap.get("qos") is not None:
                    self.qos.import_state(snap["qos"])
                if snap.get("history") is not None:
                    if self.history is None:
                        raise RuntimeError(
                            "snapshot holds history-plane branch state "
                            "but no HistoryPlane is attached")
                    self.history.import_state(snap["history"])
                start = snap["tick_watermark"]
                restored_from = head
                if self.residency is not None:
                    # Docs the global snapshot restored are resident; the
                    # WAL-tail replay below hydrates cold docs on first
                    # touch (prepare_replay).
                    self.residency.adopt_resident()
            elif self._blob_log is not None and len(self._blob_log) > 0:
                # Durable ticks but no readable snapshot: serving EMPTY
                # live state over an acked history would silently diverge
                # from what clients already saw — fail loudly.
                raise RuntimeError(
                    f"recover(): WAL holds {len(self._blob_log)} durable "
                    "ticks but no snapshot head is readable; refusing to "
                    "serve empty state over an acked history")
        # Memory-only serving with snapshots: tick ids continue past the
        # watermark, so fresh ticks never alias.
        self._tick_counter = max(self._tick_counter, start)
        durable = len(self._blob_log) if self._blob_log is not None else 0
        if self._blob_log is not None and start > durable:
            # Snapshot watermark ahead of the WAL (an unfsynced tail died
            # with the host under durability != "group"): the snapshot
            # holds the full state, but tick ids must stay 1:1 with WAL
            # record indices, so pad docs-less filler ticks.
            import json as _json
            import struct as _struct
            header = _json.dumps({"ts": 0, "docs": []},
                                 separators=(",", ":")).encode()
            filler = _struct.pack("<I", len(header)) + header
            while len(self._blob_log) < start:
                self._blob_log.append(filler)
            if self._group_wal is not None:
                self._group_wal.sync()
            durable = len(self._blob_log)
        replayed = 0
        if restored_from is not None and start < durable:
            replayed = self._replay_wal(start, durable)
        self._last_checkpoint_tick = self._tick_counter
        if self.residency is not None:
            # Trim the blob-scan index back to the hot set: cold docs'
            # indexes live in their cold snapshots (restored on hydrate).
            self.residency.after_recover()
        return {"restored_from": restored_from, "replayed_ticks": replayed}

    def _replay_wal(self, start: int, end: int) -> int:
        """Re-run ticks [start, end) from their durable blobs through the
        serving path: same cohorts, same recorded timestamps, no
        re-persisting (the blob being replayed IS the durable record)."""
        self._replay = True
        try:
            for tick in range(start, end):
                blob = self._read_blob(tick)
                header, off = self._parse_header(blob)
                if header.get("qos") is not None:
                    # Roll the scheduler forward to the state this tick
                    # was composed against.
                    self.qos.import_state(header["qos"])
                mg = header.get("mg")
                if mg is not None:
                    # Mega-doc lifecycle control record: re-apply the event
                    # at the identical point in the total order.
                    if self.megadoc is None:
                        raise RuntimeError(
                            "WAL holds mega-doc control records but no "
                            "MegaDocManager is attached — attach one "
                            "before recover()")
                    self._tick_counter = tick + 1
                    self.megadoc.apply_control(mg, header["ts"])
                    continue
                hp = header.get("hp")
                if hp is not None:
                    # History-plane control record: branch forks re-seed
                    # at the identical point in the total order (the
                    # seed is a pure function of the records below this
                    # tick); trimmed-tick fillers are stateless.
                    self._tick_counter = tick + 1
                    if hp.get("op") == "trimmed" or hp.get("trimmed"):
                        continue
                    if self.history is None:
                        raise RuntimeError(
                            "WAL holds history-plane control records "
                            "but no HistoryPlane is attached — attach "
                            "one before recover()")
                    self.history.apply_control(hp, header["ts"])
                    continue
                self._tick_counter = tick
                self._replay_ts = header["ts"]
                entries = [e[:5] for e in header["docs"]]
                payload = memoryview(blob)[off:]
                if self.residency is not None:
                    # Hydrate cold docs on first touch; drop the entries a
                    # doc's cold snapshot already reflects (ticks below
                    # its watermark).
                    kept = self.residency.prepare_replay(entries, tick)
                    if not kept:
                        # Whole tick inside cold snapshots: account for it
                        # without a device tick.
                        self._tick_counter = tick + 1
                        continue
                    if len(kept) != len(entries):
                        # The payload is positional, so dropped entries
                        # splice their word slices out too (each header
                        # entry records its byte offset, index 9).
                        w_off = {e[0]: e[9] for e in header["docs"]}
                        payload = memoryview(b"".join(
                            bytes(payload[w_off[doc]:
                                          w_off[doc] + count * 4])
                            for doc, _c, _c0, _r, count in kept))
                    entries = kept
                self._adopt_replay_clients(entries, header)
                self.submit_frame(None, {"docs": entries, "rid": None},
                                  payload)
                self.flush()
        finally:
            self._replay = False
            self._replay_ts = None
        assert self._tick_counter == end, (self._tick_counter, end)
        return end - start

    def _adopt_replay_clients(self, entries: list, header: dict) -> None:
        """A client named by a durable tick header that the restored row
        does not know joined AFTER the restore source (membership rides
        the bus tier, never the storm WAL). Replaying its frame against
        the ghost lane would silently drop ops the live tick acked, so
        adopt the client at its RECORDED dedup prefix: ``cseq`` just
        below the first sequenced op and ``cref`` at the entry's ref.
        Mega lane ids are skipped — the combiner mirror syncs lane
        membership itself (replay_decide)."""
        rec_by_doc = {e[0]: e for e in header["docs"]}
        for doc, client, cseq0, ref, count in entries:
            if self.megadoc is not None \
                    and self.megadoc.parent_of(doc) is not None:
                continue
            row = self.seq_host._rows.get(doc)
            if row is not None and client in self.seq_host._slots[row]:
                continue
            ns = rec_by_doc[doc][5]
            self.seq_host._row(doc)
            cp = self.seq_host.checkpoint(doc)
            cp.clients.append({
                "client_id": client,
                "client_seq": cseq0 + (count - ns) - 1,
                "ref_seq": ref,
                "last_update": header["ts"],
                "can_evict": True, "can_summarize": True,
                "nack": False,
            })
            self.seq_host.restore(doc, cp)

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
        if self.megadoc is not None:
            # A poisoned LANE freezes the whole promoted doc: submits name
            # the parent, and a partial freeze would let sibling lanes
            # advance the doc's total order past an unservable range.
            parent = self.megadoc.parent_of(doc_id)
            if parent is not None:
                for other in [parent] + self.megadoc.lane_ids(parent):
                    if other not in self.quarantined:
                        self._quarantine_doc(other, reason, tick_id)
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
        """Scalar-engine serving for a quarantined doc: fold the durable
        columnar records (poison-free by construction — the ticket plane
        is exact even when the served planes corrupt) into the converged
        map. The doc stays readable at scalar cost while frozen."""
        from ..dds.map_data import MapData
        if self.history is not None and self.history.tail_floor(doc_id):
            # A compacted+trimmed doc's record prefix is gone — the
            # summary chain is the authoritative base; the history fold
            # serves the same converged entries shape.
            return self.history.read_at(
                doc_id, self.history.head_seq(doc_id))["entries"]
        records = self.records_overlapping(doc_id, 0)
        data = MapData()
        for m in materialize_storm_records(records, self.datastore,
                                           self.channel,
                                           blob_reader=self.read_tick_words):
            data.process(m.contents["contents"]["contents"], False, None)
        return dict(data.items())

    def readmit_doc(self, doc_id: str, verify: bool = True) -> dict:
        """From-snapshot rebuild of ONE quarantined document: restore its
        sequencer row and map row from the snapshot head, replay its WAL
        tail through the serving tick (recorded timestamps, single-doc
        cohorts), verify against the scalar fold, and lift the freeze.
        The rest of the batch serves normally throughout."""
        assert doc_id in self.quarantined, f"{doc_id!r} not quarantined"
        assert self.snapshots is not None, \
            "readmit_doc needs a snapshot store"
        self.flush()  # settle peers; the doc itself has nothing buffered
        head = self.snapshots.head(self.SNAPSHOT_DOC)
        snap = self.snapshots.get(self.SNAPSHOT_DOC, head)
        assert snap is not None, "no readable snapshot head to rebuild from"
        from .sequencer import SequencerCheckpoint
        cp = snap["sequencer"].get(doc_id)
        assert cp is not None, f"snapshot holds no sequencer row for {doc_id}"
        self.seq_host.restore(doc_id, SequencerCheckpoint(**cp))
        self._restore_map_row(doc_id, snap["merge_host"])
        start = snap["tick_watermark"]
        end = saved_counter = self._tick_counter
        replayed = 0
        self._replay = True
        try:
            for tick in range(start, end):
                blob = self._read_blob(tick)
                header, off = self._parse_header(blob)
                for entry in header["docs"]:
                    doc, client, cseq0, ref, count = entry[:5]
                    if doc != doc_id or count <= 0:
                        continue
                    w_off = entry[9]
                    self._tick_counter = tick
                    self._replay_ts = header["ts"]
                    words = memoryview(blob)[off + w_off:
                                             off + w_off + count * 4]
                    self.submit_frame(
                        None, {"docs": [[doc, client, cseq0, ref, count]],
                               "rid": None}, words)
                    self.flush()
                    replayed += 1
                    break
        finally:
            self._replay = False
            self._replay_ts = None
            self._tick_counter = saved_counter
        if verify:
            rebuilt = self.merge_host.map_entries(doc_id, self.datastore,
                                                  self.channel)
            shadow = self.quarantined_map_entries(doc_id)
            assert rebuilt == shadow, (
                f"readmit of {doc_id!r} diverged from the durable-record "
                f"fold: {rebuilt} != {shadow}")
        info = self.quarantined.pop(doc_id)
        self.stats["readmitted_docs"] += 1
        self.merge_host.metrics.counter("storm.readmits").inc()
        return {"doc": doc_id, "reason": info["reason"],
                "replayed_ticks": replayed, "snapshot": head}

    def _restore_map_row(self, doc_id: str, host_snap: dict) -> None:
        """Overwrite the doc's LIVE device map row, in place on its
        device, with its snapshot row (or init defaults when the snapshot
        predates the row) — the map half of the per-doc rebuild; peers'
        rows and the planes' storage are untouched."""
        live_row = self._storm_map_row(doc_id)
        from .merge_host import _nd_unpack
        m = host_snap["map"]
        snap_row = None
        for rec in m["rows"]:
            if list(rec["key"]) == [doc_id, self.datastore, self.channel]:
                snap_row = rec["row"]
                break
        xs = self.merge_host._xstate
        s_live = xs.present.shape[1]
        vals = {"present": np.zeros(s_live, np.bool_),
                "value": np.zeros(s_live, np.int32),
                "vseq": np.full(s_live, -1, np.int32),
                "cleared_seq": np.int32(-1)}
        if snap_row is not None:
            planes = {f: _nd_unpack(m["planes"][f])
                      for f in mk.MapState._fields}
            s_snap = planes["present"].shape[1]
            assert s_snap <= s_live, (
                f"snapshot map row wider than live ({s_snap} > {s_live})")
            for f in ("present", "value", "vseq"):
                vals[f][:s_snap] = planes[f][snap_row]
            vals["cleared_seq"] = planes["cleared_seq"][snap_row]
        self.merge_host.write_map_row(live_row, vals["present"],
                                      vals["value"], vals["vseq"],
                                      vals["cleared_seq"])

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
        if self._blob_log is not None:
            if (self._group_wal is not None
                    and tick_id >= self._group_wal.durable_len):
                # Catch-up reads ARE durability proof to clients: a record
                # must never leave this process ahead of its fsync, so
                # reading an in-flight tick barriers the group commit
                # first (with the breaker open this raises
                # WalDegradedError instead of serving unfsynced bytes).
                self._group_wal.sync()
            return bytes(self._blob_log.read(tick_id))
        return self._tick_blobs[tick_id]

    def read_tick_words(self, tick_id: int) -> bytes:
        """Raw words of one harvested tick (scriptorium read path)."""
        blob = self._read_blob(tick_id)
        _header, off = self._parse_header(blob)
        return blob[off:]

    def trim_tick_blobs(self, ticks: set[int]) -> int:
        """Rewrite superseded tick blobs to tiny filler records: tick ids
        stay 1:1 with WAL positions — only the bytes shrink. Callers have
        already proven the ticks are below the checkpoint watermark and
        referenced by no live catch-up index. The filler parses as a
        valid docs-less tick header, so a reused spill dir rescans
        cleanly."""
        if not ticks:
            return 0
        import json as _json
        import struct as _struct
        header = _json.dumps(
            {"v": STORM_WAL_VERSION, "ts": 0, "docs": [],
             "hp": {"op": "trimmed"}}, separators=(",", ":")).encode()
        filler = _struct.pack("<I", len(header)) + header

        def transform(idx: int, data: bytes) -> bytes | None:
            if idx in ticks and len(data) > len(filler):
                return filler
            return None

        if self._group_wal is not None:
            return self._group_wal.rewrite_records(transform)
        if self._blob_log is not None:
            from .durable_store import rewrite_oplog_records
            self._blob_log, changed = rewrite_oplog_records(
                self._blob_log, self._spill_path, transform)
            return changed
        changed = 0
        for tick in ticks:
            blob = self._tick_blobs.get(tick)
            if blob is not None and len(blob) > len(filler):
                self._tick_blobs[tick] = filler
                changed += 1
        return changed

    def records_overlapping(self, doc_id: str, from_seq: int,
                            to_seq: int | None = None) -> list[dict]:
        """Columnar scriptorium records of ``doc_id`` whose seq windows
        overlap (from_seq, to_seq] — resolved from the per-tick blobs via
        the compact in-RAM (first, last, tick) index. The shape matches
        what :func:`materialize_storm_records` consumes. A doc with
        mega-lane history merges its lane records translated to doc seq
        space through the combine logs."""
        if self.megadoc is not None and self.megadoc.has_history(doc_id):
            return self.megadoc.records(doc_id, from_seq, to_seq,
                                        self._records_for)
        return self._records_for(doc_id, from_seq, to_seq)

    def _records_for(self, doc_id: str, from_seq: int,
                     to_seq: int | None = None) -> list[dict]:
        """Untranslated per-id record resolution (lane ids included)."""
        out = []
        ticks = self._doc_ticks.get(doc_id)
        if ticks is None and self.residency is not None \
                and not self.residency.is_resident(doc_id):
            # Cold doc: its catch-up index rode the eviction snapshot. A
            # gap fetch is a READ — serve it from the cold head without
            # hydrating (readers must not churn the pool).
            ticks = self.residency.cold_doc_ticks(doc_id)
        for fs, ls, tick in ticks or ():
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

    def _storm_map_row(self, doc_id: str) -> int:
        return self._storm_mrow(doc_id).row


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


__all__ = ["StormController", "choose_pipeline_depth",
           "materialize_storm_records"]
