"""Sharded serving assembly — the multi-host deployment of the storm
pipeline (the partitionManager.ts scale-out analog).

Port of ``fluidframework_tpu/parallel/serving.py``. The reference scales
its ordering service by Kafka partitions assigning documents to consumer
PROCESSES (lambdas-driver/src/kafka-service/partitionManager.ts:24). Here
the same assignment is the document axis of a :class:`~.mesh.Mesh`:

* each serving host owns a CONTIGUOUS document-row range — in a real
  multi-process deployment that range is :func:`.multihost.local_docs`;
  the front door / bus routes exactly those documents to it;
* every host contributes its rows' columnar op planes; each device shard
  holds one contiguous slice of this process's rows (a list of per-shard
  states, :mod:`.mesh`), so no host materializes another's rows;
* ONE tick — the deli + all-family ``_mixed_tick`` of ``server/storm.py``
  (``_storm_tick`` for a map-only assembly) — runs on every shard, each
  shard's launches queued on its own device before any readback;
* each host harvests ONLY its own rows for acks, durability and broadcast.

ALL op families ride the one tick (the reference's single deltas stream —
deli/lambda.ts:82 tickets every op type, scriptorium lambda.ts:16
consumes them uniformly): a document row can carry a map channel (packed
u32 words), a merge-tree text channel, a matrix channel or a tree channel.

Single-process deployments (and a virtual mesh of several shards on one
device) run the same code with simulated hosts.

:class:`MegaDocLanes` spreads one document over several rows of an
assembly (the mega-doc tier's lane placement), with the combiner and the
cross-lane fold of ``server/megadoc.py``.
"""

from __future__ import annotations

import time as _time
import zlib
from typing import Any, NamedTuple

import numpy as np
import torch

from ..ops import map_kernel as mk
from ..ops import matrix_kernel as mxk
from ..ops import mergetree_blocks as mtb
from ..ops import mergetree_kernel as mtk
from ..ops import sequencer as seqk
from ..ops import sequencer_cuda as seqc
from ..ops import tree_kernel as tk
from ..protocol.messages import MessageType
from ..utils import faults
from . import multihost
from .mesh import Mesh, aggregate_metrics, shard_bounds, tree_map

TEXT_FIELDS = ("kind", "pos", "end", "ref_seq", "client",
               "pool_start", "text_len", "prop_key", "prop_val")
MATRIX_FIELDS = ("target", "kind", "pos", "end", "count", "handle_base",
                 "row", "col", "value", "ref_seq", "client")
TREE_FIELDS = ("kind", "node", "parent", "trait", "payload")


def _plane_rows(planes, bounds, port: "HostPort") -> np.ndarray:
    """Host copy of one state plane's rows in [start, stop) — assembled
    from this process's shards only (``planes[i]`` holds global rows
    ``bounds[i]``). A checkpoint must cover the WHOLE range: rows resident
    in another process cannot be silently zero-filled (restoring zeroed
    sequencer counters would regress sequence numbers), so partial
    coverage raises — each process checkpoints its own range."""
    lead = port.stop - port.start
    out = None
    covered = 0
    for plane, (lo, hi) in zip(planes, bounds):
        s, e = max(lo, port.start), min(hi, port.stop)
        if s >= e:
            continue
        data = plane[s - lo:e - lo].detach().cpu().numpy()
        if out is None:
            out = np.zeros((lead,) + data.shape[1:], data.dtype)
        out[s - port.start:e - port.start] = data
        covered += e - s
    if out is None or covered < lead:
        raise ValueError(
            f"host range [{port.start}, {port.stop}) only has {covered} "
            "addressable rows on this process; checkpoint each process's "
            "own range")
    return out


def _addressable_rows(arrays, bounds) -> dict[int, int]:
    """row -> value from this process's per-shard host arrays."""
    out: dict[int, int] = {}
    for data, (lo, _hi) in zip(arrays, bounds):
        for offset, value in enumerate(np.asarray(data).tolist()):
            out[lo + offset] = int(value)
    return out


class HostPort(NamedTuple):
    """One serving host's front door: the doc-row range it owns and the
    columnar buffers its connections fill (the bus-partition analog)."""

    host_id: int
    start: int
    stop: int

    def owns(self, row: int) -> bool:
        return self.start <= row < self.stop


class _Sub(NamedTuple):
    """One admitted per-row submission awaiting the tick (and, after it,
    the payload of the row's durable record — the replay source)."""

    family: str        # "map" | "text" | "matrix" | "tree"
    planes: Any        # words u32[n] (map) or {field: i32[n]} planes
    count: int
    cseq0: int
    ref: int
    client: int        # sequencer client slot
    text: str          # inserted text blob (text family)
    pool_base: int     # row pool length before this submission's append


class ShardedServing:
    """N serving hosts over one docs-sharded mesh, running the sequencer +
    all-family storm tick on every shard.

    Every document row has a sequencer lane set; rows carrying map
    channels use the packed-word :meth:`submit`, text rows
    :meth:`submit_text`, matrix rows :meth:`submit_matrix`, tree rows
    :meth:`submit_tree` — one submission per row per tick (per-doc total
    order), all families sequenced and applied by the one tick.

    Failure story (kafka-service/checkpointManager.ts:24 analog): every
    tick appends one durable columnar record per submitted row to
    ``durable``; :meth:`checkpoint_host` captures a host's row states +
    per-row log offsets. When a host dies, its device state dies with it —
    a replacement assembly (possibly with its doc range REASSIGNED,
    :meth:`rebalance_from`) restores the checkpoints and replays the
    durable tail through the REAL tick path; the sequencer's clientSeq
    dedup makes the replay idempotent and the restored seq counters make
    it regression-free.

    States are lists of per-shard NamedTuples (``seq_state[i]`` holds rows
    ``shard_rows[i]``); :meth:`family_rows` is their host copy."""

    def __init__(self, mesh: Mesh, num_docs: int, k: int,
                 num_hosts: int, num_clients: int = 2,
                 map_slots: int = 32,
                 durable_retention_ticks: int = 1024,
                 text_slots: int = 0, text_k: int = 0, text_props: int = 4,
                 text_locality: float = 0.0,
                 matrix_vec_slots: int = 0, matrix_cell_slots: int = 0,
                 matrix_k: int = 0,
                 tree_slots: int = 0, tree_k: int = 0,
                 pipeline_depth: int = 0) -> None:
        if num_docs % mesh.size:
            raise ValueError("num_docs must divide over the mesh")
        self.mesh = mesh
        self.num_docs = num_docs
        self.k = k
        self.map_slots = map_slots
        self.num_clients = num_clients
        # The doc rows THIS PROCESS feeds and harvests: the full range for
        # one process, this process's contiguous slice in a multi-process
        # launch — the same code runs both shapes.
        self.local_lo, self.local_hi = multihost.local_docs(mesh, num_docs)
        b_local = self.local_hi - self.local_lo
        #: Global [start, stop) rows of each local shard.
        self.shard_rows = [(self.local_lo + lo, self.local_lo + hi)
                           for lo, hi in shard_bounds(mesh, b_local)]
        self.devices = mesh.devices
        overlap_words = mtk.overlap_words_for(num_clients)

        def per_shard(make):
            return [make(hi - lo, dev) for (lo, hi), dev
                    in zip(self.shard_rows, self.devices)]

        self.seq_state = per_shard(
            lambda b, dev: seqk.init_state(b, num_clients + 1, dev))
        self.map_state = per_shard(
            lambda b, dev: mk.init_state(b, map_slots, dev))
        # Optional channel families — rows share the document axis: row i
        # of every family state IS document i.
        self.text_slots = text_slots
        self.text_k = text_k or (k if text_slots else 0)
        # Text rows live in the block-structured table; the geometry
        # guarantees a capacity-checked tick cannot overflow a block given
        # the per-tick maintenance ladder inside _mixed_tick.
        self.text_props = text_props
        self.text_geometry = (mtb.choose_block_geometry(
            text_slots, self.text_k, text_locality)
            if text_slots else None)
        self.merge_state = per_shard(lambda b, dev: mtb.init_state(
            b, *self.text_geometry, text_props, overlap_words, dev)
        ) if text_slots else None
        #: Cumulative mixed-tick rebalance attribution (from the kstats
        #: readback): the observed-locality input.
        self.rebalance_stats = {"ticks": 0, "fired": 0,
                                "blocks_touched": 0}
        self.matrix_vec_slots = matrix_vec_slots
        self.matrix_cell_slots = matrix_cell_slots
        self.matrix_k = matrix_k or (k if matrix_vec_slots else 0)
        self.matrix_state = per_shard(lambda b, dev: mxk.init_state(
            b, matrix_vec_slots, matrix_cell_slots, overlap_words, dev)
        ) if matrix_vec_slots else None
        self.tree_slots = tree_slots
        self.tree_k = tree_k or (k if tree_slots else 0)
        self.tree_state = per_shard(
            lambda b, dev: tk.init_state(b, tree_slots, dev)
        ) if tree_slots else None
        self._mixed = bool(text_slots or matrix_vec_slots or tree_slots)
        # Host-side text pools + capacity high-water marks for OWNED rows
        # (device overflow is silent by kernel contract, so admission
        # checks worst-case growth BEFORE the tick: 2 slots per text op,
        # 2 vector slots + 1 cell slot per matrix op).
        local_rows = range(self.local_lo, self.local_hi)
        self.text_pool = ({row: "" for row in local_rows}
                          if text_slots else {})
        self._text_high = ({row: 0 for row in local_rows}
                           if text_slots else {})
        self._mx_high = ({row: [0, 0, 0] for row in local_rows}
                         if matrix_vec_slots else {})  # [rows, cols, cells]
        # ONE handle counter per doc SHARED by both axes (the
        # deterministic in-sequence-order rule of dds/matrix.py).
        self._mx_handles = ({row: 0 for row in local_rows}
                            if matrix_vec_slots else {})
        # Contiguous per-host ranges — what multihost.local_docs reports
        # per process in a real multi-host launch.
        bounds = np.linspace(0, num_docs, num_hosts + 1).astype(int)
        self.hosts = [HostPort(i, int(bounds[i]), int(bounds[i + 1]))
                      for i in range(num_hosts)]
        self._pending: list[dict[int, _Sub]] = [dict()
                                                for _ in range(num_hosts)]
        # Durable columnar tick records per row (the scriptorium leg):
        # the replay source for host failover. Offsets in checkpoints are
        # ABSOLUTE record counts; trim_durable retires the prefix below
        # the fleet's checkpoint horizon.
        self.durable: dict[int, list[dict]] = {}
        self._durable_base: dict[int, int] = {}
        # Automatic retention: an assembly that never checkpoints must not
        # grow the log with total op history.
        self.durable_retention_ticks = max(1, durable_retention_ticks)
        #: row -> overflow count from the last tick's tree leg.
        self.last_tree_overflow: dict[int, int] = {}
        # Depth-N harvest pipeline: a tick's readbacks start copying at
        # enqueue and are harvested only after N later ticks are in
        # flight. Depth 0 = synchronous (tick returns its own harvest).
        self.pipeline_depth = max(0, pipeline_depth)
        self._inflight: list[dict] = []
        # Pinned readback buffers, one set per in-flight generation.
        self._staging: list[list | None] = [None] * (self.pipeline_depth
                                                     + 2)
        self._staging_idx = 0

    def route(self, row: int) -> HostPort:
        """The owning host of a document row (front-door routing)."""
        for port in self.hosts:
            if port.owns(row):
                return port
        raise KeyError(row)

    def _shard_of(self, row: int) -> int:
        for i, (lo, hi) in enumerate(self.shard_rows):
            if lo <= row < hi:
                return i
        raise ValueError(f"row {row} is not on this process's shards")

    # -- front door ------------------------------------------------------------

    def join_all(self, slot: int = 0, slots=None) -> None:
        """Sequence a CLIENT_JOIN on every document through the deli
        kernel (not state surgery). ``slots`` joins several client lanes
        per doc in one batch — text/matrix rows with multiple writers need
        every writer's lane active."""
        lanes = tuple(slots) if slots is not None else (slot,)
        for i, ((lo, hi), dev) in enumerate(zip(self.shard_rows,
                                                self.devices)):
            b = hi - lo
            ops = seqk.make_op_batch(
                [[dict(kind=int(MessageType.CLIENT_JOIN), slot=-1,
                       target=s, timestamp=1) for s in lanes]
                 for _ in range(b)], b, len(lanes), dev)
            self.seq_state[i], _out = seqc.process_batch_best(
                self.seq_state[i], ops)

    def _admit(self, row: int, sub: _Sub) -> None:
        """Common admission: ownership, one-sub-per-row-per-tick, family
        capacity bookkeeping, pool append. The replay path re-admits
        recorded subs through here so recovery is the ingest path."""
        port = self.route(row)
        pending = self._pending[port.host_id]
        if row in pending:
            raise ValueError(f"row {row} already pending this tick")
        if sub.family == "text":
            pool = self.text_pool[row]
            if len(pool) != sub.pool_base:
                raise ValueError(
                    f"row {row}: pool length {len(pool)} != submission "
                    f"base {sub.pool_base} (durable replay out of order?)")
            high = self._text_high[row] + 2 * sub.count
            if high > self.text_slots:
                raise ValueError(
                    f"row {row}: worst-case {high} segment slots exceeds "
                    f"{self.text_slots}; run compact_text() first")
            self._text_high[row] = high
            self.text_pool[row] = pool + sub.text
        elif sub.family == "matrix":
            high = self._mx_high[row]
            planes = sub.planes
            # Pre-encoded planes (bulk path / failover replay) carry their
            # own handle_bases: advance the row's allocator past them.
            ins = (((planes["target"] == mxk.MX_ROWS)
                    | (planes["target"] == mxk.MX_COLS))
                   & (planes["kind"] == mtk.MT_INSERT))[:sub.count]
            if ins.any():
                tops = (planes["handle_base"][:sub.count]
                        + np.maximum(planes["count"][:sub.count], 1))[ins]
                self._mx_handles[row] = max(self._mx_handles[row],
                                            int(tops.max()))
            n_row = int(np.sum((planes["target"] == mxk.MX_ROWS)[:sub.count]))
            n_col = int(np.sum((planes["target"] == mxk.MX_COLS)[:sub.count]))
            n_cell = sub.count - n_row - n_col
            grown = [high[0] + 2 * n_row, high[1] + 2 * n_col,
                     high[2] + n_cell]
            if (grown[0] > self.matrix_vec_slots
                    or grown[1] > self.matrix_vec_slots
                    or grown[2] > self.matrix_cell_slots):
                raise ValueError(
                    f"row {row}: matrix capacity exceeded {grown} vs "
                    f"({self.matrix_vec_slots}, {self.matrix_vec_slots}, "
                    f"{self.matrix_cell_slots})")
            self._mx_high[row] = grown
        pending[row] = sub

    def submit(self, row: int, words: np.ndarray, first_cseq: int,
               ref_seq: int = 1, client_slot: int = 0) -> None:
        """One map row's packed-word op batch into its OWNING host's
        buffer — a frame for a foreign row is a routing bug and raises."""
        if len(words) > self.k:
            raise ValueError(
                f"batch of {len(words)} ops exceeds tick width {self.k}")
        self._admit(row, _Sub("map", np.asarray(words, np.uint32),
                              len(words), first_cseq, ref_seq,
                              client_slot, "", 0))

    def submit_text(self, row: int, ops: list[dict], first_cseq: int,
                    ref_seq: int = 1, client_slot: int = 0) -> None:
        """One text row's merge-tree op batch (mtk.MT_* dicts; inserts
        carry ``text``). The owning host appends inserted text to the
        row's pool and fills pool_start/text_len; the device assigns seqs
        at the tick."""
        if self.merge_state is None:
            raise ValueError("assembly built without text_slots")
        if len(ops) > self.text_k:
            raise ValueError(f"{len(ops)} text ops exceed tick width "
                             f"{self.text_k}")
        pool_base = len(self.text_pool[row])
        blob: list[str] = []
        offset = 0
        encoded = []
        for op in ops:
            op = dict(op)
            if op.get("kind", mtk.MT_INSERT) == mtk.MT_INSERT:
                text = op.pop("text", "")
                op.setdefault("pool_start", pool_base + offset)
                op.setdefault("text_len", len(text))
                blob.append(text)
                offset += len(text)
            op.setdefault("ref_seq", ref_seq)
            op.setdefault("client", client_slot)
            encoded.append(op)
        planes = {f: np.array([op.get(f, 0) for op in encoded], np.int32)
                  for f in TEXT_FIELDS}
        self._admit(row, _Sub("text", planes, len(ops), first_cseq,
                              ref_seq, client_slot, "".join(blob),
                              pool_base))

    def submit_matrix(self, row: int, ops: list[dict], first_cseq: int,
                      ref_seq: int = 1, client_slot: int = 0) -> None:
        """One matrix row's op batch (mxk fields; vector inserts without
        ``handle_base`` draw from the row's deterministic in-sequence
        handle counter, mirroring dds/matrix.py)."""
        if self.matrix_state is None:
            raise ValueError("assembly built without matrix slots")
        if len(ops) > self.matrix_k:
            raise ValueError(f"{len(ops)} matrix ops exceed tick width "
                             f"{self.matrix_k}")
        encoded = []
        for op in ops:
            op = dict(op)
            target = op.get("target", mxk.MX_CELL)
            if (target in (mxk.MX_ROWS, mxk.MX_COLS)
                    and op.get("kind", 0) == mtk.MT_INSERT):
                # Pin the count BEFORE both consumers read it.
                op.setdefault("count", 1)
                if "handle_base" not in op:
                    op["handle_base"] = self._mx_handles[row]
                    self._mx_handles[row] += op["count"]
            op.setdefault("ref_seq", ref_seq)
            op.setdefault("client", client_slot)
            encoded.append(op)
        planes = {f: np.array([op.get(f, 0) for op in encoded], np.int32)
                  for f in MATRIX_FIELDS}
        self._admit(row, _Sub("matrix", planes, len(ops), first_cseq,
                              ref_seq, client_slot, "", 0))

    def submit_tree(self, row: int, ops: list[dict], first_cseq: int,
                    ref_seq: int = 1, client_slot: int = 0) -> None:
        """One tree row's op batch (tk.TREE_* dicts; node-slot management
        is the submitter's, as in the tree channel contract)."""
        if self.tree_state is None:
            raise ValueError("assembly built without tree_slots")
        if len(ops) > self.tree_k:
            raise ValueError(f"{len(ops)} tree ops exceed tick width "
                             f"{self.tree_k}")
        planes = {f: np.array([op.get(f, 0) for op in ops], np.int32)
                  for f in TREE_FIELDS}
        self._admit(row, _Sub("tree", planes, len(ops), first_cseq,
                              ref_seq, client_slot, "", 0))

    def submit_planes(self, row: int, family: str, planes: dict,
                      count: int, first_cseq: int, ref_seq: int = 1,
                      client_slot: int = 0, text: str = "",
                      pool_base: int | None = None) -> None:
        """Pre-encoded columnar admission — the decoded-frame fast path and
        the replay path's re-admission hook. ``planes`` carries the
        family's field arrays (text planes use ABSOLUTE pool_starts;
        ``text`` is the blob those offsets expect appended at
        ``pool_base``, default the row pool's current length)."""
        width = {"map": self.k, "text": self.text_k,
                 "matrix": self.matrix_k, "tree": self.tree_k}[family]
        if count > width:
            raise ValueError(
                f"{count} {family} ops exceed tick width {width}")
        if pool_base is None:
            pool_base = len(self.text_pool[row]) if family == "text" else 0
        self._admit(row, _Sub(family, planes, count, first_cseq, ref_seq,
                              client_slot, text, pool_base))

    # -- the sharded tick ------------------------------------------------------

    def _feed_shards(self, arrays: list) -> list:
        """Per-shard device tensors of host arrays with this process's
        rows on dim 0 (None entries stay None)."""
        out = []
        for (lo, hi), dev in zip(self.shard_rows, self.devices):
            a, b = lo - self.local_lo, hi - self.local_lo
            out.append([None if x is None else torch.from_numpy(
                np.ascontiguousarray(x[a:b])).to(dev) for x in arrays])
        return out

    def _stage(self, outs: list) -> list | None:
        """Pinned host buffers for one tick's per-shard readbacks (one
        generation of a ring of ``pipeline_depth + 2``, so a generation is
        never reused while its tick is in flight); None on the CPU."""
        if all(d.type != "cuda" for d in self.devices):
            return None
        self._staging_idx = (self._staging_idx + 1) % len(self._staging)
        gen = self._staging[self._staging_idx]
        shapes = [[(t.shape, t.dtype) for t in shard] for shard in outs]
        if gen is None or gen[0] != shapes:
            gen = (shapes, [[torch.empty(s, dtype=d, pin_memory=True)
                             for s, d in shard] for shard in shapes])
            self._staging[self._staging_idx] = gen
        return gen[1]

    def tick(self, now: int = 2):
        """Assemble every host's contribution, run the tick on every
        shard, and return each host's harvest of ITS OWN rows:
        {host_id: {row: (n_seq, first_seq, last_seq)}}."""
        from ..server import storm as storm_mod

        # Host buffers at LOCAL size (this process's doc rows): each
        # process feeds only its multihost.local_docs slice.
        lo, hi = self.local_lo, self.local_hi
        b_local = hi - lo
        slot = np.zeros(b_local, np.int32)
        cseq0 = np.zeros(b_local, np.int32)
        ref = np.zeros(b_local, np.int32)
        seq_counts = np.zeros(b_local, np.int32)
        map_words = np.zeros((b_local, self.k), np.uint32)
        map_counts = np.zeros(b_local, np.int32)
        # One packed i32[B_local, F, K] plane stack per configured family
        # (field orders pinned by storm.TEXT_PACK/MATRIX_PACK/TREE_PACK,
        # index 0 = valid).
        pack_fields = {"text": storm_mod.TEXT_PACK,
                       "matrix": storm_mod.MATRIX_PACK,
                       "tree": storm_mod.TREE_PACK}
        widths = {"text": self.text_k, "matrix": self.matrix_k,
                  "tree": self.tree_k}
        enabled = {"text": self.merge_state is not None,
                   "matrix": self.matrix_state is not None,
                   "tree": self.tree_state is not None}
        fam_pack = {
            name: (np.zeros((b_local, len(pack_fields[name]),
                             widths[name]), np.int32)
                   if enabled[name] else None)
            for name in pack_fields}

        submitted: list[tuple[int, int]] = []  # (host, row)
        records: dict[int, dict] = {}
        for port in self.hosts:
            for row, sub in self._pending[port.host_id].items():
                if not lo <= row < hi:
                    raise ValueError(
                        f"row {row} outside this process's doc range "
                        f"[{lo}, {hi}) cannot be fed from here")
                r = row - lo
                n = sub.count
                seq_counts[r] = n
                cseq0[r] = sub.cseq0
                ref[r] = sub.ref
                slot[r] = sub.client
                if sub.family == "map":
                    map_counts[r] = n
                    map_words[r, :n] = sub.planes
                else:
                    pack = fam_pack[sub.family]
                    pack[r, 0, :n] = 1
                    for i, f in enumerate(pack_fields[sub.family][1:]):
                        pack[r, i + 1, :n] = sub.planes[f]
                submitted.append((port.host_id, row))
                rec_planes = (np.array(sub.planes, np.uint32)
                              if sub.family == "map"
                              else {f: p.copy()
                                    for f, p in sub.planes.items()})
                records[row] = dict(
                    family=sub.family, planes=rec_planes,
                    count=n, cseq0=sub.cseq0, ref=sub.ref,
                    client=sub.client, text=sub.text,
                    pool_base=sub.pool_base,
                    # Back-compat alias for the map-words record shape
                    # (same object — not a second copy).
                    words=(rec_planes if sub.family == "map" else None))

        words_i32 = map_words.view(np.int32)
        tree_overflow = text_overflow = kstats = None
        if not self._mixed:
            fed = self._feed_shards([slot, cseq0, ref,
                                     np.full(b_local, now, np.int32),
                                     seq_counts, words_i32, map_counts])
            outs = []
            for i, (s_slot, s_cseq0, s_ref, s_ts, s_counts, s_words,
                    s_mcounts) in enumerate(fed):
                gather = torch.arange(s_slot.shape[0], dtype=torch.int32,
                                      device=s_slot.device)
                (self.seq_state[i], self.map_state[i], n_seq, first, last,
                 _msn, _bad, _kstats) = storm_mod._storm_tick(
                    self.seq_state[i], self.map_state[i], s_slot, s_cseq0,
                    s_ref, s_ts, s_counts, gather, s_words, s_mcounts)
                outs.append((n_seq, first, last))
        else:
            scalars = np.stack(
                [slot, cseq0, ref, np.full(b_local, now, np.int32),
                 seq_counts, map_counts], axis=1)
            steps = None
            if enabled["tree"]:
                # Steps from the HOST's pack, before the ticket window
                # masks anything: a superset of the detaches and moves
                # that apply, so skipping the other steps stays exact.
                p = fam_pack["tree"]
                kinds = np.isin(p[:, 1], list(tk.SUBTREE_KINDS)) \
                    & (p[:, 0] != 0)
                steps = [bool(x) for x in kinds.any(axis=0)]
            fed = self._feed_shards([scalars, words_i32, fam_pack["text"],
                                     fam_pack["matrix"], fam_pack["tree"]])
            shards = [(self.seq_state[i], self.map_state[i],
                       self._at(self.merge_state, i),
                       self._at(self.matrix_state, i),
                       self._at(self.tree_state, i), *fed[i])
                      for i in range(len(fed))]
            results = storm_mod._mixed_tick_shards(
                shards, tree_steps=steps, mesh=self.mesh)
            outs = []
            for i, res in enumerate(results):
                self.seq_state[i], self.map_state[i] = res[0], res[1]
                if self.merge_state is not None:
                    self.merge_state[i] = res[2]
                if self.matrix_state is not None:
                    self.matrix_state[i] = res[3]
                if self.tree_state is not None:
                    self.tree_state[i] = res[4]
                outs.append(tuple(x for x in (res[5], res[6], res[7],
                                              res[9], res[10], res[11])
                                  if x is not None))
            tree_overflow = enabled["tree"]
            text_overflow = enabled["text"]
            kstats = True
        # The device has the batch; only now may buffers drop
        # (at-least-once: an assembly failure above must keep them).
        for port in self.hosts:
            self._pending[port.host_id] = {}
        # Pipeline: start this tick's device→host copies at enqueue;
        # harvest once ``pipeline_depth`` later ticks are in flight.
        host = self._stage(outs)
        readbacks = [storm_mod._Readback(shard, None if host is None
                                         else host[i])
                     for i, shard in enumerate(outs)]
        rec = dict(submitted=submitted, records=records,
                   readbacks=readbacks, tree_overflow=tree_overflow,
                   text_overflow=text_overflow, kstats=kstats)
        self._inflight.append(rec)
        if len(self._inflight) > self.pipeline_depth:
            return self._harvest_rec(self._inflight.pop(0))
        return {port.host_id: {} for port in self.hosts}

    @staticmethod
    def _at(states, i):
        return None if states is None else states[i]

    def flush(self) -> list[dict[int, dict[int, tuple[int, int, int]]]]:
        """Drain the harvest pipeline; one {host: {row: ack}} dict per
        outstanding tick, oldest first (acks must not collapse across
        ticks — a client matches each to its frame)."""
        out = []
        while self._inflight:
            out.append(self._harvest_rec(self._inflight.pop(0)))
        return out

    def _harvest_rec(self, rec: dict
                     ) -> dict[int, dict[int, tuple[int, int, int]]]:
        # Shard-local harvest: each host reads ONLY the rows of this
        # process's shards.
        arrays = [rb.wait() for rb in rec["readbacks"]]
        cols = list(zip(*arrays))
        n_seq_l = _addressable_rows(cols[0], self.shard_rows)
        first_l = _addressable_rows(cols[1], self.shard_rows)
        last_l = _addressable_rows(cols[2], self.shard_rows)
        extra = iter(cols[3:])
        tree_ovf = next(extra) if rec["tree_overflow"] else None
        text_ovf = next(extra) if rec["text_overflow"] else None
        kstats = next(extra) if rec["kstats"] else None
        records = rec["records"]
        harvest: dict[int, dict[int, tuple[int, int, int]]] = {
            port.host_id: {} for port in self.hosts}
        for host_id, row in rec["submitted"]:
            n_ok = n_seq_l[row]
            harvest[host_id][row] = ((n_ok, first_l[row], last_l[row])
                                     if n_ok > 0 else (0, 0, 0))
            # scriptorium: the durable columnar record for this (row,
            # tick) — the failover replay source.
            row_rec = records[row]
            row_rec.update(n_seq=n_ok, first=first_l[row],
                           last=last_l[row])
            log = self.durable.setdefault(row, [])
            log.append(row_rec)
            overflow = len(log) - self.durable_retention_ticks
            if overflow > 0:
                del log[:overflow]
                self._durable_base[row] = (
                    self._durable_base.get(row, 0) + overflow)
        if tree_ovf is not None:
            self.last_tree_overflow = {
                row: n for row, n in _addressable_rows(
                    tree_ovf, self.shard_rows).items() if n > 0}
            if self.last_tree_overflow:
                raise RuntimeError(
                    f"tree rank overflow on rows "
                    f"{sorted(self.last_tree_overflow)}; host re-rank "
                    "required (size tree ranks for the tick width)")
        if kstats is not None:
            from ..server import storm as storm_mod
            # The rebalance cells are batch-wide (every shard holds the
            # same two numbers).
            ks = np.asarray(kstats[0])
            self.rebalance_stats["ticks"] += 1
            self.rebalance_stats["fired"] += int(
                ks[storm_mod.KSTAT_REBALANCE_FIRED])
            self.rebalance_stats["blocks_touched"] += int(
                ks[storm_mod.KSTAT_BLOCKS_TOUCHED])
        if text_ovf is not None:
            # choose_block_geometry + the per-tick ladder make this
            # unreachable for capacity-checked admissions; a hit means the
            # geometry contract was violated — fail loudly.
            overflowed = {
                row: idx for row, idx in _addressable_rows(
                    text_ovf, self.shard_rows).items()
                if idx != int(mtb.OVF_NONE)}
            if overflowed:
                raise RuntimeError(
                    f"text block overflow on rows {sorted(overflowed)}; "
                    "size text blocks for the tick width")
        return harvest

    # -- capacity maintenance --------------------------------------------------

    def observed_head_fraction(self) -> float:
        """Fraction of mixed ticks whose block-table rebalance fired —
        the op-locality estimate :meth:`retune_text_geometry` takes."""
        ticks = self.rebalance_stats["ticks"]
        if ticks == 0:
            return 0.0
        return self.rebalance_stats["fired"] / ticks

    def retune_text_geometry(self, head_fraction: float | None = None
                             ) -> tuple[int, int]:
        """Re-derive the text block geometry from observed op locality
        and re-block the live table in place (between ticks): a pure
        re-layout through the packed flat form, deterministic in (state,
        head_fraction). Returns the (possibly unchanged) geometry."""
        if self.merge_state is None:
            raise ValueError("assembly built without text_slots")
        if head_fraction is None:
            head_fraction = self.observed_head_fraction()
        nb, bk = mtb.choose_block_geometry(self.text_slots, self.text_k,
                                           head_fraction)
        if (nb, bk) == self.text_geometry:
            return self.text_geometry
        # Chaos kill class "mid-retune": the layout is about to move.
        faults.crashpoint("pool.mid_retune")
        self.merge_state = [mtb.from_flat(mtb.to_flat(ms, slots=nb * bk),
                                          nb) for ms in self.merge_state]
        self.text_geometry = (nb, bk)
        self.rebalance_stats = {"ticks": 0, "fired": 0,
                                "blocks_touched": 0}
        return self.text_geometry

    def compact_text(self) -> None:
        """Zamboni over every text row (the block rebalance at each doc's
        device MSN), then refresh the host's admission high-water marks
        from the REAL device slot counts."""
        if self.merge_state is None:
            raise ValueError("assembly built without text_slots")
        self.merge_state = [mtb.rebalance(ms, ss.msn) for ms, ss
                            in zip(self.merge_state, self.seq_state)]
        counts = _addressable_rows([ms.count.cpu().numpy()
                                    for ms in self.merge_state],
                                   self.shard_rows)
        for row, count in counts.items():
            if row in self._text_high:
                self._text_high[row] = int(count)
        # Submissions admitted but not yet ticked kept their worst-case
        # charge against the PRE-compact mark; re-charge them.
        for pending in self._pending:
            for row, sub in pending.items():
                if sub.family == "text":
                    self._text_high[row] += 2 * sub.count

    def durable_offset(self, row: int) -> int:
        """Absolute record count of a row's durable log (checkpoint
        cursor)."""
        return (self._durable_base.get(row, 0)
                + len(self.durable.get(row, [])))

    def trim_durable(self, horizons: dict[int, int]) -> None:
        """Retire durable records below the given ABSOLUTE per-row
        offsets — call with the minimum checkpointed offset across hosts
        (the Kafka log-retention analog)."""
        for row, horizon in horizons.items():
            base = self._durable_base.get(row, 0)
            cut = max(0, min(horizon - base,
                             len(self.durable.get(row, []))))
            if cut:
                del self.durable[row][:cut]
                self._durable_base[row] = base + cut

    # -- failover (checkpointManager.ts:24 analog) -----------------------------

    def _family_states(self) -> dict[str, list]:
        out: dict[str, list] = {"seq": self.seq_state,
                                "map": self.map_state}
        if self.merge_state is not None:
            out["text"] = self.merge_state
        if self.matrix_state is not None:
            out["matrix"] = self.matrix_state
        if self.tree_state is not None:
            out["tree"] = self.tree_state
        return out

    def family_rows(self, name: str, port: HostPort | None = None):
        """Host (numpy) copy of one family's rows in ``port``'s range
        (this process's whole range by default): a NamedTuple of arrays."""
        if port is None:
            port = HostPort(-1, self.local_lo, self.local_hi)
        shards = self._family_states()[name]
        return tree_map(lambda *planes: _plane_rows(planes, self.shard_rows,
                                                    port), *shards)

    def _write_rows(self, name: str, rows: np.ndarray, values) -> None:
        """Install host rows (a NamedTuple/dict tree of arrays, one entry
        per ``rows``) into one family's shards, in place."""
        shards = self._family_states()[name]
        rows = np.asarray(rows)
        for i, (lo, hi) in enumerate(self.shard_rows):
            sel = np.flatnonzero((rows >= lo) & (rows < hi))
            if not len(sel):
                continue
            idx = torch.from_numpy(rows[sel] - lo)

            def put(plane, vals, idx=idx, sel=sel):
                src = torch.as_tensor(np.asarray(vals)[sel])
                plane[idx.to(plane.device)] = src.to(plane.device,
                                                     plane.dtype)
            tree_map(put, shards[i], _like(shards[i], values))

    def checkpoint_host(self, host_id: int) -> dict:
        """Durable snapshot of one host's rows across EVERY family state
        (+ text pools + per-row durable-log offsets), consistent BY
        CONSTRUCTION when taken between ticks. Harvests of ticks still in
        the pipeline are returned under ``"drained"`` — each ack matches a
        client frame, so the caller must deliver them."""
        drained = self.flush()  # durable log must cover in-flight ticks
        port = self.hosts[host_id]
        states = {name: self.family_rows(name, port)
                  for name in self._family_states()}
        return {
            "host_id": host_id,
            "start": port.start,
            "stop": port.stop,
            "drained": drained,
            "states": states,
            "seq": dict(states["seq"]._asdict()),
            "map": dict(states["map"]._asdict()),
            "text_pool": {row: self.text_pool[row]
                          for row in range(port.start, port.stop)
                          if row in self.text_pool},
            "log_offsets": {row: self.durable_offset(row)
                            for row in range(port.start, port.stop)},
        }

    def rebalance_from(self, dead_host_id: int, target_host_id: int
                       ) -> None:
        """Reassign a dead host's doc range to a surviving neighbour (the
        Kafka partition-reassignment analog). Ranges stay contiguous."""
        dead = self.hosts[dead_host_id]
        target = self.hosts[target_host_id]
        if dead.stop != target.start and target.stop != dead.start:
            raise ValueError("rebalance target must be an adjacent range")
        merged = HostPort(target.host_id, min(dead.start, target.start),
                          max(dead.stop, target.stop))
        self.hosts[target_host_id] = merged
        self.hosts[dead_host_id] = HostPort(dead.host_id, dead.start,
                                            dead.start)  # empty range
        # The dead host's buffered frames are LOST (at-least-once:
        # clients resend un-acked frames to the new owner).
        self._pending[dead_host_id] = {}

    def restore_host(self, checkpoint: dict,
                     durable: dict[int, list[dict]],
                     durable_base: dict[int, int]) -> None:
        """Install a dead host's checkpointed rows into THIS assembly and
        replay its durable-log tail through the REAL tick path — map,
        text, matrix and tree records alike. The restored sequencer
        counters resume seq assignment exactly where the log ends, and
        clientSeq dedup makes an overlapping replay idempotent.
        Submissions route via the CURRENT host ranges, so run
        :meth:`rebalance_from` first."""
        lo, hi = checkpoint["start"], checkpoint["stop"]
        idx = np.arange(lo, hi)
        states = checkpoint.get("states")
        if states is None:  # legacy two-family checkpoint shape
            states = {"seq": seqk.SequencerState(**checkpoint["seq"]),
                      "map": mk.MapState(**checkpoint["map"])}
        self._write_rows("seq", idx, states["seq"])
        self._write_rows("map", idx, states["map"])
        if "text" in states:
            self._write_rows("text", idx, states["text"])
        if "matrix" in states:
            self._write_rows("matrix", idx, states["matrix"])
            # Rebuild the host-side handle allocators + admission marks
            # from the RESTORED planes: the next free handle is one past
            # the highest handle any live-or-tombstoned vector run covers,
            # and the admission high-water is the real slot count.
            mx = states["matrix"]
            for offset in range(hi - lo):
                row = lo + offset
                if row not in self._mx_handles:
                    continue
                tops = [0]
                for axis in (mx.rows, mx.cols):
                    valid = np.asarray(axis.valid[offset])
                    if valid.any():
                        tops.append(int(
                            (np.asarray(axis.pool_start[offset])
                             + np.asarray(axis.length[offset]))[valid]
                            .max()))
                self._mx_handles[row] = max(tops)
                self._mx_high[row] = [
                    int(np.asarray(mx.rows.count[offset])),
                    int(np.asarray(mx.cols.count[offset])),
                    int(np.asarray(mx.cell_count[offset]))]
        if "tree" in states:
            self._write_rows("tree", idx, states["tree"])
        for row, pool in checkpoint.get("text_pool", {}).items():
            self.text_pool[row] = pool
        if self.merge_state is not None and checkpoint.get("text_pool"):
            # Admission high-water = the restored rows' REAL slot counts.
            counts = _addressable_rows([ms.count.cpu().numpy()
                                        for ms in self.merge_state],
                                       self.shard_rows)
            for row in checkpoint["text_pool"]:
                if row in self._text_high and row in counts:
                    self._text_high[row] = counts[row]

        # Replay the tail one logged tick at a time (records of one row
        # are strictly ordered; distinct rows may interleave freely).
        def tail_of(row: int) -> list[dict]:
            # Offsets are ABSOLUTE, so the source log's base is required.
            records = durable.get(row, [])
            start = (checkpoint["log_offsets"].get(row, 0)
                     - durable_base.get(row, 0))
            if start < 0:
                raise ValueError(
                    f"row {row}: durable log trimmed past the checkpoint")
            return records[start:]

        depth = max((len(tail_of(row)) for row in range(lo, hi)),
                    default=0)
        for i in range(depth):
            for row in range(lo, hi):
                tail = tail_of(row)
                if i < len(tail):
                    rec = tail[i]
                    family = rec.get("family", "map")
                    if family == "map":
                        self.submit(row, rec.get("planes", rec["words"]),
                                    rec["cseq0"], rec["ref"],
                                    rec.get("client", 0))
                    else:
                        # Recorded planes carry absolute pool_starts;
                        # _admit re-verifies the pool base and re-extends
                        # the pool with the recorded blob.
                        self.submit_planes(
                            row, family, rec["planes"], rec["count"],
                            rec["cseq0"], rec["ref"], rec["client"],
                            text=rec["text"], pool_base=rec["pool_base"])
            self.tick()
        self.flush()

    # -- observability ---------------------------------------------------------

    def global_metrics(self) -> dict[str, int]:
        """Sum over the mesh: total sequenced ops + live keys across every
        host's documents (the cross-partition metrics roll-up)."""
        totals = aggregate_metrics(self.mesh, [
            {"seq": ss.seq,
             "present": ms.present.to(torch.int32).sum(dim=1,
                                                       dtype=torch.int32)}
            for ss, ms in zip(self.seq_state, self.map_state)])
        return {name: int(value) for name, value in totals.items()}

    def map_rows(self) -> np.ndarray:
        """Converged map value plane (host copy) of this process's rows —
        every row for a single process."""
        return self.family_rows("map").value

    def local_map_rows(self) -> dict[int, np.ndarray]:
        """{row: value plane} for the rows on THIS process's shards — the
        multi-process verification surface."""
        values = self.map_rows()
        return {self.local_lo + i: values[i] for i in range(len(values))}

    def text_of(self, row: int) -> str:
        """Materialized visible text of one OWNED text row (host copy of
        the row's segment table + the host pool)."""
        if self.merge_state is None:
            raise ValueError("assembly built without text_slots")
        state1 = self.family_rows("text", HostPort(-1, row, row + 1))
        state1 = tree_map(torch.from_numpy, state1)
        pool = mtk.TextPool(1)
        pool.append(0, self.text_pool[row])
        return mtb.materialize(state1, pool, 0)


def _like(template, values):
    """``values`` (a NamedTuple or dict of arrays, possibly another
    package's NamedTuple type) in ``template``'s NamedTuple shape."""
    if hasattr(template, "_fields"):
        get = (values.get if isinstance(values, dict)
               else lambda f: getattr(values, f))
        return type(template)(*(_like(getattr(template, f), get(f))
                                for f in template._fields))
    return values


class ShardResidency:
    """Per-shard tiered doc residency over one :class:`ShardedServing`
    assembly: each host range is a fixed pool of device rows, and the
    REGISTERED document population (doc ids) can be arbitrarily larger. A
    resident doc owns one row inside its owning host's range; a cold doc
    is one host-side record (its row's planes across every family + text
    pool + durable log tail) and zero device rows.

    :meth:`resolve` is the front door: it returns the doc's row, hydrating
    on miss — restore the cold record into a recycled row, or CLIENT_JOIN
    the configured lanes through the deli kernel for a first-touch doc
    (never state surgery: a recycled row's blanked clientSeq table MUST
    re-join). When the host range is full the LRU resident evicts first; a
    doc with a pending (unticked) submission refuses eviction.

    Determinism: recency is dict insertion order, not wall time —
    identical resolve/submit sequences make identical placement decisions
    on every host. Single-process scope: each process manages ONLY rows
    inside its ``multihost.local_docs`` slice."""

    def __init__(self, serving: ShardedServing,
                 join_slots: tuple[int, ...] = (0,),
                 active_hosts: tuple[int, ...] | None = None) -> None:
        self.serving = serving
        self._join_slots = tuple(join_slots)
        # Free rows per host = the host's range within this process's
        # slice (reversed so pops hand out low rows first).
        self._free = {
            p.host_id: list(range(
                max(p.start, serving.local_lo),
                min(p.stop, serving.local_hi)))[::-1]
            for p in serving.hosts}
        self.row_of: dict[str, int] = {}
        self._doc_of: dict[int, str] = {}
        # Insertion-ordered dict as the LRU spine.
        self._lru: dict[str, None] = {}
        #: doc_id -> cold record (the demoted row's full state).
        self.cold: dict[str, dict] = {}
        # LIVE placement directory: the hash default is pinned to the
        # GENESIS active-host set — activating a host later must never
        # silently re-route a doc whose state lives elsewhere.
        self.active = (list(active_hosts) if active_hosts is not None
                       else [p.host_id for p in serving.hosts])
        self._genesis = tuple(self.active)
        #: doc -> host overlay (migrated docs); absent = genesis hash.
        self.placement: dict[str, int] = {}
        self.stats = {"hydrations": 0, "cold_hydrations": 0,
                      "evictions": 0, "migrations": 0}
        #: Per-migration blackout seconds (freeze -> serving again).
        self.blackouts_s: list[float] = []
        self._blank1: tuple[Any, dict] | None = None  # (geometry, states)

    # -- directory -------------------------------------------------------------

    def host_for(self, doc_id: str) -> int:
        """The doc's CURRENT owning host: the migration overlay when
        present, else the stable genesis hash."""
        host = self.placement.get(doc_id)
        if host is not None:
            return host
        return self._genesis[zlib.crc32(doc_id.encode())
                             % len(self._genesis)]

    def activate_host(self, host_id: int) -> None:
        """Bring one host range online as a migration TARGET: existing
        docs keep their genesis-hash homes until migrated."""
        if host_id not in range(len(self.serving.hosts)):
            raise KeyError(host_id)
        if host_id not in self.active:
            self.active.append(host_id)

    def hosts_list(self) -> list[int]:
        """Active host ids (the placement-controller backend surface)."""
        return list(self.active)

    def owned(self, host_id: int) -> list[str]:
        """Docs this host currently owns, cold first, then residents in
        LRU order."""
        return ([d for d in self.cold if self.host_for(d) == host_id]
                + [d for d in self._lru if self.host_for(d) == host_id])

    def load_signals(self, host_id: int) -> dict:
        """One host's load inputs: owned docs and pending submissions."""
        return {"docs": len(self.owned(host_id)),
                "queue_depth": len(self.serving._pending[host_id]),
                "tick_cost_ms": 0.0}

    def migrate(self, doc_id: str, target_host: int) -> int | None:
        """LIVE migration of one doc to another host range: evict to the
        cold record, flip the directory, hydrate into the target's row
        pool. Eviction refuses while a submission is pending. Returns the
        new row (None when the doc was cold)."""
        if target_host not in range(len(self.serving.hosts)):
            raise KeyError(target_host)
        if target_host not in self.active:
            raise ValueError(f"host {target_host} is not active")
        src = self.host_for(doc_id)
        if target_host == src:
            return self.row_of.get(doc_id)
        t0 = _time.perf_counter()
        was_resident = doc_id in self.row_of
        faults.crashpoint("placement.pre_evict")
        if was_resident:
            self.evict(doc_id)  # refuses while a submission is pending
        faults.crashpoint("placement.post_evict")
        self.placement[doc_id] = target_host
        row = None
        if was_resident:
            row = self.resolve(doc_id, host_id=target_host)
        faults.crashpoint("placement.post_hydrate")
        self.stats["migrations"] += 1
        self.blackouts_s.append(_time.perf_counter() - t0)
        return row

    def is_resident(self, doc_id: str) -> bool:
        return doc_id in self.row_of

    def resident_count(self, host_id: int | None = None) -> int:
        if host_id is None:
            return len(self.row_of)
        port = self.serving.hosts[host_id]
        return sum(1 for row in self._doc_of if port.owns(row))

    def _touch(self, doc_id: str) -> None:
        self._lru.pop(doc_id, None)
        self._lru[doc_id] = None

    # -- hydration -------------------------------------------------------------

    def resolve(self, doc_id: str, host_id: int | None = None) -> int:
        """The doc's device row, hydrating it on miss (possibly evicting
        the owning host's LRU resident to free a row)."""
        row = self.row_of.get(doc_id)
        if row is not None:
            self._touch(doc_id)
            return row
        if host_id is None:
            host_id = self.host_for(doc_id)
        port = self.serving.hosts[host_id]
        free = self._free[host_id]
        if not free:
            pending = self.serving._pending[host_id]
            victim = next(
                (d for d in self._lru
                 if port.owns(self.row_of[d])
                 and self.row_of[d] not in pending), None)
            if victim is None:
                raise RuntimeError(
                    f"host {host_id} has no free or evictable row for "
                    f"{doc_id!r} (every resident has a pending "
                    "submission — tick first)")
            self.evict(victim)
        row = free.pop()
        cold = self.cold.pop(doc_id, None)
        if cold is not None:
            self._restore(row, cold)
            self.stats["cold_hydrations"] += 1
        else:
            self._join_fresh(row)
        self.row_of[doc_id] = row
        self._doc_of[row] = doc_id
        self._touch(doc_id)
        self.stats["hydrations"] += 1
        return row

    def _join_fresh(self, row: int) -> None:
        """Activate a first-touch doc's client lanes through the deli
        kernel (the row's shard runs one JOIN batch; its other rows carry
        zero valid ops)."""
        s = self.serving
        if not self._join_slots:
            return
        i = s._shard_of(row)
        lo, hi = s.shard_rows[i]
        per_row: list[list[dict]] = [[] for _ in range(hi - lo)]
        per_row[row - lo] = [
            dict(kind=int(MessageType.CLIENT_JOIN), slot=-1, target=lane,
                 timestamp=1) for lane in self._join_slots]
        ops = seqk.make_op_batch(per_row, hi - lo, len(self._join_slots),
                                 s.devices[i])
        s.seq_state[i], _out = seqc.process_batch_best(s.seq_state[i], ops)

    def _restore(self, row: int, rec: dict) -> None:
        s = self.serving
        for name, planes in rec["states"].items():
            if name not in s._family_states():
                raise ValueError(f"unknown family {name!r}")
            s._write_rows(name, np.array([row]), planes)
        if "text_pool" in rec and row in s.text_pool:
            s.text_pool[row] = rec["text_pool"]
            s._text_high[row] = rec["text_high"]
        if "mx_high" in rec and row in s._mx_high:
            s._mx_high[row] = list(rec["mx_high"])
            s._mx_handles[row] = rec["mx_handles"]
        if rec["durable"]:
            s.durable[row] = rec["durable"]
        if rec["durable_base"]:
            s._durable_base[row] = rec["durable_base"]

    # -- eviction --------------------------------------------------------------

    def evict(self, doc_id: str) -> None:
        """Demote one resident doc: export its row's planes (every family)
        + host bookkeeping into a cold record, blank the row to init fills
        and recycle it. The row's durable log travels with the doc."""
        s = self.serving
        row = self.row_of[doc_id]
        port = s.route(row)
        if row in s._pending[port.host_id]:
            raise ValueError(
                f"{doc_id!r} (row {row}) has a pending submission — "
                "tick before evicting")
        if s._inflight:
            s.flush()  # the durable log must cover in-flight ticks
        port1 = HostPort(-1, row, row + 1)
        rec: dict[str, Any] = {
            "states": {name: s.family_rows(name, port1)
                       for name in s._family_states()},
            "durable": s.durable.pop(row, []),
            "durable_base": s._durable_base.pop(row, 0),
        }
        if row in s.text_pool:
            rec["text_pool"] = s.text_pool[row]
            rec["text_high"] = s._text_high[row]
        if row in s._mx_high:
            rec["mx_high"] = list(s._mx_high[row])
            rec["mx_handles"] = s._mx_handles[row]
        self.cold[doc_id] = rec
        self._blank(row)
        del self.row_of[doc_id]
        del self._doc_of[row]
        self._lru.pop(doc_id, None)
        self._free[port.host_id].append(row)
        self.stats["evictions"] += 1

    def _blank(self, row: int) -> None:
        s = self.serving
        if self._blank1 is None or self._blank1[0] != s.text_geometry:
            overlap = mtk.overlap_words_for(s.num_clients)
            states: dict[str, Any] = {
                "seq": seqk.init_state(1, s.num_clients + 1, "cpu"),
                "map": mk.init_state(1, s.map_slots, "cpu")}
            if s.merge_state is not None:
                states["text"] = mtb.init_state(
                    1, *s.text_geometry, s.text_props, overlap, "cpu")
            if s.matrix_state is not None:
                states["matrix"] = mxk.init_state(
                    1, s.matrix_vec_slots, s.matrix_cell_slots, overlap,
                    "cpu")
            if s.tree_state is not None:
                states["tree"] = tk.init_state(1, s.tree_slots, "cpu")
            self._blank1 = (s.text_geometry,
                            tree_map(lambda t: t.numpy(), states))
        for name, planes in self._blank1[1].items():
            s._write_rows(name, np.array([row]), planes)
        if row in s.text_pool:
            s.text_pool[row] = ""
            s._text_high[row] = 0
        if row in s._mx_high:
            s._mx_high[row] = [0, 0, 0]
            s._mx_handles[row] = 0

    def evict_idle(self, keep_per_host: int) -> list[str]:
        """Shrink every host's resident set to ``keep_per_host`` by
        evicting LRU residents (pending-submission docs are skipped)."""
        evicted: list[str] = []
        for port in self.serving.hosts:
            excess = self.resident_count(port.host_id) - keep_per_host
            if excess <= 0:
                continue
            for doc in [d for d in self._lru
                        if port.owns(self.row_of[d])]:
                if excess <= 0:
                    break
                row = self.row_of[doc]
                if row in self.serving._pending[port.host_id]:
                    continue
                self.evict(doc)
                evicted.append(doc)
                excess -= 1
        return evicted


class MegaDocLanes:
    """ONE logical document spread over several ROWS of a
    :class:`ShardedServing` assembly — the lane-placement face of the
    mega-doc write tier (rows shard over the mesh, so L lanes are L
    device lanes). Writers hash to lanes (``megadoc.lane_of_writer``);
    the doc-space :class:`~..server.megadoc.DocSequencerMirror` is the
    combiner (dup/gap/refseq/MSN in doc space, doc seqs stamped in
    submission order — the single-row interleaving); each lane's cleaned
    batch sequences on its OWN row through the real device kernel, and
    the converged doc map is the cross-lane LWW fold
    (:func:`~..server.megadoc.fold_map_rows`) through each lane's
    combine log. Lane rows take ref 0 (the doc-space refseq law already
    ran in the mirror). Map-words family only — the text family's
    sequence-parallel serving lives in the merge host's
    ``promote_merge_row`` tier.

    Single-process scope (the verification shape): the lane rows are
    read from this process's shards, one gather per shard."""

    def __init__(self, serving: ShardedServing,
                 lane_rows: list[int]) -> None:
        from ..server.megadoc import DocSequencerMirror, LaneCombineLog
        if not lane_rows:
            raise ValueError("need at least one lane row")
        self.serving = serving
        self.rows = list(lane_rows)
        self.mirror = DocSequencerMirror()
        self.logs = [LaneCombineLog() for _ in self.rows]
        # Construct AFTER join_all: each lane row's device seq already
        # counts its slot joins, and the combine log must number lane
        # seqs in the DEVICE's space (the map fold's vseq plane carries
        # them) — anchor the log's high water there.
        seqs = self._lane_planes("seq", ("seq",))["seq"]
        for lane in range(len(self.rows)):
            self.logs[lane].seq = int(seqs[lane])
        self._slot_of: dict[str, int] = {}
        self._lane_fill = [0] * len(self.rows)

    def _lane_planes(self, family: str, names: tuple[str, ...]
                     ) -> dict[str, np.ndarray]:
        """Host copy of one family's named planes at the lane rows (lane
        order): per shard holding lanes, ONE gather of the planes packed
        side by side as int32 and ONE device→host copy."""
        serving = self.serving
        shards = serving._family_states()[family]
        by_shard: dict[int, list[int]] = {}
        for lane, row in enumerate(self.rows):
            by_shard.setdefault(serving._shard_of(row), []).append(lane)
        out: dict[str, np.ndarray] = {}
        for i, lanes in by_shard.items():
            lo = serving.shard_rows[i][0]
            state = shards[i]
            planes = [getattr(state, n) for n in names]
            idx = torch.as_tensor([self.rows[j] - lo for j in lanes],
                                  dtype=torch.long,
                                  device=planes[0].device)
            cols = [p[idx].to(torch.int32).reshape(len(lanes), -1)
                    for p in planes]
            packed = torch.cat(cols, dim=1).cpu().numpy()
            at = 0
            for n, p, c in zip(names, planes, cols):
                width = c.shape[1]
                part = packed[:, at:at + width].reshape(
                    (len(lanes),) + tuple(p.shape[1:]))
                at += width
                if n not in out:
                    out[n] = np.zeros((len(self.rows),) + part.shape[1:],
                                      np.bool_ if p.dtype == torch.bool
                                      else np.int32)
                out[n][lanes] = part
        return out

    def join(self, client: str) -> tuple[int, int]:
        """Register a writer: lane by stable hash, client slot within
        the lane's row in join order (the row's joined lanes are the
        capacity — join_all(slots=...) them first). A join revs the
        LOGICAL doc's seq exactly as a sequenced CLIENT_JOIN revs a
        single row's, so the doc seq stream matches a single-row twin
        whose writers joined the same way. Returns (lane, slot)."""
        w = self.mirror.writers.get(client)
        if w is None:
            w = self.mirror.adopt(client, len(self.rows), clu=1)
            self.mirror.seq += 1  # the join's seq rev
        if client in self._slot_of:
            return w.lane, self._slot_of[client]
        slot = self._lane_fill[w.lane]
        if slot >= self.serving.num_clients:
            raise ValueError(
                f"lane {w.lane} writer slots exhausted "
                f"({self.serving.num_clients}); build the assembly with "
                "more num_clients")
        self._lane_fill[w.lane] += 1
        self._slot_of[client] = slot
        return w.lane, slot

    def submit(self, client: str, words, first_cseq: int,
               ref_seq: int = 1):
        """One writer batch through the combiner: the doc-space ticket
        decides (dups trimmed, zero-op outcomes never touch a lane),
        the cleaned batch rides the writer's lane row, and the returned
        :class:`~..server.megadoc.Decision` carries the doc-space ack
        quad."""
        w = self.mirror.writers.get(client)
        if w is None:
            self.join(client)
            w = self.mirror.writers[client]
        dec = self.mirror.decide(client, first_cseq, ref_seq,
                                 len(words), ts=1)
        if dec.n_seq == 0:
            return dec
        lane = w.lane
        row = self.rows[lane]
        port = self.serving.route(row)
        if row in self.serving._pending[port.host_id]:
            # Lane collision (one submission per row per tick): run the
            # pending tick first. Doc seqs were already stamped at
            # decide time, so tick boundaries never reorder the doc.
            self.serving.tick()
        self.logs[lane].append(dec.n_seq, dec.first, dec.msn)
        lane_cseq0 = (first_cseq + dec.dups) - w.offset
        self.serving.submit(self.rows[lane],
                            np.asarray(words, np.uint32)[dec.dups:],
                            lane_cseq0, ref_seq=0,
                            client_slot=self._slot_of[client])
        return dec

    def entries(self) -> dict[int, int]:
        """Converged doc map (slot -> value): the cross-lane fold by
        translated doc seq — byte-comparable to a single-row twin
        serving the same batches sequentially."""
        from ..server.megadoc import fold_map_rows
        if any(self.serving._pending[p.host_id]
               for p in self.serving.hosts):
            self.serving.tick()  # lane batches still staged: run them
        self.serving.flush()
        ms = self._lane_planes("map", mk.MapState._fields)
        sources = []
        for lane in range(len(self.rows)):
            log = self.logs[lane]
            cs = int(ms["cleared_seq"][lane])
            sources.append({
                "present": ms["present"][lane], "value": ms["value"][lane],
                "vseq": log.to_doc_array(
                    ms["vseq"][lane].astype(np.int64)),
                "cleared_seq": log.to_doc(cs) if cs >= 1 else cs})
        fold = fold_map_rows(sources)
        return {int(s): int(fold["value"][s])
                for s in np.flatnonzero(fold["present"])}


__all__ = ["ShardedServing", "ShardResidency", "MegaDocLanes",
           "HostPort"]
