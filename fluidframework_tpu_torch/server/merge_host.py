"""KernelMergeHost — device-resident converged document state on the server.

Port of the map, text and matrix parts of ``fluidframework_tpu/server/
merge_host.py``. Reference parity: the *server-observed* hot loops of the
reference — the merge-tree sequenced apply path (packages/dds/merge-tree/
src/mergeTree.ts: 1974 insertingWalk, 2626 markRangeRemoved, 2584
annotateRange) and the SharedMap message fold (packages/dds/map/src/
mapKernel.ts:510 tryProcessMessage) — hosted behind the service seams as
batched device programs: every (document, datastore, channel) is a row
of a :class:`~fluidframework_tpu_torch.ops.mergetree_blocks.
BlockMergeState` pool (text) or of the :class:`~fluidframework_tpu_torch.
ops.map_kernel.MapState` (map), and every SharedMatrix channel a row of
one :class:`~fluidframework_tpu_torch.ops.matrix_kernel.MatrixState`
(matrix.ts:547 processCore); a flush applies the pending sequenced ops
of all channels, one block merge tick per dirty text pool and one matrix
tick (the op tick kernel, or the all-cells append) for the matrix rows.

The host owns what the kernels cannot:

* string→int mappings (client id → slot lane, property key → key slot,
  value → interned id, text → pool offsets);
* capacity — before each tick it checks each row's free slots, compacts
  (and coalesces) rows under pressure, and migrates rows that still do not
  fit to the next pow2 bucket; block pools rebalance rows whose fullest
  block could not absorb the tick (``pre_tick``);
* overflow — an op that overflows its block freezes the doc on the device;
  the host replays the tail through the flat merge tick and re-blocks. A
  row that fails any of that is handed to the scalar
  :class:`~fluidframework_tpu_torch.dds.mergetree.MergeEngine`
  (``_quarantine_merge_row``), as is a channel whose writer set passes
  ``max_client_slots``; it readmits once zamboni shrinks the set;
* materialization of converged text, rich text runs, map entries,
  matrix grids and trees.

Every SharedTree channel is a row of one
:class:`~fluidframework_tpu_torch.ops.tree_kernel.TreeState` (its node
table; SharedTree.ts:446 processCore, Checkout.ts:172 rebase): a flush
runs one tree tick over every row; an edit shape the tick cannot apply
atomically, or an op that overflows its rank space or depth, hands the
channel to the scalar ``Transaction`` replay of its edit log.

Documents too large for one device's table, and documents promoted for
their writer count (the mega-doc residency class), serve from
sequence-parallel pools: the segment axis split over ``seg_mesh``
(``ops/mergetree_sharded.py``). The mesh must be virtual (every shard on
the host's device), so these pools tick with kernel 4 like a flat pool.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..dds.matrix import PermutationVector
from ..dds.mergetree import Marker, MergeEngine, Segment
from ..dds.tree_core import ROOT_ID, VALID, Transaction, TreeSnapshot
from ..device import resolve_device
from ..ops import _build
from ..ops import map_kernel as mk
from ..ops import matrix_cuda as mxc
from ..ops import matrix_kernel as mxk
from ..ops import mergetree_blocks as mtb
from ..ops import mergetree_blocks_cuda as mtbc
from ..ops import mergetree_cuda as mtc
from ..ops import mergetree_kernel as mtk
from ..ops import mergetree_sharded as mts
from ..ops import tree_cuda as tcc
from ..ops import tree_kernel as tk
from ..protocol.messages import MessageType, SequencedDocumentMessage
from ..utils import faults
from .kernel_host import _next_pow2, _tick_k

_MERGE_OPS = frozenset({"insert", "remove", "annotate", "group"})
_MAP_OPS = frozenset({"set", "delete", "clear"})

# Text pools are append-only; once a row's pool churn passes this mark the
# host repacks it down to the referenced slices (zamboni for text bytes).
_TEXT_REPACK_MIN = 1 << 20
# Tree channels trim their applied edit-log prefix into a materialized
# base snapshot once it outgrows this (the overflow fallback replays
# base + remaining log).
_TREE_LOG_TRIM = 512

# A marker occupies one pool char; stripped at materialization. Real text
# never contains NUL (the wire format is JSON-ish strings).
_MARKER_CHAR = "\x00"

class ChannelKey(NamedTuple):
    doc_id: str
    datastore: str
    channel: str


class _MergeRow:
    __slots__ = ("pool", "row", "client_slots", "key_slots", "pending",
                 "raw_log", "scalar", "min_seq", "last_seq",
                 "repack_at", "applied_seq", "applied_min_seq",
                 "readmit_seen_min", "mega_idle")

    def __init__(self) -> None:
        self.pool: "_MergePool | None" = None
        self.row = -1
        self.client_slots: dict[str, int] = {}
        self.key_slots: dict[str, int] = {}
        self.pending: list[dict] = []
        # Sequenced ops NOT YET applied on device (subop, seq, ref_seq,
        # client) — trimmed at every flush; the scalar-fallback replay
        # source is the device row itself (seeded exactly) plus this tail.
        self.raw_log: list[tuple[dict, int, int, str]] = []
        self.scalar: MergeEngine | None = None
        self.min_seq = 0
        self.last_seq = 0
        # Frontier the DEVICE row reflects (advances when raw_log trims):
        # the scalar seed starts here, then replays the unapplied tail.
        self.applied_seq = 0
        self.applied_min_seq = 0
        # Text-pool churn level that triggers the next repack attempt.
        self.repack_at = _TEXT_REPACK_MIN
        # min_seq at the last failed readmission attempt (scalar rows):
        # the writer set only shrinks when the window advances.
        self.readmit_seen_min = -1
        # Flushes since a mega-promoted row last had pending ops — the
        # cooling signal maybe_adapt_megadocs keys on.
        self.mega_idle = 0


class _MapRow:
    __slots__ = ("row", "key_slots", "pending", "last_seq",
                 "literal_values")

    def __init__(self, row: int) -> None:
        self.row = row
        self.key_slots: dict[str, int] = {}
        self.pending: list[dict] = []
        self.last_seq = 0
        # Storm channels (server/storm.py) carry literal small-int values
        # in the op words instead of interned ids; they reject dict-path
        # traffic, so one row is always one mode.
        self.literal_values = False


class _MatrixRow:
    __slots__ = ("row", "client_slots", "pending", "raw_log", "scalar",
                 "last_seq", "min_seq", "next_row_handle",
                 "next_col_handle", "applied_seq", "applied_min_seq",
                 "last_vec_seq")

    def __init__(self, row: int) -> None:
        self.row = row
        self.client_slots: dict[str, int] = {}
        self.pending: list[dict] = []
        # Ops NOT YET applied on device (channel_op, seq, ref_seq, client)
        # — trimmed at every flush; the fallback seeds from the device row
        # and replays only this tail (bounded host memory).
        self.raw_log: list[tuple[dict, int, int, str]] = []
        self.scalar: tuple | None = None  # (rows vec, cols vec, cells dict)
        self.last_seq = 0
        self.min_seq = 0
        self.applied_seq = 0
        self.applied_min_seq = 0
        self.next_row_handle = 0
        self.next_col_handle = 0
        # Seq of the newest structural (vector) op — the cell-run fast
        # path is exact only when every cell's refSeq covers it.
        self.last_vec_seq = 0


class _TreeRow:
    """Host bookkeeping for one device-served SharedTree channel: string id
    → slot interning (the device stores only slots), per-row trait-label
    interning, and the sequenced-edit log that seeds the scalar fallback."""

    __slots__ = ("row", "slot_of", "info_of", "trait_ids", "trait_rev",
                 "free", "next_slot", "pending", "raw_log", "scalar",
                 "last_seq", "base")

    def __init__(self, row: int) -> None:
        self.row = row
        self.slot_of: dict[str, int] = {ROOT_ID: 0}
        self.info_of: dict[int, tuple[str, str]] = {0: (ROOT_ID, "root")}
        self.trait_ids: dict[str, int] = {}
        self.trait_rev: list[str] = []
        self.free: list[int] = []
        self.next_slot = 1
        self.pending: list[dict] = []
        # Sequenced edits since ``base`` — the exact replay source if this
        # channel leaves the device (unsupported edit shape / rank or
        # depth overflow). At clean flush boundaries an over-long applied
        # prefix folds into ``base`` (a device-materialized snapshot),
        # bounding host memory; the fallback replays base + remaining log.
        self.raw_log: list[dict] = []
        self.base: dict | None = None  # serialized TreeSnapshot
        self.scalar: TreeSnapshot | None = None
        self.last_seq = 0


# Fill values of fresh tree rows and slots (a fresh row's slot 0 is then
# set live: its root).
_TREE_FILL = dict(exists=False, parent=-1, trait=0, rank=0, payload=0)


def _pad_axis(a: torch.Tensor, axis: int, extra: int, fill) -> torch.Tensor:
    """``a`` grown by ``extra`` entries of ``fill`` along ``axis``."""
    shape = list(a.shape)
    shape[axis] = extra
    return torch.cat((a, torch.full(shape, fill, dtype=a.dtype,
                                    device=a.device)), dim=axis)


def _np_pad(a: np.ndarray, axis: int, extra: int, fill) -> np.ndarray:
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, extra)
    return np.pad(a, widths, constant_values=fill)


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor (never a view of device-pool storage)."""
    return t.cpu().numpy().copy()


def _next_pow2_width(cur: int, need: int) -> int:
    """Doubling growth policy shared by every plane-width axis: the
    smallest pow2 multiple of ``cur`` that fits ``need``."""
    while cur < need:
        cur *= 2
    return cur


def _overlap_slots(words: np.ndarray) -> list[int]:
    """Set bits of one slot's overlap words → client slot indices. Words
    are i32 with the sign bit as a payload bit (slot 31 of each word)."""
    out = []
    for w, word in enumerate(np.asarray(words, np.int32).reshape(-1)):
        bits = int(np.uint32(word))  # sign bit → bit 31, not a sign
        base = 32 * w
        while bits:
            low = bits & -bits
            out.append(base + low.bit_length() - 1)
            bits ^= low
    return out


def _set_overlap_bit(words_row: np.ndarray, slot: int) -> None:
    """Set client ``slot``'s bit in an [W] i32 word vector (in place),
    wrapping bit 31 through the sign bit."""
    words_row[slot >> 5] |= np.uint32(1 << (slot & 31)).astype(np.int32)


_MERGE_FILL = mtk.FILL
_MAP_FILL = dict(present=False, value=0, vseq=-1, cleared_seq=-1)


class _MergePool:
    """One device MergeState for channels in the same segment-size bucket.

    Bucketed ragged batching: a channel lives in the smallest pow2 bucket
    that fits it and migrates up (host round-trip, rare — doubling) when
    compaction can no longer make room. Each flush issues one tick per
    dirty bucket. This flat pool serves snapshots that hold flat pools;
    every pool the host creates itself is a :class:`_BlockMergePool`.
    """

    #: Per-field blank values of the state class and the trailing feature
    #: axis the prop / overlap planes grow on.
    _FILL = _MERGE_FILL
    _FEATURE_AXIS = 2

    def __init__(self, slots: int, num_props: int, row_capacity: int = 8,
                 overlap_words: int = 1,
                 device: torch.device | None = None) -> None:
        self.device = resolve_device(device)
        self.slots = slots
        self.num_props = num_props
        self.overlap_words = max(1, overlap_words)
        self.capacity = max(1, row_capacity)
        self.state = self._make_state()
        self.text = mtk.TextPool(self.capacity)
        self.members: list[_MergeRow | None] = []
        self.free: list[int] = []

    def _make_state(self):
        return mtk.init_state(self.capacity, self.slots, self.num_props,
                              self.overlap_words, self.device)

    @property
    def client_capacity(self) -> int:
        """Distinct writer slots the overlap planes can track."""
        return mtk.OVERLAP_WORD_BITS * self.overlap_words

    def alloc(self, mrow: _MergeRow) -> None:
        if self.free:
            row = self.free.pop()
            self.members[row] = mrow
        else:
            row = len(self.members)
            if row >= self.capacity:
                self._grow_rows()
            self.members.append(mrow)
        mrow.pool, mrow.row = self, row

    def release(self, row: int) -> None:
        """Blank a device row (in place) and recycle its index."""
        self.members[row] = None
        for f in type(self.state)._fields:
            getattr(self.state, f)[row] = self._FILL[f]
        self.text.chunks[row] = []
        self.text.used[row] = 0
        self.free.append(row)

    def _grow_rows(self) -> None:
        old = self.capacity
        self.capacity = old * 2
        cls = type(self.state)
        self.state = cls(**{f: _pad_axis(getattr(self.state, f), 0, old,
                                         self._FILL[f])
                            for f in cls._fields})
        self.text.chunks += [[] for _ in range(old)]
        self.text.used += [0] * old
        # members stays shorter than capacity; alloc() grows it by append

    def grow_props(self, need: int) -> None:
        new = _next_pow2_width(self.num_props, need)
        if new == self.num_props:
            return
        self.state = self.state._replace(prop_val=_pad_axis(
            self.state.prop_val, self._FEATURE_AXIS, new - self.num_props, 0))
        self.num_props = new

    def grow_overlap(self, need_words: int) -> None:
        """Widen the remover-bitmask planes (32 more writer slots per
        word)."""
        new = _next_pow2_width(self.overlap_words, need_words)
        if new == self.overlap_words:
            return
        self.state = self.state._replace(rem_overlap=_pad_axis(
            self.state.rem_overlap, self._FEATURE_AXIS,
            new - self.overlap_words, 0))
        self.overlap_words = new

    def row_arrays(self, row: int) -> dict[str, np.ndarray]:
        """Host copies of one row's planes (migration source)."""
        return {f: _host(getattr(self.state, f)[row])
                for f in mtk.MergeState._fields}

    def write_row(self, row: int, arrays: dict[str, np.ndarray]) -> None:
        """Install planes (padded by the caller) into a row."""
        for f in mtk.MergeState._fields:
            plane = getattr(self.state, f)
            plane[row] = torch.as_tensor(np.asarray(arrays[f]),
                                         dtype=plane.dtype)

    # -- device dispatch / layout hooks (the block pool overrides them) ------

    def apply(self, batch: mtk.MergeOpBatch):
        return mtc.apply_tick_best(self.state, batch)

    def compact_state(self, min_seq: np.ndarray, coalesce: bool = False):
        return mtk.compact(self.state, torch.from_numpy(min_seq).to(
            self.device), coalesce)

    def margins(self) -> np.ndarray:
        """Free slots per row (worst-case admission check input)."""
        return mtk.capacity_margin(self.state)

    def pre_tick(self, need: np.ndarray) -> bool:
        """Layout maintenance before a tick (block pools rebalance)."""
        return False

    def take_overflow(self) -> np.ndarray | None:
        """Per-row first-overflow op index of the last apply (block pools
        only; None = the layout cannot overflow mid-tick)."""
        return None

    def materialize_row(self, row: int) -> str:
        return mtk.materialize(self.state, self.text, row)

    def set_pool_start(self, row: int, starts: np.ndarray) -> None:
        """Install a repacked pool_start plane (flat document order)."""
        self.state.pool_start[row] = torch.from_numpy(
            np.asarray(starts, np.int32))


_BLOCK_FILL = dict(length=0, ins_seq=0, ins_client=-1,
                   rem_seq=int(mtk.NONE_SEQ), rem_client=-1,
                   rem_overlap=0, pool_start=0, prop_val=0,
                   blk_count=0, blk_live_len=0, blk_max_seq=0,
                   blk_tomb=0, count=0)


class _BlockMergePool(_MergePool):
    """A bucket served by the block-structured table
    (ops/mergetree_blocks.py) — the text serving path. Bucket capacity is
    NB blocks × Bk slots; the host seams exchange FLAT document-order
    arrays (gaps = block tails), so migration, scalar seeding and the text
    repack are layout-agnostic.

    Overflow contract: an op whose target block is full freezes its doc at
    that op (atomic, first index reported); ``_flush_merge`` replays the
    tail through the flat table and re-blocks. ``pre_tick`` rebalances any
    row whose fullest block cannot absorb its tick (2 slots/op)."""

    BK = 128  # blocks of 128 slots; buckets below 128 use one block
    _FILL = _BLOCK_FILL
    _FEATURE_AXIS = 3  # [B, NB, Bk, F] prop/overlap planes

    def __init__(self, slots: int, num_props: int, row_capacity: int = 8,
                 overlap_words: int = 1, block_slots: int | None = None,
                 device: torch.device | None = None) -> None:
        # ``block_slots`` overrides the default Bk — the geometry-autotune
        # seam; snapshots record it so import_state re-blocks identically.
        self.bk = min(block_slots or self.BK, slots)
        self.nb = max(1, slots // self.bk)
        #: pre_tick trigger telemetry: (flush gates seen, rebalances fired)
        #: — the fire RATE is autotune_block_geometry's locality input.
        self.pre_ticks = 0
        self.rebalance_fires = 0
        self.last_overflow: np.ndarray | None = None
        super().__init__(slots, num_props, row_capacity, overlap_words,
                         device)

    def _make_state(self):
        return mtb.init_state(self.capacity, self.nb, self.bk,
                              self.num_props, self.overlap_words, self.device)

    def row_arrays(self, row: int) -> dict[str, np.ndarray]:
        """Flat document-order planes of one row (gaps masked to fills)."""
        s = self.state
        flat = self.nb * self.bk
        bc = _host(s.blk_count[row])
        valid = (np.arange(self.bk)[None, :] < bc[:, None]).reshape(-1)
        out: dict[str, np.ndarray] = {"valid": valid,
                                      "count": _host(s.count[row])}
        for f in ("length", "ins_seq", "ins_client", "rem_seq",
                  "rem_client", "pool_start"):
            plane = _host(getattr(s, f)[row]).reshape(flat)
            plane[~valid] = _MERGE_FILL[f]
            out[f] = plane
        for f in ("rem_overlap", "prop_val"):
            plane = _host(getattr(s, f)[row]).reshape(flat, -1)
            plane[~valid] = 0
            out[f] = plane
        return out

    def write_row(self, row: int, arrays: dict[str, np.ndarray]) -> None:
        blocked = mtb.host_block_row(arrays, self.nb, self.bk)
        for f in mtb.BlockMergeState._fields:
            getattr(self.state, f)[row] = torch.from_numpy(
                np.asarray(blocked[f], np.int32))

    def apply(self, batch: mtk.MergeOpBatch):
        state, overflow = mtbc.apply_tick_blocks_best(self.state, batch)
        self.last_overflow = overflow.cpu().numpy()
        return state

    def compact_state(self, min_seq: np.ndarray, coalesce: bool = False):
        return mtb.rebalance(self.state, torch.from_numpy(min_seq).to(
            self.device), coalesce)

    def margins(self) -> np.ndarray:
        return mtb.capacity_margin(self.state)

    def pre_tick(self, need: np.ndarray) -> bool:
        """Rebalance when any pending row's fullest block could not take
        its whole tick (all ops landing in one block is the worst case).
        The ladder (mtb.maybe_rebalance) spills overfull blocks into their
        neighbours and only pays the full pack + redistribution when the
        spill is infeasible. Returns whether the host trigger fired."""
        self.pre_ticks += 1
        fills = mtb.max_block_fill(self.state)
        if not np.any(need + fills > self.bk):
            return False
        self.rebalance_fires += 1
        min_seq = np.full(self.capacity, -1, np.int32)
        for r in self.members:
            if r is not None:
                min_seq[r.row] = r.min_seq
        # Chaos kill class "mid-rebalance": the layout is about to move.
        faults.crashpoint("pool.mid_rebalance")
        # The pow2-bucketed tick width keeps 2*kk + 2 >= need.
        kk = _tick_k(int(need.max() - 2 + 1) // 2)
        self.state = mtb.maybe_rebalance(
            self.state, torch.from_numpy(min_seq).to(self.device), kk)
        return True

    def take_overflow(self) -> np.ndarray | None:
        out = self.last_overflow
        self.last_overflow = None
        return out

    def fire_rate(self) -> float:
        """Observed rebalance fire rate (fires per flush gate) — the
        head-concentration estimate geometry autotuning keys on."""
        if not self.pre_ticks:
            return 0.0
        return self.rebalance_fires / self.pre_ticks

    def retune(self, block_slots: int) -> None:
        """Re-block the WHOLE pool to a new Bk (same total slots): pack
        each row's occupied slots and redistribute uniformly over the new
        [NB', Bk'] grid — a pure re-layout, deterministic in (state,
        block_slots)."""
        bk = min(block_slots, self.slots)
        nb = max(1, self.slots // bk)
        if nb * bk != self.slots:
            raise ValueError(
                f"block_slots {bk} does not divide pool slots "
                f"{self.slots}")
        if (nb, bk) == (self.nb, self.bk):
            return
        faults.crashpoint("pool.mid_retune")
        packed = mtb.to_flat(self.state, slots=self.slots)
        self.state = mtb.from_flat(packed, nb)
        self.nb, self.bk = nb, bk
        self.pre_ticks = 0
        self.rebalance_fires = 0

    def materialize_row(self, row: int) -> str:
        return mtb.materialize(self.state, self.text, row)

    def set_pool_start(self, row: int, starts: np.ndarray) -> None:
        self.state.pool_start[row] = torch.from_numpy(
            np.asarray(starts, np.int32).reshape(self.nb, self.bk))


class _ShardedMergePool(_MergePool):
    """A bucket whose SEGMENT axis is split over a mesh — the serving home
    for documents too large for one device's table
    (ops/mergetree_sharded.py, the sequence-parallel path). Everything
    else about the pool (rows, text, migration) is inherited and every
    rebuild is re-placed for the mesh. The host takes only a virtual mesh
    (every shard on its own device), which holds the whole segment axis
    on that device, so the tick is the flat one: kernel 4 on the card,
    bit-identical to ``apply_tick_sharded`` on the same mesh.

    Two populations live in pools of this class: documents whose segment
    tables OUTGREW one device (``sharded_slot_threshold``, the size tier)
    and documents PROMOTED for write rate (``mega=True`` — the mega-doc
    residency class)."""

    def __init__(self, slots: int, num_props: int, mesh,
                 row_capacity: int = 1, overlap_words: int = 1,
                 mega: bool = False) -> None:
        self.mesh = mesh
        self.mega = mega
        super().__init__(slots, num_props, row_capacity, overlap_words,
                         mesh.devices[0])
        self.state = self.place(self.state)

    def compact_state(self, min_seq: np.ndarray, coalesce: bool = False
                      ) -> mtk.MergeState:
        return self.place(super().compact_state(min_seq, coalesce))

    def place(self, state: mtk.MergeState) -> mtk.MergeState:
        return mts.shard_merge_state(state, self.mesh)


class KernelMergeHost:
    """Batched device host for the merge-tree and map kernels."""

    def __init__(self, merge_slots: int = 128, map_slots: int = 32,
                 num_props: int = 4, row_capacity: int = 8,
                 flush_threshold: int = 256, metrics=None,
                 seg_mesh=None, sharded_slot_threshold: int = 65536,
                 tree_slots: int = 32,
                 max_client_slots: int = 1024,
                 megadoc_writer_threshold: int | None = None,
                 megadoc_demote_idle_flushes: int = 64,
                 device: str | torch.device | None = None) -> None:
        from ..parallel.mesh import canonical_device, mesh_kind
        from ..utils import MetricsRegistry
        self.device = resolve_device(device)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # Sequence-parallel escape hatch: documents whose segment tables
        # outgrow one device migrate into pools whose SEGMENT axis is
        # split over ``seg_mesh`` instead of growing a single-device table
        # without bound. Misconfiguration fails HERE, not at the first
        # flush mid-serving: pool slot counts are powers of two, so the
        # mesh size must be one too, and every shard needs >= 2 slots.
        self.seg_mesh = seg_mesh
        if seg_mesh is not None:
            n_shards = seg_mesh.size
            if n_shards & (n_shards - 1) != 0:
                # ValueError, not assert: python -O must not defer this
                # to the first sharded flush mid-serving.
                raise ValueError(
                    f"seg_mesh size {n_shards} must be a power of two "
                    "(pool slot counts are)")
            if (mesh_kind(seg_mesh) != "stacked"
                    or canonical_device(seg_mesh.devices[0])
                    != canonical_device(self.device)):
                raise ValueError(
                    f"seg_mesh {seg_mesh} must hold every shard on the "
                    f"host's device {self.device} (a virtual mesh)")
            sharded_slot_threshold = max(sharded_slot_threshold,
                                         2 * n_shards)
        self.sharded_slot_threshold = max(8, sharded_slot_threshold)
        self._row_capacity = max(1, row_capacity)
        self._map_capacity = max(1, row_capacity)
        self._merge_slots = max(8, merge_slots)  # smallest bucket size
        self._map_slots = max(4, map_slots)
        self._num_props = max(1, num_props)
        self.flush_threshold = flush_threshold
        # Ceiling on distinct device-tracked writers per channel: the
        # overlap planes grow on demand (32 slots/word) up to here; only
        # beyond it does a channel route to the scalar path.
        self.max_client_slots = max(mtk.OVERLAP_WORD_BITS,
                                    max_client_slots)
        # Merge channels live in pow2-bucketed pools; maps keep one state.
        self._merge_pools: dict[int, _MergePool] = {}
        # Mega-doc pools: sequence-parallel pools for PROMOTED docs, keyed
        # apart from the size tier so a mega doc at (say) 128 slots does
        # not hijack the block bucket every ordinary 128-slot doc serves
        # from. Promotion/demotion moves a row between the tiers through
        # the exact packed-flat seam.
        self._mega_pools: dict[int, _ShardedMergePool] = {}
        # Auto-promotion by OBSERVED writer count (None = explicit-only);
        # a promoted row idle for ``megadoc_demote_idle_flushes`` flushes
        # demotes back.
        self.megadoc_writer_threshold = megadoc_writer_threshold
        self.megadoc_demote_idle_flushes = max(
            1, megadoc_demote_idle_flushes)
        self._xstate = mk.init_state(self._map_capacity, self._map_slots,
                                     self.device)
        # Matrices (two embedded merge states + a cell table) lazily
        # allocate one state for every matrix channel.
        self._matrix_state: mxk.MatrixState | None = None
        self._matrix_capacity = max(1, row_capacity)
        self._matrix_vec_slots = 64
        self._matrix_cell_slots = 256
        self._matrix_overlap_words = 1
        self._matrix_rows: dict[ChannelKey, _MatrixRow] = {}
        # Tree channels share one pooled TreeState [B, N] (uniform slot
        # axis; both axes grow pow2), allocated at the first tree flush.
        self._tree_state: tk.TreeState | None = None
        self._tree_capacity = max(1, row_capacity)
        self._tree_slots = max(8, tree_slots)
        self._tree_rows: dict[ChannelKey, _TreeRow] = {}
        self._merge_rows: dict[ChannelKey, _MergeRow] = {}
        self._map_rows: dict[ChannelKey, _MapRow] = {}
        # Map-row recycling (doc residency): released rows reissue before
        # the high-water counter grows the state — see release_map_row.
        self._free_map_rows: list[int] = []
        self._map_row_count = 0
        # Shared value interning (map values + annotate values). Id 0 is
        # reserved for "absent"/None; ids index _val_rev.
        self._vals: dict[str, int] = {}
        self._val_rev: list[Any] = [None]
        self._pending_ops = 0
        # Counters surfaced by the telemetry layer (the reference host's
        # full set, so dashboards read the same names).
        self.stats = {"device_ops": 0, "scalar_ops": 0, "flushes": 0,
                      "compactions": 0, "overflow_routed": 0,
                      "migrations": 0, "readmissions": 0,
                      "block_overflow_replays": 0,
                      "quarantined_channels": 0,
                      "rebalances": 0, "geometry_retunes": 0,
                      "megadoc_promotions": 0, "megadoc_demotions": 0}
        #: Device reads of whole map rows (read_map_rows calls): the
        #: residency and mega-doc planes' readbacks, each a pipeline drain.
        self.map_row_reads = 0

    # -- interning -------------------------------------------------------------

    def _intern(self, value: Any) -> int:
        if value is None:
            return 0
        key = repr(value)
        vid = self._vals.get(key)
        if vid is None:
            vid = len(self._val_rev)
            self._vals[key] = vid
            self._val_rev.append(value)
        return vid

    # -- row allocation / growth -----------------------------------------------

    def _pool_for(self, slots: int) -> _MergePool:
        slots = max(_next_pow2(slots), self._merge_slots)
        pool = self._merge_pools.get(slots)
        if pool is None:
            if (self.seg_mesh is not None
                    and slots >= self.sharded_slot_threshold):
                pool = _ShardedMergePool(slots, self._num_props,
                                         self.seg_mesh)
            else:
                # The block-structured table IS the single-device serving
                # path; only the sequence-parallel pools stay flat (the
                # segment axis shards, the block axis would not).
                pool = _BlockMergePool(slots, self._num_props,
                                       self._row_capacity,
                                       device=self.device)
            self._merge_pools[slots] = pool
        return pool

    def _merge_row(self, key: ChannelKey) -> _MergeRow:
        state = self._merge_rows.get(key)
        if state is None:
            state = _MergeRow()
            self._pool_for(self._merge_slots).alloc(state)
            self._merge_rows[key] = state
        return state

    def _migrate_merge_row(self, mrow: _MergeRow, target_slots: int) -> None:
        """Move a channel to a bigger bucket (its segment table no longer
        fits even after compaction). A mega-promoted row grows WITHIN the
        mega tier — capacity pressure never silently demotes it."""
        if getattr(mrow.pool, "mega", False):
            self._move_row(mrow, self._mega_pool_for(target_slots))
        else:
            self._move_row(mrow, self._pool_for(target_slots))
        self.stats["migrations"] += 1

    def _move_row(self, mrow: _MergeRow, dst_pool: _MergePool) -> None:
        """Relocate one channel's row between pools through the exact
        packed-flat seam (row_arrays → write_row: block sources flatten to
        document order, block destinations re-block). Pending ops ride
        along — their encodings index the row's text pool, which moves
        with the row."""
        src_pool, src_row = mrow.pool, mrow.row
        assert dst_pool is not src_pool
        if src_pool.num_props > dst_pool.num_props:
            dst_pool.grow_props(src_pool.num_props)
        if src_pool.overlap_words > dst_pool.overlap_words:
            dst_pool.grow_overlap(src_pool.overlap_words)
        arrays = src_pool.row_arrays(src_row)
        pad_s = dst_pool.slots - src_pool.slots
        out: dict[str, np.ndarray] = {}
        for f, a in arrays.items():
            if f == "count":
                out[f] = a
            elif f == "prop_val":
                out[f] = _np_pad(_np_pad(a, 0, pad_s, 0), 1,
                                 dst_pool.num_props - a.shape[1], 0)
            elif f == "rem_overlap":
                out[f] = _np_pad(_np_pad(a, 0, pad_s, 0), 1,
                                 dst_pool.overlap_words - a.shape[1], 0)
            else:
                out[f] = _np_pad(a, 0, pad_s, _MERGE_FILL[f])
        dst_pool.alloc(mrow)
        dst_pool.write_row(mrow.row, out)
        dst_pool.text.chunks[mrow.row] = src_pool.text.chunks[src_row]
        dst_pool.text.used[mrow.row] = src_pool.text.used[src_row]
        src_pool.release(src_row)

    # -- mega-doc promotion (the write-rate residency class) -----------------

    def _mega_pool_for(self, slots: int) -> _ShardedMergePool:
        assert self.seg_mesh is not None, "mega promotion needs a seg_mesh"
        slots = max(_next_pow2(slots), self._merge_slots,
                    2 * self.seg_mesh.size)
        pool = self._mega_pools.get(slots)
        if pool is None:
            pool = _ShardedMergePool(slots, self._num_props,
                                     self.seg_mesh, mega=True)
            self._mega_pools[slots] = pool
        return pool

    def is_mega_row(self, key: ChannelKey) -> bool:
        row = self._merge_rows.get(key)
        return (row is not None and row.pool is not None
                and getattr(row.pool, "mega", False))

    def promote_merge_row(self, key: ChannelKey) -> None:
        """Mega-doc promotion: move one channel's segment table from its
        block bucket into a sequence-parallel pool through the packed-flat
        seam (``mergetree_sharded.from_block_state`` is the tick-side twin
        of this host move). Pending ops ride along. Idempotent on an
        already-promoted row; scalar-routed channels refuse."""
        row = self._merge_rows[key]
        if row.scalar is not None:
            raise ValueError(
                f"{key} is scalar-routed; readmit before promoting")
        if getattr(row.pool, "mega", False):
            return
        dst = self._mega_pool_for(row.pool.slots)
        # Kill window: the layout is about to move wholesale.
        faults.crashpoint("megadoc.mid_promotion")
        self._move_row(row, dst)
        row.mega_idle = 0
        self.stats["megadoc_promotions"] += 1
        self.metrics.counter("megadoc.text_promotions").inc()

    def demote_merge_row(self, key: ChannelKey) -> bool:
        """Demote a promoted channel back to its single-device block
        bucket (the block pool's write_row re-blocks the packed document
        order exactly). A doc whose table exceeds
        ``sharded_slot_threshold`` stays sequence-parallel (the SIZE
        tier) — returns False then."""
        row = self._merge_rows[key]
        if not getattr(row.pool, "mega", False):
            return False
        if row.pool.slots >= self.sharded_slot_threshold:
            return False
        faults.crashpoint("megadoc.mid_demotion")
        self._move_row(row, self._pool_for(row.pool.slots))
        row.mega_idle = 0
        self.stats["megadoc_demotions"] += 1
        self.metrics.counter("megadoc.text_demotions").inc()
        return True

    def maybe_adapt_megadocs(self) -> None:
        """Flush-cadence promotion/demotion from OBSERVED load: distinct
        writers in the PENDING tick promote (instantaneous concurrency,
        not the historical client table), idle flushes demote. No-op
        unless ``megadoc_writer_threshold`` is armed and a seg_mesh
        exists."""
        if self.megadoc_writer_threshold is None or self.seg_mesh is None:
            return
        for key, row in list(self._merge_rows.items()):
            if row.scalar is not None or row.pool is None:
                continue
            if getattr(row.pool, "mega", False):
                row.mega_idle = 0 if row.pending else row.mega_idle + 1
                if row.mega_idle >= self.megadoc_demote_idle_flushes:
                    self.demote_merge_row(key)
            elif row.pending and len(
                    {op["client"] for op in row.pending}
                    ) >= self.megadoc_writer_threshold:
                self.promote_merge_row(key)

    def _map_row(self, key: ChannelKey) -> _MapRow:
        state = self._map_rows.get(key)
        if state is None:
            if self._free_map_rows:
                row = self._free_map_rows.pop()
            else:
                row = self._map_row_count
                if row >= self._map_capacity:
                    self._grow_map_rows()
                self._map_row_count += 1
            state = _MapRow(row)
            self._map_rows[key] = state
        return state

    def release_map_row(self, key: ChannelKey) -> int:
        """Free a map channel's device row: blank the planes back to init
        fills (in place) and recycle the index. Returns the freed row."""
        state = self._map_rows.pop(key)
        assert not state.pending, (
            f"release_map_row({key}) with pending ops — flush first")
        row = state.row
        for f, plane in zip(mk.MapState._fields, self._xstate):
            plane[row] = _MAP_FILL[f]
        self._free_map_rows.append(row)
        return row

    def read_map_rows(self, rows) -> dict[str, np.ndarray]:
        """Host copy of the four map planes of ``rows`` (a list of row
        indices): one gather over the rows and one device→host copy.
        The copy is stream-ordered after every dispatched tick, so like
        the reference's ``np.asarray`` it drains the pipeline. Returns
        ``present`` bool / ``value`` / ``vseq`` int32 ``[n, S]`` and
        ``cleared_seq`` int32 ``[n]``."""
        xs = self._xstate
        s = xs.value.shape[1]
        idx = torch.as_tensor(list(rows), dtype=torch.long,
                              device=xs.value.device)
        packed = torch.cat([xs.present[idx].to(torch.int32),
                            xs.value[idx], xs.vseq[idx],
                            xs.cleared_seq[idx].unsqueeze(1)],
                           dim=1).cpu().numpy()
        self.map_row_reads += 1
        return {"present": packed[:, :s].astype(np.bool_),
                "value": packed[:, s:2 * s], "vseq": packed[:, 2 * s:3 * s],
                "cleared_seq": packed[:, 3 * s]}

    def write_map_row(self, row: int, present: np.ndarray,
                      value: np.ndarray, vseq: np.ndarray,
                      cleared_seq: int) -> None:
        """Overwrite one map row in place on its device, each plane from
        one host array (full row width) with a blocking copy on the
        current stream: the write lands after every dispatched tick and
        before the next one, and never goes through the storm's pinned
        staging buffers."""
        xs = self._xstate
        dev = xs.value.device
        for plane, vals, dtype in ((xs.present, present, np.bool_),
                                   (xs.value, value, np.int32),
                                   (xs.vseq, vseq, np.int32)):
            plane[row] = torch.from_numpy(
                np.ascontiguousarray(vals, dtype)).to(dev)
        xs.cleared_seq[row] = int(cleared_seq)

    def _grow_map_rows(self) -> None:
        old = self._map_capacity
        self._map_capacity = old * 2
        self._xstate = mk.MapState(**{
            f: _pad_axis(getattr(self._xstate, f), 0, old, _MAP_FILL[f])
            for f in mk.MapState._fields})

    def _grow_map_slots(self, need: int) -> None:
        new = _next_pow2_width(self._map_slots, need)
        extra = new - self._map_slots
        self._xstate = mk.MapState(**{
            f: (_pad_axis(getattr(self._xstate, f), 1, extra, _MAP_FILL[f])
                if f != "cleared_seq" else self._xstate.cleared_seq)
            for f in mk.MapState._fields})
        self._map_slots = new

    # -- ingest ----------------------------------------------------------------

    def ingest(self, doc_id: str, message: SequencedDocumentMessage) -> None:
        """Feed one sequenced message. Non-channel-ops are ignored; merge,
        map, matrix and tree channel ops are routed to their device rows."""
        if message.type != MessageType.OPERATION:
            return
        envelope = message.contents
        if not isinstance(envelope, dict) or "address" not in envelope:
            return
        inner = envelope.get("contents")
        if not isinstance(inner, dict) or "address" not in inner:
            return
        channel_op = inner.get("contents")
        if not isinstance(channel_op, dict) or "type" not in channel_op:
            return
        key = ChannelKey(doc_id, envelope["address"], inner["address"])
        kind = channel_op["type"]
        if "target" in channel_op:
            # Matrix ops carry a target axis/cell and reuse type names the
            # merge/map sets also use — route by shape FIRST.
            self._ingest_matrix(key, channel_op, message)
        elif kind == "edit" and "edit" in channel_op:
            self._ingest_tree(key, channel_op, message)
        elif kind in _MERGE_OPS:
            self._ingest_merge(key, channel_op, message)
        elif kind in _MAP_OPS:
            self._ingest_map(key, channel_op, message)
        if self._pending_ops >= self.flush_threshold:
            self.flush()

    def _ingest_merge(self, key: ChannelKey, channel_op: dict,
                      message: SequencedDocumentMessage) -> None:
        row = self._merge_row(key)
        seq = message.sequence_number
        if seq <= row.last_seq:
            return  # bus replay
        row.last_seq = seq
        row.min_seq = message.minimum_sequence_number
        ref_seq = message.reference_sequence_number
        client = message.client_id
        subops = (channel_op["ops"] if channel_op["type"] == "group"
                  else [channel_op])
        if row.scalar is not None:
            # Scalar-served: the engine is the state now; no log needed.
            for op in subops:
                row.scalar.apply_remote(op, seq, ref_seq, client)
            # The window advances here too: tombstones compact and the
            # live writer set can shrink back under the device bitmask —
            # the readmission check at flush watches for that.
            row.scalar.update_min_seq(message.minimum_sequence_number)
            self.stats["scalar_ops"] += len(subops)
            return
        for op in subops:
            row.raw_log.append((op, seq, ref_seq, client))
        if (client not in row.client_slots
                and len(row.client_slots) >= self.max_client_slots):
            self._route_to_scalar(key, row)
            self.stats["scalar_ops"] += len(subops)
            return
        slot = row.client_slots.setdefault(client, len(row.client_slots))
        if slot >= row.pool.client_capacity:
            row.pool.grow_overlap(mtk.overlap_words_for(slot + 1))
        for op in subops:
            base = dict(seq=seq, ref_seq=ref_seq, client=slot)
            if op["type"] == "insert":
                if "text" in op:
                    text = op["text"]
                elif "items" in op:
                    # Item-vector insert: one placeholder char per item
                    # keeps later position-based ops resolving against the
                    # right visible lengths; payloads are opaque here.
                    text = _MARKER_CHAR * len(op["items"])
                else:
                    text = _MARKER_CHAR
                enc = dict(base, kind=mtk.MT_INSERT, pos=op["pos"],
                           pool_start=row.pool.text.append(row.row, text),
                           text_len=len(text))
                row.pending.append(enc)
                self._pending_ops += 1
                # An insert may also carry initial props; they apply to the
                # fresh segment only, which at this seq is exactly the
                # inserted range.
                if op.get("props"):
                    self._encode_annotates(
                        row, base, op["pos"], op["pos"] + len(text),
                        op["props"])
            elif op["type"] == "remove":
                row.pending.append(dict(base, kind=mtk.MT_REMOVE,
                                        pos=op["start"], end=op["end"]))
                self._pending_ops += 1
            else:  # annotate
                self._encode_annotates(row, base, op["start"], op["end"],
                                       op["props"])

    def _encode_annotates(self, row: _MergeRow, base: dict, start: int,
                          end: int, props: dict) -> None:
        for prop_key, value in sorted(props.items()):
            kslot = row.key_slots.setdefault(prop_key, len(row.key_slots))
            row.pending.append(dict(base, kind=mtk.MT_ANNOTATE, pos=start,
                                    end=end, prop_key=kslot,
                                    prop_val=self._intern(value)))
            self._pending_ops += 1

    def _seed_merge_engine(self, row: _MergeRow) -> MergeEngine:
        """Exact scalar twin of a device merge row: every table slot —
        live AND tombstoned-in-window — becomes a Segment with its insert
        seq/client, removal seq/client/overlap set and props."""
        arrays = row.pool.row_arrays(row.row)
        buffer = row.pool.text.buffer(row.row)
        slot_rev = {s: c for c, s in row.client_slots.items()}
        key_rev = {s: k for k, s in row.key_slots.items()}
        engine = MergeEngine(local_client=None)
        engine.current_seq = row.applied_seq
        engine.min_seq = row.applied_min_seq
        none_seq = int(mtk.NONE_SEQ)
        for i in range(arrays["valid"].shape[0]):
            if not arrays["valid"][i]:
                continue
            length = int(arrays["length"][i])
            if length == 0:
                continue  # transient zero-length slot: nothing to carry
            start = int(arrays["pool_start"][i])
            text = buffer[start:start + length]
            if text == _MARKER_CHAR * length:
                # Marker / item-run segment: a non-str content keeps
                # text() from serving NULs; placeholders keep the length.
                content: Any = Marker() if length == 1 \
                    else tuple([None] * length)
            else:
                content = text
            rem_seq = int(arrays["rem_seq"][i])
            overlap = {slot_rev[s]
                       for s in _overlap_slots(arrays["rem_overlap"][i])
                       if s in slot_rev}
            props = {key_rev[p]: self._val_rev[int(arrays["prop_val"][i, p])]
                     for p in range(arrays["prop_val"].shape[1])
                     if int(arrays["prop_val"][i, p]) and p in key_rev}
            engine.segments.append(Segment(
                content=content,
                seq=int(arrays["ins_seq"][i]),
                client=slot_rev.get(int(arrays["ins_client"][i])),
                removed_seq=None if rem_seq == none_seq else rem_seq,
                removed_client=slot_rev.get(int(arrays["rem_client"][i])),
                removed_overlap=overlap,
                props=props or None,
            ))
        return engine

    def _route_to_scalar(self, key: ChannelKey, row: _MergeRow) -> None:
        """Client-slot bitmask exhausted: seed the scalar engine from the
        device row (exact, O(row)) and replay only the unapplied tail."""
        engine = self._seed_merge_engine(row)
        for op, seq, ref_seq, client in row.raw_log:
            engine.apply_remote(op, seq, ref_seq, client)
        self._pending_ops -= len(row.pending)
        self.stats["overflow_routed"] += 1
        self._demote_row_to_scalar(row, engine)

    def _demote_row_to_scalar(self, row: _MergeRow, engine) -> None:
        """Shared tail of the device→scalar escapes (slot overflow and
        per-row quarantine): the engine becomes the channel state and the
        device row is surrendered."""
        row.scalar = engine
        row.raw_log = []
        row.pending = []
        row.applied_seq = row.last_seq
        row.applied_min_seq = row.min_seq
        row.pool.release(row.row)
        row.pool, row.row = None, -1
        self._export_stats()

    def _ingest_map(self, key: ChannelKey, channel_op: dict,
                    message: SequencedDocumentMessage) -> None:
        row = self._map_row(key)
        if row.literal_values:
            raise ValueError(
                f"channel {key} is storm-served (literal values); dict-path "
                "ops cannot mix on one channel")
        seq = message.sequence_number
        if seq <= row.last_seq:
            return
        row.last_seq = seq
        kind = channel_op["type"]
        if kind == "clear":
            row.pending.append(dict(kind=mk.MAP_CLEAR, seq=seq))
        else:
            slot = row.key_slots.setdefault(channel_op["key"],
                                            len(row.key_slots))
            if kind == "set":
                row.pending.append(dict(
                    kind=mk.MAP_SET, slot=slot, seq=seq,
                    value=self._intern(channel_op["value"])))
            else:
                row.pending.append(dict(kind=mk.MAP_DELETE, slot=slot,
                                        seq=seq))
        self._pending_ops += 1

    # -- matrix channels (matrix.ts:547 behind the service) --------------------

    def _matrix_row(self, key: ChannelKey) -> _MatrixRow:
        state = self._matrix_rows.get(key)
        if state is None:
            row = len(self._matrix_rows)
            if row >= self._matrix_capacity:
                self._grow_matrix_rows()
            state = _MatrixRow(row)
            self._matrix_rows[key] = state
        return state

    def _ingest_matrix(self, key: ChannelKey, channel_op: dict,
                       message: SequencedDocumentMessage) -> None:
        row = self._matrix_row(key)
        seq = message.sequence_number
        if seq <= row.last_seq:
            return  # bus replay
        row.last_seq = seq
        row.min_seq = message.minimum_sequence_number
        ref_seq = message.reference_sequence_number
        client = message.client_id
        if row.scalar is not None:
            # Scalar-served: no device state to rebuild later, no log.
            self._matrix_scalar_apply(row, channel_op, seq, ref_seq, client)
            self.stats["scalar_ops"] += 1
            return
        row.raw_log.append((channel_op, seq, ref_seq, client))
        if (client not in row.client_slots
                and len(row.client_slots) >= self.max_client_slots):
            self._route_matrix_to_scalar(row)
            self.stats["scalar_ops"] += 1
            return
        slot = row.client_slots.setdefault(client, len(row.client_slots))
        if slot >= mtk.OVERLAP_WORD_BITS * self._matrix_overlap_words:
            self._grow_matrix_overlap(mtk.overlap_words_for(slot + 1))

        def alloc(axis):
            def inner(count):
                base = getattr(row, axis)
                setattr(row, axis, base + count)
                return base
            return inner

        encoded = mxk.encode_matrix_op(
            channel_op, dict(seq=seq, ref_seq=ref_seq, client=slot),
            alloc("next_row_handle"), alloc("next_col_handle"),
            self._intern)
        row.pending.extend(encoded)
        for enc in encoded:
            if enc["target"] != mxk.MX_CELL:
                row.last_vec_seq = max(row.last_vec_seq, enc["seq"])
        self._pending_ops += len(encoded)

    def _seed_matrix_scalar(self, row: _MatrixRow) -> tuple:
        """Exact scalar twin of a device matrix row: the two embedded
        merge states become PermutationVectors (handle runs from
        pool_start), the cell table becomes the LWW dict."""
        s = self._matrix_state
        slot_rev = {sl: c for c, sl in row.client_slots.items()}
        none_seq = int(mtk.NONE_SEQ)

        def seed_vec(ms: mtk.MergeState,
                     next_handle: int) -> PermutationVector:
            vec = PermutationVector(None)
            # Handle allocation continues where the host's device-path
            # counter left off (a fresh vector restarting at 0 would
            # collide new runs with live handles).
            vec.next_handle = next_handle
            engine = vec.engine
            engine.current_seq = row.applied_seq
            engine.min_seq = row.applied_min_seq
            arrays = {f: _host(getattr(ms, f)[row.row])
                      for f in mtk.MergeState._fields if f != "count"}
            for i in range(arrays["valid"].shape[0]):
                if not arrays["valid"][i] or arrays["length"][i] == 0:
                    continue
                base = int(arrays["pool_start"][i])
                length = int(arrays["length"][i])
                rem = int(arrays["rem_seq"][i])
                overlap = {slot_rev[c]
                           for c in _overlap_slots(arrays["rem_overlap"][i])
                           if c in slot_rev}
                engine.segments.append(Segment(
                    content=tuple(range(base, base + length)),
                    seq=int(arrays["ins_seq"][i]),
                    client=slot_rev.get(int(arrays["ins_client"][i])),
                    removed_seq=None if rem == none_seq else rem,
                    removed_client=slot_rev.get(
                        int(arrays["rem_client"][i])),
                    removed_overlap=overlap,
                ))
            return vec

        cells: dict[tuple[int, int], Any] = {}
        used = _host(s.cell_used[row.row])
        cell_rh = _host(s.cell_rh[row.row])
        cell_ch = _host(s.cell_ch[row.row])
        cell_val = _host(s.cell_val[row.row])
        for c in range(used.shape[0]):
            if used[c]:
                cells[(int(cell_rh[c]), int(cell_ch[c]))] = \
                    self._val_rev[int(cell_val[c])]
        return (seed_vec(s.rows, row.next_row_handle),
                seed_vec(s.cols, row.next_col_handle), cells)

    def _route_matrix_to_scalar(self, row: _MatrixRow) -> None:
        """Client-slot bitmask exhausted: seed scalar permutation vectors
        + the LWW cell dict from the device row, replay the unapplied
        tail, and serve host-side from now on."""
        if self._matrix_state is None:
            row.scalar = (PermutationVector(None), PermutationVector(None),
                          {})
        else:
            row.scalar = self._seed_matrix_scalar(row)
        self._pending_ops -= len(row.pending)
        row.pending = []
        for op, seq, ref_seq, client in row.raw_log:
            self._matrix_scalar_apply(row, op, seq, ref_seq, client)
        row.raw_log = []  # the scalar vectors ARE the state from here on
        if self._matrix_state is not None:
            self._blank_matrix_device_row(row.row)
        self.stats["overflow_routed"] += 1
        self._export_stats()

    def _matrix_scalar_apply(self, row: _MatrixRow, op: dict, seq: int,
                             ref_seq: int, client: str) -> None:
        rows_vec, cols_vec, cells = row.scalar
        target = op["target"]
        if target in ("rows", "cols"):
            (rows_vec if target == "rows" else cols_vec).apply_remote(
                op, seq, ref_seq, client)
        else:
            rh = rows_vec.handle_at(op["row"], ref_seq, client)
            ch = cols_vec.handle_at(op["col"], ref_seq, client)
            if rh is not None and ch is not None:
                cells[(rh, ch)] = op["value"]

    def _blank_matrix_device_row(self, row: int) -> None:
        """Reset a device matrix row to its blank planes (in place) — the
        row of a channel that now serves from the scalar vectors."""
        s = self._matrix_state
        for ms in (s.rows, s.cols):
            for f in mtk.MergeState._fields:
                getattr(ms, f)[row] = _MERGE_FILL[f]
        s.cell_used[row] = False
        s.cell_count[row] = 0

    def _ensure_matrix_state(self) -> None:
        if self._matrix_state is None:
            self._matrix_state = mxk.init_state(
                self._matrix_capacity, self._matrix_vec_slots,
                self._matrix_cell_slots, self._matrix_overlap_words,
                self.device)

    def _grow_matrix_overlap(self, need_words: int) -> None:
        """Widen the remover-bitmask planes of both permutation vectors
        (32 more writer slots per word) — matrix twin of the merge pools'
        grow_overlap."""
        new = _next_pow2_width(self._matrix_overlap_words, need_words)
        if new == self._matrix_overlap_words:
            return
        extra = new - self._matrix_overlap_words
        if self._matrix_state is not None:
            def pad_ov(ms: mtk.MergeState) -> mtk.MergeState:
                return ms._replace(
                    rem_overlap=_pad_axis(ms.rem_overlap, 2, extra, 0))
            self._matrix_state = self._matrix_state._replace(
                rows=pad_ov(self._matrix_state.rows),
                cols=pad_ov(self._matrix_state.cols))
        self._matrix_overlap_words = new

    def _grow_matrix_rows(self) -> None:
        old = self._matrix_capacity
        self._matrix_capacity = old * 2
        if self._matrix_state is not None:
            self._matrix_state = self._pad_matrix_state(
                self._matrix_state, rows_extra=old)

    @staticmethod
    def _pad_matrix_state(s: mxk.MatrixState, rows_extra: int = 0,
                          vec_extra: int = 0,
                          cell_extra: int = 0) -> mxk.MatrixState:
        def pad_merge(ms: mtk.MergeState) -> mtk.MergeState:
            out = {}
            for f in mtk.MergeState._fields:
                a = _pad_axis(getattr(ms, f), 0, rows_extra, _MERGE_FILL[f])
                if f != "count" and vec_extra:
                    a = _pad_axis(a, 1, vec_extra, _MERGE_FILL[f])
                out[f] = a
            return mtk.MergeState(**out)

        cells = {}
        for f, fill in mxk.CELL_FILL.items():
            a = _pad_axis(getattr(s, f), 0, rows_extra, fill)
            if cell_extra:
                a = _pad_axis(a, 1, cell_extra, fill)
            cells[f] = a
        return mxk.MatrixState(
            rows=pad_merge(s.rows), cols=pad_merge(s.cols),
            cell_count=_pad_axis(s.cell_count, 0, rows_extra, 0), **cells)

    def _matrix_vec_shortfall(self, rows: list[_MatrixRow]
                              ) -> tuple[int, int]:
        """(vec_extra, cell_extra) pow2 growth needed for the dirty rows
        (each vector op can consume 2 slots; each cell op 1 cell slot)."""
        margins = mxk.capacity_margin(self._matrix_state)
        vec_extra = cell_extra = 0
        for r in rows:
            vec_need = 2 * len(r.pending) + 2
            cell_need = len(r.pending) + 1
            worst_vec = min(int(margins["rows"][r.row]),
                            int(margins["cols"][r.row]))
            if vec_need > worst_vec:
                vec_extra = max(vec_extra,
                                _next_pow2(vec_need - worst_vec))
            cell_margin = int(margins["cells"][r.row])
            if cell_need > cell_margin:
                cell_extra = max(cell_extra,
                                 _next_pow2(cell_need - cell_margin))
        return vec_extra, cell_extra

    # -- flush (the device tick) ----------------------------------------------

    def scalar_fraction(self) -> float:
        """Fraction of served channel ops that ran on the scalar fallback
        instead of the device kernels. 0.0 = everything device-served."""
        total = self.stats["device_ops"] + self.stats["scalar_ops"]
        return self.stats["scalar_ops"] / total if total else 0.0

    def _export_stats(self) -> None:
        """Mirror the routing counters into the shared metrics registry."""
        for name, value in self.stats.items():
            self.metrics.gauge(f"merge_host.{name}").set(value)
        self.metrics.gauge("merge_host.scalar_fraction").set(
            self.scalar_fraction())

    def flush(self) -> None:
        """Apply every pending op: at most one tick per pool and kernel."""
        import time as _time
        self.metrics.gauge("merge_host.queue_depth").set(self._pending_ops)
        start = _time.perf_counter()
        self._readmit_scalar_rows()
        # Mega tier adaptation BEFORE the merge tick: a row promoted here
        # serves this very flush from the sequence-parallel pool.
        self.maybe_adapt_megadocs()
        self._flush_merge()
        self._flush_map()
        self._flush_matrix()
        self._flush_tree()
        if self._pending_ops:
            self.metrics.histogram("merge_host.tick_seconds").observe(
                _time.perf_counter() - start)
            self.metrics.counter("merge_host.merged_ops").inc(
                self._pending_ops)
        self._export_stats()
        self._pending_ops = 0

    def autotune_block_geometry(self, min_observations: int = 8,
                                fire_threshold: float = 0.5,
                                head_fraction: float | None = None
                                ) -> dict:
        """Per-bucket (NB, Bk) retune from OBSERVED op locality: a block
        pool whose pre_tick rebalance trigger fired on >=
        ``fire_threshold`` of its flush gates is serving a
        head-concentrated stream — trade NB for a larger Bk (same total
        slots) so the hot block absorbs several ticks per spill.
        ``head_fraction`` overrides the observed rate. Returns
        {bucket_slots: (nb, bk)} for the pools it re-blocked."""
        retuned: dict[int, tuple[int, int]] = {}
        for slots, pool in sorted(self._merge_pools.items()):
            if not isinstance(pool, _BlockMergePool):
                continue
            if pool.pre_ticks < min_observations:
                continue
            rate = (pool.fire_rate() if head_fraction is None
                    else head_fraction)
            if rate < fire_threshold:
                continue
            # The SAME Bk-scaling rule as choose_block_geometry, under the
            # pool constraint nb * bk == slots.
            bk = min(mtb.bk_for_locality(32, rate), pool.slots)
            if bk <= pool.bk or pool.slots % bk:
                continue
            pool.retune(bk)
            self.stats["geometry_retunes"] += 1
            self.metrics.counter("merge.geometry_retunes").inc()
            retuned[slots] = (pool.nb, pool.bk)
        return retuned

    def _readmit_scalar_rows(self) -> None:
        """A scalar-served merge channel whose writer set shrank back under
        the device client bitmask re-encodes onto a device row."""
        for key, row in self._merge_rows.items():
            if row.scalar is None:
                continue
            if row.min_seq <= row.readmit_seen_min:
                continue  # window unmoved since the last failed attempt
            if not self._try_readmit_merge(key, row):
                row.readmit_seen_min = row.min_seq

    def _try_readmit_merge(self, key: ChannelKey, row: _MergeRow) -> bool:
        engine = row.scalar
        clients: set[str] = set()
        for seg in engine.segments:
            if seg.length == 0:
                continue
            if seg.client is not None:
                clients.add(seg.client)
            if seg.removed_client is not None:
                clients.add(seg.removed_client)
            clients.update(seg.removed_overlap)
        # Hysteresis: readmit only with headroom below the ceiling, or a
        # single fresh writer would bounce the channel straight back out.
        if len(clients) > self.max_client_slots - 4:
            return False
        segments = [s for s in engine.segments if s.length > 0]
        slot_of = {c: i for i, c in enumerate(sorted(clients))}
        pool = self._pool_for(max(len(segments) * 2, self._merge_slots))
        if clients:
            pool.grow_overlap(mtk.overlap_words_for(len(clients)))
        row.pool = None
        pool.alloc(row)
        key_slots: dict[str, int] = {}
        for seg in segments:
            for prop_key in (seg.props or {}):
                key_slots.setdefault(prop_key, len(key_slots))
        if len(key_slots) > pool.num_props:
            pool.grow_props(len(key_slots))

        s = pool.slots
        extra_axis = {"prop_val": pool.num_props,
                      "rem_overlap": pool.overlap_words}
        arrays = {f: np.full(
            (s, extra_axis[f]) if f in extra_axis else (s,),
            _MERGE_FILL[f],
            np.bool_ if f == "valid" else np.int32)
            for f in mtk.MergeState._fields if f != "count"}
        pool.text.chunks[row.row] = []
        pool.text.used[row.row] = 0
        for i, seg in enumerate(segments):
            arrays["valid"][i] = True
            arrays["length"][i] = seg.length
            arrays["ins_seq"][i] = max(seg.seq, 0)  # baseline loads are 0
            arrays["ins_client"][i] = slot_of.get(seg.client, -1)
            if seg.removed_seq is not None:
                arrays["rem_seq"][i] = seg.removed_seq
                arrays["rem_client"][i] = slot_of.get(seg.removed_client, -1)
                for overlap_client in seg.removed_overlap:
                    _set_overlap_bit(arrays["rem_overlap"][i],
                                     slot_of[overlap_client])
            if isinstance(seg.content, str):
                text = seg.content
            else:  # Marker or handle/placeholder run
                text = _MARKER_CHAR * seg.length
            arrays["pool_start"][i] = pool.text.append(row.row, text)
            for prop_key, value in (seg.props or {}).items():
                arrays["prop_val"][i, key_slots[prop_key]] = \
                    self._intern(value)
        state_arrays = dict(arrays)
        state_arrays["count"] = np.int32(len(segments))
        pool.write_row(row.row, state_arrays)
        row.client_slots = slot_of
        row.key_slots = key_slots
        row.scalar = None
        row.raw_log = []
        row.pending = []
        row.applied_seq = row.last_seq
        row.applied_min_seq = row.min_seq
        self.stats["readmissions"] += 1
        return True

    def _flush_merge(self) -> None:
        rows = [r for r in self._merge_rows.values() if r.pending]
        if not rows:
            return
        # Capacity: each op can consume up to 2 fresh slots (split+place /
        # split+split). Compact rows under pressure; rows that STILL don't
        # fit migrate to the next bucket — only they pay for the growth.
        for _ in range(32):  # bounded: each pass doubles the short rows
            short_rows: list[tuple[_MergeRow, int]] = []
            for pool, pool_rows in self._rows_by_pool(rows).items():
                margins = pool.margins()
                need = np.zeros(pool.capacity, np.int64)
                for r in pool_rows:
                    need[r.row] = 2 * len(r.pending) + 2
                short = need > margins
                if not short.any():
                    continue
                min_seq = np.full(pool.capacity, -1, np.int32)
                for r in pool.members:
                    if r is not None and short[r.row]:
                        min_seq[r.row] = r.min_seq
                pool.state = pool.compact_state(min_seq)
                self.stats["compactions"] += 1
                still = need > pool.margins()
                if still.any():
                    # Second chance before a bigger bucket: repack the
                    # short rows' text pools so live document order is
                    # pool-contiguous, then COALESCE adjacent acked runs.
                    for r in pool_rows:
                        if still[r.row]:
                            self._repack_text_pool(r)
                    pool.state = pool.compact_state(min_seq, coalesce=True)
                    self.stats["compactions"] += 1
                    still = need > pool.margins()
                for r in pool_rows:
                    if still[r.row]:
                        short_rows.append((r, int(need[r.row])))
            if not short_rows:
                break
            for r, n in short_rows:
                live = int(r.pool.state.count[r.row])
                self._migrate_merge_row(
                    r, max(_next_pow2(live + n), r.pool.slots * 2))

        # One tick per dirty bucket; prop planes grow per pool.
        for pool, pool_rows in self._rows_by_pool(rows).items():
            max_props = max(len(r.key_slots) for r in pool_rows)
            if max_props > pool.num_props:
                pool.grow_props(max_props)
            k = _tick_k(max(len(r.pending) for r in pool_rows))
            need = np.zeros(pool.capacity, np.int64)
            for r in pool_rows:
                need[r.row] = 2 * len(r.pending) + 2
            if pool.pre_tick(need):
                self.stats["rebalances"] += 1
                self.metrics.counter("merge.rebalance_fires").inc()
            per_doc = [[] for _ in range(pool.capacity)]
            for r in pool_rows:
                per_doc[r.row] = r.pending
            batch = mtk.make_merge_op_batch(per_doc, pool.capacity, k,
                                            pool.client_capacity,
                                            self.device)
            pool.state = pool.apply(batch)
            if isinstance(pool, _ShardedMergePool):
                # The reference's sequence-parallel attribution: ops
                # served by the tier, and its boundary-exchange bound (2
                # one-hop edge exchanges an op in the split program; the
                # kernel-4 tick of a virtual mesh exchanges nothing).
                n_ops = sum(len(r.pending) for r in pool_rows)
                self.metrics.counter("megadoc.sharded_ops").inc(n_ops)
                self.metrics.counter(
                    "megadoc.boundary_exchanges").inc(2 * n_ops)
            overflow = pool.take_overflow()
            if overflow is not None:
                for r in pool_rows:
                    idx = int(overflow[r.row])
                    if idx == int(mtb.OVF_NONE):
                        continue
                    # Block full mid-tick: the device froze the row at op
                    # ``idx``; replay the tail through the flat table and
                    # re-block. A replay that FAILS quarantines only this
                    # channel (scalar route) — one poisoned doc must never
                    # abort the whole bucket's flush. A kernel that cannot
                    # build, bind or launch is no per-row fault: it raises.
                    src_pool, src_row = r.pool, r.row
                    try:
                        self._replay_block_overflow(r, r.pending[idx:])
                    except _build.KernelError:
                        raise
                    except Exception as err:
                        if r.pool is not src_pool or r.row != src_row:
                            # Died mid-migration: the half-written
                            # destination row is abandoned; the frozen
                            # source row is still intact.
                            r.pool.release(r.row)
                            r.pool, r.row = src_pool, src_row
                            src_pool.members[src_row] = r
                        self._quarantine_merge_row(r, r.pending[idx:], err)
            self.stats["device_ops"] += sum(
                len(r.pending) for r in pool_rows)
            for r in pool_rows:
                if r.pool is None:
                    continue  # quarantined above; already settled
                r.pending = []
                # The device row now reflects everything in raw_log; the
                # tail resets so host memory per channel stays bounded.
                r.raw_log = []
                r.applied_seq = r.last_seq
                r.applied_min_seq = r.min_seq
                if r.pool.text.used[r.row] > r.repack_at:
                    self._repack_text_pool(r)
        self.stats["flushes"] += 1

    def _replay_block_overflow(self, row: _MergeRow,
                               rest: list[dict]) -> None:
        """A block filled mid-tick: the device froze the row before op
        ``rest[0]``. Pack the frozen table into a flat row, replay the tail
        through the flat merge tick, and re-block — migrating to a bigger
        bucket when the replayed table outgrows this one."""
        pool = row.pool
        arrays = pool.row_arrays(row.row)
        order = np.flatnonzero(arrays["valid"])
        n = len(order)
        slots = _next_pow2(max(8, n + 2 * len(rest) + 2))
        packed: dict[str, torch.Tensor] = {}
        for f in mtk.MergeState._fields:
            if f == "count":
                continue
            src = np.asarray(arrays[f])
            dst = np.full((slots,) + src.shape[1:], _MERGE_FILL[f],
                          np.bool_ if f == "valid" else np.int32)
            dst[:n] = src[order]
            packed[f] = torch.from_numpy(dst[None]).to(self.device)
        state1 = mtk.MergeState(
            count=torch.tensor([n], dtype=torch.int32, device=self.device),
            **packed)
        batch = mtk.make_merge_op_batch([rest], 1, _tick_k(len(rest)),
                                        device=self.device)
        state1 = mtc.apply_tick_best(state1, batch)
        out = {f: _host(getattr(state1, f)[0])
               for f in mtk.MergeState._fields}
        if slots > pool.slots:
            src_pool, src_row = pool, row.row
            dst_pool = self._pool_for(slots)
            if dst_pool.num_props < src_pool.num_props:
                dst_pool.grow_props(src_pool.num_props)
            if dst_pool.overlap_words < src_pool.overlap_words:
                dst_pool.grow_overlap(src_pool.overlap_words)
            out["prop_val"] = _np_pad(
                out["prop_val"], 1,
                dst_pool.num_props - out["prop_val"].shape[1], 0)
            out["rem_overlap"] = _np_pad(
                out["rem_overlap"], 1,
                dst_pool.overlap_words - out["rem_overlap"].shape[1], 0)
            dst_pool.alloc(row)
            dst_pool.write_row(row.row, out)
            dst_pool.text.chunks[row.row] = src_pool.text.chunks[src_row]
            dst_pool.text.used[row.row] = src_pool.text.used[src_row]
            src_pool.release(src_row)
            self.stats["migrations"] += 1
        else:
            pool.write_row(row.row, out)
        self.stats["block_overflow_replays"] += 1

    def _decode_pending_op(self, row: _MergeRow, enc: dict,
                           slot_rev: dict[int, str],
                           key_rev: dict[int, str]
                           ) -> tuple[dict, int, int, str | None]:
        """Invert :meth:`_ingest_merge`'s encoding of one pending op back
        to a (channel_op, seq, ref_seq, client) tuple the scalar engine
        applies — the quarantine path's exact-tail replay input."""
        client = slot_rev.get(enc["client"])
        if enc["kind"] == mtk.MT_INSERT:
            start = enc["pool_start"]
            text = row.pool.text.buffer(row.row)[
                start:start + enc["text_len"]]
            op: dict[str, Any] = {"type": "insert", "pos": enc["pos"]}
            if text and text == _MARKER_CHAR * len(text):
                if len(text) == 1:
                    op["marker"] = {"ref_type": "simple", "id": None}
                else:
                    op["items"] = [None] * len(text)
            else:
                op["text"] = text
        elif enc["kind"] == mtk.MT_REMOVE:
            op = {"type": "remove", "start": enc["pos"], "end": enc["end"]}
        else:  # MT_ANNOTATE — one encoded op per (key, value)
            op = {"type": "annotate", "start": enc["pos"],
                  "end": enc["end"],
                  "props": {key_rev[enc["prop_key"]]:
                            self._val_rev[enc["prop_val"]]}}
        return op, enc["seq"], enc["ref_seq"], client

    def _quarantine_merge_row(self, row: _MergeRow, rest: list[dict],
                              err: Exception) -> None:
        """The per-doc escape hatch: a per-row tick failure — overflow
        replay included, a :class:`~..ops._build.KernelError` not — seeds
        the scalar engine from the frozen
        last-good device table, replays the unapplied tail through it, and
        serves the channel scalar from here on; the rest of the batch
        never sees the failure. The channel readmits to the device through
        :meth:`_readmit_scalar_rows` once its window compacts."""
        self.metrics.counter("merge_host.quarantines").inc()
        engine = self._seed_merge_engine(row)
        slot_rev = {s: c for c, s in row.client_slots.items()}
        key_rev = {s: k for k, s in row.key_slots.items()}
        for enc in rest:
            op, seq, ref_seq, client = self._decode_pending_op(
                row, enc, slot_rev, key_rev)
            engine.apply_remote(op, seq, ref_seq, client)
        engine.update_min_seq(row.min_seq)
        self.stats["quarantined_channels"] += 1
        self._demote_row_to_scalar(row, engine)

    def _repack_text_pool(self, row: _MergeRow) -> None:
        """Zamboni for text bytes: rebuild the row's append-only pool from
        the slices its table still references (tombstones included) in
        TABLE order and rewrite the pool_start plane — after this,
        adjacent document-order segments are pool-contiguous (the
        coalescing zamboni's precondition). Pending insert ops' slices
        migrate too and their op dicts are rewritten in place."""
        pool = row.pool
        arrays = pool.row_arrays(row.row)
        buffer = pool.text.buffer(row.row)
        starts = arrays["pool_start"].copy()
        pieces: list[str] = []
        used = 0
        for i in range(arrays["valid"].shape[0]):
            if not arrays["valid"][i] or arrays["length"][i] == 0:
                continue
            start = int(starts[i])
            length = int(arrays["length"][i])
            pieces.append(buffer[start:start + length])
            starts[i] = used
            used += length
        for op in row.pending:
            if op["kind"] == mtk.MT_INSERT and op["text_len"] > 0:
                start = op["pool_start"]
                pieces.append(buffer[start:start + op["text_len"]])
                op["pool_start"] = used
                used += op["text_len"]
        pool.set_pool_start(row.row, starts)
        pool.text.chunks[row.row] = pieces
        pool.text.used[row.row] = used
        # Back off if the row is legitimately large.
        row.repack_at = max(_TEXT_REPACK_MIN, 3 * used)
        self.stats["compactions"] += 1

    @staticmethod
    def _rows_by_pool(rows: list[_MergeRow]
                      ) -> dict[_MergePool, list[_MergeRow]]:
        grouped: dict[_MergePool, list[_MergeRow]] = {}
        for r in rows:
            if r.pending and r.pool is not None:
                grouped.setdefault(r.pool, []).append(r)
        return grouped

    def _flush_map(self) -> None:
        rows = [r for r in self._map_rows.values() if r.pending]
        if not rows:
            return
        max_keys = max(len(r.key_slots) for r in rows)
        if max_keys > self._map_slots:
            self._grow_map_slots(max_keys)
        k = _tick_k(max(len(r.pending) for r in rows))
        per_doc = [[] for _ in range(self._map_capacity)]
        for r in rows:
            per_doc[r.row] = r.pending
        batch = mk.make_map_op_batch(per_doc, self._map_capacity, k,
                                     self.device)
        self._xstate = mk.apply_tick(self._xstate, batch)
        self.stats["device_ops"] += sum(len(r.pending) for r in rows)
        self.stats["flushes"] += 1
        for r in rows:
            r.pending = []

    def _flush_matrix(self) -> None:
        """One matrix tick for every matrix row with pending ops: the cell
        log and the permutation vectors compact (then grow) under
        capacity pressure; a flush of cell writes only, whose refs cover
        every structural op, appends as one cell run; any other flush
        runs the matrix op tick kernel. A kernel failure leaves
        ``flush()``: there is no per-row fallback on this path."""
        rows = [r for r in self._matrix_rows.values() if r.pending]
        if not rows:
            return
        self._ensure_matrix_state()
        vec_extra, cell_extra = self._matrix_vec_shortfall(rows)
        if cell_extra:
            # Dedup the cell append log before paying for growth on ANY
            # path — after cell-run storms it is mostly superseded
            # duplicates (the per-op path would otherwise ratchet device
            # memory that one compaction frees).
            self._matrix_state = mxk.compact_cell_log(self._matrix_state)
            self.stats["compactions"] += 1
            vec_extra, cell_extra = self._matrix_vec_shortfall(rows)
        if vec_extra:
            # Zamboni the permutation vectors before paying for growth —
            # tombstoned row/col segments below the window pack away.
            min_seq = np.full(self._matrix_capacity, -1, np.int32)
            for r in self._matrix_rows.values():
                min_seq[r.row] = r.min_seq
            ms = torch.from_numpy(min_seq).to(self.device)
            self._matrix_state = self._matrix_state._replace(
                rows=mtk.compact(self._matrix_state.rows, ms),
                cols=mtk.compact(self._matrix_state.cols, ms))
            self.stats["compactions"] += 1
            vec_extra, cell_extra = self._matrix_vec_shortfall(rows)
        if vec_extra or cell_extra:
            self._matrix_state = self._pad_matrix_state(
                self._matrix_state, vec_extra=vec_extra,
                cell_extra=cell_extra)
            self._matrix_vec_slots += vec_extra
            self._matrix_cell_slots += cell_extra
        k = _tick_k(max(len(r.pending) for r in rows))
        # Config-4 fast path: a flush that is ALL cell writes whose refs
        # cover every structural op applies scan-free as one [B, k] tile
        # (apply_cell_run) — the steady state of a settled grid under
        # concurrent writers. Any vector op in flight takes the exact
        # per-op kernel.
        if all(op["target"] == mxk.MX_CELL
               and op["ref_seq"] >= r.last_vec_seq
               for r in rows for op in r.pending):
            top = int(self._matrix_state.cell_count.max())
            deficit = k + 1 - (self._matrix_cell_slots - top)
            if deficit > 0:
                # Dedup the append log (superseded writes pack away)
                # before paying for a bigger table — the cell analog of
                # the vector zamboni above.
                self._matrix_state = mxk.compact_cell_log(
                    self._matrix_state)
                self.stats["compactions"] += 1
                top = int(self._matrix_state.cell_count.max())
                deficit = k + 1 - (self._matrix_cell_slots - top)
            if deficit > 0:
                extra = _next_pow2(deficit)
                self._matrix_state = self._pad_matrix_state(
                    self._matrix_state, cell_extra=extra)
                self._matrix_cell_slots += extra
            cells_per_doc: list[list[dict]] = [
                [] for _ in range(self._matrix_capacity)]
            refs = np.zeros(self._matrix_capacity, np.int32)
            clients = np.zeros(self._matrix_capacity, np.int32)
            for r in rows:
                cells_per_doc[r.row] = r.pending
                refs[r.row] = min(op["ref_seq"] for op in r.pending)
            run = mxk.make_cell_run_batch(
                cells_per_doc, self._matrix_capacity, k, refs, clients,
                self.device)
            self._matrix_state = mxk.apply_cell_run(self._matrix_state, run)
            self.stats["cell_run_ticks"] = (
                self.stats.get("cell_run_ticks", 0) + 1)
        else:
            per_doc = [[] for _ in range(self._matrix_capacity)]
            for r in rows:
                per_doc[r.row] = r.pending
            batch = mxk.make_matrix_op_batch(per_doc, self._matrix_capacity,
                                             k, self.device)
            self._matrix_state = mxc.apply_tick_best(self._matrix_state,
                                                     batch)
        self.stats["device_ops"] += sum(len(r.pending) for r in rows)
        self.stats["flushes"] += 1
        for r in rows:
            r.pending = []
            r.raw_log = []  # device row now reflects the whole history
            r.applied_seq = r.last_seq
            r.applied_min_seq = r.min_seq

    # -- tree channels (SharedTree.ts:446 behind the service) ------------------
    #
    # Device-served edit shapes (everything else routes the channel to the
    # scalar fallback, which replays the exact sequenced-edit log through
    # Transaction — always correct, never fast):
    #
    #   [set_value]                      → TREE_SET_VALUE
    #   [detach(single-node, no dest)]   → TREE_DETACH
    #   [constraint]                     → TREE_CONSTRAINT_EXISTS (no mutation)
    #   [build, insert(source=build)]    → TREE_INSERT* chain
    #   [detach(single, dest), insert]   → TREE_MOVE* (fused subtree move)
    #
    # Atomicity argument (a scalar Transaction drops the WHOLE edit when
    # any change fails): single-change edits are trivially atomic; a
    # build+insert chain cascades — children/siblings anchor on the
    # previous insert's node, so a failed first placement starves every
    # later op of its anchor; a move pair is one device op. Multi-change
    # edits outside these shapes (e.g. two independent set_values) cannot
    # cascade, so they are not device-served.

    def _tree_row(self, key: ChannelKey) -> _TreeRow:
        state = self._tree_rows.get(key)
        if state is None:
            row = len(self._tree_rows)
            if row >= self._tree_capacity:
                self._grow_tree_rows()
            state = _TreeRow(row)
            self._tree_rows[key] = state
        return state

    def _ensure_tree_state(self) -> None:
        if self._tree_state is None:
            self._tree_state = tk.init_state(self._tree_capacity,
                                             self._tree_slots, self.device)

    def _grow_tree_rows(self) -> None:
        old = self._tree_capacity
        self._tree_capacity = old * 2
        if self._tree_state is not None:
            padded = {f: _pad_axis(getattr(self._tree_state, f), 0, old,
                                   _TREE_FILL[f])
                      for f in tk.TreeState._fields}
            # Fresh rows must carry a live root in slot 0.
            padded["exists"][old:, 0] = True
            self._tree_state = tk.TreeState(**padded)

    def _grow_tree_slots(self, need: int) -> None:
        new = _next_pow2_width(self._tree_slots, need)
        if new == self._tree_slots:
            return
        extra = new - self._tree_slots
        if self._tree_state is not None:
            self._tree_state = tk.TreeState(**{
                f: _pad_axis(getattr(self._tree_state, f), 1, extra,
                             _TREE_FILL[f])
                for f in tk.TreeState._fields})
        self._tree_slots = new

    def _blank_tree_row(self, row: int) -> None:
        """Reset one row of the tree planes to a lone root (in place)."""
        for f in tk.TreeState._fields:
            getattr(self._tree_state, f)[row] = _TREE_FILL[f]
        self._tree_state.exists[row, 0] = True

    def _ingest_tree(self, key: ChannelKey, channel_op: dict,
                     message: SequencedDocumentMessage) -> None:
        row = self._tree_row(key)
        seq = message.sequence_number
        if seq <= row.last_seq:
            return  # bus replay
        row.last_seq = seq
        edit = channel_op["edit"]
        if row.scalar is not None:
            self._tree_scalar_apply(row, edit)
            self.stats["scalar_ops"] += 1
            return
        row.raw_log.append(edit)
        ops = self._encode_tree_edit(row, edit)
        if row.scalar is not None:
            # A capacity flush inside encoding overflowed this row and the
            # scalar replay (from raw_log) already covered this edit.
            return
        if ops is None:
            self._route_tree_to_scalar(row)
            self.stats["scalar_ops"] += 1
            return
        row.pending.extend(ops)
        self._pending_ops += len(ops)

    def _tree_scalar_apply(self, row: _TreeRow, edit: dict) -> None:
        txn = Transaction(row.scalar)
        if txn.apply_edit(edit) == VALID:
            row.scalar = txn.snapshot

    def _route_tree_to_scalar(self, row: _TreeRow) -> None:
        """Replay the channel's sequenced edits (on top of the trimmed
        base snapshot, if any) through the scalar Transaction path and
        serve it host-side from now on."""
        snap = (TreeSnapshot.load(row.base) if row.base is not None
                else TreeSnapshot())
        for edit in row.raw_log:
            txn = Transaction(snap)
            if txn.apply_edit(edit) == VALID:
                snap = txn.snapshot
        row.scalar = snap
        row.raw_log = []  # the snapshot IS the state from here on
        self._pending_ops -= len(row.pending)
        row.pending = []
        if self._tree_state is not None:
            self._blank_tree_row(row.row)
        self.stats["overflow_routed"] += 1
        self._export_stats()

    # -- tree edit translation -------------------------------------------------

    def _tree_trait_id(self, row: _TreeRow, label: Any) -> int:
        tid = row.trait_ids.get(label)
        if tid is None:
            tid = len(row.trait_rev) + 1  # 0 = the root's own trait plane
            row.trait_ids[label] = tid
            row.trait_rev.append(label)
        return tid

    def _encode_tree_edit(self, row: _TreeRow,
                          edit: dict) -> list[dict] | None:
        """Device ops for one edit; [] = no state change either way
        (scalar-invalid or no-op), None = unsupported shape → scalar."""
        changes = edit.get("changes")
        if not isinstance(changes, list):
            return None
        if len(changes) == 1:
            ch = changes[0]
            kind = ch.get("type")
            if kind == "set_value":
                slot = row.slot_of.get(ch.get("node"))
                if slot is None:
                    return []  # unknown node: scalar-invalid
                return [dict(kind=tk.TREE_SET_VALUE, node=slot,
                             payload=self._intern(ch.get("payload")))]
            if kind == "detach" and ch.get("destination") is None:
                return self._encode_tree_detach(row, ch.get("source"))
            if kind == "constraint":
                return self._encode_tree_constraint(row, ch)
            return None
        if len(changes) == 2:
            first, second = changes
            if (first.get("type") == "build"
                    and second.get("type") == "insert"
                    and second.get("source") == first.get("destination")):
                return self._encode_tree_build_insert(row, first, second)
            if (first.get("type") == "detach"
                    and first.get("destination") is not None
                    and second.get("type") == "insert"
                    and second.get("source") == first.get("destination")):
                return self._encode_tree_move(row, first, second)
        return None

    @staticmethod
    def _single_node_range(source: Any) -> tuple[str, bool] | None:
        """(sibling id, is_real_range) for a same-sibling range; None for
        ranges the device cannot enumerate (multi-node / trait-based).
        is_real_range is False for empty or inverted ranges — scalar
        treats those as a valid no-op / an invalid edit respectively, and
        either way no state changes."""
        if not isinstance(source, dict):
            return None
        start, end = source.get("start"), source.get("end")
        if not (isinstance(start, dict) and isinstance(end, dict)):
            return None
        sib = start.get("referenceSibling")
        if sib is None or end.get("referenceSibling") != sib:
            return None
        real = (start.get("side") == "before"
                and end.get("side") == "after")
        return sib, real

    def _encode_tree_detach(self, row: _TreeRow,
                            source: Any) -> list[dict] | None:
        rng = self._single_node_range(source)
        if rng is None:
            return None
        sib, real = rng
        if not real or sib == ROOT_ID:
            return []
        slot = row.slot_of.get(sib)
        if slot is None:
            return []  # unknown anchor: scalar-invalid
        return [dict(kind=tk.TREE_DETACH, node=slot)]

    def _encode_tree_constraint(self, row: _TreeRow,
                                ch: dict) -> list[dict]:
        # Constraints never mutate; their only effect is edit validity,
        # which for a single-change edit changes no state. Emit EXISTS
        # checks where translatable so the device path is exercised.
        rng = ch.get("range")
        if not isinstance(rng, dict):
            return []
        ops = []
        for place in (rng.get("start"), rng.get("end")):
            if not isinstance(place, dict):
                continue
            sib = place.get("referenceSibling")
            if sib and sib != ROOT_ID:
                slot = row.slot_of.get(sib)
                if slot:
                    ops.append(dict(kind=tk.TREE_CONSTRAINT_EXISTS,
                                    node=slot))
        return ops

    _TREE_INVALID = "invalid"

    def _encode_tree_place(self, row: _TreeRow, place: Any):
        """(insert kind, anchor slot, trait id) | "invalid" (scalar drops
        the edit — no state change) | None (unsupported)."""
        if not isinstance(place, dict):
            return None
        if "referenceSibling" in place:
            sib = place["referenceSibling"]
            if sib == ROOT_ID:
                return self._TREE_INVALID
            slot = row.slot_of.get(sib)
            if slot is None:
                return self._TREE_INVALID
            kind = (tk.TREE_INSERT_BEFORE if place.get("side") == "before"
                    else tk.TREE_INSERT_AFTER)
            return kind, slot, 0
        trait = place.get("referenceTrait")
        if not isinstance(trait, dict):
            return None
        pslot = row.slot_of.get(trait.get("parent"))
        if pslot is None:
            return self._TREE_INVALID
        tid = self._tree_trait_id(row, trait.get("label"))
        kind = (tk.TREE_INSERT_START if place.get("side") == "start"
                else tk.TREE_INSERT)
        return kind, pslot, tid

    @staticmethod
    def _count_spec_nodes(specs: list) -> int | None:
        total = 0
        stack = list(specs)
        while stack:
            spec = stack.pop()
            if not isinstance(spec, dict) or "id" not in spec:
                return None
            total += 1
            for child_specs in (spec.get("traits") or {}).values():
                stack.extend(child_specs)
        return total

    def _ensure_tree_slots(self, row: _TreeRow, fresh: int) -> None:
        shortfall = fresh - len(row.free)
        if shortfall <= 0 or row.next_slot + shortfall <= self._tree_slots:
            return
        # Apply pending first so the exists read-back is current, then
        # reclaim slots of deleted/never-materialized nodes (the tree
        # zamboni); grow only if that is not enough. NOTE: the flush can
        # overflow-route THIS row to scalar — callers re-check.
        self.flush()
        if row.scalar is None:
            self._reclaim_tree_slots(row)
        shortfall = fresh - len(row.free)
        if shortfall > 0 and row.next_slot + shortfall > self._tree_slots:
            self._grow_tree_slots(_next_pow2(row.next_slot + shortfall))

    def _reclaim_tree_slots(self, row: _TreeRow) -> None:
        if self._tree_state is None:
            return
        exists = self._tree_state.exists[row.row].cpu().numpy()
        in_free = set(row.free)
        for slot in list(row.info_of):
            if slot != 0 and slot not in in_free and not exists[slot]:
                node_id, _ = row.info_of.pop(slot)
                row.slot_of.pop(node_id, None)
                row.free.append(slot)
        self.stats["compactions"] += 1

    def _alloc_tree_slot(self, row: _TreeRow, spec: dict) -> int:
        slot = row.free.pop() if row.free else row.next_slot
        if slot == row.next_slot:
            row.next_slot += 1
        row.slot_of[spec["id"]] = slot
        row.info_of[slot] = (spec["id"], spec.get("definition", ""))
        return slot

    def _encode_tree_build_insert(self, row: _TreeRow, build: dict,
                                  insert: dict) -> list[dict] | None:
        specs = build.get("source")
        if not isinstance(specs, list) or not specs:
            return None
        count = self._count_spec_nodes(specs)
        if count is None:
            return None
        # Conservative: an id collision with ANY known node (alive or not)
        # breaks the cascade-atomicity argument (a colliding insert fails
        # but leaves an EXISTING anchor) — scalar handles it exactly.
        stack = list(specs)
        while stack:
            spec = stack.pop()
            if spec["id"] in row.slot_of:
                return None
            for child_specs in (spec.get("traits") or {}).values():
                stack.extend(child_specs)
        place = self._encode_tree_place(row, insert.get("destination"))
        if place is None:
            return None
        if place == self._TREE_INVALID:
            return []
        self._ensure_tree_slots(row, count)
        if row.scalar is not None:
            return []  # flush inside ensure overflow-routed this row
        kind, anchor, tid = place
        ops: list[dict] = []
        prev_slot = -1
        for spec in specs:
            slot = self._alloc_tree_slot(row, spec)
            if prev_slot < 0:
                ops.append(dict(kind=kind, node=slot, parent=anchor,
                                trait=tid,
                                payload=self._intern(spec.get("payload"))))
            else:
                # Later top-level siblings chain after the previous one,
                # matching the scalar's list splice order.
                ops.append(dict(kind=tk.TREE_INSERT_AFTER, node=slot,
                                parent=prev_slot,
                                payload=self._intern(spec.get("payload"))))
            prev_slot = slot
            self._encode_tree_children(row, spec, slot, ops)
        return ops

    def _encode_tree_children(self, row: _TreeRow, spec: dict,
                              parent_slot: int, ops: list[dict]) -> None:
        for label, child_specs in (spec.get("traits") or {}).items():
            tid = self._tree_trait_id(row, label)
            for child in child_specs:
                slot = self._alloc_tree_slot(row, child)
                ops.append(dict(kind=tk.TREE_INSERT, node=slot,
                                parent=parent_slot, trait=tid,
                                payload=self._intern(child.get("payload"))))
                self._encode_tree_children(row, child, slot, ops)

    _MOVE_KIND = {tk.TREE_INSERT: tk.TREE_MOVE,
                  tk.TREE_INSERT_START: tk.TREE_MOVE_START,
                  tk.TREE_INSERT_BEFORE: tk.TREE_MOVE_BEFORE,
                  tk.TREE_INSERT_AFTER: tk.TREE_MOVE_AFTER}

    def _encode_tree_move(self, row: _TreeRow, detach: dict,
                          insert: dict) -> list[dict] | None:
        rng = self._single_node_range(detach.get("source"))
        if rng is None:
            return None
        sib, real = rng
        if not real or sib == ROOT_ID:
            return []  # empty/inverted range: no-op or invalid either way
        slot = row.slot_of.get(sib)
        if slot is None:
            return []  # unknown node: scalar-invalid
        place = self._encode_tree_place(row, insert.get("destination"))
        if place is None:
            return None
        if place == self._TREE_INVALID:
            return []
        kind, anchor, tid = place
        return [dict(kind=self._MOVE_KIND[kind], node=slot, parent=anchor,
                     trait=tid)]

    def _flush_tree(self) -> None:
        items = [(key, r) for key, r in self._tree_rows.items()
                 if r.pending]
        if not items:
            return
        self._ensure_tree_state()
        k = _tick_k(max(len(r.pending) for _, r in items))
        per_doc: list[list[dict]] = [[] for _ in range(self._tree_capacity)]
        for _, r in items:
            per_doc[r.row] = r.pending
        batch = tk.make_tree_op_batch(per_doc, self._tree_capacity, k,
                                      self.device)
        self._tree_state, outs = tcc.apply_tick_best(
            self._tree_state, batch, tk.subtree_steps(per_doc, k))
        overflowed = outs.overflow.any(dim=1).cpu().numpy()
        self.stats["device_ops"] += sum(len(r.pending) for _, r in items)
        self.stats["flushes"] += 1
        for _, r in items:
            r.pending = []
        for key, r in items:
            if overflowed[r.row]:
                # Rank space or depth exhausted mid-tick: the device state
                # is partially applied; rebuild exactly from base + log.
                self._route_tree_to_scalar(r)
            elif len(r.raw_log) > _TREE_LOG_TRIM:
                # Clean boundary: the device row reflects the whole log —
                # fold it into a materialized base snapshot.
                r.base = self.tree_snapshot(*key)
                r.raw_log = []
                self.stats["compactions"] += 1

    # -- materialization -------------------------------------------------------

    def channels(self, doc_id: str) -> list[ChannelKey]:
        return sorted(
            [k for k in self._merge_rows if k.doc_id == doc_id]
            + [k for k in self._map_rows if k.doc_id == doc_id]
            + [k for k in self._matrix_rows if k.doc_id == doc_id]
            + [k for k in self._tree_rows if k.doc_id == doc_id])

    def tree_snapshot(self, doc_id: str, datastore: str,
                      channel: str) -> dict:
        """Converged tree of a SharedTree channel in the canonical
        ``TreeSnapshot.serialize()`` form (byte-comparable to replicas)."""
        key = ChannelKey(doc_id, datastore, channel)
        row = self._tree_rows[key]
        if row.pending:
            self.flush()
        if row.scalar is not None:
            return row.scalar.serialize()
        if self._tree_state is None:
            return TreeSnapshot().serialize()
        exists, parent, trait, rank, payload = (
            plane[row.row].cpu().numpy() for plane in self._tree_state)
        # Children of each (parent, trait), rank-ascending (slot index
        # breaks exact-rank ties — ranks are unique per trait in practice:
        # colliding midpoints overflow to the scalar path instead).
        by_parent: dict[int, dict[int, list[int]]] = {}
        for slot in range(exists.shape[0]):
            if exists[slot] and slot != 0:
                by_parent.setdefault(int(parent[slot]), {}).setdefault(
                    int(trait[slot]), []).append(slot)
        out: dict[str, dict] = {}
        for slot in range(exists.shape[0]):
            if not exists[slot]:
                continue
            node_id, definition = row.info_of[slot]
            traits = {}
            for tid, slots in sorted(
                    by_parent.get(slot, {}).items(),
                    key=lambda kv: row.trait_rev[kv[0] - 1]):
                slots.sort(key=lambda i: (int(rank[i]), i))
                traits[row.trait_rev[tid - 1]] = [
                    row.info_of[i][0] for i in slots]
            out[node_id] = {
                "definition": definition,
                "payload": self._val_rev[payload[slot]],
                "traits": traits,
                "parent": (None if slot == 0 else
                           [row.info_of[int(parent[slot])][0],
                            row.trait_rev[int(trait[slot]) - 1]]),
            }
        return dict(sorted(out.items()))

    def matrix_grid(self, doc_id: str, datastore: str,
                    channel: str) -> list[list]:
        """Converged dense grid of a matrix channel (None = unset)."""
        row = self._matrix_rows[ChannelKey(doc_id, datastore, channel)]
        if row.pending:
            self.flush()
        if row.scalar is not None:
            rows_vec, cols_vec, cells = row.scalar

            def live(vec: PermutationVector) -> list[int]:
                return [h for seg in vec.engine.segments
                        if seg.removed_seq is None for h in seg.content]
            return [[cells.get((r, c)) for c in live(cols_vec)]
                    for r in live(rows_vec)]
        return mxk.materialize_grid(self._matrix_state, row.row,
                                    self._val_rev)

    def text(self, doc_id: str, datastore: str, channel: str) -> str:
        """Converged text of a string channel (markers stripped)."""
        row = self._merge_rows[ChannelKey(doc_id, datastore, channel)]
        if row.pending:
            self.flush()
        if row.scalar is not None:
            return "".join(
                seg.content for seg in row.scalar.segments
                if seg.removed_seq is None and not seg.is_marker
                and isinstance(seg.content, str))
        return row.pool.materialize_row(row.row).replace(_MARKER_CHAR, "")

    def rich_text(self, doc_id: str, datastore: str,
                  channel: str) -> list[tuple[str, dict | None]]:
        """(text, props) runs of a string channel, markers as ("\\x00", …)."""
        row = self._merge_rows[ChannelKey(doc_id, datastore, channel)]
        if row.pending:
            self.flush()
        if row.scalar is not None:
            return [(seg.content if isinstance(seg.content, str)
                     else _MARKER_CHAR,
                     dict(seg.props) if seg.props else None)
                    for seg in row.scalar.segments
                    if seg.removed_seq is None and seg.length > 0]
        key_rev = {slot: name for name, slot in row.key_slots.items()}
        arrays = row.pool.row_arrays(row.row)
        valid = arrays["valid"]
        length = arrays["length"]
        rem = arrays["rem_seq"]
        start = arrays["pool_start"]
        pvals = arrays["prop_val"]
        buffer = row.pool.text.buffer(row.row)
        out = []
        for i in range(valid.shape[0]):
            if not (valid[i] and rem[i] == mtk.NONE_SEQ and length[i] > 0):
                continue
            props = {key_rev[p]: self._val_rev[pvals[i, p]]
                     for p in range(pvals.shape[1])
                     if pvals[i, p] != 0 and p in key_rev}
            out.append((buffer[start[i]:start[i] + length[i]],
                        props or None))
        return out

    def map_entries(self, doc_id: str, datastore: str,
                    channel: str) -> dict[str, Any]:
        """Converged entries of a map channel (wire-format values)."""
        key = ChannelKey(doc_id, datastore, channel)
        row = self._map_rows[key]
        if row.pending:
            self.flush()
        present = self._xstate.present[row.row].cpu().numpy()
        value = self._xstate.value[row.row].cpu().numpy()
        if row.literal_values:
            return {name: int(value[slot])
                    for name, slot in row.key_slots.items()
                    if present[slot]}
        return {name: self._val_rev[value[slot]]
                for name, slot in row.key_slots.items() if present[slot]}

    def summarize(self, doc_id: str) -> dict:
        """Materialize every tracked channel of a document."""
        self.flush()
        datastores: dict[str, dict] = {}
        for key in self.channels(doc_id):
            channels = datastores.setdefault(key.datastore, {})
            if key in self._merge_rows:
                channels[key.channel] = {"kind": "mergeTree",
                                         "content": self.rich_text(*key)}
            elif key in self._matrix_rows:
                channels[key.channel] = {"kind": "matrix",
                                         "grid": self.matrix_grid(*key)}
            elif key in self._tree_rows:
                channels[key.channel] = {"kind": "tree",
                                         "tree": self.tree_snapshot(*key)}
            else:
                channels[key.channel] = {"kind": "map",
                                         "entries": self.map_entries(*key)}
        seqs = [r.last_seq for k, r in self._merge_rows.items()
                if k.doc_id == doc_id]
        seqs += [r.last_seq for k, r in self._map_rows.items()
                 if k.doc_id == doc_id]
        seqs += [r.last_seq for k, r in self._matrix_rows.items()
                 if k.doc_id == doc_id]
        seqs += [r.last_seq for k, r in self._tree_rows.items()
                 if k.doc_id == doc_id]
        return {"datastores": datastores,
                "sequence_number": max(seqs, default=0)}

    # -- snapshot / restore (device-pool checkpoint) ---------------------------
    #
    # export_state() captures every device plane plus the host-side
    # string/slot mappings in the reference's wire format (same keys, same
    # byte packing: bool planes stay bool), so either package's host
    # imports the other's snapshot: merge pools, the map state and matrix
    # rows (device and scalar). Tree channels are NOT snapshotted: they
    # rebuild from the scriptorium durable-log replay (the merger lambda
    # does this on restart); export records their keys so the caller
    # knows replay is required, and import skips them.

    def export_state(self) -> dict:
        """Wire-serializable checkpoint of all device pools + host maps.
        Flushes first so no pending/raw tails need serializing."""
        self.flush()
        pools = []
        pool_index: dict[int, int] = {}
        all_pools = ([(False, s, p) for s, p
                      in sorted(self._merge_pools.items())]
                     + [(True, s, p) for s, p
                        in sorted(self._mega_pools.items())])
        for mega, _slots, pool in all_pools:
            kind = ("sharded" if isinstance(pool, _ShardedMergePool)
                    else "block" if isinstance(pool, _BlockMergePool)
                    else "flat")
            pool_index[id(pool)] = len(pools)
            pools.append({
                "kind": kind, "mega": mega, "slots": pool.slots,
                "num_props": pool.num_props,
                "overlap_words": pool.overlap_words,
                "capacity": pool.capacity,
                **({"block_geometry": [pool.nb, pool.bk]}
                   if kind == "block" else {}),
                "planes": {f: _nd_pack(getattr(pool.state, f).cpu().numpy())
                           for f in type(pool.state)._fields},
                "text": [pool.text.buffer(r) for r in range(pool.capacity)],
                "text_used": list(pool.text.used),
                "free": list(pool.free),
                "n_members": len(pool.members),
            })
        merge_rows = []
        for key, r in self._merge_rows.items():
            assert not r.pending and not r.raw_log, (
                "export_state after flush() found pending ops")
            merge_rows.append({
                "key": list(key),
                "pool": (pool_index[id(r.pool)]
                         if r.pool is not None else None),
                "row": r.row,
                "client_slots": r.client_slots,
                "key_slots": r.key_slots,
                "min_seq": r.min_seq, "last_seq": r.last_seq,
                "applied_seq": r.applied_seq,
                "applied_min_seq": r.applied_min_seq,
                "repack_at": r.repack_at,
                "scalar": (_dump_engine(r.scalar)
                           if r.scalar is not None else None),
            })
        map_rows = [{
            "key": list(key), "row": r.row, "key_slots": r.key_slots,
            "last_seq": r.last_seq, "literal": r.literal_values,
        } for key, r in self._map_rows.items()]
        matrix = None
        if self._matrix_rows or self._matrix_state is not None:
            state = None
            if self._matrix_state is not None:
                s = self._matrix_state
                state = {f: _nd_pack(getattr(s, f).cpu().numpy())
                         if f not in ("rows", "cols") else
                         {g: _nd_pack(getattr(getattr(s, f), g).cpu().numpy())
                          for g in mtk.MergeState._fields}
                         for f in mxk.MatrixState._fields}
            matrix = {
                "capacity": self._matrix_capacity,
                "vec_slots": self._matrix_vec_slots,
                "cell_slots": self._matrix_cell_slots,
                "overlap_words": self._matrix_overlap_words,
                "state": state,
                "rows": [{
                    "key": list(key), "row": r.row,
                    "client_slots": r.client_slots,
                    "last_seq": r.last_seq, "min_seq": r.min_seq,
                    "applied_seq": r.applied_seq,
                    "applied_min_seq": r.applied_min_seq,
                    "next_row_handle": r.next_row_handle,
                    "next_col_handle": r.next_col_handle,
                    "last_vec_seq": r.last_vec_seq,
                    "scalar": (_dump_matrix_scalar(r.scalar)
                               if r.scalar is not None else None),
                } for key, r in self._matrix_rows.items()],
            }
        return {
            "version": 1,
            "vals": list(self._val_rev),
            "merge_pools": pools,
            "merge_rows": merge_rows,
            "map": {
                "capacity": self._map_capacity, "slots": self._map_slots,
                "planes": {f: _nd_pack(getattr(self._xstate, f).cpu().numpy())
                           for f in mk.MapState._fields},
                "rows": map_rows,
            },
            "matrix": matrix,
            # Not snapshotted — these channels need a durable-log replay.
            "tree_keys": [list(k) for k in self._tree_rows],
            "stats": dict(self.stats),
        }

    def import_state(self, snap: dict) -> None:
        """Rebuild a FRESH host from :meth:`export_state` output (of either
        package)."""
        assert not (self._map_rows or self._merge_rows or self._matrix_rows
                    or self._tree_rows), "import_state needs a fresh host"
        if snap.get("version") != 1:
            raise ValueError(f"unknown snapshot version {snap.get('version')}")
        self._val_rev = list(snap["vals"])
        self._vals = {repr(v): i for i, v in enumerate(self._val_rev)
                      if i != 0}

        pools: list[_MergePool] = []
        for p in snap["merge_pools"]:
            if p["kind"] == "block":
                geom = p.get("block_geometry")
                pool: _MergePool = _BlockMergePool(
                    p["slots"], p["num_props"], p["capacity"],
                    p["overlap_words"], block_slots=geom[1] if geom else None,
                    device=self.device)
            elif p["kind"] == "flat":
                pool = _MergePool(p["slots"], p["num_props"], p["capacity"],
                                  p["overlap_words"], device=self.device)
            else:  # sharded: needs a seg_mesh like the exporting host's
                if self.seg_mesh is None:
                    raise ValueError(
                        "snapshot holds a sequence-parallel pool but this "
                        "host has no seg_mesh")
                pool = _ShardedMergePool(p["slots"], p["num_props"],
                                         self.seg_mesh, p["capacity"],
                                         p["overlap_words"],
                                         mega=p.get("mega", False))
            cls = type(pool.state)
            pool.state = cls(**{
                f: torch.from_numpy(_nd_unpack(p["planes"][f])).to(
                    self.device) for f in cls._fields})
            pool.text = mtk.TextPool(p["capacity"])
            for r, text in enumerate(p["text"]):
                if text:
                    pool.text.chunks[r] = [text]
            pool.text.used = list(p["text_used"])
            pool.free = list(p["free"])
            pool.members = [None] * p["n_members"]
            if p.get("mega", False):
                self._mega_pools[p["slots"]] = pool
            else:
                self._merge_pools[p["slots"]] = pool
            pools.append(pool)

        for rec in snap["merge_rows"]:
            r = _MergeRow()
            r.client_slots = dict(rec["client_slots"])
            r.key_slots = dict(rec["key_slots"])
            r.min_seq, r.last_seq = rec["min_seq"], rec["last_seq"]
            r.applied_seq = rec["applied_seq"]
            r.applied_min_seq = rec["applied_min_seq"]
            r.repack_at = rec["repack_at"]
            if rec["scalar"] is not None:
                r.scalar = _load_engine(rec["scalar"])
                r.pool, r.row = None, -1
            else:
                r.pool = pools[rec["pool"]]
                r.row = rec["row"]
                r.pool.members[r.row] = r
            self._merge_rows[ChannelKey(*rec["key"])] = r

        m = snap["map"]
        self._map_capacity, self._map_slots = m["capacity"], m["slots"]
        self._xstate = mk.MapState(**{
            f: torch.from_numpy(_nd_unpack(m["planes"][f])).to(self.device)
            for f in mk.MapState._fields})
        for rec in m["rows"]:
            row = _MapRow(rec["row"])
            row.key_slots = dict(rec["key_slots"])
            row.last_seq = rec["last_seq"]
            row.literal_values = rec["literal"]
            self._map_rows[ChannelKey(*rec["key"])] = row
        # Row allocator resumes past the restored rows; gaps left by
        # pre-snapshot evictions are reissued exactly like live frees.
        used = {r.row for r in self._map_rows.values()}
        self._map_row_count = max(used, default=-1) + 1
        self._free_map_rows = [r for r in range(self._map_row_count)
                               if r not in used]

        mx = snap.get("matrix")
        if mx is not None:
            self._matrix_capacity = mx["capacity"]
            self._matrix_vec_slots = mx["vec_slots"]
            self._matrix_cell_slots = mx["cell_slots"]
            self._matrix_overlap_words = mx["overlap_words"]
            if mx["state"] is not None:
                st = mx["state"]

                def planes(packed, fields):
                    return {f: torch.from_numpy(_nd_unpack(packed[f])).to(
                        self.device) for f in fields}
                self._matrix_state = mxk.MatrixState(
                    rows=mtk.MergeState(**planes(st["rows"],
                                                 mtk.MergeState._fields)),
                    cols=mtk.MergeState(**planes(st["cols"],
                                                 mtk.MergeState._fields)),
                    **planes(st, mxk.CELL_FILL.keys() | {"cell_count"}))
            for rec in mx["rows"]:
                row = _MatrixRow(rec["row"])
                row.client_slots = dict(rec["client_slots"])
                row.last_seq, row.min_seq = rec["last_seq"], rec["min_seq"]
                row.applied_seq = rec["applied_seq"]
                row.applied_min_seq = rec["applied_min_seq"]
                row.next_row_handle = rec["next_row_handle"]
                row.next_col_handle = rec["next_col_handle"]
                row.last_vec_seq = rec["last_vec_seq"]
                if rec["scalar"] is not None:
                    row.scalar = _load_matrix_scalar(rec["scalar"])
                self._matrix_rows[ChannelKey(*rec["key"])] = row


def _nd_pack(a: np.ndarray) -> dict:
    """ndarray → wire dict (dtype + shape + b64 of the raw bytes)."""
    import base64
    a = np.ascontiguousarray(a)
    return {"d": a.dtype.str, "s": list(a.shape),
            "b": base64.b64encode(a.tobytes()).decode()}


def _nd_unpack(d: dict) -> np.ndarray:
    import base64
    return np.frombuffer(base64.b64decode(d["b"]),
                         np.dtype(d["d"])).reshape(d["s"]).copy()


def _dump_content(content) -> Any:
    if isinstance(content, str):
        return content
    if isinstance(content, Marker):
        return {"marker": [content.ref_type, content.id]}
    return {"items": list(content)}  # handle / item run


def _load_content(data) -> Any:
    if isinstance(data, str):
        return data
    if "marker" in data:
        return Marker(ref_type=data["marker"][0], id=data["marker"][1])
    return tuple(data["items"])


def _dump_engine(engine: MergeEngine) -> dict:
    """Serialize a server-side scalar engine (remote ops only, so no
    local pending state)."""
    return {
        "current_seq": engine.current_seq,
        "min_seq": engine.min_seq,
        "segments": [{
            "content": _dump_content(seg.content),
            "seq": seg.seq,
            "client": seg.client,
            "removed_seq": seg.removed_seq,
            "removed_client": seg.removed_client,
            "removed_overlap": sorted(seg.removed_overlap),
            "props": seg.props,
        } for seg in engine.segments],
    }


def _load_engine(data: dict) -> MergeEngine:
    engine = MergeEngine(local_client=None)
    engine.current_seq = data["current_seq"]
    engine.min_seq = data["min_seq"]
    for s in data["segments"]:
        engine.segments.append(Segment(
            content=_load_content(s["content"]),
            seq=s["seq"], client=s["client"],
            removed_seq=s["removed_seq"],
            removed_client=s["removed_client"],
            removed_overlap=set(s["removed_overlap"]),
            props=dict(s["props"]) if s["props"] else None,
        ))
    return engine


def _dump_matrix_scalar(scalar: tuple) -> dict:
    rows_vec, cols_vec, cells = scalar
    return {
        "rows": {"engine": _dump_engine(rows_vec.engine),
                 "next_handle": rows_vec.next_handle},
        "cols": {"engine": _dump_engine(cols_vec.engine),
                 "next_handle": cols_vec.next_handle},
        "cells": [[rh, ch, v] for (rh, ch), v in sorted(cells.items())],
    }


def _load_matrix_scalar(data: dict) -> tuple:
    def load_vec(d):
        vec = PermutationVector(None)
        vec.engine = _load_engine(d["engine"])
        vec.next_handle = d["next_handle"]
        return vec

    return (load_vec(data["rows"]), load_vec(data["cols"]),
            {(rh, ch): v for rh, ch, v in data["cells"]})


__all__ = ["ChannelKey", "KernelMergeHost"]
