"""KernelMergeHost — device-resident converged document state on the server.

Port of the map half of ``fluidframework_tpu/server/merge_host.py``.
Reference parity: the *server-observed* SharedMap message fold
(packages/dds/map/src/mapKernel.ts:510 tryProcessMessage), hosted behind
the service seams as one batched device program: every (document,
datastore, channel) map is a row of :class:`~fluidframework_tpu_torch.
ops.map_kernel.MapState`; a service tick applies the pending sequenced
ops of all map channels in one ``apply_tick`` call.

The host owns what the kernels cannot: the key → key-slot and value →
interned-id mappings, capacity growth (doubling on both axes), and
materialization of converged entries.

Only the map family is ported so far. Text (merge-tree), matrix and tree
ops reaching :meth:`KernelMergeHost.ingest` raise ``NotImplementedError``
naming the family; the class keeps the reference's shape (``stats``,
``metrics``, ``export_state`` sections) so those pools slot in later.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import map_kernel as mk
from ..protocol.messages import MessageType, SequencedDocumentMessage
from .kernel_host import _tick_k

_MERGE_OPS = frozenset({"insert", "remove", "annotate", "group"})
_MAP_OPS = frozenset({"set", "delete", "clear"})


class ChannelKey(NamedTuple):
    doc_id: str
    datastore: str
    channel: str


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


def _pad_axis(a: torch.Tensor, axis: int, extra: int, fill) -> torch.Tensor:
    """``a`` grown by ``extra`` entries of ``fill`` along ``axis``."""
    shape = list(a.shape)
    shape[axis] = extra
    return torch.cat((a, torch.full(shape, fill, dtype=a.dtype,
                                    device=a.device)), dim=axis)


def _next_pow2_width(cur: int, need: int) -> int:
    """Doubling growth policy shared by every plane-width axis: the
    smallest pow2 multiple of ``cur`` that fits ``need``."""
    while cur < need:
        cur *= 2
    return cur


_MAP_FILL = dict(present=False, value=0, vseq=-1, cleared_seq=-1)


class KernelMergeHost:
    """Batched device host for the map apply kernel."""

    def __init__(self, map_slots: int = 32, row_capacity: int = 8,
                 flush_threshold: int = 256, metrics=None,
                 device: str | torch.device | None = None) -> None:
        from ..utils import MetricsRegistry
        self.device = resolve_device(device)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._map_capacity = max(1, row_capacity)
        self._map_slots = max(4, map_slots)
        self.flush_threshold = flush_threshold
        self._xstate = mk.init_state(self._map_capacity, self._map_slots,
                                     self.device)
        self._map_rows: dict[ChannelKey, _MapRow] = {}
        # Map-row recycling (doc residency): released rows reissue before
        # the high-water counter grows the state — see release_map_row.
        self._free_map_rows: list[int] = []
        self._map_row_count = 0
        # Shared value interning. Id 0 is reserved for "absent"/None; ids
        # index _val_rev.
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
        """Feed one sequenced message. Non-channel-ops are ignored; map
        channel ops are routed to their device rows. Text, matrix and tree
        ops raise ``NotImplementedError`` (not ported yet)."""
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
            raise NotImplementedError(
                "matrix channel ops are not ported to the torch merge host")
        if kind == "edit" and "edit" in channel_op:
            raise NotImplementedError(
                "tree channel ops are not ported to the torch merge host")
        if kind in _MERGE_OPS:
            raise NotImplementedError(
                "text (merge-tree) channel ops are not ported to the torch "
                "merge host")
        if kind in _MAP_OPS:
            self._ingest_map(key, channel_op, message)
        if self._pending_ops >= self.flush_threshold:
            self.flush()

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

    # -- flush (the device tick) ----------------------------------------------

    def scalar_fraction(self) -> float:
        """Fraction of served channel ops that ran on a scalar fallback
        instead of the device (0.0 here: every map op is device-served)."""
        total = self.stats["device_ops"] + self.stats["scalar_ops"]
        return self.stats["scalar_ops"] / total if total else 0.0

    def _export_stats(self) -> None:
        """Mirror the routing counters into the shared metrics registry."""
        for name, value in self.stats.items():
            self.metrics.gauge(f"merge_host.{name}").set(value)
        self.metrics.gauge("merge_host.scalar_fraction").set(
            self.scalar_fraction())

    def flush(self) -> None:
        """Apply every pending op: at most one ``apply_tick`` per kernel."""
        import time as _time
        self.metrics.gauge("merge_host.queue_depth").set(self._pending_ops)
        start = _time.perf_counter()
        self._flush_map()
        if self._pending_ops:
            self.metrics.histogram("merge_host.tick_seconds").observe(
                _time.perf_counter() - start)
            self.metrics.counter("merge_host.merged_ops").inc(
                self._pending_ops)
        self._export_stats()
        self._pending_ops = 0

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

    # -- materialization -------------------------------------------------------

    def channels(self, doc_id: str) -> list[ChannelKey]:
        return sorted(k for k in self._map_rows if k.doc_id == doc_id)

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
        """Materialize every tracked map channel of a document."""
        self.flush()
        datastores: dict[str, dict] = {}
        for key in self.channels(doc_id):
            datastores.setdefault(key.datastore, {})[key.channel] = {
                "kind": "map", "entries": self.map_entries(*key)}
        seqs = [r.last_seq for k, r in self._map_rows.items()
                if k.doc_id == doc_id]
        return {"datastores": datastores,
                "sequence_number": max(seqs, default=0)}

    # -- snapshot / restore (device-pool checkpoint) ---------------------------
    #
    # export_state() captures the map planes plus the host-side string/slot
    # mappings in the reference's wire format (same keys, same byte
    # packing: bool planes stay bool); the text, matrix and tree sections
    # are empty until those families are ported.

    def export_state(self) -> dict:
        """Wire-serializable checkpoint of the map state + host maps.
        Flushes first so no pending tails need serializing."""
        self.flush()
        map_rows = [{
            "key": list(key), "row": r.row, "key_slots": r.key_slots,
            "last_seq": r.last_seq, "literal": r.literal_values,
        } for key, r in self._map_rows.items()]
        return {
            "version": 1,
            "vals": list(self._val_rev),
            "merge_pools": [],
            "merge_rows": [],
            "map": {
                "capacity": self._map_capacity, "slots": self._map_slots,
                "planes": {f: _nd_pack(getattr(self._xstate, f).cpu().numpy())
                           for f in mk.MapState._fields},
                "rows": map_rows,
            },
            "matrix": None,
            "tree_keys": [],
            "stats": dict(self.stats),
        }

    def import_state(self, snap: dict) -> None:
        """Rebuild a FRESH host from :meth:`export_state` output."""
        assert not self._map_rows, "import_state needs a fresh host"
        if snap.get("version") != 1:
            raise ValueError(f"unknown snapshot version {snap.get('version')}")
        for section in ("merge_pools", "merge_rows", "tree_keys"):
            if snap.get(section):
                raise NotImplementedError(
                    f"snapshot section {section!r} needs a family not "
                    "ported to the torch merge host")
        if snap.get("matrix") is not None:
            raise NotImplementedError(
                "snapshot holds matrix state; matrix is not ported yet")
        self._val_rev = list(snap["vals"])
        self._vals = {repr(v): i for i, v in enumerate(self._val_rev)
                      if i != 0}
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


__all__ = ["ChannelKey", "KernelMergeHost"]
