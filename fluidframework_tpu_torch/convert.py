"""Carry state between the JAX reference package and the port.

This system has no weights; its device state plays that role. The
functions here turn state exported by the reference package — given as
numpy arrays and plain Python values, so nothing of JAX is imported —
into the port's tensors and hosts, and back:

* :class:`~.ops.sequencer.SequencerState`, :class:`~.ops.map_kernel.
  MapState` and :class:`~.ops.tree_kernel.TreeState` NamedTuples ↔
  ``{field: ndarray}``;
* ``KernelMergeHost.export_state()`` snapshots — the map planes, the
  text pools (block and flat planes, text buffers, rows with their client
  and key slots, scalar-routed rows' engines), the matrix state and
  matrix rows (device planes, handle counters, scalar-routed rows'
  permutation vectors and cells) — which share one wire format and load
  with :func:`merge_host_from_export`;
* ``KernelSequencerHost.checkpoint_all()`` checkpoints, loaded with
  :func:`restore_sequencer_host`;
* a whole sequencer host's planes and row/slot maps, with
  :func:`sequencer_host_from_numpy` / :func:`sequencer_host_to_numpy`.

Every conversion copies: the port's hosts update their planes in place,
and must never write into a caller's arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .device import resolve_device
from .ops import map_kernel as mk
from .ops import sequencer as seqk
from .ops import tree_kernel as tk
from .server.kernel_host import KernelSequencerHost
from .server.merge_host import KernelMergeHost
from .server.sequencer import SequencerCheckpoint


def state_from_numpy(cls, arrays, device=None):
    """A NamedTuple ``cls`` of tensors from ``{field: ndarray}`` (or any
    object with those attributes), copied onto ``device``. Bool planes
    stay bool, int planes become int32."""
    dev = resolve_device(device)
    out = {}
    for f in cls._fields:
        a = np.asarray(arrays[f] if isinstance(arrays, dict)
                       else getattr(arrays, f))
        if a.dtype != np.bool_:
            a = a.astype(np.int32)
        out[f] = torch.tensor(a, device=dev)
    return cls(**out)


def state_to_numpy(state) -> dict[str, np.ndarray]:
    """``{field: ndarray}`` of a NamedTuple of tensors (host copies)."""
    return {f: getattr(state, f).cpu().numpy().copy() for f in state._fields}


def sequencer_state_from_numpy(arrays, device=None) -> seqk.SequencerState:
    return state_from_numpy(seqk.SequencerState, arrays, device)


def map_state_from_numpy(arrays, device=None) -> mk.MapState:
    return state_from_numpy(mk.MapState, arrays, device)


def tree_state_from_numpy(arrays, device=None) -> tk.TreeState:
    return state_from_numpy(tk.TreeState, arrays, device)


def merge_host_from_export(snap: dict, device=None,
                           **kwargs) -> KernelMergeHost:
    """A fresh port merge host holding an ``export_state()`` snapshot of
    either package (map, text and matrix channels; tree channels are not
    snapshotted and come back from a replay of the durable op log)."""
    host = KernelMergeHost(device=device, **kwargs)
    host.import_state(snap)
    return host


def _checkpoint(cp: Any) -> SequencerCheckpoint:
    if isinstance(cp, SequencerCheckpoint):
        return cp
    if dataclasses.is_dataclass(cp):
        cp = dataclasses.asdict(cp)
    return SequencerCheckpoint(**cp)


def restore_sequencer_host(host: KernelSequencerHost,
                           checkpoints: dict[str, Any]) -> None:
    """Restore ``checkpoint_all()`` output (the reference's dataclasses,
    their ``asdict`` form, or the port's own) into ``host``, one document
    row at a time in the mapping's order."""
    for doc_id, cp in checkpoints.items():
        host.restore(doc_id, _checkpoint(cp))


def sequencer_host_to_numpy(host) -> dict:
    """The whole of a sequencer host as numpy planes plus its host maps.
    Works on either package's host: it reads only attributes both share
    (``_state`` planes via ``np.asarray``)."""
    def host_copy(a) -> np.ndarray:
        if isinstance(a, torch.Tensor):
            a = a.cpu()
        return np.array(a)

    return {
        "planes": {f: host_copy(getattr(host._state, f))
                   for f in seqk.SequencerState._fields},
        "rows": dict(host._rows),
        "free_rows": list(host._free_rows),
        "row_count": host._row_count,
        "slots": [dict(s) for s in host._slots],
        "timeout_ms": list(host._timeout_ms),
        "alloc_slots": host._alloc_slots,
        "membership_gen": host.membership_gen,
    }


def sequencer_host_from_numpy(dump: dict,
                              device=None) -> KernelSequencerHost:
    """A port sequencer host equal to ``dump`` (see
    :func:`sequencer_host_to_numpy`): same planes, rows and slots."""
    capacity = dump["planes"]["seq"].shape[0]
    host = KernelSequencerHost(num_slots=dump["alloc_slots"],
                               initial_capacity=capacity, device=device)
    host._state = sequencer_state_from_numpy(dump["planes"], host.device)
    host._rows = dict(dump["rows"])
    host._free_rows = list(dump["free_rows"])
    host._row_count = dump["row_count"]
    host._slots = [dict(s) for s in dump["slots"]]
    host._pending = [[] for _ in range(capacity)]
    host._timeout_ms = list(dump["timeout_ms"])
    host.membership_gen = dump["membership_gen"]
    return host


__all__ = [
    "map_state_from_numpy",
    "merge_host_from_export",
    "restore_sequencer_host",
    "sequencer_host_from_numpy",
    "sequencer_host_to_numpy",
    "sequencer_state_from_numpy",
    "state_from_numpy",
    "state_to_numpy",
    "tree_state_from_numpy",
]
