"""Plain replay of SharedMap's sequenced ops (mapKernel.ts
tryProcessMessage): a set stores its value and sequence number under its
key, a delete drops the key and stamps it, a clear drops every key and
stamps the map. Words pack kind (2 bits) | key slot (10) | value (20);
keys at or past the map's slot count are ignored."""

from __future__ import annotations

import numpy as np

SET, DELETE, CLEAR = 0, 1, 2


def replay(words: np.ndarray, first: np.ndarray, slots: int,
           order=None) -> dict:
    """One document: ``words`` i32[ticks, k], ``first`` [ticks] the
    sequence number of each tick's first op. Returns ``present``,
    ``value`` (0 where absent), ``vseq`` and ``cleared_seq``."""
    present = np.zeros(slots, bool)
    value = np.zeros(slots, np.int64)
    vseq = np.full(slots, -1, np.int64)
    cleared = -1
    for t in range(words.shape[0]):
        w = words[t].astype(np.int64) & 0xFFFFFFFF
        idx = range(len(w)) if order is None else order(t, len(w))
        for i in idx:
            kind, slot, val = w[i] & 3, (w[i] >> 2) & 0x3FF, w[i] >> 12
            seq = int(first[t]) + i
            if kind == CLEAR:
                present[:] = False
                vseq[:] = -1
                cleared = seq
            elif slot < slots and kind in (SET, DELETE):
                present[slot] = kind == SET
                if kind == SET:
                    value[slot] = val
                vseq[slot] = seq
    return {"present": present, "value": np.where(present, value, 0),
            "vseq": vseq, "cleared_seq": cleared}
