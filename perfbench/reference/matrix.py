"""Plain replay of SharedMatrix (matrix.ts processCore,
permutationvector.ts): rows and columns are two merge-tree vectors of
storage handles, and a cell write resolves its row and column to handles
in its op's (ref, client) view, before the op, and stores its value under
that pair, the last write winning. A write whose row or column does not
resolve is dropped."""

from __future__ import annotations

import numpy as np

from .text import INSERT, REMOVE, MergeSeq

ROWS, COLS, CELL = 0, 1, 2


def replay(pack: np.ndarray, first: np.ndarray, clients: int,
           order=None) -> dict:
    """One document: ``pack`` i32[ticks, len(FIELDS), k] in the serving
    tick's matrix field order, ``first`` [ticks]. Returns the live
    ``rows`` and ``cols`` handles in order and the ``cells`` as a dict
    {(row handle, col handle): value}."""
    axes = {ROWS: MergeSeq(1, clients), COLS: MergeSeq(1, clients)}
    cells: dict = {}
    for t in range(pack.shape[0]):
        p = pack[t].astype(np.int64)
        idx = range(p.shape[1]) if order is None else order(t, p.shape[1])
        for i in idx:
            (valid, target, kind, pos, end, count, handle, row, col, value,
             ref, client) = p[:, i]
            if not valid:
                continue
            seq = int(first[t]) + i
            if target == CELL:
                rh = axes[ROWS].name_at(row, ref, client)
                ch = axes[COLS].name_at(col, ref, client)
                if rh >= 0 and ch >= 0:
                    cells[(rh, ch)] = int(value)
            elif kind == INSERT:
                axes[target].insert(pos, np.arange(handle, handle + count),
                                    seq, ref, client)
            elif kind == REMOVE:
                axes[target].remove(pos, end, seq, ref, client)
    return {"rows": axes[ROWS].name[axes[ROWS].live()],
            "cols": axes[COLS].name[axes[COLS].live()], "cells": cells}
