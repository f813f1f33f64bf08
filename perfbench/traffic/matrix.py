"""SharedMatrix traffic, drawn per document from the seed.

Every tick one client sends ``k`` ops: ``row_inserts`` row inserts and
``col_inserts`` column inserts of one row or column each, in a
per-document order, at positions drawn uniformly within the grid, then
cell writes at cells drawn uniformly within the grid as it stands after
them, with values drawn uniformly over 1 .. 2**16 - 1. Inserted rows and
columns take storage handles from one counter per document, in sequence
order (the deterministic allocation of SharedMatrix)."""

from __future__ import annotations

import numpy as np

FIELDS = ("valid", "target", "kind", "pos", "end", "count", "handle_base",
          "row", "col", "value", "ref_seq", "client")
ROWS, COLS, CELL = 0, 1, 2
INSERT = 0
_F = {name: i for i, name in enumerate(FIELDS)}


def generate(rng: np.random.Generator, n: int, k: int, ticks: int,
             ctx: dict, params: dict) -> dict:
    """``pack``: i32[ticks, n, len(FIELDS), k]; ``size``:
    i64[ticks + 1, n], the grid's cell count after every tick."""
    vec = [ROWS] * params["row_inserts"] + [COLS] * params["col_inserts"]
    if len(vec) >= k:
        raise ValueError("a matrix tick needs room for a cell write")
    pack = np.zeros((ticks, n, len(FIELDS), k), np.int32)
    sizes = {ROWS: np.zeros((ticks + 1, n), np.int64),
             COLS: np.zeros((ticks + 1, n), np.int64)}
    handle = np.zeros(n, np.int64)
    for t in range(ticks):
        p = pack[t]
        p[:, _F["valid"]] = 1
        p[:, _F["ref_seq"]] = ctx["ref"][t][:, None]
        p[:, _F["client"]] = ctx["slot"][t][:, None]
        size = {a: sizes[a][t].copy() for a in (ROWS, COLS)}
        order = np.argsort(rng.random((n, len(vec))), axis=1)
        for i in range(len(vec)):
            axis = np.asarray(vec)[order[:, i]]
            now = np.where(axis == ROWS, size[ROWS], size[COLS])
            p[:, _F["target"], i] = axis
            p[:, _F["kind"], i] = INSERT
            p[:, _F["pos"], i] = np.floor(rng.random(n) * (now + 1))
            p[:, _F["count"], i] = 1
            p[:, _F["handle_base"], i] = handle
            handle += 1
            for a in (ROWS, COLS):
                size[a] += axis == a
        cells = slice(len(vec), k)
        m = k - len(vec)
        p[:, _F["target"], cells] = CELL
        p[:, _F["row"], cells] = np.floor(rng.random((n, m))
                                          * size[ROWS][:, None])
        p[:, _F["col"], cells] = np.floor(rng.random((n, m))
                                          * size[COLS][:, None])
        p[:, _F["value"], cells] = rng.integers(1, 1 << 16, (n, m))
        for a in (ROWS, COLS):
            sizes[a][t + 1] = size[a]
    return {"pack": pack, "size": sizes[ROWS] * sizes[COLS]}
