"""SharedTree traffic, drawn per document from the seed.

Every tick one client sends ``k`` edits, each of a kind drawn with the
cell's ``mix`` weights:

* ``insert``: a new node (the document's next free slot) with a drawn
  payload, at the end or the start (even odds) of one of ``traits``
  traits under an existing node of depth below ``insert_depth``;
* ``move``: an existing node's subtree to the end of a trait under an
  existing node outside it, where the moved subtree stays within
  ``max_depth`` levels;
* ``detach``: an existing node's whole subtree;
* ``set_value``: a new payload on an existing node.

A kind that finds no node to act on becomes an insert. The generator
follows the tree as it changes, so every edit is valid where it is
applied."""

from __future__ import annotations

import numpy as np

FIELDS = ("valid", "kind", "node", "parent", "trait", "payload")
SET_VALUE, DETACH, INSERT, INSERT_START, MOVE = 0, 1, 2, 5, 8
KINDS = ("insert", "move", "detach", "set_value")
_F = {name: i for i, name in enumerate(FIELDS)}


def generate(rng: np.random.Generator, n: int, k: int, ticks: int,
             ctx: dict, params: dict) -> dict:
    """``pack``: i32[ticks, n, len(FIELDS), k]; ``size``: i64[ticks + 1,
    n], the live nodes after every tick (root excluded)."""
    slots = params["slots"]
    weights = np.array([params["mix"][name] for name in KINDS], float)
    pack = np.zeros((ticks, n, len(FIELDS), k), np.int32)
    nodes = np.zeros((ticks + 1, n), np.int64)
    exists = np.zeros((n, slots), bool)
    exists[:, 0] = True
    parent = np.full((n, slots), -1, np.int64)
    depth = np.zeros((n, slots), np.int64)
    nxt = np.ones(n, np.int64)
    rows = np.arange(n)
    for t in range(ticks):
        p = pack[t]
        p[:, _F["valid"]] = 1
        for i in range(k):
            live = exists.copy()
            live[:, 0] = False
            kind = rng.choice(len(KINDS), size=n, p=weights / weights.sum())
            kind = np.where(live.any(axis=1), kind, 0)
            node = _pick(rng, live)
            # Moves: the moved subtree, and where it may go.
            sub = np.zeros((n, slots), bool)
            dest = np.zeros(n, np.int64)
            walk = np.flatnonzero((kind == 1) | (kind == 2))
            if len(walk):
                sub[walk] = _subtree(parent[walk], node[walk],
                                     params["max_depth"])
            mv = np.flatnonzero(kind == 1)
            if len(mv):
                d = depth[mv]
                height = np.where(sub[mv] & exists[mv], d, 0).max(axis=1) \
                    - d[np.arange(len(mv)), node[mv]]
                ok = exists[mv] & ~sub[mv] \
                    & (d + 1 + height[:, None] <= params["max_depth"])
                dest[mv] = _pick(rng, ok)
                kind[mv[~ok.any(axis=1)]] = 0
            host = _pick(rng, exists & (depth < params["insert_depth"]))
            if np.any((kind == 0) & (nxt >= slots)):
                raise ValueError("tree slots exhausted: raise 'slots'")
            front = rng.random(n) < 0.5
            code = np.choose(kind, [np.where(front, INSERT_START, INSERT),
                                    MOVE, DETACH, SET_VALUE])
            ins, mov, det = kind == 0, kind == 1, kind == 2
            target = np.where(ins, nxt, node)
            _put(p, i, kind=code, node=target,
                 parent=np.where(ins, host, np.where(mov, dest, 0)),
                 trait=np.where(ins | mov,
                                rng.integers(0, params["traits"], n), 0),
                 payload=np.where(ins | (kind == 3),
                                  rng.integers(1, 1 << 16, n), 0))
            exists[rows[ins], nxt[ins]] = True
            parent[rows[ins], nxt[ins]] = host[ins]
            depth[rows[ins], nxt[ins]] = depth[rows[ins], host[ins]] + 1
            nxt += ins
            parent[rows[mov], node[mov]] = dest[mov]
            shift = depth[rows, dest] + 1 - depth[rows, node]
            depth += np.where(sub & mov[:, None], shift[:, None], 0)
            exists &= ~(sub & det[:, None])
        nodes[t + 1] = exists[:, 1:].sum(axis=1)
    return {"pack": pack, "size": nodes}


def _put(p: np.ndarray, i: int, **planes) -> None:
    for name, values in planes.items():
        p[:, _F[name], i] = values


def _pick(rng, mask: np.ndarray) -> np.ndarray:
    """One slot per row drawn uniformly among ``mask``'s (slot 0 where
    none is)."""
    seen = np.cumsum(mask, axis=1)
    nth = np.floor(rng.random(mask.shape[0]) * seen[:, -1])
    return np.where(seen[:, -1] > 0, (seen > nth[:, None]).argmax(axis=1), 0)


def _subtree(parent: np.ndarray, node: np.ndarray,
             depth: int) -> np.ndarray:
    """[n, slots]: the slots at or below ``node`` in each row, among those
    at most ``depth`` levels deep (every live slot is)."""
    n, slots = parent.shape
    rows = np.arange(n)[:, None]
    sub = np.arange(slots)[None, :] == node[:, None]
    up = parent.copy()
    for _ in range(depth):
        sub |= up == node[:, None]
        up = parent[rows, np.maximum(up, 0)]
    return sub
