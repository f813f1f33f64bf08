"""SharedString traffic, drawn per document from the seed.

Three patterns, chosen by the cell's ``pattern``:

* ``sequential``: every tick one client sends ``k`` ops in a per-document
  shuffle of the cell's ``mix`` (inserts, removes, annotates), each op at a
  position drawn uniformly within the document as that client sees it
  (its own earlier ops of the tick included). A remove or annotate that
  finds the document empty becomes an insert.
* ``scattered``: ``k`` distinct writers out of ``writers`` each send one op
  against the tick's head. While a document is longer than
  ``remove_above`` characters, ``remove_share`` of the ops are removes of
  1-8 characters at uniform positions; the rest are inserts of 1-8
  characters at uniform positions.
* ``typing``: 2-4 writers out of ``writers`` are active in a document each
  tick; each op goes to one of them, who types one character at its own
  cursor (which advances) or, one op in ``backspace_every`` once it has
  typed in this tick, deletes the character before its cursor.

Every insert draws its characters from a per-document pool: the op's
``pool_start`` is the pool's length before it, so a character is named by
its pool index. Lengths are tracked exactly (a tick's concurrent removes
count once per character), so every position is in range for the view
its op is resolved in. Returns the tick packs in the serving tick's text
field order and each document's length after every tick."""

from __future__ import annotations

import numpy as np

FIELDS = ("valid", "kind", "pos", "end", "ref_seq", "client", "pool_start",
          "text_len", "prop_key", "prop_val")
INSERT, REMOVE, ANNOTATE = 0, 1, 2
_F = {name: i for i, name in enumerate(FIELDS)}


def generate(rng: np.random.Generator, n: int, k: int, ticks: int,
             ctx: dict, params: dict) -> dict:
    """``pack``: i32[ticks, n, len(FIELDS), k]; ``size``: i64[ticks + 1,
    n]. ``ctx`` holds the sessions' [ticks, n] ``ref`` and ``slot``."""
    pattern = {"sequential": _sequential, "scattered": _scattered,
               "typing": _typing}[params["pattern"]]
    pack = np.zeros((ticks, n, len(FIELDS), k), np.int32)
    length = np.zeros((ticks + 1, n), np.int64)
    pool = np.zeros(n, np.int64)
    for t in range(ticks):
        p = pack[t]
        p[:, _F["valid"]] = 1
        p[:, _F["ref_seq"]] = ctx["ref"][t][:, None]
        length[t + 1] = pattern(rng, p, length[t], pool, ctx["slot"][t],
                                params)
    return {"pack": pack, "size": length}


def _put(p: np.ndarray, i: int, **planes) -> None:
    for name, values in planes.items():
        p[:, _F[name], i] = values


def _sequential(rng, p, length, pool, slot, params) -> np.ndarray:
    n, _f, k = p.shape
    mix = params["mix"]
    kinds = np.array([INSERT] * mix["insert"] + [REMOVE] * mix["remove"]
                     + [ANNOTATE] * mix["annotate"])
    if len(kinds) != k:
        raise ValueError(f"text mix sums to {len(kinds)} ops, not k={k}")
    order = np.argsort(rng.random((n, k)), axis=1)
    kinds = kinds[order]
    length = length.copy()
    for i in range(k):
        kind = np.where(length == 0, INSERT, kinds[:, i])
        ins = kind == INSERT
        tlen = rng.integers(1, params["max_run"] + 1, n)
        pos = np.floor(rng.random(n) * (length + 1)).astype(np.int64)
        start = np.floor(rng.random(n) * length).astype(np.int64)
        end = np.minimum(start + rng.integers(1, params["max_run"] + 1, n),
                         length)
        _put(p, i, kind=kind, client=slot,
             pos=np.where(ins, pos, start), end=np.where(ins, 0, end),
             pool_start=np.where(ins, pool, 0),
             text_len=np.where(ins, tlen, 0),
             prop_key=np.where(kind == ANNOTATE,
                               rng.integers(0, params["props"], n), 0),
             prop_val=np.where(kind == ANNOTATE,
                               rng.integers(1, 1 << 16, n), 0))
        pool += np.where(ins, tlen, 0)
        length += np.where(ins, tlen, 0) - np.where(kind == REMOVE,
                                                    end - start, 0)
    return length


def _scattered(rng, p, length, pool, slot, params) -> np.ndarray:
    n, _f, k = p.shape
    writers = np.argsort(rng.random((n, params["writers"])), axis=1)[:, :k]
    rem = (rng.random((n, k)) < params["remove_share"]) \
        & (length > params["remove_above"])[:, None]
    start = np.floor(rng.random((n, k)) * length[:, None]).astype(np.int64)
    end = np.minimum(start + rng.integers(1, params["max_run"] + 1, (n, k)),
                     length[:, None])
    pos = np.floor(rng.random((n, k)) * (length[:, None] + 1)).astype(
        np.int64)
    tlen = np.where(rem, 0, rng.integers(1, params["max_run"] + 1, (n, k)))
    pool_start = pool[:, None] + np.cumsum(tlen, axis=1) - tlen
    p[:, _F["kind"]] = np.where(rem, REMOVE, INSERT)
    p[:, _F["pos"]] = np.where(rem, start, pos)
    p[:, _F["end"]] = np.where(rem, end, 0)
    p[:, _F["client"]] = writers
    p[:, _F["pool_start"]] = np.where(rem, 0, pool_start)
    p[:, _F["text_len"]] = tlen
    pool += tlen.sum(axis=1)
    # Every op of the tick is resolved against the head: a character two
    # removes cover goes once.
    width = int(length.max()) + 2
    diff = np.zeros((n, width), np.int64)
    rows = np.broadcast_to(np.arange(n)[:, None], (n, k))
    np.add.at(diff, (rows[rem], start[rem]), 1)
    np.add.at(diff, (rows[rem], end[rem]), -1)
    gone = (np.cumsum(diff, axis=1) > 0).sum(axis=1)
    return length + tlen.sum(axis=1) - gone


def _typing(rng, p, length, pool, slot, params) -> np.ndarray:
    n, _f, k = p.shape
    most = params["active_max"]
    writers = np.argsort(rng.random((n, params["writers"])), axis=1)[:, :most]
    active = rng.integers(params["active_min"], most + 1, n)
    owner = np.floor(rng.random((n, k)) * active[:, None]).astype(np.int64)
    cursor = np.floor(rng.random((n, most)) * (length[:, None] + 1)).astype(
        np.int64)
    typed = np.zeros((n, most), np.int64)
    rows = np.arange(n)
    grown = np.zeros(n, np.int64)
    for i in range(k):
        w = owner[:, i]
        cur = cursor[rows, w]
        back = (rng.random(n) < 1.0 / params["backspace_every"]) \
            & (typed[rows, w] > 0)
        _put(p, i, kind=np.where(back, REMOVE, INSERT),
             pos=np.where(back, cur - 1, cur), end=np.where(back, cur, 0),
             client=writers[rows, w], pool_start=np.where(back, 0, pool),
             text_len=np.where(back, 0, 1))
        step = np.where(back, -1, 1)
        pool += ~back
        cursor[rows, w] += step
        typed[rows, w] += step
        grown += step
    return length + grown
