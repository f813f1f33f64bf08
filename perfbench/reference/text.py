"""Plain replay of SharedString's merge rules, one character at a time.

Follows the merge-tree's sequenced-op semantics (packages/dds/merge-tree
``Client.applyMsg``): an op from client ``c`` with reference ``ref`` sees
the characters inserted at or before ``ref`` or by ``c`` itself, less
those removed at or before ``ref`` or by ``c``. An insert at position
``p`` lands before the first character at visible offset ``p`` that the
client has not seen removed (a later-sequenced concurrent insert goes
left of an earlier one); a remove marks the visible characters of its
range removed by its sequence number, or, where another client removed
one first, records ``c`` as a further remover; an annotate sets one
property on the visible characters of its range (0 clears it).

A character is named by its pool index. The class also serves the
matrix's row and column vectors, whose characters are storage handles."""

from __future__ import annotations

import numpy as np

INSERT, REMOVE, ANNOTATE = 0, 1, 2
NEVER = np.iinfo(np.int64).max


class MergeSeq:
    """The characters of one document with their insert and remove
    stamps and their properties."""

    def __init__(self, props: int = 1, clients: int = 128) -> None:
        self.name = np.zeros(0, np.int64)
        self.ins_seq = np.zeros(0, np.int64)
        self.ins_client = np.zeros(0, np.int64)
        self.rem_seq = np.zeros(0, np.int64)
        self.rem_client = np.zeros(0, np.int64)
        self.removers = np.zeros((0, clients), bool)
        self.props = np.zeros((0, props), np.int64)
        #: Ops whose range ran past the view and were cut to it.
        self.clipped = 0

    def _visible(self, ref: int, client: int) -> np.ndarray:
        seen = (self.ins_seq <= ref) | (self.ins_client == client)
        gone = (self.rem_seq <= ref) | (self.rem_client == client) \
            | self.removers[:, client]
        return seen & ~gone

    def _offsets(self, ref: int, client: int):
        vis = self._visible(ref, client)
        return vis, np.cumsum(vis) - vis

    def insert(self, pos: int, names: np.ndarray, seq: int, ref: int,
               client: int) -> None:
        vis, at = self._offsets(ref, client)
        if pos > int(vis.sum()):
            self.clipped += 1
            pos = int(vis.sum())
        here = np.flatnonzero((at == pos) & (self.rem_seq > ref))
        i = int(here[0]) if len(here) else len(self.name)
        n = len(names)

        def put(plane, value):
            block = np.broadcast_to(value, (n,) + plane.shape[1:])
            return np.concatenate([plane[:i], block, plane[i:]])
        self.name = put(self.name, names)
        self.ins_seq = put(self.ins_seq, seq)
        self.ins_client = put(self.ins_client, client)
        self.rem_seq = put(self.rem_seq, NEVER)
        self.rem_client = put(self.rem_client, -1)
        self.removers = put(self.removers, False)
        self.props = put(self.props, 0)

    def _range(self, start: int, end: int, ref: int, client: int):
        vis, at = self._offsets(ref, client)
        if end > int(vis.sum()) or start > end:
            self.clipped += 1
        return vis & (at >= start) & (at < end)

    def remove(self, start: int, end: int, seq: int, ref: int,
               client: int) -> None:
        hit = self._range(start, end, ref, client)
        first = hit & (self.rem_seq == NEVER)
        self.rem_seq[first] = seq
        self.rem_client[first] = client
        self.removers[hit & ~first, client] = True

    def annotate(self, start: int, end: int, key: int, value: int,
                 ref: int, client: int) -> None:
        hit = self._range(start, end, ref, client)
        self.props[hit, key] = value

    def live(self) -> np.ndarray:
        return self.rem_seq == NEVER

    def name_at(self, pos: int, ref: int, client: int) -> int:
        """The name of the character at visible position ``pos`` in the
        (ref, client) view; -1 when there is none."""
        vis, at = self._offsets(ref, client)
        hit = np.flatnonzero(vis & (at == pos))
        return int(self.name[hit[0]]) if len(hit) else -1


def replay(pack: np.ndarray, first: np.ndarray, props: int, clients: int,
           order=None) -> dict:
    """One document: ``pack`` i32[ticks, len(FIELDS), k] in the serving
    tick's text field order, ``first`` [ticks] the sequence number of each
    tick's first op (ops take consecutive numbers). ``order(t, k)`` gives
    the order in which a tick's ops are applied (the control's broken
    order); by default as sequenced. Returns the visible characters'
    ``names`` and ``props``."""
    doc = MergeSeq(props, clients)
    for t in range(pack.shape[0]):
        p = pack[t].astype(np.int64)
        idx = range(p.shape[1]) if order is None else order(t, p.shape[1])
        for i in idx:
            valid, kind, pos, end, ref, client, pool, tlen, key, val = p[:, i]
            if not valid:
                continue
            seq = int(first[t]) + i
            if kind == INSERT:
                doc.insert(pos, np.arange(pool, pool + tlen), seq, ref,
                           client)
            elif kind == REMOVE:
                doc.remove(pos, end, seq, ref, client)
            elif kind == ANNOTATE:
                doc.annotate(pos, end, key, val, ref, client)
    live = doc.live()
    return {"names": doc.name[live], "props": doc.props[live],
            "clipped": doc.clipped}
