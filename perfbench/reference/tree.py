"""Plain replay of SharedTree edits (experimental/dds/tree
Transaction): each node has a parent, a trait label under it, a payload,
and an order among the children of that trait.

* insert (at the end or the start of a trait) applies when the node does
  not exist, is not the root, and the parent exists;
* move (to the end of a trait) applies when the node exists, is not the
  root, and the destination parent exists outside the node's subtree; the
  subtree moves whole;
* detach applies when the node exists and is not the root, and removes
  its whole subtree;
* set_value applies when the node exists.

Edits of a document apply one after another in sequence order."""

from __future__ import annotations

import numpy as np

SET_VALUE, DETACH, INSERT, INSERT_START, MOVE = 0, 1, 2, 5, 8


class Tree:
    def __init__(self) -> None:
        self.parent = {0: -1}
        self.trait = {0: 0}
        self.payload = {0: 0}
        self.kids: dict = {}

    def _under(self, node: int) -> list:
        out, stack = [], [node]
        while stack:
            x = stack.pop()
            out.append(x)
            for key in [k for k in self.kids if k[0] == x]:
                stack.extend(self.kids[key])
        return out

    def _unlink(self, node: int) -> None:
        key = (self.parent[node], self.trait[node])
        self.kids[key].remove(node)
        if not self.kids[key]:
            del self.kids[key]

    def _link(self, node: int, parent: int, trait: int, front: bool) -> None:
        self.parent[node], self.trait[node] = parent, trait
        kids = self.kids.setdefault((parent, trait), [])
        kids.insert(0 if front else len(kids), node)

    def apply(self, kind: int, node: int, parent: int, trait: int,
              payload: int) -> bool:
        exists = node in self.parent
        if kind == SET_VALUE:
            if exists:
                self.payload[node] = payload
            return exists
        if kind == DETACH:
            if not exists or node == 0:
                return False
            self._unlink(node)
            for x in self._under(node):
                self.kids = {k: v for k, v in self.kids.items() if k[0] != x}
                del self.parent[x], self.trait[x], self.payload[x]
            return True
        if kind in (INSERT, INSERT_START):
            if exists or node == 0 or parent not in self.parent:
                return False
            self.payload[node] = payload
            self._link(node, parent, trait, kind == INSERT_START)
            return True
        if kind == MOVE:
            if (not exists or node == 0 or parent not in self.parent
                    or parent in self._under(node)):
                return False
            self._unlink(node)
            self._link(node, parent, trait, False)
            return True
        raise ValueError(f"tree edit kind {kind} is not replayed here")

    def visible(self) -> dict:
        nodes = {x: (self.parent[x], self.trait[x], self.payload[x])
                 for x in self.parent}
        return {"nodes": nodes,
                "order": {k: list(v) for k, v in self.kids.items() if v}}


def replay(pack: np.ndarray, order=None) -> dict:
    """One document: ``pack`` i32[ticks, len(FIELDS), k] in the serving
    tick's tree field order. Returns ``nodes`` {slot: (parent, trait,
    payload)} (the root as slot 0) and ``order`` {(parent, trait): [slots
    in sibling order]}."""
    tree = Tree()
    for t in range(pack.shape[0]):
        p = pack[t].astype(np.int64)
        idx = range(p.shape[1]) if order is None else order(t, p.shape[1])
        for i in idx:
            valid, kind, node, parent, trait, payload = (int(x)
                                                         for x in p[:, i])
            if valid:
                tree.apply(kind, node, parent, trait, payload)
    return tree.visible()
