"""SharedTree core: immutable snapshots + transactions + edit log.

Reference parity: experimental/dds/tree/src — ``Snapshot`` (immutable tree
view, Snapshot.ts), ``Transaction`` (applies a Change list to a snapshot,
yielding a new snapshot + validity result, Transaction.ts:40), ``EditLog``
(sequenced + local edits, EditLog.ts:163), and the HistoryEditFactory's
inverse edits for undo.

Model: nodes have *stable identities*; changes reference nodes by id, so
there is no positional OT — a sequenced edit applies against the tree state
at its sequence point, and becomes INVALID (dropped whole) if its anchors
no longer resolve (e.g. the target was concurrently detached). Local edits
rebase by *reapplication* on top of each new sequenced state
(CachingLogViewer/Checkout.rebaseCurrentEdit semantics).

Change kinds (reference ChangeType): build, insert, detach, set_value,
constraint.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any

ROOT_ID = "root"

# Edit application results (reference EditValidity).
VALID = "valid"
INVALID = "invalid"
MALFORMED = "malformed"


@dataclass(slots=True)
class TreeNode:
    id: str
    definition: str
    payload: Any = None
    # trait label -> ordered child id list
    traits: dict[str, list[str]] = field(default_factory=dict)
    parent: tuple[str, str] | None = None  # (parent id, trait label)


class TreeSnapshot:
    """A tree state. Treated as immutable: mutate only via copy()."""

    def __init__(self) -> None:
        self.nodes: dict[str, TreeNode] = {
            ROOT_ID: TreeNode(id=ROOT_ID, definition="root")
        }

    def copy(self) -> "TreeSnapshot":
        out = TreeSnapshot()
        out.nodes = {
            nid: TreeNode(id=n.id, definition=n.definition, payload=n.payload,
                          traits={k: list(v) for k, v in n.traits.items()},
                          parent=n.parent)
            for nid, n in self.nodes.items()
        }
        return out

    def has(self, node_id: str) -> bool:
        return node_id in self.nodes

    def get(self, node_id: str) -> TreeNode:
        return self.nodes[node_id]

    def children(self, node_id: str, label: str) -> list[str]:
        return list(self.nodes[node_id].traits.get(label, ()))

    def serialize(self) -> dict:
        """Canonical JSON form (deterministic ordering)."""
        return {
            nid: {
                "definition": n.definition,
                "payload": n.payload,
                "traits": {k: list(v)
                           for k, v in sorted(n.traits.items())},
                "parent": list(n.parent) if n.parent else None,
            }
            for nid, n in sorted(self.nodes.items())
        }

    @classmethod
    def load(cls, data: dict) -> "TreeSnapshot":
        snap = cls()
        snap.nodes = {}
        for nid, entry in data.items():
            snap.nodes[nid] = TreeNode(
                id=nid, definition=entry["definition"],
                payload=entry["payload"],
                traits={k: list(v) for k, v in entry["traits"].items()},
                parent=tuple(entry["parent"]) if entry["parent"] else None,
            )
        return snap


def _is_attached(snapshot: TreeSnapshot, node_id: str) -> bool:
    """True iff the node's parent chain reaches the root (i.e. it is part of
    the document tree, not a detached/built-but-not-inserted node)."""
    seen = set()
    current = node_id
    while True:
        if current == ROOT_ID:
            return True
        if current in seen or not snapshot.has(current):
            return False
        seen.add(current)
        parent = snapshot.get(current).parent
        if parent is None:
            return False
        current = parent[0]


def _resolve_place(snapshot: TreeSnapshot,
                   place: dict) -> tuple[str, str, int] | None:
    """StablePlace -> (parent id, trait label, index) or None if invalid.
    Anchors must be ATTACHED to the document tree — a detached node (e.g.
    the edit's own built source) is not a valid destination."""
    if "referenceSibling" in place:
        sibling = place["referenceSibling"]
        if (sibling == ROOT_ID or not snapshot.has(sibling)
                or not _is_attached(snapshot, sibling)):
            return None
        node = snapshot.get(sibling)
        parent_id, label = node.parent
        siblings = snapshot.get(parent_id).traits[label]
        index = siblings.index(sibling)
        return (parent_id, label,
                index if place.get("side") == "before" else index + 1)
    trait = place["referenceTrait"]
    parent_id, label = trait["parent"], trait["label"]
    if not snapshot.has(parent_id) or not _is_attached(snapshot, parent_id):
        return None
    count = len(snapshot.get(parent_id).traits.get(label, ()))
    return (parent_id, label, 0 if place.get("side") == "start" else count)


def _build_nodes(snapshot: TreeSnapshot, specs: list[dict],
                 parent: tuple[str, str] | None) -> list[str] | None:
    """Materialize node specs into the snapshot (detached). None on dup id."""
    ids = []
    for spec in specs:
        nid = spec["id"]
        if snapshot.has(nid):
            return None  # identity collision → invalid
        snapshot.nodes[nid] = TreeNode(
            id=nid, definition=spec.get("definition", ""),
            payload=spec.get("payload"), parent=parent)
        for label, child_specs in (spec.get("traits") or {}).items():
            child_ids = _build_nodes(snapshot, child_specs, (nid, label))
            if child_ids is None:
                return None
            snapshot.nodes[nid].traits[label] = child_ids
        ids.append(nid)
    return ids


class Transaction:
    """Applies one edit's changes to a snapshot (Transaction.ts:40)."""

    def __init__(self, snapshot: TreeSnapshot) -> None:
        self.snapshot = snapshot.copy()
        # detached sequence id -> node id list (build/detach destinations)
        self.detached: dict[str, list[str]] = {}
        self.validity = VALID

    def apply_edit(self, edit: dict) -> str:
        for change in edit["changes"]:
            if not self._apply_change(change):
                self.validity = INVALID
                break
        return self.validity

    def _apply_change(self, change: dict) -> bool:
        kind = change.get("type")
        if kind == "build":
            ids = _build_nodes(self.snapshot, change["source"], parent=None)
            if ids is None or change["destination"] in self.detached:
                return False
            self.detached[change["destination"]] = ids
            return True
        if kind == "insert":
            source = self.detached.pop(change["source"], None)
            if source is None:
                return False
            resolved = _resolve_place(self.snapshot, change["destination"])
            if resolved is None:
                return False
            parent_id, label, index = resolved
            trait = self.snapshot.get(parent_id).traits.setdefault(label, [])
            trait[index:index] = source
            for nid in source:
                self.snapshot.get(nid).parent = (parent_id, label)
            return True
        if kind == "detach":
            start = _resolve_place(self.snapshot, change["source"]["start"])
            end = _resolve_place(self.snapshot, change["source"]["end"])
            if start is None or end is None:
                return False
            if start[:2] != end[:2] or start[2] > end[2]:
                return False
            parent_id, label = start[:2]
            trait = self.snapshot.get(parent_id).traits.get(label, [])
            removed = trait[start[2]:end[2]]
            del trait[start[2]:end[2]]
            if not trait:
                self.snapshot.get(parent_id).traits.pop(label, None)
            destination = change.get("destination")
            if destination is not None:
                if destination in self.detached:
                    return False
                self.detached[destination] = removed
                for nid in removed:
                    self.snapshot.get(nid).parent = None
            else:
                for nid in removed:
                    self._delete_subtree(nid)
            return True
        if kind == "set_value":
            if not self.snapshot.has(change["node"]):
                return False
            self.snapshot.get(change["node"]).payload = change["payload"]
            return True
        if kind == "constraint":
            # Reference TreeConstraint: range must still exist/resolve.
            start = _resolve_place(self.snapshot, change["range"]["start"])
            end = _resolve_place(self.snapshot, change["range"]["end"])
            return start is not None and end is not None
        self.validity = MALFORMED
        return False

    def _delete_subtree(self, node_id: str) -> None:
        node = self.snapshot.nodes.pop(node_id, None)
        if node is None:
            return
        for children in node.traits.values():
            for child in children:
                self._delete_subtree(child)


@dataclass(slots=True)
class SequencedEdit:
    edit: dict
    seq: int
    validity: str


class EditLog:
    """Sequenced + local edits (EditLog.ts:163)."""

    def __init__(self) -> None:
        self.sequenced: list[SequencedEdit] = []
        self.local: list[dict] = []

    def add_sequenced(self, edit: dict, seq: int, validity: str) -> None:
        self.sequenced.append(SequencedEdit(edit, seq, validity))

    def add_local(self, edit: dict) -> None:
        self.local.append(edit)

    def ack_front_local(self) -> dict:
        return self.local.pop(0)

    @property
    def length(self) -> int:
        return len(self.sequenced) + len(self.local)


# -- inverse edits (HistoryEditFactory.ts) ------------------------------------

_invert_counter = itertools.count(1)


def invert_edit(edit: dict, before: TreeSnapshot) -> dict | None:
    """Inverse of an edit as applied to `before` (for undo). None when an
    inverse cannot be derived (e.g. the edit was invalid)."""
    inverse_changes: list[dict] = []
    txn = Transaction(before)
    for change in edit["changes"]:
        kind = change.get("type")
        if kind == "set_value":
            if not txn.snapshot.has(change["node"]):
                return None
            old = txn.snapshot.get(change["node"]).payload
            inverse_changes.insert(0, {"type": "set_value",
                                       "node": change["node"],
                                       "payload": old})
        elif kind == "insert":
            ids = txn.detached.get(change["source"], [])
            if ids:
                first, last = ids[0], ids[-1]
                inverse_changes.insert(0, {
                    "type": "detach",
                    "source": {
                        "start": {"referenceSibling": first,
                                  "side": "before"},
                        "end": {"referenceSibling": last, "side": "after"},
                    },
                })
        elif kind == "detach":
            start = _resolve_place(txn.snapshot, change["source"]["start"])
            if start is None:
                return None
            parent_id, label, index = start
            end = _resolve_place(txn.snapshot, change["source"]["end"])
            if end is None:
                return None
            trait = txn.snapshot.get(parent_id).traits.get(label, [])
            removed = trait[index:end[2]]
            specs = [_to_spec(txn.snapshot, nid) for nid in removed]
            build_id = f"__undo_{next(_invert_counter)}"
            if index > 0:
                place = {"referenceSibling": trait[index - 1],
                         "side": "after"}
            else:
                place = {"referenceTrait": {"parent": parent_id,
                                            "label": label},
                         "side": "start"}
            inverse_changes.insert(0, {"type": "insert", "source": build_id,
                                       "destination": place})
            inverse_changes.insert(0, {"type": "build", "source": specs,
                                       "destination": build_id})
        if not txn._apply_change(change):
            return None
    return {"id": f"undo-{edit['id']}", "changes": inverse_changes}


def _to_spec(snapshot: TreeSnapshot, node_id: str) -> dict:
    node = snapshot.get(node_id)
    return {
        "id": node.id,
        "definition": node.definition,
        "payload": node.payload,
        "traits": {label: [_to_spec(snapshot, c) for c in children]
                   for label, children in sorted(node.traits.items())},
    }
