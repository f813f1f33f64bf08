"""A SharedTree row of the serving state (a node table) as the
reference's visible form, and their comparison: every live node's
parent, trait and payload, and each trait's children in sibling order
(rank ascending, slot breaking a tie)."""

from __future__ import annotations

import numpy as np


def visible(planes: dict) -> dict:
    """``planes``: one document's ``exists``, ``parent``, ``trait``,
    ``rank`` and ``payload`` [N]."""
    exists = np.flatnonzero(np.asarray(planes["exists"]).astype(bool))
    parent, trait = planes["parent"], planes["trait"]
    nodes = {int(x): (int(parent[x]), int(trait[x]),
                      int(planes["payload"][x])) for x in exists}
    order: dict = {}
    for x in sorted(exists, key=lambda x: (int(planes["rank"][x]), int(x))):
        if x:
            order.setdefault((int(parent[x]), int(trait[x])), []).append(
                int(x))
    return {"nodes": nodes, "order": order}


def equal(got: dict, want: dict) -> bool:
    return got == want
