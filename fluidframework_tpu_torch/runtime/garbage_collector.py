"""Reference-graph garbage collection over handle routes.

Reference parity: packages/runtime/garbage-collector/src/garbageCollector.ts
(``runGarbageCollection``: mark reachable from the root over the node →
outbound-routes graph, report referenced/deleted) and utils.ts:90
(``GCDataBuilder`` route normalization). The graph nodes are data stores
(``/ds``) and channels (``/ds/channel``); edges are stored handles
(see :mod:`.handles`) plus the implicit datastore→its-channels edges.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class GCResult:
    referenced: list[str] = field(default_factory=list)
    deleted: list[str] = field(default_factory=list)  # unreachable nodes


def normalize_route(route: str) -> str:
    """Strip trailing slash; routes are ``/ds`` or ``/ds/channel``."""
    return route.rstrip("/") if route != "/" else route


def run_garbage_collection(graph: dict[str, list[str]],
                           roots: list[str]) -> GCResult:
    """Mark-phase BFS from ``roots`` over ``graph`` (node → outbound routes).

    Referencing any node also references its ancestors' children? No — per
    the reference, referencing ``/ds/channel`` references ``/ds`` (a channel
    cannot outlive its store), and referencing ``/ds`` references all of its
    channels via the implicit edges the caller includes in ``graph``.
    """
    reachable: set[str] = set()
    stack = [normalize_route(r) for r in roots]
    while stack:
        node = stack.pop()
        if node in reachable:
            continue
        reachable.add(node)
        # /ds/channel keeps /ds alive (garbageCollector.ts parent routes).
        if node.count("/") >= 2:
            parent = node.rsplit("/", 1)[0]
            if parent not in reachable:
                stack.append(parent)
        for route in graph.get(node, ()):  # outbound handle edges
            route = normalize_route(route)
            if route not in reachable:
                stack.append(route)
    all_nodes = set(graph.keys())
    return GCResult(
        referenced=sorted(n for n in all_nodes if n in reachable),
        deleted=sorted(n for n in all_nodes if n not in reachable),
    )
