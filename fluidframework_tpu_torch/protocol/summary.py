"""Incremental summary handles — subtree reuse across summaries.

Reference parity: ISummaryTree's SummaryType.Handle nodes
(server/routerlicious/packages/protocol-definitions/src/summary.ts:53) +
the container-runtime summarizerNode machinery: a summary may replace any
unchanged subtree with a HANDLE naming the same path in the PARENT (last
acked) summary. The client then serializes and uploads only what changed
— O(changed) instead of O(document) — and the service resolves handles
against the stored parent at upload time, so readers always see a full
tree.
"""

from __future__ import annotations

from typing import Any

SUMMARY_HANDLE_KEY = "_handle"


def make_handle(path: str) -> dict:
    """A handle node referencing ``path`` in the parent summary (paths are
    '/'-joined keys from the summary root, e.g.
    ``runtime/datastores/default/channels/root``)."""
    return {SUMMARY_HANDLE_KEY: path}


def is_handle(node: Any) -> bool:
    return (isinstance(node, dict) and len(node) == 1
            and SUMMARY_HANDLE_KEY in node)


def _lookup(parent: dict, path: str) -> Any:
    target: Any = parent
    for part in path.split("/"):
        if not isinstance(target, dict) or part not in target:
            raise KeyError(f"summary handle {path!r} not in parent summary")
        target = target[part]
    return target


def resolve_handles(summary: dict, parent: dict) -> dict:
    """Replace handle stubs with the parent summary's subtrees.

    Resolution is STRUCTURAL: handles are only ever emitted at channel
    positions (runtime/datastores/*/channels/*), so only those positions
    are inspected — user content that happens to look like a handle node
    (a map value ``{"_handle": ...}``) is never touched (no in-band
    collision). Raises KeyError when a stub's path does not exist in the
    parent (the summary is then invalid — nack it, never store a broken
    tree)."""
    runtime = summary.get("runtime")
    if not isinstance(runtime, dict):
        return summary
    datastores = runtime.get("datastores")
    if not isinstance(datastores, dict):
        return summary
    out_datastores = {}
    for ds_id, ds_node in datastores.items():
        channels = ds_node.get("channels") if isinstance(ds_node, dict) \
            else None
        if not isinstance(channels, dict):
            out_datastores[ds_id] = ds_node
            continue
        out_channels = {
            ch_id: (_lookup(parent, node[SUMMARY_HANDLE_KEY])
                    if is_handle(node) else node)
            for ch_id, node in channels.items()}
        out_datastores[ds_id] = {**ds_node, "channels": out_channels}
    return {**summary, "runtime": {**runtime, "datastores": out_datastores}}


def count_handles(node: Any) -> int:
    if is_handle(node):
        return 1
    if isinstance(node, dict):
        return sum(count_handles(v) for v in node.values())
    if isinstance(node, list):
        return sum(count_handles(v) for v in node)
    return 0
