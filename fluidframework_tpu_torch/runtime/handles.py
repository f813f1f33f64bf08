"""Fluid handles — serializable references between stored objects.

Reference parity: packages/loader/core-interfaces (IFluidHandle),
packages/dds/shared-object-base/src/handle.ts (``SharedObjectHandle``) and
runtime-utils handle encoding: a handle is a JSON-encodable pointer
``{"type": "__fluid_handle__", "url": "/datastoreId[/channelId]"}`` that a
DDS can store as a value. Handles are what the reference-graph GC walks
(packages/runtime/garbage-collector): every stored handle is an outbound
GC route from the DDS that stores it to the routed node.
"""

from __future__ import annotations

from typing import Any, Callable

HANDLE_MARKER = "__fluid_handle__"


class FluidHandle:
    """A reference to a data store (``/ds``) or channel (``/ds/channel``)."""

    def __init__(self, absolute_path: str,
                 resolver: "Callable[[str], Any] | None" = None) -> None:
        assert absolute_path.startswith("/"), absolute_path
        self.absolute_path = absolute_path
        self._resolver = resolver

    def get(self) -> Any:
        """Resolve to the live DataStoreRuntime / SharedObject."""
        if self._resolver is None:
            raise RuntimeError(
                f"handle {self.absolute_path!r} is not bound to a runtime")
        return self._resolver(self.absolute_path)

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, FluidHandle)
                and other.absolute_path == self.absolute_path)

    def __hash__(self) -> int:
        return hash(self.absolute_path)

    def __repr__(self) -> str:  # pragma: no cover
        return f"FluidHandle({self.absolute_path!r})"


def encode_value(value: Any) -> Any:
    """Deep-encode: FluidHandle → wire marker dict (handle.ts toJSON)."""
    if isinstance(value, FluidHandle):
        return {"type": HANDLE_MARKER, "url": value.absolute_path}
    if isinstance(value, dict):
        return {k: encode_value(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [encode_value(v) for v in value]
    return value


def decode_value(value: Any, resolver: Callable[[str], Any] | None) -> Any:
    """Deep-decode: wire marker dict → FluidHandle bound to ``resolver``.

    Handle-free values are returned as-is (no copy) so reads keep
    reference semantics and O(1) cost for the common case.
    """
    if not _has_marker(value):
        return value
    if is_handle_marker(value):
        return FluidHandle(value["url"], resolver)
    if isinstance(value, dict):
        return {k: decode_value(v, resolver) for k, v in value.items()}
    if isinstance(value, list):
        return [decode_value(v, resolver) for v in value]
    return value


def _has_marker(value: Any) -> bool:
    if is_handle_marker(value) or isinstance(value, FluidHandle):
        return True
    if isinstance(value, dict):
        return any(_has_marker(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return any(_has_marker(v) for v in value)
    return False


def is_handle_marker(value: Any) -> bool:
    return (isinstance(value, dict) and value.get("type") == HANDLE_MARKER
            and isinstance(value.get("url"), str))


def collect_handle_routes(value: Any) -> list[str]:
    """All handle routes stored anywhere inside ``value`` (GC outbound
    edges; runtime-utils' equivalent scans serialized summary content)."""
    routes: list[str] = []
    _collect(value, routes)
    return routes


def _collect(value: Any, out: list[str]) -> None:
    if is_handle_marker(value):
        out.append(value["url"])
        return
    if isinstance(value, FluidHandle):
        out.append(value.absolute_path)
        return
    if isinstance(value, dict):
        for v in value.values():
            _collect(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _collect(v, out)
