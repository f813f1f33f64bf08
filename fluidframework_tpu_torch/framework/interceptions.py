"""DDS interception wrappers — decorate edits without changing the DDS.

Reference parity: packages/framework/dds-interceptions — e.g.
``createSharedMapWithInterception`` (wrap set to stamp attribution props)
and the SharedString props interception. The wrapper delegates everything
else to the underlying DDS, so both views observe the same state.
"""

from __future__ import annotations

from typing import Any, Callable

from ..dds.map import SharedMap
from ..dds.sequence import SharedString


class _Intercepted:
    """Delegating proxy: attribute access falls through to the target."""

    def __init__(self, target: Any) -> None:
        object.__setattr__(self, "_target", target)

    def __getattr__(self, name: str) -> Any:
        return getattr(self._target, name)

    def __setattr__(self, name: str, value: Any) -> None:
        setattr(self._target, name, value)

    def __len__(self) -> int:
        return len(self._target)


class InterceptedSharedMap(_Intercepted):
    def __init__(self, target: SharedMap,
                 set_interceptor: Callable[[str, Any], Any]) -> None:
        super().__init__(target)
        object.__setattr__(self, "_set_interceptor", set_interceptor)

    def set(self, key: str, value: Any):
        self._target.set(key, self._set_interceptor(key, value))
        return self


class InterceptedSharedString(_Intercepted):
    def __init__(self, target: SharedString,
                 props_interceptor: Callable[[dict | None], dict | None]
                 ) -> None:
        super().__init__(target)
        object.__setattr__(self, "_props_interceptor", props_interceptor)

    def insert_text(self, pos: int, text: str,
                    props: dict | None = None) -> None:
        self._target.insert_text(pos, text, self._props_interceptor(props))

    def annotate_range(self, start: int, end: int, props: dict) -> None:
        self._target.annotate_range(start, end,
                                    self._props_interceptor(props) or {})


def create_map_with_interception(
        shared_map: SharedMap,
        set_interceptor: Callable[[str, Any], Any]) -> InterceptedSharedMap:
    """``set_interceptor(key, value) -> value`` transforms every stored
    value (e.g. wrap with attribution metadata)."""
    return InterceptedSharedMap(shared_map, set_interceptor)


def create_string_with_interception(
        shared_string: SharedString,
        props_interceptor: Callable[[dict | None], dict | None]
) -> InterceptedSharedString:
    """``props_interceptor(props) -> props`` decorates every inserted /
    annotated range (e.g. stamp the author's user id)."""
    return InterceptedSharedString(shared_string, props_interceptor)
