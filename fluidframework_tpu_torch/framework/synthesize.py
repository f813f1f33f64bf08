"""Dependency synthesizer — provider registry + scoped injection.

Reference parity: packages/framework/synthesize — ``DependencyContainer``
registers providers under capability keys (IFluidObject interface names)
and synthesizes a scope object exposing required + optional providers;
containers chain to a parent for fallback resolution. Providers may be
instances, factories (called once, cached), or already-resolved values.
"""

from __future__ import annotations

from typing import Any, Callable

_UNSET = object()


class DependencyError(KeyError):
    pass


class _Provider:
    def __init__(self, value: Any = _UNSET,
                 factory: Callable[[], Any] | None = None) -> None:
        self._value = value
        self._factory = factory

    def resolve(self) -> Any:
        if self._value is _UNSET:
            assert self._factory is not None
            self._value = self._factory()  # lazy singleton, like the ref's
        return self._value


class SynthesizedScope:
    """What synthesize() returns: providers as attributes; optional ones
    missing resolve to None (the reference's FluidObject<Optional...>)."""

    def __init__(self, resolved: dict[str, Any]) -> None:
        self.__dict__.update(resolved)

    def __getitem__(self, key: str) -> Any:
        return self.__dict__[key]


class DependencyContainer:
    def __init__(self, parent: "DependencyContainer | None" = None) -> None:
        self._parent = parent
        self._providers: dict[str, _Provider] = {}

    def register(self, key: str, value: Any = _UNSET, *,
                 factory: Callable[[], Any] | None = None) -> None:
        if (value is _UNSET) == (factory is None):
            raise ValueError("register exactly one of value= or factory=")
        self._providers[key] = _Provider(value, factory)

    def has(self, key: str) -> bool:
        if key in self._providers:
            return True
        return self._parent.has(key) if self._parent is not None else False

    def resolve(self, key: str) -> Any:
        provider = self._providers.get(key)
        if provider is not None:
            return provider.resolve()
        if self._parent is not None:
            return self._parent.resolve(key)
        raise DependencyError(f"no provider registered for {key!r}")

    def synthesize(self, required: list[str] | None = None,
                   optional: list[str] | None = None) -> SynthesizedScope:
        resolved: dict[str, Any] = {}
        for key in required or []:
            resolved[key] = self.resolve(key)  # raises when missing
        for key in optional or []:
            resolved[key] = self.resolve(key) if self.has(key) else None
        return SynthesizedScope(resolved)
