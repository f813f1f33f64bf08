"""Layered configuration: defaults < file < environment < overrides.

Reference parity: the server's nconf stack (services-utils; per-service
``config.json`` — routerlicious/config/config.json:1-80) and the client's
``ILoaderOptions``/``IContainerRuntimeOptions`` plumbing
(containerRuntime.ts:1407). One Config object serves both sides here.

Lookup keys are colon-separated paths (nconf style): ``cfg.get("bus:partitions")``.
Environment variables override with prefix ``FF_TPU_`` and ``__`` as the
path separator: ``FF_TPU_BUS__PARTITIONS=8``. Values from env parse as
JSON when possible (so numbers/bools/objects round-trip), else stay strings.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any

ENV_PREFIX = "FF_TPU_"
_MISSING = object()


def _deep_merge(base: dict, overlay: dict) -> dict:
    out = dict(base)
    for key, value in overlay.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = value
    return out


class Config:
    def __init__(self, defaults: dict[str, Any] | None = None,
                 file: str | os.PathLike | None = None,
                 env: dict[str, str] | None = None,
                 overrides: dict[str, Any] | None = None) -> None:
        layers: list[dict[str, Any]] = [dict(defaults or {})]
        if file is not None and Path(file).exists():
            layers.append(json.loads(Path(file).read_text()))
        layers.append(self._from_env(env if env is not None
                                     else dict(os.environ)))
        layers.append(dict(overrides or {}))
        merged: dict[str, Any] = {}
        for layer in layers:
            merged = _deep_merge(merged, layer)
        self._data = merged

    @staticmethod
    def _from_env(env: dict[str, str]) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for key, raw in env.items():
            if not key.startswith(ENV_PREFIX):
                continue
            path = key[len(ENV_PREFIX):].lower().split("__")
            try:
                value: Any = json.loads(raw)
            except ValueError:
                value = raw
            node = out
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = value
        return out

    def get(self, path: str, default: Any = None) -> Any:
        node: Any = self._data
        for part in path.split(":"):
            if not isinstance(node, dict):
                return default
            node = node.get(part, _MISSING)
            if node is _MISSING:
                return default
        return node

    def require(self, path: str) -> Any:
        value = self.get(path, _MISSING)
        if value is _MISSING:
            raise KeyError(f"missing required config {path!r}")
        return value

    def section(self, path: str) -> "Config":
        sub = self.get(path, {})
        cfg = Config.__new__(Config)
        cfg._data = sub if isinstance(sub, dict) else {}
        return cfg

    def as_dict(self) -> dict[str, Any]:
        return json.loads(json.dumps(self._data))  # deep copy


DEFAULTS: dict[str, Any] = {
    "bus": {"partitions": 4},
    "alfred": {"max_message_size": 16 * 1024,  # config.json:38
               "throttle": {"rate_per_interval": 1_000_000,
                            "interval_ms": 1000}},
    "deli": {"client_timeout_ms": 300_000},
    "merge_host": {"tick_ops": 64, "seg_slots": 64, "map_slots": 32},
    "summary": {"max_ops": 100, "idle_time_ms": 5000,
                "max_time_ms": 60_000},
    "runtime": {"max_op_bytes": 16 * 1024},  # chunk above this
}


def default_config(overrides: dict[str, Any] | None = None,
                   file: str | os.PathLike | None = None) -> Config:
    return Config(defaults=DEFAULTS, file=file, overrides=overrides)
