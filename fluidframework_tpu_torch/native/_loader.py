"""Shared build-and-load helper for the C++ runtime components.

Artifacts are keyed by a content hash of the source (``lib{name}.{digest}.so``)
so a rebuilt checkout never silently loads a stale or tampered binary —
mtimes are meaningless after clone. They land in the package's
git-ignored ``_build/native/`` (beside the CUDA kernels' libraries);
every binary on disk is reproducible from the .cpp next to this file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build" / "native"
_lock = threading.Lock()  # guards _cache and _name_locks only
_name_locks: dict[str, threading.Lock] = {}
_cache: dict[str, ctypes.CDLL | None] = {}


def build_and_load(name: str, src: Path,
                   extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL | None:
    """Compile ``src`` (if its hash-keyed artifact is absent) and dlopen it.

    Returns None when the toolchain is unavailable and no matching
    artifact exists; callers fall back to their pure-Python twins.
    """
    # Per-name locks: compiles of unrelated libraries (bridge vs shuttle,
    # possibly from different threads at startup) must not serialize
    # behind one global lock for the duration of a g++ run.
    with _lock:
        if name in _cache:
            return _cache[name]
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        with _lock:
            if name in _cache:
                return _cache[name]
        try:
            source = src.read_bytes()
            digest = hashlib.sha256(source).hexdigest()[:16]
            lib_path = _BUILD_DIR / f"lib{name}.{digest}.so"
            if not lib_path.exists():
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                # No ".so" suffix on the temp: the stale-artifact glob
                # below must never delete another process's in-flight
                # build out from under it.
                tmp = _BUILD_DIR / f"lib{name}.{digest}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-pthread",
                     str(src), "-o", str(tmp), *extra_flags],
                    check=True, capture_output=True, timeout=120)
                tmp.replace(lib_path)
                for stale in _BUILD_DIR.glob(f"lib{name}.*.so"):
                    if stale != lib_path:
                        try:
                            stale.unlink()
                        except OSError:
                            pass
            lib = ctypes.CDLL(str(lib_path))
        except (OSError, subprocess.SubprocessError):
            lib = None
        with _lock:
            _cache[name] = lib
        return lib
