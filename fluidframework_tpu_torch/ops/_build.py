"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface under
``fluidframework_tpu_torch/_build/`` (listed in ``.gitignore``). Nothing
here runs at import: :func:`load` compiles on the first call for a
source, and :func:`build_all` starts one ``nvcc`` per source in parallel
(what ``chip_smoke.py`` calls before it drives anything).

The libraries do not include PyTorch's headers, so a build takes seconds.
A library's file name carries a hash of its source, the flags and the
compiler's path, so a change to any of them builds a new library. There is
no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else /usr/local/cuda, else
    PATH. Raises when none exists."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def _paths(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    """The source and the library built from it with today's flags."""
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes())
    key.update("\0".join([nvcc_path(), *NVCC_FLAGS]).encode())
    return src, BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def _stale(name: str) -> bool:
    return not _paths(name)[1].exists()


def _start(name: str) -> tuple[subprocess.Popen, pathlib.Path]:
    src, lib = _paths(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def _finish(name: str, proc: subprocess.Popen, lib: pathlib.Path) -> None:
    out, _ = proc.communicate()
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)


def build_all(names: list[str]) -> None:
    """Compile every stale source in ``names`` with one ``nvcc`` each,
    all started together."""
    with _lock:
        procs = [(n, *_start(n)) for n in names if _stale(n)]
        errors = []
        for name, proc, lib in procs:
            try:
                _finish(name, proc, lib)
            except RuntimeError as err:
                errors.append(str(err))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        if _stale(name):
            build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_paths(name)[1]))
                _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
