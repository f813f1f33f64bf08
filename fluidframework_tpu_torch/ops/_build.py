"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface under
``fluidframework_tpu_torch/_build/`` (listed in ``.gitignore``). Nothing
here runs at import: :func:`load` compiles on the first call for a
source, and :func:`build_all` starts one ``nvcc`` per source in parallel
(what ``chip_smoke.py`` calls before it drives anything).

The libraries do not include PyTorch's headers, so a build takes seconds.
A library's file name carries a hash of its source, the headers beside
it (``csrc/*.cuh``), the flags and the compiler's path, so a change to
any of them builds a new library. There is
no fallback: a missing ``nvcc``, a failed build or load, a launcher whose
pointer layout disagrees with its binding, or a failed launch raises
:class:`KernelError`, which callers that isolate per-document faults
re-raise, so a broken kernel never turns into serving on the host.
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
_optin: dict[int, int] = {}


class KernelError(RuntimeError):
    """A kernel could not be built, loaded, bound or launched."""


class KernelInputError(KernelError, ValueError):
    """A wrapper was handed a tensor its kernel does not take."""


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else /usr/local/cuda, else
    PATH. Raises when none exists."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (pathlib.Path(root) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME); the port's CUDA "
                          "kernels are built from csrc/ at first use")
    return found


def _paths(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    """The source and the library built from it with today's flags."""
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
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
        raise KernelError(f"nvcc failed for csrc/{name}.cu "
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
            except KernelError as err:
                errors.append(str(err))
        if errors:
            raise KernelError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        if _stale(name):
            build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                try:
                    lib = ctypes.CDLL(str(_paths(name)[1]))
                except OSError as err:
                    raise KernelError(f"cannot load csrc/{name}.cu's "
                                      f"library: {err}") from err
                _libs[name] = lib
    return lib


def pointer_args(n_ints: int) -> list:
    """The argtypes of a launcher that takes its tensors as one pointer
    array: (pointers, ``n_ints`` ints, stream)."""
    return [ctypes.POINTER(ctypes.c_void_p), *[ctypes.c_int] * n_ints,
            ctypes.c_void_p]


def bind(name: str, argtypes: list, layout: tuple[str, ...] | None = None):
    """The launcher ``<name>_launch`` of ``csrc/<name>.cu``, built and
    loaded if needed, with its argtypes set (once). Where ``layout`` is
    given, the order in which the launcher reads its pointer array
    (``<name>_layout()``) must equal it first."""
    lib = load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        if layout is not None:
            read = getattr(lib, f"{name}_layout")
            read.restype = ctypes.c_char_p
            got = tuple(read().decode().split(","))
            if got != tuple(layout):
                raise KernelError(
                    f"csrc/{name}.cu reads its pointers in the order {got}, "
                    f"the binding passes {tuple(layout)}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def need(t, what: str, dtype, shape, dev) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``dev`` (the kernels index raw row-major storage)."""
    if t.device != dev or t.dtype != dtype \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise KernelInputError(
            f"{what} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {dev}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if rc != 0:
        raise KernelError(f"{what}: CUDA launch failed with cudaError {rc}")


def smem_limit(name: str, index: int) -> int:
    """The per-block shared-memory limit with opt-in
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``; 232,448 bytes on an
    H100) of card ``index``, read once through ``<name>_optin`` of
    ``csrc/<name>.cu`` while that card is current (the caller makes it
    so). The shape checks of the shared-memory kernels compare against
    it."""
    if index not in _optin:
        got = getattr(load(name), f"{name}_optin")()
        if got <= 0:
            raise KernelError(f"cannot read the shared-memory limit of "
                              f"cuda:{index}")
        _optin[index] = got
    return _optin[index]


def device_smem_limit(dev, name: str) -> int:
    """:func:`smem_limit` of torch device ``dev`` (the current card when
    it names no index), read through ``csrc/<name>.cu``."""
    import torch

    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    with torch.cuda.device(index):
        return smem_limit(name, index)
