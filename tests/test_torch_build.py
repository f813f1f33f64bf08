"""The CUDA build and binding contracts that hold without a card.

The deli and merge-tick launchers read a flat array of pointers; the
order is written once in the ``.cu`` (its ``*_layout`` string and the
assignments in its launcher) and once in the binding (``LAYOUT``, from
the NamedTuple fields). These tests read the sources so a reordering on
either side fails here, not on the card.
"""

import re

import pytest

from fluidframework_tpu_torch.ops import _build
from fluidframework_tpu_torch.ops import sequencer_cuda as seqc

SRC = (_build.CSRC / "sequencer_tick.cu").read_text()


def _layout_string() -> tuple:
    body = re.search(r"sequencer_tick_layout\(\)\s*\{\s*return(.*?);", SRC,
                     re.S).group(1)
    return tuple("".join(re.findall(r'"([^"]*)"', body)).split(","))


def test_layout_string_matches_binding():
    assert _layout_string() == seqc.LAYOUT
    assert len(seqc.LAYOUT) == 38


def test_launcher_reads_pointers_in_layout_order():
    reads = re.findall(r"a\.(\w+) = \([^)]*\)p\[(\d+)\];", SRC)
    assert [int(i) for _, i in reads] == list(range(len(seqc.LAYOUT)))
    assert tuple(name for name, _ in reads) == seqc.LAYOUT


@pytest.mark.parametrize("source", ["sequencer_tick", "sequencer_tick_warp"])
def test_both_deli_launchers_read_the_bindings_layout(source):
    """The one-thread and the warp deli launchers read the same pointer
    array, in the binding's order, and the warp one takes its shared
    memory size after (B, C, K)."""
    layout, reads = _source_layout(source)
    assert layout == seqc.LAYOUT
    assert [int(i) for _, i in reads] == list(range(len(seqc.LAYOUT)))
    assert tuple(name for name, _ in reads) == seqc.LAYOUT
    src = (_build.CSRC / f"{source}.cu").read_text()
    ints = re.search(source + r"_launch\(void\*\* p,(.*?)void\* stream\)",
                     src, re.S).group(1)
    want = ["B", "C", "K"] + (["smem_bytes"] if source.endswith("warp")
                              else [])
    assert re.findall(r"int (\w+)", ints) == want


def test_library_name_tracks_source_flags_and_compiler(monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/cuda/bin/nvcc")
    _src, lib = _build._paths("sequencer_tick")
    assert lib.parent == _build.BUILD_DIR
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-G"])
    assert _build._paths("sequencer_tick")[1] != lib
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/other/bin/nvcc")
    assert _build._paths("sequencer_tick")[1] != lib


MERGE_KERNELS = [("mergetree_flat", "mergetree_cuda"),
                 ("mergetree_flat_smem", "mergetree_cuda"),
                 ("mergetree_blocks", "mergetree_blocks_cuda")]


def _source_layout(source: str) -> tuple[tuple, list]:
    """(the layout string's names, the launcher's (name, index) reads) of
    ``csrc/<source>.cu``."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    body = re.search(source + r"_layout\(\)\s*\{\s*return(.*?);", src,
                     re.S).group(1)
    layout = tuple("".join(re.findall(r'"([^"]*)"', body)).split(","))
    return layout, re.findall(r"a\.(\w+) = \([^)]*\)p\[(\d+)\];", src)


@pytest.mark.parametrize("source,binding", MERGE_KERNELS)
def test_merge_kernel_layouts_match_bindings(source, binding):
    """Both merge tick launchers read their pointer array in the order
    their layout string names, and that order is the binding's."""
    import importlib

    layout, reads = _source_layout(source)
    mod = importlib.import_module(f"fluidframework_tpu_torch.ops.{binding}")
    assert layout == mod.LAYOUT
    assert [int(i) for _, i in reads] == list(range(len(mod.LAYOUT)))
    assert tuple(name for name, _ in reads) == mod.LAYOUT


@pytest.mark.parametrize("source,name", [("matrix_tick", "TICK_LAYOUT"),
                                         ("matrix_tick_smem", "TICK_LAYOUT"),
                                         ("matrix_steps", "STEPS_LAYOUT")])
def test_matrix_kernel_layouts_match_bindings(source, name):
    """The matrix tick launchers read their pointer array in the order
    their layout string names, and that order is the binding's."""
    from fluidframework_tpu_torch.ops import matrix_cuda as mxc

    layout, reads = _source_layout(source)
    assert layout == getattr(mxc, name)
    assert [int(i) for _, i in reads] == list(range(len(layout)))
    assert tuple(n for n, _ in reads) == layout


def test_matrix_layouts_follow_the_state_and_batch_fields():
    """The matrix launchers take both axes' MergeState planes, then the
    cell planes, the op (or step) planes and the outputs — 65 and 70
    pointers."""
    from fluidframework_tpu_torch.ops import matrix_cuda as mxc

    assert len(mxc.TICK_LAYOUT) == 26 + 13 + 26
    assert len(mxc.STEPS_LAYOUT) == 26 + 17 + 26 + 1
    assert mxc.TICK_LAYOUT[:2] == ("rows_valid", "rows_length")
    assert mxc.TICK_LAYOUT[20:26] == ("cell_rh", "cell_ch", "cell_val",
                                      "cell_seq", "cell_used", "cell_count")


def test_library_name_tracks_the_shared_header(monkeypatch, tmp_path):
    """A change to csrc/merge_apply.cuh rebuilds the kernels that include
    it."""
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/cuda/bin/nvcc")
    lib = _build._paths("mergetree_flat")[1]
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    (tmp_path / "merge_apply.cuh").write_text("// changed\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build._paths("mergetree_flat")[1] != lib


@pytest.mark.parametrize("kernel", ["matrix_tick_smem", "matrix_steps_smem"])
def test_library_name_tracks_the_matrix_smem_header(monkeypatch, tmp_path,
                                                    kernel):
    """A change to csrc/matrix_smem.cuh rebuilds both shared-memory
    matrix kernels, which include it."""
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/cuda/bin/nvcc")
    lib = _build._paths(kernel)[1]
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    (tmp_path / "matrix_smem.cuh").write_text("// changed\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build._paths(kernel)[1] != lib


@pytest.mark.parametrize("kernel", ["mergetree_flat_smem", "matrix_tick_smem",
                                    "matrix_steps_smem"])
def test_library_name_tracks_the_flat_smem_header(monkeypatch, tmp_path,
                                                  kernel):
    """A change to csrc/flat_smem.cuh (the shared-memory flat merge step)
    rebuilds the flat tick's shared-memory variant and both shared-memory
    matrix kernels, which include it."""
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/cuda/bin/nvcc")
    lib = _build._paths(kernel)[1]
    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    (tmp_path / "flat_smem.cuh").write_text("// changed\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build._paths(kernel)[1] != lib


@pytest.mark.parametrize("variant,source", [("smem", "mergetree_flat_smem"),
                                            ("global", "mergetree_flat")])
def test_flat_binding_binds_each_variants_launcher(monkeypatch, variant,
                                                   source):
    """Each flat-tick variant binds its own source's launcher, with the
    binding's layout, and the shared-memory one takes its bytes as a
    sixth int."""
    from fluidframework_tpu_torch.ops import mergetree_cuda as mtc

    seen = []
    monkeypatch.setattr(_build, "bind", lambda name, args, layout: seen.append(
        (name, len(args), layout)))
    mtc._lib(variant)
    assert seen == [(source, 1 + (6 if variant == "smem" else 5) + 1,
                     mtc.LAYOUT)]


@pytest.mark.parametrize("variant,source", [("warp", "map_fold_warp"),
                                            ("block", "map_fold")])
def test_fold_binding_binds_each_variants_launcher(monkeypatch, variant,
                                                   source):
    from fluidframework_tpu_torch.ops import map_fold_cuda as mfc

    seen = []
    monkeypatch.setattr(_build, "bind", lambda name, args: seen.append(
        (name, len(args))))
    mfc._lib(variant)
    assert seen == [(source, 16)]


class _FakeLauncher:
    argtypes = None
    restype = None


class _FakeLib:
    """A loaded library whose launcher ``fake_launch`` reads its pointers
    in the order ``order``."""

    def __init__(self, order: str) -> None:
        self.fake_launch = _FakeLauncher()
        self.fake_layout = lambda: order.encode()


@pytest.mark.parametrize("order,ok", [("a,b,c", True), ("a,c,b", False),
                                      ("a,b", False)])
def test_bind_checks_the_launchers_layout(monkeypatch, order, ok):
    lib = _FakeLib(order)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    args = _build.pointer_args(2)
    if ok:
        assert _build.bind("fake", args, ("a", "b", "c")) is lib.fake_launch
        assert lib.fake_launch.argtypes == args
    else:
        with pytest.raises(_build.KernelError, match="reads its pointers"):
            _build.bind("fake", args, ("a", "b", "c"))
        assert lib.fake_launch.argtypes is None


def test_a_library_that_does_not_load_raises_kernel_error(monkeypatch,
                                                          tmp_path):
    monkeypatch.setattr(_build, "_stale", lambda name: False)
    monkeypatch.setattr(_build, "_paths", lambda name: (
        tmp_path / f"{name}.cu", tmp_path / f"lib{name}.so"))
    with pytest.raises(_build.KernelError, match="cannot load"):
        _build.load("no_such_kernel")
    assert "no_such_kernel" not in _build._libs


def test_missing_nvcc_raises_kernel_error(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    real = _build.pathlib.Path.is_file
    monkeypatch.setattr(_build.pathlib.Path, "is_file", lambda self: (
        False if self.name == "nvcc" else real(self)))
    with pytest.raises(_build.KernelError, match="nvcc not found"):
        _build.nvcc_path()


def test_a_failed_launch_raises_kernel_error():
    _build.check(0, "k")
    with pytest.raises(_build.KernelError, match="cudaError 700"):
        _build.check(700, "k")


@pytest.mark.parametrize("case", ["dtype", "shape", "strides", "device"])
def test_need_refuses_what_a_kernel_does_not_take(case):
    """A refused tensor raises KernelInputError: a ValueError to the
    caller, and a KernelError that per-row fault handlers re-raise."""
    import torch

    t = torch.zeros((4, 6), dtype=torch.int32)
    bad = {"dtype": t.long(), "shape": t[:3], "strides": t.t(),
           "device": t.to("meta")}[case]
    want = (4, 6) if case != "strides" else (6, 4)
    _build.need(t if case != "strides" else t.t().contiguous(), "x",
                torch.int32, want, t.device)
    with pytest.raises(_build.KernelInputError, match="x must be") as err:
        _build.need(bad, "x", torch.int32, want, t.device)
    assert isinstance(err.value, ValueError)
    assert isinstance(err.value, _build.KernelError)


def test_oplog_library_builds_from_the_ports_own_source():
    """The op log's g++ library lands in the port's git-ignored build
    directory, named by a hash of the port's copy of ``oplog.cpp`` (not
    the reference package's)."""
    import hashlib

    from fluidframework_tpu_torch import native
    from fluidframework_tpu_torch.native import _loader

    src = native._SRC
    assert src == _build.PKG / "native" / "oplog.cpp"
    assert _loader._BUILD_DIR == _build.BUILD_DIR / "native"
    assert native.native_available()
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = _loader._BUILD_DIR / f"liboplog.{digest}.so"
    assert lib.is_file()
    assert native._configured._name == str(lib)


@pytest.mark.parametrize("name,module", [("fanout", "fanout"),
                                         ("shuttle", "shuttle"),
                                         ("bridge", "bridge")])
def test_native_bus_and_fanout_build_from_the_ports_own_sources(name,
                                                                module):
    """The fan-out's, the shuttle bus's and the socket bridge's g++
    libraries land in the port's build directory too, each named by a
    hash of the port's copy of its ``.cpp``; nothing is loaded from the
    reference package's own build directory."""
    import hashlib
    import importlib

    from fluidframework_tpu_torch.native import _loader

    mod = importlib.import_module(f"fluidframework_tpu_torch.native.{module}")
    src = mod._SRC
    assert src == _build.PKG / "native" / f"{name}.cpp"
    lib_obj = mod._load_library()
    assert lib_obj is not None
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = _loader._BUILD_DIR / f"lib{name}.{digest}.so"
    assert lib.is_file()
    assert lib_obj._name == str(lib)
    assert "fluidframework_tpu_torch" in lib_obj._name
    assert "/fluidframework_tpu/" not in lib_obj._name
