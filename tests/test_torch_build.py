"""The CUDA build and binding contracts that hold without a card.

The deli kernel's launcher reads a flat array of pointers; the order is
written once in ``csrc/sequencer_tick.cu`` (``sequencer_tick_layout`` and
the assignments in ``sequencer_tick_launch``) and once in the binding
(``sequencer_cuda.LAYOUT``, from the NamedTuple fields). These tests read
the source so a reordering on either side fails here, not on the card.
"""

import re

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


def test_library_name_tracks_source_flags_and_compiler(monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/cuda/bin/nvcc")
    _src, lib = _build._paths("sequencer_tick")
    assert lib.parent == _build.BUILD_DIR
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-G"])
    assert _build._paths("sequencer_tick")[1] != lib
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/other/bin/nvcc")
    assert _build._paths("sequencer_tick")[1] != lib
