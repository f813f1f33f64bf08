"""Shared fixtures of the benchmark's own tests: cells shrunk to a few
documents and short epochs, run on the CPU (the program's plain
versions), and the card for the cases marked ``cuda``."""

from __future__ import annotations

import pytest

from perfbench.tests.small import shrink


@pytest.fixture
def small_cells(monkeypatch):
    """Every cell loaded shrunk, wherever the harness loads one; torch on
    one thread (the plain versions are many small ops)."""
    import torch

    from perfbench.harness import bench, cell
    real = cell.load_cell

    def load(name):
        return shrink(*real(name))
    monkeypatch.setattr(bench, "load_cell", load)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield load
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
