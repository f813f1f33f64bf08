"""The roofline counts, pinned on a fixed small batch."""

from __future__ import annotations

import numpy as np

from perfbench.metrics import _work


def test_k3_bytes_pinned():
    pack = np.zeros((3, 10, 4), np.int32)
    pack[0, 0, :2] = 1      # two ops in document 0
    pack[2, 0, :4] = 1      # four in document 2; document 1 sends none
    got = _work.k3_bytes(pack, nb=8, bk=128, props=4, words=4)
    per_doc = 2 * 8 * 4 * 4 + 2 * 128 * (6 + 4 + 4) * 4 + 4
    assert got == 6 * 41 + 2 * per_doc == 29_438


def test_tree_bytes_pinned():
    pack = np.zeros((2, 6, 8), np.int32)
    pack[0, 0, :3] = 1
    pack[1, 0, :8] = 1
    assert _work.tree_bytes(pack) == 11 * (21 + 34 + 2) == 627


def test_least_time():
    assert _work.least_s(3.35e12) == 1.0
