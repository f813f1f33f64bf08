"""The traffic generators: deterministic by seed, every op in range for
the document state it is resolved against (the plain replay never has to
cut or drop one), and every document's stream its own."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench.harness import cell, check
from perfbench.reference import tree as tree_ref
from perfbench.tests.small import TICK_CELLS as CELLS, shrink


def small(name, docs=64):
    return shrink(*cell.load_cell(name), docs=docs, ticks=4, sets=2,
                  sample=4)


@pytest.mark.parametrize("name", CELLS)
def test_deterministic_by_seed(name):
    work, config = small(name)
    a = cell.generate(config, work, 2**31 + 5, 1)
    b = cell.generate(config, work, 2**31 + 5, 1)
    c = cell.generate(config, work, 2**31 + 6, 1)
    assert np.array_equal(a["scalars"], b["scalars"])
    for fam in a["inputs"]:
        assert np.array_equal(a["inputs"][fam], b["inputs"][fam])
        assert not np.array_equal(a["inputs"][fam], c["inputs"][fam])
        assert np.array_equal(a["sample"][fam], b["sample"][fam])


@pytest.mark.parametrize("name", CELLS)
def test_population_dealt_by_seed(name):
    """With a ``population_seed`` every seed gets the same streams, in
    another order of the input sets and of the rows."""
    work, config = small(name)
    work = dict(work, population_seed=3)

    def streams(s, fam):
        rows = cell.family_rows(config, fam)
        x = np.concatenate([s["scalars"], s["inputs"][fam].reshape(
            s["inputs"][fam].shape[:2] + (-1,))], axis=2)
        return sorted(x[:, r].tobytes() for r in rows)
    a = [cell.generate(config, work, 2**31 + 5, i) for i in range(2)]
    b = [cell.generate(config, work, 2**40 + 9, i) for i in range(2)]
    for fam in a[0]["inputs"]:
        assert sorted(streams(s, fam) for s in a) \
            == sorted(streams(s, fam) for s in b)
        assert any(not np.array_equal(x["inputs"][fam], y["inputs"][fam])
                   for x, y in zip(a, b))


@pytest.mark.parametrize("name", CELLS)
def test_documents_differ(name):
    work, config = small(name)
    s = cell.generate(config, work, 77, 0)
    for fam, x in s["inputs"].items():
        rows = cell.family_rows(config, fam)
        streams = {x[:, r].tobytes() for r in rows}
        assert len(streams) == len(rows), fam


@pytest.mark.parametrize("name", CELLS)
def test_every_op_in_range(name):
    work, config = small(name, docs=32)
    s = cell.generate(config, work, 1234567, 0)
    first = check.expected_tickets(config, [s])[0]["first"]
    for fam, x in s["inputs"].items():
        for r in cell.family_rows(config, fam):
            if fam == "text":
                out = check.replay_doc(config, fam, x[:, r], first[:, r])
                assert out["clipped"] == 0
            elif fam == "matrix":
                _assert_matrix_cells_resolve(config, x[:, r], first[:, r])
            elif fam == "tree":
                t = tree_ref.Tree()
                for tick in x[:, r]:
                    for op in tick.T:
                        if op[0]:
                            assert t.apply(*(int(v) for v in op[1:]))


def _assert_matrix_cells_resolve(config, pack, first):
    from perfbench.reference.text import MergeSeq
    axes = {0: MergeSeq(1, 2), 1: MergeSeq(1, 2)}
    for t, tick in enumerate(pack):
        for i, op in enumerate(tick.T.astype(np.int64)):
            (valid, target, _kind, pos, _end, count, handle, row, col,
             _value, ref, client) = op
            if not valid:
                continue
            if target == 2:
                assert axes[0].name_at(row, ref, client) >= 0
                assert axes[1].name_at(col, ref, client) >= 0
            else:
                axes[target].insert(pos, np.arange(handle, handle + count),
                                    int(first[t]) + i, ref, client)
    assert axes[0].clipped == axes[1].clipped == 0


def test_sessions_follow_the_deli():
    work, config = small("mixed_8k.seeded")
    s = cell.generate(config, work, 9, 0)
    want = check.expected_tickets(config, [s])[0]
    counts = s["scalars"][0, :, 4]
    assert np.array_equal(want["n_seq"], np.broadcast_to(
        counts, want["n_seq"].shape))
    assert np.all(s["scalars"][:, :, 2] == want["first"] - 1)
