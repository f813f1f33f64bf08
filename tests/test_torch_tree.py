"""Differential: the port's SharedTree core and tree tick against the JAX
package's.

``dds/tree_core.py`` (a verbatim copy): seeded edit streams — subtree
builds and inserts at every kind of place, set_value, single- and
multi-node detaches, moves (into their own subtree too), constraints,
duplicate ids, unknown anchors and malformed changes — through both
packages' ``Transaction``; validity per edit and ``serialize()`` equal,
and so are the inverse edits and ``TreeSnapshot.load`` round trips.

``ops/tree_kernel.py`` (plain PyTorch): seeded batches at B = 4, N = 32
and 64, K = 32 through both ``apply_tick``s; every plane, ``applied``
and ``overflow`` exactly equal (tolerance 0: every plane is integer).
Named cases pin the edges: rank midpoint exhaustion, appends and
prepends past ``RANK_LIMIT``, a midpoint sum that wraps in int32, detach
and move chains of depth 31, 32, 33 and 40 (``MAX_DEPTH_PASSES`` = 32),
stale detached slots whose parents still chain, a move into its own
subtree, ``TREE_CONSTRAINT_COUNT`` after a detach, K padded with invalid
ops, and documents that differ within one batch.
"""

from __future__ import annotations

import itertools
import random

import jax.numpy as jnp
import numpy as np
import pytest

from fluidframework_tpu.dds import tree_core as jtc
from fluidframework_tpu.ops import tree_kernel as jtk
from fluidframework_tpu_torch import convert
from fluidframework_tpu_torch.dds import tree_core as ttc
from fluidframework_tpu_torch.ops import tree_kernel as ttk

B, K = 4, 32


# -- tree_core -----------------------------------------------------------------


def _place(rng: random.Random, ids: list[str]) -> dict:
    anchor = rng.choice(ids)
    if anchor != "root" and rng.random() < 0.5:
        return {"referenceSibling": anchor,
                "side": rng.choice(["before", "after"])}
    return {"referenceTrait": {"parent": anchor,
                               "label": rng.choice(["children", "kids"])},
            "side": rng.choice(["start", "end"])}


def _range(rng: random.Random, a: str, b: str | None = None) -> dict:
    return {"start": {"referenceSibling": a,
                      "side": rng.choice(["before", "before", "after"])},
            "end": {"referenceSibling": a if b is None else b,
                    "side": rng.choice(["after", "after", "before"])}}


def random_edit(rng: random.Random, snap, counter) -> dict:
    """One edit against ``snap``'s ids, valid or not: ids are drawn from
    the snapshot's nodes (attached or not) plus a few unknown ones."""
    ids = sorted(snap.nodes) + ["ghost", f"n{rng.randrange(200)}"]
    non_root = [i for i in ids if i != "root"]
    roll = rng.random()
    if roll < 0.35:
        nid = f"n{next(counter)}" if rng.random() < 0.9 else rng.choice(ids)
        spec = {"id": nid, "definition": "n", "payload": rng.randrange(50),
                "traits": {}}
        if rng.random() < 0.3:
            spec["traits"]["kids"] = [
                {"id": f"{nid}k{i}", "definition": "k", "traits": {}}
                for i in range(rng.randrange(1, 3))]
        changes = [{"type": "build", "source": [spec], "destination": "b"},
                   {"type": "insert", "source": "b",
                    "destination": _place(rng, ids)}]
    elif roll < 0.5:
        changes = [{"type": "set_value", "node": rng.choice(ids),
                    "payload": rng.choice([rng.randrange(9), "s", None])}]
    elif roll < 0.65:
        b = rng.choice(non_root) if rng.random() < 0.2 else None
        changes = [{"type": "detach",
                    "source": _range(rng, rng.choice(non_root), b)}]
    elif roll < 0.85:
        changes = [{"type": "detach",
                    "source": _range(rng, rng.choice(non_root)),
                    "destination": "m"},
                   {"type": "insert", "source": "m",
                    "destination": _place(rng, ids)}]
    elif roll < 0.95:
        changes = [{"type": "constraint",
                    "range": _range(rng, rng.choice(non_root))}]
    else:
        changes = rng.choice([
            [{"type": "bogus"}],
            [{"type": "insert", "source": "nothing",
              "destination": _place(rng, ids)}],
            [{"type": "set_value", "node": rng.choice(ids), "payload": 1},
             {"type": "set_value", "node": rng.choice(ids), "payload": 2}]])
    return {"id": f"e{next(counter)}", "changes": changes}


@pytest.mark.parametrize("seed", range(3))
def test_tree_core_matches_jax(seed, monkeypatch):
    monkeypatch.setattr(jtc, "_invert_counter", itertools.count(1))
    monkeypatch.setattr(ttc, "_invert_counter", itertools.count(1))
    rng = random.Random(seed)
    counter = itertools.count()
    js, ts = jtc.TreeSnapshot(), ttc.TreeSnapshot()
    jlog, tlog = jtc.EditLog(), ttc.EditLog()
    verdicts = []
    for n in range(160):
        edit = random_edit(rng, js, counter)
        inv_j = jtc.invert_edit(edit, js)
        inv_t = ttc.invert_edit(edit, ts)
        assert inv_t == inv_j, n
        jt, tt = jtc.Transaction(js), ttc.Transaction(ts)
        vj, vt = jt.apply_edit(edit), tt.apply_edit(edit)
        assert vt == vj, n
        verdicts.append(vj)
        if vj == jtc.VALID:
            js, ts = jt.snapshot, tt.snapshot
        jlog.add_sequenced(edit, n, vj)
        tlog.add_sequenced(edit, n, vt)
        assert ts.serialize() == js.serialize(), n
    assert ttc.TreeSnapshot.load(ts.serialize()).serialize() \
        == js.serialize()
    assert [e.validity for e in tlog.sequenced] \
        == [e.validity for e in jlog.sequenced]
    # A malformed change reads INVALID in both (apply_edit overwrites it).
    assert set(verdicts) == {jtc.VALID, jtc.INVALID}
    assert len(ts.nodes) > 10


# -- the tree tick -------------------------------------------------------------


def _jax_state(arrays: dict) -> jtk.TreeState:
    return jtk.TreeState(**{f: jnp.asarray(arrays[f])
                            for f in jtk.TreeState._fields})


def _numpy(state) -> dict:
    return {f: np.array(getattr(state, f)) for f in state._fields}


def _blank(n: int, b: int = B) -> dict:
    return _numpy(jtk.init_state(b, n))


def run_both(arrays: dict, per_doc: list[list[dict]], k: int = K):
    """One tick of ``per_doc`` from the planes ``arrays`` through both
    packages; every plane and output equal. Returns the JAX result as
    numpy (state, out)."""
    b = arrays["exists"].shape[0]
    js, jo = jtk.apply_tick(_jax_state(arrays),
                            jtk.make_tree_op_batch(per_doc, b, k))
    tstate = convert.tree_state_from_numpy(arrays, "cpu")
    tbatch = ttk.make_tree_op_batch(per_doc, b, k, device="cpu")
    results = [ttk.apply_tick(tstate, tbatch, ttk.subtree_steps(per_doc, k)),
               ttk.apply_tick(tstate, tbatch)]
    want_s, want_o = _numpy(js), _numpy(jo)
    for ts, to in results:
        for f, got in convert.state_to_numpy(ts).items():
            assert got.dtype == want_s[f].dtype, f
            assert np.array_equal(got, want_s[f]), f
        for f in jtk.TreeOpOut._fields:
            assert np.array_equal(getattr(to, f).numpy(), want_o[f]), f
    # The input planes are left as they were.
    for f, a in convert.state_to_numpy(tstate).items():
        assert np.array_equal(a, arrays[f]), f
    return want_s, want_o


def random_ops(rng: random.Random, exists: np.ndarray, n: int,
               count: int) -> list[dict]:
    """``count`` ops of every kind; anchors mostly live slots, sometimes
    any slot or out of range."""
    live = [i for i in range(n) if exists[i]]

    def pick():
        return (rng.choice(live) if rng.random() < 0.8
                else rng.randrange(-2, n + 2))
    ops = []
    for _ in range(count):
        kind = rng.randrange(12)
        node = (rng.randrange(-1, n + 1) if kind in (
            ttk.TREE_INSERT, ttk.TREE_INSERT_BEFORE, ttk.TREE_INSERT_AFTER,
            ttk.TREE_INSERT_START) else pick())
        ops.append(dict(kind=kind, node=node, parent=pick(),
                        trait=rng.randrange(3), payload=rng.randrange(5)))
    return ops


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("seed", range(3))
def test_apply_tick_matches_jax(seed, n):
    rng = random.Random(100 * n + seed)
    arrays = _blank(n)
    applied = overflowed = 0
    for _tick in range(6):
        per_doc = [random_ops(rng, arrays["exists"][d], n,
                              rng.randrange(K + 1)) for d in range(B)]
        arrays, out = run_both(arrays, per_doc)
        applied += int(out["applied"].sum())
        overflowed += int(out["overflow"].sum())
    assert applied > 100 and arrays["exists"].sum() > 3 * B


def test_op_batch_and_trait_order_match_jax():
    rng = random.Random(7)
    n = 32
    per_doc = [random_ops(rng, np.ones(n, bool), n, c) for c in (0, 3, 17)]
    jb = jtk.make_tree_op_batch(per_doc, 3, 20)
    tb = ttk.make_tree_op_batch(per_doc, 3, 20, device="cpu")
    for f in jtk.TreeOpBatch._fields:
        want = np.asarray(getattr(jb, f))
        got = getattr(tb, f).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    with pytest.raises(ValueError):
        ttk.make_tree_op_batch(per_doc, 3, 16, device="cpu")
    arrays = _blank(n)
    for _ in range(3):
        ops = [random_ops(rng, arrays["exists"][d], n, K) for d in range(B)]
        arrays, _ = run_both(arrays, ops)
    js, ts = _jax_state(arrays), convert.tree_state_from_numpy(arrays, "cpu")
    for d in range(B):
        for parent in range(n):
            for trait in range(3):
                assert ttk.trait_order(ts, d, parent, trait) \
                    == jtk.trait_order(js, d, parent, trait)


def _ins(node, parent, trait=0, payload=1, kind=ttk.TREE_INSERT):
    return dict(kind=kind, node=node, parent=parent, trait=trait,
                payload=payload)


def test_rank_midpoint_exhaustion():
    per_doc = [
        [_ins(1, 0), _ins(2, 0)]
        + [_ins(s, 2, kind=ttk.TREE_INSERT_BEFORE) for s in range(3, 30)],
        [_ins(1, 0), _ins(2, 0)]
        + [_ins(s, 1, kind=ttk.TREE_INSERT_AFTER) for s in range(3, 30)],
        [_ins(1, 0)] + [_ins(s, s - 1, kind=ttk.TREE_INSERT_AFTER)
                        for s in range(2, 30)],
        [_ins(1, 0)] + [_ins(s, 0, kind=ttk.TREE_INSERT_START)
                        for s in range(2, 30)],
    ]
    _, out = run_both(_blank(64), per_doc)
    assert out["overflow"][0].any() and out["overflow"][1].any()
    assert not out["overflow"][2:].any()


def _ranked(ranks: dict[int, list[tuple[int, int]]], n: int = 64) -> dict:
    """Planes with, in doc d, each (slot, rank) of ``ranks[d]`` a live
    child of the root in trait 0."""
    arrays = _blank(n)
    for d, nodes in ranks.items():
        for slot, rank in nodes:
            arrays["exists"][d, slot] = True
            arrays["parent"][d, slot] = 0
            arrays["rank"][d, slot] = rank
            arrays["payload"][d, slot] = slot
    return arrays


def test_append_and_prepend_past_rank_limit():
    lim, gap = ttk.RANK_LIMIT, ttk.RANK_GAP
    arrays = _ranked({0: [(1, lim - gap - 1)], 1: [(1, -(lim - gap - 1))],
                      2: [(1, lim - 1)], 3: [(1, 5)]})
    per_doc = [
        [_ins(2, 0), _ins(3, 0)],
        [_ins(2, 0, kind=ttk.TREE_INSERT_START),
         _ins(3, 0, kind=ttk.TREE_INSERT_START)],
        [_ins(2, 0), dict(kind=ttk.TREE_MOVE, node=1, parent=0, trait=1)],
        [_ins(2, 0), _ins(3, 0)],
    ]
    _, out = run_both(arrays, per_doc)
    assert out["applied"][:2, :2].tolist() == [[True, False], [True, False]]
    assert out["overflow"][:2, :2].tolist() == [[False, True], [False, True]]
    assert out["overflow"][2, 0] and not out["overflow"][3].any()


def test_midpoint_sum_wraps_in_int32():
    """A lone sibling near -RANK_LIMIT: its default lower neighbour is
    r - 2 * RANK_GAP, and r + that passes -2**31, so the before-midpoint
    wraps in int32 (as the reference's does); likewise after a sibling
    near +RANK_LIMIT."""
    lim, gap = ttk.RANK_LIMIT, ttk.RANK_GAP
    low, high = -(lim - 3), lim - 3
    assert 2 * low - 2 * gap < -(1 << 31) and 2 * high + 2 * gap >= 1 << 31
    arrays = _ranked({0: [(1, low)], 1: [(1, high)], 2: [(1, low), (4, 0)],
                      3: [(1, high), (4, 0)]})
    per_doc = [
        [_ins(2, 1, kind=ttk.TREE_INSERT_BEFORE),
         _ins(3, 1, kind=ttk.TREE_INSERT_AFTER)],
        [_ins(2, 1, kind=ttk.TREE_INSERT_AFTER),
         _ins(3, 1, kind=ttk.TREE_INSERT_BEFORE)],
        [dict(kind=ttk.TREE_MOVE_BEFORE, node=4, parent=1)],
        [dict(kind=ttk.TREE_MOVE_AFTER, node=4, parent=1)],
    ]
    _, out = run_both(arrays, per_doc)
    assert out["overflow"][:, 0].all()
    assert out["applied"][:2, 1].all()


def _chain(depths: list[int], n: int = 64) -> dict:
    """Planes with, in doc d, slots 1..depths[d] a chain under the root
    (slot i the only child of slot i - 1)."""
    arrays = _blank(n)
    for d, depth in enumerate(depths):
        for i in range(1, depth + 1):
            arrays["exists"][d, i] = True
            arrays["parent"][d, i] = i - 1
            arrays["payload"][d, i] = i
    return arrays


@pytest.mark.parametrize("depth", [31, 32, 33, 40])
def test_detach_and_move_chains_at_the_pass_cap(depth):
    arrays = _chain([depth] * B)
    per_doc = [
        [dict(kind=ttk.TREE_DETACH, node=1)],
        [dict(kind=ttk.TREE_MOVE, node=1, parent=0, trait=1)],
        [dict(kind=ttk.TREE_DETACH, node=2)],
        [dict(kind=ttk.TREE_DETACH, node=depth),
         dict(kind=ttk.TREE_SET_VALUE, node=1, payload=9)],
    ]
    state, out = run_both(arrays, per_doc)
    blown = depth > ttk.MAX_DEPTH_PASSES
    assert out["overflow"][:, 0].tolist() == [blown, blown,
                                              depth - 1 > 32, False]
    assert bool(state["exists"][0, 1]) == blown


def test_stale_detached_slots_still_chain():
    """Detached slots keep their parent links and the sweep covers every
    slot, so a detach or move whose live subtree is shallow runs out of
    passes when stale slots chain on below it, as in the reference."""
    arrays = _chain([40, 30, 20, 40])
    detach = ttk.TREE_DETACH
    per_doc = [
        [dict(kind=detach, node=20), dict(kind=detach, node=1)],
        [dict(kind=detach, node=20), dict(kind=detach, node=1)],
        [dict(kind=detach, node=5), _ins(5, 0), dict(kind=detach, node=5)],
        [dict(kind=detach, node=20),
         dict(kind=ttk.TREE_MOVE, node=1, parent=0, trait=1)],
    ]
    _, out = run_both(arrays, per_doc)
    assert out["applied"][0, :2].tolist() == [True, False]
    assert out["overflow"][0, :2].tolist() == [False, True]
    assert out["applied"][1, :2].all() and out["applied"][2, :3].all()
    assert out["overflow"][3, 1] and not out["applied"][3, 1]


def test_move_into_its_own_subtree_is_invalid():
    arrays = _chain([3] * B)
    per_doc = [
        [dict(kind=ttk.TREE_MOVE, node=1, parent=3, trait=1),
         dict(kind=ttk.TREE_MOVE_START, node=1, parent=1, trait=1)],
        [dict(kind=ttk.TREE_MOVE_BEFORE, node=1, parent=2),
         dict(kind=ttk.TREE_MOVE_AFTER, node=1, parent=1)],
        [dict(kind=ttk.TREE_MOVE, node=2, parent=0, trait=1),
         dict(kind=ttk.TREE_MOVE_AFTER, node=1, parent=2)],
        [dict(kind=ttk.TREE_MOVE, node=0, parent=1),
         dict(kind=ttk.TREE_MOVE, node=3, parent=70)],
    ]
    _, out = run_both(arrays, per_doc)
    assert out["applied"][:2].sum() == 0 and out["applied"][2, :2].all()
    assert not out["applied"][3].any() and not out["overflow"].any()


def test_constraint_count_after_detach_and_padded_k():
    ops = [
        _ins(1, 0), _ins(2, 0),
        dict(kind=ttk.TREE_CONSTRAINT_COUNT, parent=0, trait=0, payload=2),
        dict(kind=ttk.TREE_DETACH, node=1),
        dict(kind=ttk.TREE_CONSTRAINT_COUNT, parent=0, trait=0, payload=2),
        dict(kind=ttk.TREE_CONSTRAINT_COUNT, parent=0, trait=0, payload=1),
        dict(kind=ttk.TREE_CONSTRAINT_EXISTS, node=2),
        dict(kind=ttk.TREE_CONSTRAINT_EXISTS, node=1),
        dict(kind=ttk.TREE_CONSTRAINT_EXISTS, node=0),
        dict(kind=ttk.TREE_CONSTRAINT_EXISTS, node=100),
        dict(kind=ttk.TREE_CONSTRAINT_COUNT, parent=-1, payload=0),
    ]
    per_doc = [ops, [], ops[:1], ops[:4] + [_ins(3, 2, trait=1)] * 28]
    _, out = run_both(_blank(64), per_doc)
    assert out["applied"][0, :10].tolist() == [
        True, True, True, True, False, True, True, False, False, False]
    assert not out["applied"][1].any() and out["applied"][2].sum() == 1
    assert not out["applied"][:, len(ops):][:3].any()
