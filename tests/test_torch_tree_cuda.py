"""The tree tick's CUDA kernel (``ops/tree_cuda.py``, one launch a tick)
against the plain tree tick (``ops/tree_kernel.py``), on the card.

Marked ``cuda``: without a CUDA device every test here skips (decided in
the ``cuda`` fixture, never at import). The file imports only torch,
numpy and the port (the benchmark's tree traffic generator by path), so
on a machine with a card and no JAX it runs without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_tree_cuda.py

Both versions run on the same CUDA inputs, tick after tick; every state
plane, ``applied`` and ``overflow`` must be exactly equal (every plane is
integer), the kernel must launch once a tick and never reach the plain
tick, and the inputs must be left as they were. Shapes: the mixed cell's
(8,192, 8, 128) with ops drawn by ``perfbench/traffic/tree.py``, tree B's
(8,192, 32, 256), and odd widths (rows that are not whole 16-byte words,
more than 32 ops, wide rows held a few a block). Named cases are
``tests/test_torch_tree.py``'s edges: rank midpoint exhaustion, appends
and prepends past ``RANK_LIMIT``, a midpoint sum that wraps in int32,
detach and move chains at depths 31, 32, 33 and 40 around the pass cap,
stale detached slots that still chain, a move into its own subtree, the
count constraint after a detach with K padded; each with ``steps=None``,
the host's steps, and steps marked False where a document detaches.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from fluidframework_tpu_torch.ops import tree_cuda as tcc
from fluidframework_tpu_torch.ops import tree_kernel as tk

pytestmark = pytest.mark.cuda

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _traffic():
    """``perfbench/traffic/tree.py`` and the mixed cell's tree parameters,
    loaded by path."""
    path = ROOT / "perfbench" / "traffic" / "tree.py"
    spec = importlib.util.spec_from_file_location("perfbench_tree", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    work = json.loads((ROOT / "perfbench" / "workloads"
                       / "mixed_8k.seeded.json").read_text())
    return mod, work["traffic"]["tree"]


def _blank(b: int, n: int) -> dict:
    exists = np.zeros((b, n), np.bool_)
    exists[:, 0] = True
    return {"exists": exists, "parent": np.full((b, n), -1, np.int32),
            **{f: np.zeros((b, n), np.int32)
               for f in ("trait", "rank", "payload")}}


def _state(arrays: dict, device) -> tk.TreeState:
    return tk.TreeState(*(torch.from_numpy(np.ascontiguousarray(
        arrays[f])).to(device) for f in tk.TreeState._fields))


def _batch(planes: dict, device) -> tk.TreeOpBatch:
    return tk.TreeOpBatch(*(torch.from_numpy(np.ascontiguousarray(
        planes[f])).to(device) for f in tk.TreeOpBatch._fields))


def _ops_planes(per_doc: list[list[dict]], k: int) -> dict:
    b = len(per_doc)
    planes = {"valid": np.zeros((b, k), np.bool_),
              **{f: np.zeros((b, k), np.int32)
                 for f in ("kind", "node", "parent", "trait", "payload")}}
    for d, ops in enumerate(per_doc):
        for i, op in enumerate(ops):
            planes["valid"][d, i] = True
            for f in ("kind", "node", "parent", "trait", "payload"):
                planes[f][d, i] = op.get(f, 0)
    return planes


def _pack_planes(pack: np.ndarray, rows: np.ndarray, docs: int) -> dict:
    """A [rows, 6, k] traffic pack (field order ``tree.FIELDS``) at
    ``rows`` of ``docs`` documents; the other rows hold no op."""
    k = pack.shape[2]
    planes = {"valid": np.zeros((docs, k), np.bool_),
              **{f: np.zeros((docs, k), np.int32)
                 for f in ("kind", "node", "parent", "trait", "payload")}}
    planes["valid"][rows] = pack[:, 0] != 0
    for i, f in enumerate(("kind", "node", "parent", "trait", "payload")):
        planes[f][rows] = pack[:, i + 1]
    return planes


def _steps_of(planes: dict) -> list[bool]:
    kinds = np.isin(planes["kind"], list(tk.SUBTREE_KINDS)) & planes["valid"]
    return [bool(x) for x in kinds.any(axis=0)]


def _tick_both(state: tk.TreeState, planes: dict, steps, device):
    """One tick of ``planes`` through the kernel and the plain tick on the
    same CUDA inputs: every plane and flag equal, one launch, the plain
    tick never reached from the kernel's call, the inputs unchanged.
    Returns the kernel's (state, out)."""
    ops = _batch(planes, device)
    before = [t.clone() for t in (*state, *ops)]
    plain = tk.apply_tick
    reached = []

    def spy(*args, **kwargs):
        reached.append(args)
        return plain(*args, **kwargs)
    launches = tcc.tick.launches
    tk.apply_tick = spy
    try:
        got_s, got_o = tcc.apply_tick_best(state, ops, steps)
    finally:
        tk.apply_tick = plain
    assert not reached, "CUDA tensors reached the plain tick"
    assert tcc.tick.launches == launches + 1
    want_s, want_o = plain(state, ops, steps)
    for f, a, b in zip(tk.TreeState._fields, got_s, want_s):
        assert a.dtype == b.dtype and a.device.type == "cuda", f
        assert torch.equal(a, b), f
    for f, a, b in zip(tk.TreeOpOut._fields, got_o, want_o):
        assert a.dtype == b.dtype, f
        assert torch.equal(a, b), f
    for x, y in zip(before, (*state, *ops)):
        assert torch.equal(x, y), "an input was modified"
    return got_s, got_o


def _run_both(arrays: dict, per_doc: list[list[dict]], device, k: int = 32):
    """One tick of ``per_doc`` from ``arrays`` through both, with the
    host's steps and with every step swept; returns the kernel's (state,
    out) as numpy."""
    planes = _ops_planes(per_doc, k)
    state = _state(arrays, device)
    _tick_both(state, planes, None, device)
    got_s, got_o = _tick_both(state, planes, tk.subtree_steps(per_doc, k),
                              device)
    return ({f: t.cpu().numpy() for f, t in zip(tk.TreeState._fields,
                                                 got_s)},
            {f: t.cpu().numpy() for f, t in zip(tk.TreeOpOut._fields,
                                                 got_o)})


# -- the serving shapes ---------------------------------------------------------


def test_mixed_cell_shape_matches_plain(cuda):
    """The mixed cell's tree leg: 8,192 documents of 128 slots, K = 8, the
    tree rows (r % 4 == 3) drawn by the benchmark's generator, the rest
    idle; 12 ticks chained, the steps from the host's pack (nearly every
    step holds a move or detach somewhere, so the sweep runs)."""
    traffic, params = _traffic()
    docs, n, k, ticks = 8192, 128, 8, 12
    rows = np.arange(3, docs, 4)
    gen = traffic.generate(np.random.default_rng(2**33 + 21), len(rows), k,
                           ticks, {}, dict(params, slots=n))
    state = _state(_blank(docs, n), cuda)
    swept = applied = 0
    for t in range(ticks):
        planes = _pack_planes(gen["pack"][t], rows, docs)
        steps = _steps_of(planes)
        swept += sum(steps)
        state, out = _tick_both(state, planes, steps, cuda)
        applied += int(out.applied.sum())
    assert swept > 0.9 * ticks * k
    assert applied > 0.9 * len(rows) * k * ticks


def test_tree_b_shape_matches_plain(cuda):
    """Tree B's shape, 8,192 documents of 256 slots and K = 32: six ticks
    of the generator's traffic in every document, then two of ops of
    every kind with anchors anywhere in [-2, N + 2)."""
    traffic, params = _traffic()
    docs, n, k = 8192, 256, 32
    rng = np.random.default_rng(5)
    gen = traffic.generate(rng, docs, k, 6, {}, dict(params, slots=n))
    state = _state(_blank(docs, n), cuda)
    for t in range(6):
        planes = _pack_planes(gen["pack"][t], np.arange(docs), docs)
        state, _ = _tick_both(state, planes, _steps_of(planes), cuda)
    for _ in range(2):
        planes = _wild(rng, docs, n, k)
        state, _ = _tick_both(state, planes, _steps_of(planes), cuda)


def _wild(rng, b: int, n: int, k: int) -> dict:
    """Ops of every kind (and one past them) with anchors anywhere in
    [-2, N + 2), a random count a document."""
    planes = {"valid": np.arange(k)[None, :] < rng.integers(0, k + 1,
                                                            (b, 1)),
              "kind": rng.integers(0, 13, (b, k)).astype(np.int32),
              "node": rng.integers(-2, n + 2, (b, k)).astype(np.int32),
              "parent": rng.integers(-2, n + 2, (b, k)).astype(np.int32),
              "trait": rng.integers(0, 3, (b, k)).astype(np.int32),
              "payload": rng.integers(0, 5, (b, k)).astype(np.int32)}
    # Chains so detaches and moves sweep deep subtrees.
    for d in range(0, b, 7):
        m = min(k - 1, n - 1)
        planes["valid"][d] = np.arange(k) <= m
        planes["kind"][d, :m] = tk.TREE_INSERT
        planes["node"][d, :m] = np.arange(1, m + 1)
        planes["parent"][d, :m] = np.arange(m)
        planes["trait"][d, :m] = 0
        planes["kind"][d, m] = tk.TREE_DETACH
        planes["node"][d, m] = 1
    return planes


@pytest.mark.parametrize("b,n,k", [
    (5, 37, 40),     # rows not whole 16-byte words; two op chunks
    (64, 100, 70),   # three op chunks, scalar row copies
    (9, 600, 33),    # four documents a block
    (3, 2048, 8),    # one document a block
    (16, 32, 0),     # no ops: every row copies through
    (13, 1, 5)])     # the root alone
def test_odd_shapes_match_plain(cuda, b, n, k):
    rng = np.random.default_rng(b * 1000 + n)
    state = _state(_blank(b, n), cuda)
    for _tick in range(4):
        planes = _wild(rng, b, n, k) if k else _ops_planes([[]] * b, 0)
        state, _ = _tick_both(state, planes, _steps_of(planes), cuda)
        state, _ = _tick_both(state, planes, None, cuda)


# -- the edges ------------------------------------------------------------------


def _ins(node, parent, trait=0, payload=1, kind=tk.TREE_INSERT):
    return dict(kind=kind, node=node, parent=parent, trait=trait,
                payload=payload)


def _ranked(ranks: dict[int, list[tuple[int, int]]], n: int = 64) -> dict:
    arrays = _blank(4, n)
    for d, nodes in ranks.items():
        for slot, rank in nodes:
            arrays["exists"][d, slot] = True
            arrays["parent"][d, slot] = 0
            arrays["rank"][d, slot] = rank
            arrays["payload"][d, slot] = slot
    return arrays


def _chain(depths: list[int], n: int = 64) -> dict:
    arrays = _blank(len(depths), n)
    for d, depth in enumerate(depths):
        for i in range(1, depth + 1):
            arrays["exists"][d, i] = True
            arrays["parent"][d, i] = i - 1
            arrays["payload"][d, i] = i
    return arrays


def test_rank_midpoint_exhaustion(cuda):
    per_doc = [
        [_ins(1, 0), _ins(2, 0)]
        + [_ins(s, 2, kind=tk.TREE_INSERT_BEFORE) for s in range(3, 30)],
        [_ins(1, 0), _ins(2, 0)]
        + [_ins(s, 1, kind=tk.TREE_INSERT_AFTER) for s in range(3, 30)],
        [_ins(1, 0)] + [_ins(s, s - 1, kind=tk.TREE_INSERT_AFTER)
                        for s in range(2, 30)],
        [_ins(1, 0)] + [_ins(s, 0, kind=tk.TREE_INSERT_START)
                        for s in range(2, 30)],
    ]
    _, out = _run_both(_blank(4, 64), per_doc, cuda)
    assert out["overflow"][0].any() and out["overflow"][1].any()
    assert not out["overflow"][2:].any()


def test_append_and_prepend_past_rank_limit(cuda):
    lim, gap = tk.RANK_LIMIT, tk.RANK_GAP
    arrays = _ranked({0: [(1, lim - gap - 1)], 1: [(1, -(lim - gap - 1))],
                      2: [(1, lim - 1)], 3: [(1, 5)]})
    per_doc = [
        [_ins(2, 0), _ins(3, 0)],
        [_ins(2, 0, kind=tk.TREE_INSERT_START),
         _ins(3, 0, kind=tk.TREE_INSERT_START)],
        [_ins(2, 0), dict(kind=tk.TREE_MOVE, node=1, parent=0, trait=1)],
        [_ins(2, 0), _ins(3, 0)],
    ]
    _, out = _run_both(arrays, per_doc, cuda)
    assert out["applied"][:2, :2].tolist() == [[True, False], [True, False]]
    assert out["overflow"][:2, :2].tolist() == [[False, True], [False, True]]
    assert out["overflow"][2, 0] and not out["overflow"][3].any()


def test_midpoint_sum_wraps_in_int32(cuda):
    """Siblings near -/+RANK_LIMIT: the midpoint sums pass -2**31 and
    2**31 and wrap in int32, in the kernel as in the plain tick."""
    lim, gap = tk.RANK_LIMIT, tk.RANK_GAP
    low, high = -(lim - 3), lim - 3
    assert 2 * low - 2 * gap < -(1 << 31) and 2 * high + 2 * gap >= 1 << 31
    arrays = _ranked({0: [(1, low)], 1: [(1, high)], 2: [(1, low), (4, 0)],
                      3: [(1, high), (4, 0)]})
    per_doc = [
        [_ins(2, 1, kind=tk.TREE_INSERT_BEFORE),
         _ins(3, 1, kind=tk.TREE_INSERT_AFTER)],
        [_ins(2, 1, kind=tk.TREE_INSERT_AFTER),
         _ins(3, 1, kind=tk.TREE_INSERT_BEFORE)],
        [dict(kind=tk.TREE_MOVE_BEFORE, node=4, parent=1)],
        [dict(kind=tk.TREE_MOVE_AFTER, node=4, parent=1)],
    ]
    _, out = _run_both(arrays, per_doc, cuda)
    assert out["overflow"][:, 0].all()
    assert out["applied"][:2, 1].all()


def test_ranks_at_the_int32_ends(cuda):
    """Ranks at INT32_MIN and INT32_MAX: appends and prepends wrap, and
    abs(INT32_MIN) stays negative (under RANK_LIMIT), as in torch."""
    i32 = np.iinfo(np.int32)
    arrays = _ranked({0: [(1, i32.max)], 1: [(1, i32.min)],
                      2: [(1, i32.min), (2, i32.min + 1)],
                      3: [(1, i32.max - 1), (2, i32.max)]})
    per_doc = [
        [_ins(3, 0), _ins(4, 1, kind=tk.TREE_INSERT_AFTER)],
        [_ins(3, 0, kind=tk.TREE_INSERT_START),
         _ins(4, 1, kind=tk.TREE_INSERT_BEFORE)],
        [_ins(3, 1, kind=tk.TREE_INSERT_BEFORE), _ins(4, 0),
         dict(kind=tk.TREE_MOVE_START, node=2, parent=0)],
        [_ins(3, 2, kind=tk.TREE_INSERT_AFTER),
         _ins(4, 0, kind=tk.TREE_INSERT_START),
         dict(kind=tk.TREE_MOVE, node=1, parent=0)],
    ]
    _run_both(arrays, per_doc, cuda)


def test_midpoint_floors_negative_odd_sums(cuda):
    """Halving floors (an arithmetic shift), as torch's floor division:
    between ranks -3 and 0 the midpoint is -2, not -1."""
    arrays = _ranked({0: [(1, -3), (2, 0)], 1: [(1, -3), (2, 0)],
                      2: [(1, -5), (2, -2)], 3: [(1, -1), (2, 0)]})
    per_doc = [
        [_ins(3, 2, kind=tk.TREE_INSERT_BEFORE)],
        [_ins(3, 1, kind=tk.TREE_INSERT_AFTER)],
        [dict(kind=tk.TREE_MOVE_BEFORE, node=2, parent=1),
         _ins(3, 1, kind=tk.TREE_INSERT_AFTER)],
        [_ins(3, 2, kind=tk.TREE_INSERT_BEFORE),
         _ins(4, 1, kind=tk.TREE_INSERT_AFTER)],
    ]
    state, out = _run_both(arrays, per_doc, cuda)
    assert state["rank"][0, 3] == -2 and state["rank"][1, 3] == -2
    assert out["applied"][:3, 0].all()


@pytest.mark.parametrize("depth", [31, 32, 33, 40])
def test_detach_and_move_chains_at_the_pass_cap(cuda, depth):
    arrays = _chain([depth] * 4)
    per_doc = [
        [dict(kind=tk.TREE_DETACH, node=1)],
        [dict(kind=tk.TREE_MOVE, node=1, parent=0, trait=1)],
        [dict(kind=tk.TREE_DETACH, node=2)],
        [dict(kind=tk.TREE_DETACH, node=depth),
         dict(kind=tk.TREE_SET_VALUE, node=1, payload=9)],
    ]
    state, out = _run_both(arrays, per_doc, cuda)
    blown = depth > tk.MAX_DEPTH_PASSES
    assert out["overflow"][:, 0].tolist() == [blown, blown,
                                              depth - 1 > 32, False]
    assert bool(state["exists"][0, 1]) == blown


def test_stale_detached_slots_still_chain(cuda):
    arrays = _chain([40, 30, 20, 40])
    detach = tk.TREE_DETACH
    per_doc = [
        [dict(kind=detach, node=20), dict(kind=detach, node=1)],
        [dict(kind=detach, node=20), dict(kind=detach, node=1)],
        [dict(kind=detach, node=5), _ins(5, 0), dict(kind=detach, node=5)],
        [dict(kind=detach, node=20),
         dict(kind=tk.TREE_MOVE, node=1, parent=0, trait=1)],
    ]
    _, out = _run_both(arrays, per_doc, cuda)
    assert out["applied"][0, :2].tolist() == [True, False]
    assert out["overflow"][0, :2].tolist() == [False, True]
    assert out["applied"][1, :2].all() and out["applied"][2, :3].all()
    assert out["overflow"][3, 1] and not out["applied"][3, 1]


def test_move_into_its_own_subtree_is_invalid(cuda):
    arrays = _chain([3] * 4)
    per_doc = [
        [dict(kind=tk.TREE_MOVE, node=1, parent=3, trait=1),
         dict(kind=tk.TREE_MOVE_START, node=1, parent=1, trait=1)],
        [dict(kind=tk.TREE_MOVE_BEFORE, node=1, parent=2),
         dict(kind=tk.TREE_MOVE_AFTER, node=1, parent=1)],
        [dict(kind=tk.TREE_MOVE, node=2, parent=0, trait=1),
         dict(kind=tk.TREE_MOVE_AFTER, node=1, parent=2)],
        [dict(kind=tk.TREE_MOVE, node=0, parent=1),
         dict(kind=tk.TREE_MOVE, node=3, parent=70)],
    ]
    _, out = _run_both(arrays, per_doc, cuda)
    assert out["applied"][:2].sum() == 0 and out["applied"][2, :2].all()
    assert not out["applied"][3].any() and not out["overflow"].any()


def test_constraint_count_after_detach_and_padded_k(cuda):
    ops = [
        _ins(1, 0), _ins(2, 0),
        dict(kind=tk.TREE_CONSTRAINT_COUNT, parent=0, trait=0, payload=2),
        dict(kind=tk.TREE_DETACH, node=1),
        dict(kind=tk.TREE_CONSTRAINT_COUNT, parent=0, trait=0, payload=2),
        dict(kind=tk.TREE_CONSTRAINT_COUNT, parent=0, trait=0, payload=1),
        dict(kind=tk.TREE_CONSTRAINT_EXISTS, node=2),
        dict(kind=tk.TREE_CONSTRAINT_EXISTS, node=1),
        dict(kind=tk.TREE_CONSTRAINT_EXISTS, node=0),
        dict(kind=tk.TREE_CONSTRAINT_EXISTS, node=100),
        dict(kind=tk.TREE_CONSTRAINT_COUNT, parent=-1, payload=0),
    ]
    per_doc = [ops, [], ops[:1], ops[:4] + [_ins(3, 2, trait=1)] * 28]
    _, out = _run_both(_blank(4, 64), per_doc, cuda)
    assert out["applied"][0, :10].tolist() == [
        True, True, True, True, False, True, True, False, False, False]
    assert not out["applied"][1].any() and out["applied"][2].sum() == 1


def test_steps_marked_false_where_a_document_detaches(cuda):
    """A step marked False takes the seed as its mask and never reports
    depth: a detach there drops the node alone and a move there never
    overflows, in the kernel as in the plain tick; None sweeps every
    step."""
    arrays = _chain([40, 10, 40, 5])
    per_doc = [
        [dict(kind=tk.TREE_DETACH, node=1), _ins(50, 2)],
        [dict(kind=tk.TREE_DETACH, node=3),
         dict(kind=tk.TREE_DETACH, node=1)],
        [dict(kind=tk.TREE_MOVE, node=1, parent=0, trait=1),
         dict(kind=tk.TREE_MOVE, node=2, parent=1, trait=2)],
        [dict(kind=tk.TREE_MOVE, node=1, parent=3),
         dict(kind=tk.TREE_DETACH, node=2)],
    ]
    planes = _ops_planes(per_doc, 32)
    state = _state(arrays, cuda)
    off, _ = _tick_both(state, planes, [False] * 32, cuda)
    # Document 0 lost slot 1 alone; slot 2 still exists.
    exists = off.exists.cpu().numpy()
    assert not exists[0, 1] and exists[0, 2]
    mixed = [False, True] + [False] * 30
    _tick_both(state, planes, mixed, cuda)
    swept, out = _tick_both(state, planes, None, cuda)
    assert out.overflow[0, 0] and out.overflow[2, 0]
    assert not swept.exists.cpu().numpy()[1, 1:].any()
