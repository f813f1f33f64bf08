"""Differential: the port's flat merge table (the plain version of the flat
merge tick kernel) and its scalar MergeEngine against the JAX package's.

Inputs are sequenced streams with genuinely concurrent refs (the
reference's own generator, tests/test_mergetree_blocks.gen_stream) with
client slots spread over two overlap words; every plane must be EXACTLY
equal (int32 and bool planes, tolerance 0) after every tick, against
``mergetree_kernel.apply_tick`` and, at one shape, against the Pallas
kernel in interpret mode.
"""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.dds.mergetree import MergeEngine as JaxEngine
from fluidframework_tpu.ops import mergetree_kernel as jmtk
from fluidframework_tpu.ops import mergetree_pallas as jmtp
from fluidframework_tpu_torch.dds.mergetree import MergeEngine
from fluidframework_tpu_torch.ops import mergetree_kernel as mtk
from tests.test_mergetree_blocks import gen_stream

B, S, K, P, W = 4, 64, 8, 2, 2


def streams(seed: int, n_ops: int = 24) -> list[list[dict]]:
    """B concurrent streams; clients 0..36 need two overlap words."""
    rng = random.Random(seed)
    out = [gen_stream(rng, n_ops) for _ in range(B)]
    for s in out:
        for op in s:
            op["client"] *= 9
    return out


def jplanes(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def tplanes(state) -> dict:
    return {f: getattr(state, f).numpy() for f in state._fields}


def assert_planes_equal(a: dict, b: dict, where="") -> None:
    assert a.keys() == b.keys()
    for f in a:
        assert a[f].dtype == b[f].dtype, (where, f)
        assert np.array_equal(a[f], b[f]), (where, f)


def batches(chunk: list[list[dict]]):
    return (jmtk.make_merge_op_batch(chunk, B, K),
            mtk.make_merge_op_batch(chunk, B, K, device="cpu"))


def run_both(seed: int):
    """Tick both flat tables through the same streams; yields the pair
    after every tick."""
    js = jmtk.init_state(B, S, P, W)
    ts = mtk.init_state(B, S, P, W, device="cpu")
    ss = streams(seed)
    for start in range(0, len(ss[0]), K):
        jb, tb = batches([s[start:start + K] for s in ss])
        js, ts = jmtk.apply_tick(js, jb), mtk.apply_tick(ts, tb)
        yield js, ts


@pytest.mark.parametrize("seed", range(2))
def test_apply_tick_matches_jax(seed):
    for t, (js, ts) in enumerate(run_both(seed)):
        assert_planes_equal(jplanes(js), tplanes(ts), t)
    assert int(ts.count.max()) > 20  # real tables, not empty ones


def test_apply_tick_matches_pallas_interpret():
    js = jmtk.init_state(B, S, P, W)
    ts = mtk.init_state(B, S, P, W, device="cpu")
    ss = streams(7, 16)
    for start in range(0, 16, K):
        jb, tb = batches([s[start:start + K] for s in ss])
        js = jmtp.apply_tick_pallas(js, jb, interpret=True)
        ts = mtk.apply_tick(ts, tb)
        assert_planes_equal(jplanes(js), tplanes(ts), start)


def test_apply_tick_leaves_its_inputs_alone():
    ts = mtk.init_state(B, S, P, W, device="cpu")
    before = tplanes(ts)
    before = {f: a.copy() for f, a in before.items()}
    _, tb = batches([s[:K] for s in streams(3)])
    out = mtk.apply_tick(ts, tb)
    assert_planes_equal(before, tplanes(ts))
    assert all(a is not b for a, b in zip(out, ts))


@pytest.mark.parametrize("coalesce", [False, True])
def test_compact_matches_jax(coalesce):
    *_, (js, ts) = run_both(1)
    for ms in ([0, 5, 12, -1], [30, 30, 30, 30]):
        got = mtk.compact(ts, torch.tensor(ms, dtype=torch.int32), coalesce)
        want = jmtk.compact(js, jnp.asarray(ms, jnp.int32), coalesce)
        assert_planes_equal(jplanes(want), tplanes(got), ms)


def test_capacity_margin_and_materialize():
    *_, (js, ts) = run_both(0)
    assert mtk.client_capacity(ts) == jmtk.client_capacity(js) == 64
    assert np.array_equal(mtk.capacity_margin(ts),
                          jmtk.capacity_margin(js))
    jpool, tpool = jmtk.TextPool(B), mtk.TextPool(B)
    rng = random.Random(4)
    for d in range(B):
        for _ in range(30):
            text = "".join(rng.choice("xyz") for _ in range(4))
            assert jpool.append(d, text) == tpool.append(d, text)
    for d in range(B):
        assert mtk.materialize(ts, tpool, d) \
            == jmtk.materialize(js, jpool, d)


def test_op_batch_refuses_clients_past_the_overlap_planes():
    ops = [[dict(kind=mtk.MT_INSERT, pos=0, seq=1, ref_seq=0, client=64,
                 pool_start=0, text_len=1)]]
    with pytest.raises(ValueError, match="overlap"):
        mtk.make_merge_op_batch(ops, 1, 4, client_slots=64, device="cpu")
    batch = mtk.make_merge_op_batch(ops, 1, 4, client_slots=96,
                                    device="cpu")
    assert batch.valid.dtype == torch.bool and batch.client[0, 0] == 64


def test_merge_engine_matches_jax():
    """The port's scalar engine is a copy of the reference's: the same
    remote stream (with markers, props and min_seq advances) gives the
    same segments and text."""
    rng = random.Random(11)
    engines = (JaxEngine(local_client=None), MergeEngine(local_client=None))
    for seq in range(1, 301):
        length = engines[1].local_length()
        client = f"c{rng.randrange(6)}"
        r = rng.random()
        if length > 4 and r < 0.3:
            s = rng.randrange(length - 2)
            op = {"type": "remove", "start": s,
                  "end": s + rng.randint(1, 2)}
        elif length > 4 and r < 0.4:
            s = rng.randrange(length - 2)
            op = {"type": "annotate", "start": s, "end": s + 2,
                  "props": {"k": rng.randrange(3)}}
        elif r < 0.45:
            op = {"type": "insert", "pos": rng.randint(0, length),
                  "marker": {"ref_type": "simple", "id": None}}
        else:
            op = {"type": "insert", "pos": rng.randint(0, length),
                  "text": "ab"[:rng.randint(1, 2)]}
        for e in engines:
            e.apply_remote(op, seq, seq - 1, client)
            if seq % 25 == 0:
                e.update_min_seq(seq - 10)
    jax_engine, port_engine = engines
    assert port_engine.get_text() == jax_engine.get_text()
    assert [(s.content if isinstance(s.content, str) else repr(s.content),
             s.seq, s.client, s.removed_seq, s.removed_client,
             sorted(s.removed_overlap), s.props)
            for s in port_engine.segments] \
        == [(s.content if isinstance(s.content, str) else repr(s.content),
             s.seq, s.client, s.removed_seq, s.removed_client,
             sorted(s.removed_overlap), s.props)
            for s in jax_engine.segments]


@pytest.mark.parametrize("case,s,k,clients,pallas", [
    ("past_capacity", 16, 12, 32, False),
    ("past_capacity_at_lane_width", 128, 48, 32, True),
    ("wide_clients", 64, 12, 38, True)])
def test_apply_tick_matches_jax_at_the_edges(case, s, k, clients, pallas):
    """Inputs both variants of the flat tick's kernel must take: a table
    filled past capacity (segments fall off the end and the shift reads
    wrap), and removes by clients at or past 32 * W (the overlap bit
    clamps to the last word's top bit). The plain version equals the JAX
    package's XLA tick tick by tick, and its Pallas kernel (interpret
    mode) where that kernel's lane padding does not widen the table: the
    Pallas kernel pads S to 128 lanes, so below that a tick that fills
    the table keeps, until it ends, the segments the XLA tick drops
    (ROADMAP Queue C)."""
    from tests.test_torch_cuda_kernels import _merge_ticks

    b, p, w = 3, 2, 1
    rng = np.random.default_rng(s + k + clients)
    js = jmtk.init_state(b, s, p, w)
    ps = jmtk.init_state(b, s, p, w)
    ts = mtk.init_state(b, s, p, w, device="cpu")
    for fields in _merge_ticks(rng, b, k, 3, clients):
        tb = mtk.MergeOpBatch(**{f: torch.from_numpy(np.ascontiguousarray(
            fields[f])) for f in mtk.MergeOpBatch._fields})
        jb = jmtk.MergeOpBatch(**{f: jnp.asarray(fields[f])
                                  for f in jmtk.MergeOpBatch._fields})
        js, ts = jmtk.apply_tick(js, jb), mtk.apply_tick(ts, tb)
        assert_planes_equal(jplanes(js), tplanes(ts), case)
        if pallas:
            ps = jmtp.apply_tick_pallas(ps, jb, interpret=True)
            assert_planes_equal(jplanes(ps), tplanes(ts), (case, "pallas"))
    if case.startswith("past_capacity"):
        assert int(ts.count.max()) > s
    else:
        assert int(ts.rem_seq.ne(mtk.NONE_SEQ).sum()) > 0
