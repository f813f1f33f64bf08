"""Differential: the port's matrix table (the plain versions of the matrix
op tick and the matrix step tick, the cell-run append, the cell-log
compaction, the host-side encoders and ``materialize_grid``) and its
``PermutationVector`` against the JAX package's.

Inputs are seeded sequenced matrix streams with concurrent refs: row and
col inserts and removes from many writers (client slots past 32, so the
overlap planes take two words), cell writes aimed at live, removed and
out-of-range rows. Every plane must be EXACTLY equal (int32 and bool
planes, tolerance 0) after every tick, against ``matrix_kernel`` and, at
one shape each, against the Pallas kernels in interpret mode.
"""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidframework_tpu.dds.matrix import PermutationVector as JaxVector
from fluidframework_tpu.ops import matrix_kernel as jmxk
from fluidframework_tpu.ops import matrix_pallas as jmxp
from fluidframework_tpu.ops import mergetree_kernel as jmtk
from fluidframework_tpu_torch.dds.matrix import PermutationVector
from fluidframework_tpu_torch.ops import matrix_kernel as mxk
from fluidframework_tpu_torch.ops import mergetree_kernel as mtk

B, S, C, K, W = 4, 64, 64, 12, 2


def stream(rng: random.Random, n_ops: int, clients: int = 40,
           lag: int = 4, seq0: int = 0) -> list[dict]:
    """One document's sequenced kernel ops: ~55% cells, row/col inserts
    of 1-3 and removes of 1-2, each at a ref up to ``lag`` seqs back
    (concurrent with the ops in between); positions are drawn against a
    tracked length, so some fall outside the op's own frame."""
    ops, rows, cols, nr, nc = [], 0, 0, 0, 0
    for seq in range(seq0 + 1, seq0 + n_ops + 1):
        base = dict(seq=seq, ref_seq=max(seq0, seq - rng.randint(1, lag)),
                    client=rng.randrange(clients))
        r = rng.random()
        if rows and cols and r < 0.55:
            ops.append(dict(base, target=mxk.MX_CELL,
                            row=rng.randrange(rows + 1),
                            col=rng.randrange(cols + 1),
                            value=rng.randrange(1, 50)))
        elif r < 0.7 or not rows:
            n = rng.randint(1, 3)
            ops.append(dict(base, target=mxk.MX_ROWS, kind=mtk.MT_INSERT,
                            pos=rng.randint(0, rows), count=n,
                            handle_base=nr))
            nr, rows = nr + n, rows + n
        elif r < 0.85 or not cols:
            n = rng.randint(1, 3)
            ops.append(dict(base, target=mxk.MX_COLS, kind=mtk.MT_INSERT,
                            pos=rng.randint(0, cols), count=n,
                            handle_base=nc))
            nc, cols = nc + n, cols + n
        else:
            axis = mxk.MX_ROWS if rng.random() < 0.5 else mxk.MX_COLS
            length = rows if axis == mxk.MX_ROWS else cols
            pos = rng.randrange(length)
            end = min(length, pos + rng.randint(1, 2))
            ops.append(dict(base, target=axis, kind=mtk.MT_REMOVE, pos=pos,
                            end=end))
            if axis == mxk.MX_ROWS:
                rows -= end - pos
            else:
                cols -= end - pos
    return ops


def jplanes(state) -> dict:
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        if isinstance(v, tuple):
            out.update({f"{f}.{g}": np.asarray(getattr(v, g))
                        for g in v._fields})
        else:
            out[f] = np.asarray(v)
    return out


def tplanes(state) -> dict:
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        if isinstance(v, tuple):
            out.update({f"{f}.{g}": getattr(v, g).numpy() for g in v._fields})
        else:
            out[f] = v.numpy()
    return out


def assert_planes_equal(a: dict, b: dict, where="") -> None:
    assert a.keys() == b.keys()
    for f in a:
        assert a[f].dtype == b[f].dtype, (where, f)
        assert np.array_equal(a[f], b[f]), (where, f)


def to_torch(jstate) -> mxk.MatrixState:
    """The port's MatrixState holding a JAX MatrixState's planes."""
    p = jplanes(jstate)

    def axis(name):
        return mtk.MergeState(**{g: torch.from_numpy(p[f"{name}.{g}"].copy())
                                 for g in mtk.MergeState._fields})
    return mxk.MatrixState(
        rows=axis("rows"), cols=axis("cols"),
        **{f: torch.from_numpy(p[f].copy())
           for f in mxk.MatrixState._fields if f not in ("rows", "cols")})


def states(b=B, s=S, c=C, w=W):
    return (jmxk.init_state(b, s, c, w),
            mxk.init_state(b, s, c, w, device="cpu"))


def chunks(streams_: list[list[dict]], k: int):
    longest = max(len(x) for x in streams_)
    for start in range(0, longest, k):
        yield [x[start:start + k] for x in streams_]


@pytest.mark.parametrize("seed", range(3))
def test_apply_tick_matches_jax(seed):
    rng = random.Random(seed)
    streams_ = [stream(rng, rng.randint(30, 48)) for _ in range(B)]
    js, ts = states()
    for i, chunk in enumerate(chunks(streams_, K)):
        js = jmxk.apply_tick(js, jmxk.make_matrix_op_batch(chunk, B, K))
        ts = mxk.apply_tick(ts, mxk.make_matrix_op_batch(chunk, B, K,
                                                         device="cpu"))
        assert_planes_equal(jplanes(js), tplanes(ts), (seed, i))
    assert int(ts.cell_count.max()) > 10
    assert int((ts.rows.rem_overlap != 0).sum()) \
        + int((ts.rows.rem_seq != mtk.NONE_SEQ).sum()) > 0
    for d in range(B):
        assert mxk.materialize_grid(ts, d, list(range(64))) \
            == jmxk.materialize_grid(js, d, list(range(64)))


def test_apply_tick_matches_pallas_interpret():
    rng = random.Random(7)
    streams_ = [stream(rng, 30) for _ in range(B)]
    js, ts = states()
    for chunk in chunks(streams_, K):
        js = jmxp.apply_tick_pallas(
            js, jmxk.make_matrix_op_batch(chunk, B, K), interpret=True)
        ts = mxk.apply_tick(ts, mxk.make_matrix_op_batch(chunk, B, K,
                                                         device="cpu"))
    assert_planes_equal(jplanes(js), tplanes(ts))


def test_cell_ops_leave_both_axes_and_clamp_at_capacity():
    """A cell op carries kind 0 (insert), pos 0 and count 0 by default:
    its walk is gated off, so both axes keep their planes exactly. A full
    cell log (count >= C) writes new keys at C - 1 while the count keeps
    growing past C, as in the reference."""
    setup = [[dict(target=mxk.MX_ROWS, kind=mtk.MT_INSERT, pos=0, count=8,
                   handle_base=0, seq=1, ref_seq=0, client=0),
              dict(target=mxk.MX_COLS, kind=mtk.MT_INSERT, pos=0, count=8,
                   handle_base=0, seq=2, ref_seq=1, client=0)]] * 2
    js, ts = states(b=2, s=16, c=8, w=1)
    js = jmxk.apply_tick(js, jmxk.make_matrix_op_batch(setup, 2, 2))
    ts = mxk.apply_tick(ts, mxk.make_matrix_op_batch(setup, 2, 2,
                                                     device="cpu"))
    rows_before = tplanes(ts)
    cells = [[dict(target=mxk.MX_CELL, row=i // 8, col=i % 8, value=i + 1,
                   seq=3 + i, ref_seq=2, client=1) for i in range(11)],
             [dict(target=mxk.MX_CELL, row=1, col=1, value=5, seq=3,
                   ref_seq=2, client=1)]]
    js = jmxk.apply_tick(js, jmxk.make_matrix_op_batch(cells, 2, 11))
    ts = mxk.apply_tick(ts, mxk.make_matrix_op_batch(cells, 2, 11,
                                                     device="cpu"))
    assert_planes_equal(jplanes(js), tplanes(ts))
    after = tplanes(ts)
    for f in after:
        if f.startswith(("rows.", "cols.")):
            assert np.array_equal(after[f], rows_before[f]), f
    assert ts.cell_count.tolist() == [11, 1]
    assert int(ts.cell_val[0, 7]) == 11  # the last three landed at C - 1


@pytest.mark.parametrize("tick", ["op", "steps"])
def test_negative_cell_counts_drop_the_append_as_the_pallas_kernels(tick):
    """At a negative cell count the append index min(count, C - 1) is
    negative. The port's plain ticks drop the write (the count still
    grows), exactly as the JAX Pallas kernels do (``lane_c == idx``
    matches no lane), every plane equal. The JAX XLA ticks index with
    ``.at[idx]``, which wraps to C + idx: the reference disagrees with
    itself there, and the XLA result differs in ``cell_rh``."""
    layout = [dict(target=mxk.MX_ROWS, kind=mtk.MT_INSERT, pos=0, count=8,
                   handle_base=0, seq=1, ref_seq=0, client=0),
              dict(target=mxk.MX_COLS, kind=mtk.MT_INSERT, pos=0, count=8,
                   handle_base=0, seq=2, ref_seq=1, client=0)]
    js, ts = states(b=2, s=16, c=8, w=1)
    js = jmxk.apply_tick(js, jmxk.make_matrix_op_batch([layout] * 2, 2, 2))
    ts = mxk.apply_tick(ts, mxk.make_matrix_op_batch([layout] * 2, 2, 2,
                                                     device="cpu"))
    counts = np.array([-1, -2], np.int32)
    js = js._replace(cell_count=jnp.asarray(counts))
    ts = ts._replace(cell_count=torch.from_numpy(counts.copy()))
    cells = [[dict(target=mxk.MX_CELL, row=3, col=4, value=7, seq=3,
                   ref_seq=2, client=1)],
             [dict(target=mxk.MX_CELL, row=5, col=6, value=9, seq=3,
                   ref_seq=2, client=1)]]
    if tick == "op":
        pallas = jmxp.apply_tick_pallas(
            js, jmxk.make_matrix_op_batch(cells, 2, 1), interpret=True)
        xla = jmxk.apply_tick(js, jmxk.make_matrix_op_batch(cells, 2, 1))
        port = mxk.apply_tick(ts, mxk.make_matrix_op_batch(cells, 2, 1,
                                                           device="cpu"))
    else:
        jb = jmxk.make_matrix_step_batch(cells, 2, r_max=1,
                                         last_vec_seq=[2, 2])
        pallas = jmxp.apply_tick_steps_pallas(js, jb, interpret=True)
        xla = jmxk.apply_tick_steps(js, jb)
        port = mxk.apply_tick_steps(ts, mxk.make_matrix_step_batch(
            cells, 2, r_max=1, last_vec_seq=[2, 2], device="cpu"))
    assert_planes_equal(jplanes(pallas), tplanes(port))
    assert port.cell_count.tolist() == [0, -1]
    assert not port.cell_used.any()
    wrapped = jplanes(xla)
    assert not np.array_equal(wrapped["cell_rh"], tplanes(port)["cell_rh"])
    assert wrapped["cell_rh"][0, 7] >= 0 and wrapped["cell_rh"][1, 6] >= 0


def _step_chunks(streams_, k, r_max, device=None):
    """(jax, torch) step batches per chunk, carrying last_vec_seq across
    chunks as the serving host does."""
    lvs = [0] * len(streams_)
    for chunk in chunks(streams_, k):
        jb = jmxk.make_matrix_step_batch(chunk, len(chunk), r_max=r_max,
                                         last_vec_seq=list(lvs))
        tb = mxk.make_matrix_step_batch(chunk, len(chunk), r_max=r_max,
                                        last_vec_seq=list(lvs),
                                        device="cpu")
        for d, ops in enumerate(chunk):
            for op in ops:
                if op["target"] != mxk.MX_CELL:
                    lvs[d] = max(lvs[d], op["seq"])
        yield jb, tb, chunk


@pytest.mark.parametrize("seed", range(2))
def test_apply_tick_steps_matches_jax_and_the_op_tick(seed):
    """The step tick equals the JAX step tick plane for plane, and both
    equal the per-op tick on the same flat stream."""
    rng = random.Random(10 + seed)
    streams_ = [stream(rng, rng.randint(30, 48), lag=3) for _ in range(B)]
    js, ts = states()
    flat = mxk.init_state(B, S, C, W, device="cpu")
    for i, (jb, tb, chunk) in enumerate(_step_chunks(streams_, 16, 4)):
        assert tuple(tb.r_valid.shape) == tuple(jb.r_valid.shape)
        js = jmxk.apply_tick_steps(js, jb)
        ts = mxk.apply_tick_steps(ts, tb)
        flat = mxk.apply_tick(flat, mxk.make_matrix_op_batch(
            chunk, B, 16, device="cpu"))
        assert_planes_equal(jplanes(js), tplanes(ts), (seed, i))
    assert_planes_equal(tplanes(flat), tplanes(ts))


def test_apply_tick_steps_matches_pallas_interpret():
    rng = random.Random(21)
    streams_ = [stream(rng, 28, lag=3) for _ in range(B)]
    js, ts = states()
    for jb, tb, _chunk in _step_chunks(streams_, 14, 4):
        js = jmxp.apply_tick_steps_pallas(js, jb, interpret=True)
        ts = mxk.apply_tick_steps(ts, tb)
    assert_planes_equal(jplanes(js), tplanes(ts))


def test_group_matrix_steps_isolates_stale_cells():
    ops = [dict(target=mxk.MX_ROWS, kind=0, pos=0, count=2, handle_base=0,
                seq=5, ref_seq=4, client=0),
           dict(target=mxk.MX_CELL, row=0, col=0, value=1, seq=6, ref_seq=5,
                client=1),
           dict(target=mxk.MX_CELL, row=0, col=0, value=1, seq=7, ref_seq=3,
                client=2),
           dict(target=mxk.MX_CELL, row=1, col=0, value=1, seq=8, ref_seq=6,
                client=3),
           dict(target=mxk.MX_CELL, row=1, col=0, value=1, seq=9, ref_seq=7,
                client=3)]
    for lvs in (0, 8):
        for r_max in (1, 4):
            got = mxk.group_matrix_steps(ops[1:] if lvs else ops, r_max, lvs)
            want = jmxk.group_matrix_steps(ops[1:] if lvs else ops, r_max,
                                           lvs)
            assert got == want
    steps = mxk.group_matrix_steps(ops, 4)
    assert [len(s["cells"]) for s in steps] == [1, 1, 2]
    assert steps[1]["vec"] is None and steps[1]["cells"][0]["seq"] == 7


def _run_case(rng, b, r, grid, idle):
    cells, refs = [], []
    for d in range(b):
        n = 0 if d in idle else rng.randint(1, r)
        cells.append([dict(row=rng.randrange(grid + 1),
                           col=rng.randrange(grid), value=rng.randrange(1, 9),
                           seq=100 + i) for i in range(n)])
        refs.append(99)
    return cells, refs


@pytest.mark.parametrize("case", ["tile", "idle", "clamp"])
def test_apply_cell_run_and_compaction_match_jax(case):
    """The all-cells append at the shared offset (with idle docs, a short
    tile, and a start clamped so the tile still fits), then the log
    compaction (duplicate keys, unused slots)."""
    rng = random.Random({"tile": 1, "idle": 2, "clamp": 3}[case])
    b, grid, cap = 5, 5, 32
    setup = [[dict(target=mxk.MX_ROWS, kind=0, pos=0, count=grid,
                   handle_base=0, seq=1, ref_seq=0, client=0),
              dict(target=mxk.MX_COLS, kind=0, pos=0, count=grid,
                   handle_base=0, seq=2, ref_seq=1, client=0),
              dict(target=mxk.MX_ROWS, kind=1, pos=2, end=3, seq=3,
                   ref_seq=2, client=0)]] * b
    js, ts = states(b=b, s=16, c=cap, w=1)
    js = jmxk.apply_tick(js, jmxk.make_matrix_op_batch(setup, b, 3))
    ts = mxk.apply_tick(ts, mxk.make_matrix_op_batch(setup, b, 3,
                                                     device="cpu"))
    r = {"tile": 6, "idle": 8, "clamp": 12}[case]
    idle = {1, 3} if case == "idle" else set()
    for _tick in range(3):
        cells, refs = _run_case(rng, b, r, grid - 1, idle)
        clients = [d % 3 for d in range(b)]
        js = jmxk.apply_cell_run(js, jmxk.make_cell_run_batch(
            cells, b, r, refs, clients))
        ts = mxk.apply_cell_run(ts, mxk.make_cell_run_batch(
            cells, b, r, refs, clients, device="cpu"))
        assert_planes_equal(jplanes(js), tplanes(ts), case)
    if case == "clamp":
        assert int(ts.cell_count.max()) > cap - r  # the start was clamped
    jm, tm = jmxk.capacity_margin(js), mxk.capacity_margin(ts)
    for key in jm:
        assert np.array_equal(np.asarray(jm[key]), tm[key]), key
    js, ts = jmxk.compact_cell_log(js), mxk.compact_cell_log(ts)
    assert_planes_equal(jplanes(js), tplanes(ts), (case, "compacted"))
    assert int(ts.cell_count.max()) <= (grid - 1) * grid
    val_rev = list(range(16))
    for d in range(b):
        assert mxk.materialize_grid(ts, d, val_rev) \
            == jmxk.materialize_grid(js, d, val_rev)


def test_compact_cell_log_keeps_the_last_duplicate_in_log_order():
    """A hand-made log with duplicate keys out of key order, unused slots
    between them and negative handles."""
    rh = np.array([[3, 1, 3, -1, 1, 0, 3, 2], [5, 5, 5, 5, 0, 0, 0, 0]],
                  np.int32)
    ch = np.array([[1, 2, 1, -1, 2, 7, 0, 2], [1, 1, 2, 1, 0, 0, 0, 0]],
                  np.int32)
    used = np.array([[1, 1, 1, 0, 1, 1, 1, 1], [1, 1, 1, 1, 0, 1, 0, 0]],
                    bool)
    val = np.arange(16, dtype=np.int32).reshape(2, 8) + 1
    seq = val * 10
    js, ts = states(b=2, s=8, c=8, w=1)
    js = js._replace(cell_rh=jnp.asarray(rh), cell_ch=jnp.asarray(ch),
                     cell_val=jnp.asarray(val), cell_seq=jnp.asarray(seq),
                     cell_used=jnp.asarray(used),
                     cell_count=jnp.asarray([8, 6], jnp.int32))
    ts = to_torch(js)
    out = mxk.compact_cell_log(ts)
    assert_planes_equal(jplanes(jmxk.compact_cell_log(js)), tplanes(out))
    assert out.cell_count.tolist() == [5, 3]
    assert out.cell_val[0, :5].tolist() == [6, 5, 8, 7, 3]


def test_capacity_margin_matches_jax():
    rng = random.Random(4)
    streams_ = [stream(rng, 20) for _ in range(B)]
    js, ts = states(s=32, c=16)
    chunk = [x[:K] for x in streams_]
    js = jmxk.apply_tick(js, jmxk.make_matrix_op_batch(chunk, B, K))
    ts = mxk.apply_tick(ts, mxk.make_matrix_op_batch(chunk, B, K,
                                                     device="cpu"))
    jm, tm = jmxk.capacity_margin(js), mxk.capacity_margin(ts)
    assert jm.keys() == tm.keys()
    for key in jm:
        assert np.array_equal(np.asarray(jm[key]), tm[key]), key


def test_encoders_match_jax():
    """The wire decoder, the op / step / run batch encoders and the
    sequenced-log encoder give the JAX package's arrays."""
    from fluidframework_tpu.protocol import messages as jmsg
    from fluidframework_tpu_torch.protocol import messages as tmsg

    wire = [({"target": "rows", "type": "insert", "pos": 0, "count": 3},
             "a"),
            ({"target": "cols", "type": "insertGroup",
              "ranges": [[0, 2], [3, 1]]}, "b"),
            ({"target": "cell", "type": "set", "row": 1, "col": 2,
              "value": "x"}, "a"),
            ({"target": "rows", "type": "removeGroup",
              "ranges": [[0, 1], [1, 2]]}, "c"),
            ({"target": "cols", "type": "remove", "start": 0, "end": 1},
             "b"),
            ({"target": "cell", "type": "set", "row": 0, "col": 0,
              "value": None}, "c")]

    def log(mod):
        return [mod.SequencedDocumentMessage(
            client_id=client, sequence_number=i + 1,
            minimum_sequence_number=0, client_sequence_number=i + 1,
            reference_sequence_number=i, type=mod.MessageType.OPERATION,
            contents={"address": "ds", "contents": {"address": "grid",
                                                    "contents": op}})
            for i, (op, client) in enumerate(wire)]

    out = []
    for mx, mod in ((jmxk, jmsg), (mxk, tmsg)):
        slots, vals = {}, {}
        out.append((mx.encode_matrix_log(log(mod), 0, mx.HandleAllocator(1),
                                         mx.HandleAllocator(1), slots, vals),
                    slots, vals))
    assert out[0] == out[1]
    ops = out[1][0]
    assert len(ops) == 8
    for jb, tb in ((jmxk.make_matrix_op_batch([ops, ops[:3]], 2, 8),
                    mxk.make_matrix_op_batch([ops, ops[:3]], 2, 8,
                                             device="cpu")),
                   (jmxk.make_matrix_step_batch([ops, ops[2:]], 2, 2),
                    mxk.make_matrix_step_batch([ops, ops[2:]], 2, 2,
                                               device="cpu"))):
        assert_planes_equal(jplanes(jb), tplanes(tb))
    cells = [[dict(row=1, col=2, value=3, seq=4)], []]
    assert_planes_equal(
        jplanes(jmxk.make_cell_run_batch(cells, 2, 2, [3, 0], [1, 0])),
        tplanes(mxk.make_cell_run_batch(cells, 2, 2, [3, 0], [1, 0],
                                        device="cpu")))
    with pytest.raises(ValueError, match="tick overflow"):
        mxk.make_matrix_op_batch([ops], 1, 2, device="cpu")


def test_permutation_vector_matches_jax():
    """The port's PermutationVector against the JAX one on a concurrent
    stream of inserts, removes and their group forms: every handle_at in
    every op's frame, and snapshot/load."""
    rng = random.Random(3)
    jv, tv = JaxVector(None), PermutationVector(None)
    seq = 0
    for _ in range(60):
        ref = max(0, seq - rng.randint(0, 3))
        seq += 1
        client = f"c{rng.randrange(5)}"
        # Positions are drawn in the op's own (ref, client) frame.
        length = sum(tv.engine._vis_len(seg, ref, client)
                     for seg in tv.engine.segments)
        r = rng.random()
        if length > 3 and r < 0.3:
            s = rng.randrange(length - 1)
            op = {"type": "remove", "start": s,
                  "end": min(length, s + rng.randint(1, 3))}
        elif length > 4 and r < 0.4:
            op = {"type": "removeGroup", "ranges": [[0, 1], [1, 2]]}
        elif r < 0.5:
            op = {"type": "insertGroup",
                  "ranges": [[rng.randint(0, length), 2], [0, 1]]}
        else:
            op = {"type": "insert", "pos": rng.randint(0, length),
                  "count": rng.randint(1, 4)}
        jv.apply_remote(op, seq, ref, client)
        tv.apply_remote(op, seq, ref, client)
        length = tv.engine.local_length()
        for pos in range(length + 2):
            for who in (client, "c9"):
                assert tv.handle_at(pos, ref, who) \
                    == jv.handle_at(pos, ref, who)
    assert tv.next_handle == jv.next_handle
    snap = tv.snapshot()
    assert snap == jv.snapshot()
    back = PermutationVector.load(snap)
    assert back.snapshot() == snap
    assert [back.handle_at(p) for p in range(length)] \
        == [jv.handle_at(p) for p in range(length)]
    assert back.live_handles() == jv.live_handles()
