"""Differential: the port's ``ShardedServing`` and ``ShardResidency``
against the JAX package's, exactly.

The port runs on a mesh of n CPU shards (``make_mesh(["cpu"] * n)``); the
reference on the suite's 8 virtual CPU devices, whatever n: its results do
not depend on its mesh size (rows lie in docs order on any mesh, and the
block-table ladder decides once for the whole batch), so one compiled
reference program serves every port mesh size. The same
submissions go to both, and every tick's acks, every host's harvest, every
plane of every family state (read back row by row), the durable records,
``global_metrics``, the text pools and materialized texts must be equal:
mixed populations (map, text, matrix and tree rows) at 2, 4 and 8 shards,
map-only serving, dedup resends, kill/resume/rebalance, durable trimming
and retention, a pipelined harvest against a synchronous one,
``compact_text`` and ``retune_text_geometry``, and the residency cases
(oversubscribed churn, pending-evict refusal, victim skipping, live
migration), and ``MegaDocLanes`` (one doc over lane rows spread across
the shards, against the reference and a single-row twin).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from fluidframework_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fluidframework_tpu.parallel.serving import \
    ShardedServing as JaxServing
from fluidframework_tpu.parallel.serving import \
    ShardResidency as JaxResidency
from fluidframework_tpu_torch.parallel.mesh import make_mesh, tree_leaves
from fluidframework_tpu_torch.parallel.serving import (
    MegaDocLanes,
    ShardedServing,
    ShardResidency,
)
from tests.test_torch_multihost import (
    TIGHT_TEXT,
    Script,
    submit_script,
    tighten_text,
)

MIXED = dict(num_clients=2, map_slots=16, text_slots=64, text_k=4,
             matrix_vec_slots=32, matrix_cell_slots=48, matrix_k=4,
             tree_slots=16, tree_k=4)
#: The mixed population every mixed test serves: one shape, so the
#: reference compiles its tick once per mesh size for the whole file.
FAMS = [("map", "text", "matrix", "tree")[r % 4] for r in range(16)]
SCRIPT_SHAPE = dict(map_k=6, text_k=4, matrix_k=4, tree_k=4,
                    map_slots=16, tree_slots=16)


#: The reference's mesh size (see the module docstring).
JAX_SHARDS = 8


def pair(n_shards: int, **kw):
    """(JAX serving on the suite's 8 virtual devices, port serving on n
    CPU shards)."""
    js = JaxServing(jax_make_mesh(jax.devices()[:JAX_SHARDS]), **kw)
    ts = ShardedServing(make_mesh(["cpu"] * n_shards), **kw)
    return js, ts


def tighten_jax(js) -> None:
    """The reference assembly's (empty) text table at the small block
    geometry the maintenance ladder fires in (``tighten_text``'s twin):
    every mixed test here serves at it, so the reference compiles its
    tick once per mesh size."""
    from fluidframework_tpu.ops import mergetree_blocks as jmtb
    from fluidframework_tpu.ops import mergetree_kernel as jmtk
    from fluidframework_tpu.parallel.mesh import shard_state
    js.text_geometry = TIGHT_TEXT
    js.merge_state = shard_state(jmtb.init_state(
        js.num_docs, *TIGHT_TEXT, js.text_props,
        jmtk.overlap_words_for(js.num_clients)), js.mesh)


def tighten_pair(js, ts) -> None:
    tighten_jax(js)
    tighten_text(ts)


def _np_tree(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def assert_states_equal(js, ts) -> None:
    jf, tf = js._family_states(), ts._family_states()
    assert sorted(jf) == sorted(tf)
    for name in jf:
        a = _np_tree(jf[name])
        b = tree_leaves(ts.family_rows(name))
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            assert x.dtype == y.dtype and np.array_equal(x, y), (name, i)


def _norm(rec: dict) -> dict:
    out = {}
    for key, value in rec.items():
        if isinstance(value, dict):
            out[key] = {f: np.asarray(v).tolist() for f, v in value.items()}
        elif isinstance(value, np.ndarray):
            out[key] = (str(value.dtype), value.tolist())
        else:
            out[key] = value
    return out


def assert_durable_equal(js, ts) -> None:
    assert js._durable_base == ts._durable_base
    assert sorted(js.durable) == sorted(ts.durable)
    for row in js.durable:
        assert [_norm(r) for r in js.durable[row]] \
            == [_norm(r) for r in ts.durable[row]], row


def assert_serving_equal(js, ts) -> None:
    assert_states_equal(js, ts)
    assert_durable_equal(js, ts)
    assert ts.text_pool == js.text_pool
    assert ts._text_high == js._text_high
    assert ts._mx_high == js._mx_high and ts._mx_handles == js._mx_handles
    assert ts.rebalance_stats == js.rebalance_stats
    assert ts.global_metrics() == js.global_metrics()
    assert ts.hosts == [tuple(p) for p in js.hosts]


def _merged(harvest) -> dict:
    out = {}
    for rows in harvest.values():
        out.update(rows)
    return out


def drive_pair(js, ts, fams, seed, ticks, modes=None):
    script = Script(fams, seed, SCRIPT_SHAPE)
    for t in range(ticks):
        mode = (modes or {}).get(t, "fresh")
        _s, _w, _p, subs = script.tick(t, mode)
        submit_script(js, subs)
        submit_script(ts, subs)
        jh, th = js.tick(now=2 + t), ts.tick(now=2 + t)
        assert th == jh, t
        if mode == "fresh" and th:
            last = np.zeros(len(fams), np.int64)
            for row, (_n, _f, lst) in _merged(th).items():
                last[row] = lst
            script.ack(last)
    return script


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_mixed_population_matches_jax(n_shards):
    fams = FAMS
    js, ts = pair(n_shards, num_docs=16, k=6, num_hosts=2, **MIXED)
    tighten_pair(js, ts)
    js.join_all(slots=(0, 1))
    ts.join_all(slots=(0, 1))
    drive_pair(js, ts, fams, seed=20 + n_shards, ticks=5,
               modes={2: "resend", 3: "gap"})
    assert_serving_equal(js, ts)
    # The block-table ladder decided once for the whole batch.
    assert ts.rebalance_stats["fired"] > 0
    for row in range(1, 16, 4):
        assert ts.text_of(row) == js.text_of(row)
    # Each host harvested exactly its own rows.
    fams_ts = Script(fams, 0, SCRIPT_SHAPE)
    submit_script(ts, fams_ts.tick(0)[3])
    harvest = ts.tick()
    for port in ts.hosts:
        assert set(harvest[port.host_id]) == set(range(port.start,
                                                       port.stop))


def test_pipelined_harvest_equals_sync_and_jax():
    fams = FAMS
    js, ts = pair(4, num_docs=16, k=6, num_hosts=2, pipeline_depth=2,
                  **MIXED)
    sync = ShardedServing(make_mesh(["cpu"] * 2), num_docs=16, k=6,
                          num_hosts=2, **MIXED)
    tighten_pair(js, ts)
    tighten_text(sync)
    for s in (js, ts, sync):
        s.join_all(slots=(0, 1))
    script = Script(fams, 31, SCRIPT_SHAPE)
    jacks, tacks, sacks = [], [], []
    for t in range(5):
        subs = script.tick(t)[3]
        for s in (js, ts, sync):
            submit_script(s, subs)
        jacks.append(js.tick())
        tacks.append(ts.tick())
        sacks.append(sync.tick())
    jacks += js.flush()
    tacks += ts.flush()
    assert tacks == jacks
    assert [h for h in tacks if any(h.values())] == sacks
    assert_serving_equal(js, ts)
    assert_states_equal(js, sync)


def test_map_only_serving_dedup_and_metrics_match_jax():
    js, ts = pair(2, num_docs=16, k=8, num_hosts=4)
    js.join_all()
    ts.join_all()
    rng = np.random.default_rng(0)
    for t in range(3):
        for row in range(16):
            words = (rng.integers(0, 1 << 20, 8).astype(np.uint32) << 12
                     | np.uint32(row % 8) << 2)
            js.submit(row, words, first_cseq=1 + 8 * (t % 2))
            ts.submit(row, words, first_cseq=1 + 8 * (t % 2))
        assert ts.tick(now=2 + t) == js.tick(now=2 + t)
    assert_serving_equal(js, ts)
    assert np.array_equal(ts.map_rows(), np.asarray(js.map_rows()))
    with pytest.raises(KeyError):
        ts.route(99)
    ts.submit(3, np.zeros(2, np.uint32), first_cseq=1)
    with pytest.raises(ValueError, match="already pending"):
        ts.submit(3, np.zeros(2, np.uint32), first_cseq=3)


def _words_for(row, t, k=8):
    slots = (np.arange(k) + t) % 8
    vals = 1000 * (t + 1) + row * 10 + np.arange(k)
    return ((slots.astype(np.uint32) << 2)
            | (vals.astype(np.uint32) << 12)).astype(np.uint32)


def test_host_kill_resume_rebalance_matches_jax():
    num_docs, k = 16, 8
    js, ts = pair(2, num_docs=num_docs, k=k, num_hosts=2)
    for s in (js, ts):
        s.join_all()
        for t in range(2):
            for row in range(num_docs):
                s.submit(row, _words_for(row, t), first_cseq=1 + t * k)
            s.tick()
    cps = [s.checkpoint_host(1) for s in (js, ts)]
    assert sorted(cps[0]["states"]) == sorted(cps[1]["states"])
    for name in cps[0]["states"]:
        for a, b in zip(_np_tree(cps[0]["states"][name]),
                        tree_leaves(cps[1]["states"][name])):
            assert np.array_equal(a, b), name
    assert cps[1]["log_offsets"] == cps[0]["log_offsets"]
    for s in (js, ts):
        for row in range(num_docs):
            s.submit(row, _words_for(row, 2), first_cseq=1 + 2 * k)
        s.tick()
    revived = []
    for s, cp, mk in ((js, cps[0], lambda: pair(2, num_docs=num_docs,
                                                 k=k, num_hosts=2)[0]),
                      (ts, cps[1], lambda: ShardedServing(
                          make_mesh(["cpu"] * 2), num_docs=num_docs, k=k,
                          num_hosts=2))):
        r = mk()
        r.join_all()
        r.rebalance_from(1, 0)
        for t in range(3):
            for row in range(0, 8):
                r.submit(row, _words_for(row, t), first_cseq=1 + t * k)
            r.tick()
        r.restore_host(cp, s.durable, s._durable_base)
        assert np.array_equal(np.asarray(r.map_rows()),
                              np.asarray(s.map_rows()))
        revived.append(r)
    assert_serving_equal(*revived)
    for r in revived:
        for row in range(num_docs):
            r.submit(row, _words_for(row, 3), first_cseq=1 + 3 * k)
    assert revived[1].tick() == revived[0].tick()


def test_mixed_kill_resume_matches_jax():
    """Failover over a mixed population: checkpoint host 1, serve on,
    restore into a fresh assembly from the checkpoint + durable tail."""
    fams = FAMS
    js, ts = pair(2, num_docs=16, k=6, num_hosts=2, **MIXED)
    tighten_pair(js, ts)
    for s in (js, ts):
        s.join_all(slots=(0, 1))
    script = Script(fams, 41, SCRIPT_SHAPE)
    cps = None
    for t in range(4):
        subs = script.tick(t)[3]
        for s in (js, ts):
            submit_script(s, subs)
        assert ts.tick() == js.tick()
        if t == 1:
            cps = [s.checkpoint_host(1) for s in (js, ts)]
    revived = []
    for s, cp, make in ((js, cps[0], JaxServing), (ts, cps[1], None)):
        mesh = (jax_make_mesh(jax.devices()[:JAX_SHARDS]) if make
                else make_mesh(["cpu"] * 2))
        r = (make or ShardedServing)(mesh, num_docs=16, k=6, num_hosts=2,
                                     **MIXED)
        (tighten_jax if make else tighten_text)(r)
        r.join_all(slots=(0, 1))
        r.restore_host(cp, s.durable, s._durable_base)
        revived.append(r)
    assert_states_equal(*revived)
    for row in range(8, 16):
        assert revived[1].family_rows("seq").seq[row] \
            == ts.family_rows("seq").seq[row]
    for row in (9, 13):
        assert revived[1].text_of(row) == ts.text_of(row) \
            == revived[0].text_of(row)


def test_durable_trim_and_retention_match_jax():
    words = np.array([(1 << 12) | (0 << 2), (2 << 12) | (1 << 2),
                      (3 << 12) | (2 << 2), (4 << 12) | (3 << 2)],
                     np.uint32)
    js, ts = pair(2, num_docs=16, k=8, num_hosts=1)
    for s in (js, ts):
        s.join_all()
        for t in range(3):
            for r in range(16):
                s.submit(r, words, first_cseq=1 + t * 4)
            s.tick()
    cps = [s.checkpoint_host(0) for s in (js, ts)]
    for s, cp in zip((js, ts), cps):
        for r in range(16):
            s.submit(r, words, first_cseq=13)
        s.tick()
        s.trim_durable(cp["log_offsets"])
    assert_durable_equal(js, ts)
    assert ts.durable_offset(0) == js.durable_offset(0) == 4
    third = ShardedServing(make_mesh(["cpu"] * 2), num_docs=16, k=8,
                           num_hosts=1)
    third.join_all()
    with pytest.raises(ValueError):
        third.restore_host(dict(cps[1], log_offsets={r: 0
                                                     for r in range(16)}),
                           ts.durable, ts._durable_base)

    js, ts = pair(2, num_docs=16, k=8, num_hosts=1,
                  durable_retention_ticks=5)
    for s in (js, ts):
        s.join_all()
        for t in range(12):
            s.submit(0, np.array([(7 << 12)], np.uint32), first_cseq=1 + t)
            s.tick()
    assert_durable_equal(js, ts)
    assert ts._durable_base[0] == 7


def test_compact_and_retune_text_geometry_match_jax():
    js, ts = pair(2, num_docs=16, k=6, num_hosts=2, **MIXED)
    tighten_pair(js, ts)
    for s in (js, ts):
        s.join_all(slots=(0, 1))
    script = Script(FAMS, 51, SCRIPT_SHAPE)
    for t in range(6):
        subs = script.tick(t)[3]
        for s in (js, ts):
            submit_script(s, subs)
        h = ts.tick()
        assert h == js.tick()
        last = np.zeros(16, np.int64)
        for row, (_n, _f, lst) in _merged(h).items():
            last[row] = lst
        script.ack(last)
        if t == 2:
            js.compact_text()
            ts.compact_text()
    assert_serving_equal(js, ts)
    assert ts.retune_text_geometry(0.9) == js.retune_text_geometry(0.9)
    assert_serving_equal(js, ts)
    for row in range(1, 16, 4):
        assert ts.text_of(row) == js.text_of(row)


def _residency_pair(num_rows, hosts, **kw):
    js = JaxServing(jax_make_mesh(jax.devices()[:1]), num_docs=num_rows,
                    k=4, num_hosts=hosts, map_slots=8, **kw)
    ts = ShardedServing(make_mesh(["cpu"]), num_docs=num_rows, k=4,
                        num_hosts=hosts, map_slots=8, **kw)
    return js, ts


def test_shard_residency_churn_matches_jax():
    num_rows = 4
    js, ts = _residency_pair(num_rows, 2, num_clients=2)
    jr, tr = JaxResidency(js, join_slots=(0,)), ShardResidency(ts, (0,))
    docs = [f"doc-{i}" for i in range(5 * num_rows)]
    for rnd in range(2):
        for i, doc in enumerate(docs):
            rows = [r.resolve(doc) for r in (jr, tr)]
            assert rows[0] == rows[1]
            value = (rnd * 37 + i) % 97 + 1
            words = np.array([np.uint32(value) << 12
                              | np.uint32(1) << 2], np.uint32)
            for s in (js, ts):
                s.submit(rows[0], words, first_cseq=rnd + 1)
            assert ts.tick() == js.tick()
    assert tr.stats == jr.stats and tr.stats["cold_hydrations"] > 0
    assert sorted(tr.cold) == sorted(jr.cold)
    assert_states_equal(js, ts)
    for doc in docs:
        assert tr.resolve(doc) == jr.resolve(doc)
        row = tr.row_of[doc]
        assert int(ts.map_rows()[row, 1]) \
            == int(np.asarray(js.map_state.value)[row, 1])
    assert tr.evict_idle(keep_per_host=1) == jr.evict_idle(1)
    assert tr._free == jr._free
    assert_states_equal(js, ts)


def test_shard_residency_pending_rules_match_jax():
    js, ts = _residency_pair(2, 1)
    jr, tr = JaxResidency(js), ShardResidency(ts)
    for r, s in ((jr, js), (tr, ts)):
        row_a = r.resolve("doc-a")
        r.resolve("doc-b")
        s.submit(row_a, np.array([(5 << 12) | (1 << 2)], np.uint32),
                 first_cseq=1)
        with pytest.raises(ValueError):
            r.evict("doc-a")
        row_c = r.resolve("doc-c")  # evicts doc-b, not the pending doc-a
        assert r.is_resident("doc-a") and not r.is_resident("doc-b")
        assert row_c != row_a
        s.tick()
        r.evict("doc-a")
    assert tr.stats == jr.stats
    assert_states_equal(js, ts)


def test_shard_residency_migration_matches_jax():
    js, ts = _residency_pair(8, 4)
    jr = JaxResidency(js, active_hosts=(0, 1))
    tr = ShardResidency(ts, active_hosts=(0, 1))
    docs = [f"doc-{i}" for i in range(8)]
    for i, doc in enumerate(docs):
        row = tr.resolve(doc)
        assert jr.resolve(doc) == row
        for s in (js, ts):
            s.submit(row, np.array([((10 + i) << 12) | (1 << 2)],
                                   np.uint32), first_cseq=1)
        assert ts.tick() == js.tick()
    for r in (jr, tr):
        r.activate_host(2)
        r.activate_host(3)
    for doc, dst in zip(docs, (2, 3, 2, 3)):
        row = tr.migrate(doc, dst)
        assert row == jr.migrate(doc, dst)
        assert row is None or ts.hosts[dst].owns(row)
    assert tr.placement == jr.placement
    assert {k: v for k, v in tr.stats.items()} == jr.stats
    assert_states_equal(js, ts)
    # A pending submission refuses migration; after the tick it moves and
    # the doc's cseq dedup survives (a verbatim resend sequences nothing).
    doc = next(d for d in docs if tr.is_resident(d)
               and tr.host_for(d) != 3)
    row = tr.row_of[doc]
    for r, s in ((jr, js), (tr, ts)):
        s.submit(row, np.array([(5 << 12) | (1 << 2)], np.uint32),
                 first_cseq=2)
        with pytest.raises(ValueError):
            r.migrate(doc, 3)
        s.tick()
        new_row = r.migrate(doc, 3)
        s.submit(new_row, np.array([(5 << 12) | (1 << 2)], np.uint32),
                 first_cseq=2)
        assert _merged(s.tick())[new_row] == (0, 0, 0)
    assert_states_equal(js, ts)


def _megadoc_lanes_run(serving_cls, lanes_cls, mesh, lane_rows):
    """``tests/test_sharded_serving.py``'s lane scenario on one package:
    4 rounds of fresh / dup / gap batches from 6 writers through the
    lanes, and the same batches one after another on a single-row twin.
    Returns (lane acks, twin acks, lane entries, twin entries, the lane
    rows' device seqs)."""
    k, writers = 6, 6
    serving = serving_cls(mesh, num_docs=8, k=k, num_hosts=1,
                          num_clients=4, map_slots=16)
    serving.join_all(slots=list(range(4)))
    lanes = lanes_cls(serving, lane_rows=lane_rows)
    twin = serving_cls(mesh, num_docs=8, k=k, num_hosts=1,
                       num_clients=writers + 1, map_slots=16)
    twin.join_all(slots=list(range(writers)))
    for w in range(writers):
        lanes.join(f"writer-{w}")
    rng = np.random.default_rng(42)
    cseqs = {w: 1 for w in range(writers)}
    prev = {}
    mega_acks, twin_acks = [], []
    for r in range(4):
        for w in range(writers):
            action = rng.choice(["fresh", "fresh", "dup", "gap"])
            words = (rng.integers(0, 1 << 20, k).astype(np.uint32) << 12
                     | (rng.integers(0, 16, k).astype(np.uint32) << 2))
            if action == "dup" and w in prev:
                cseq0, words = prev[w]
            elif action == "gap":
                cseq0 = cseqs[w] + 3
            else:
                cseq0 = cseqs[w]
                cseqs[w] += k
                prev[w] = (cseq0, words)
            dec = lanes.submit(f"writer-{w}", words, cseq0, ref_seq=1)
            mega_acks.append((r, w, dec.n_seq, dec.first, dec.last,
                              dec.msn))
            twin.submit(0, words, cseq0, ref_seq=1, client_slot=w)
            n_ok, first, last = twin.tick()[0][0]
            twin_acks.append((r, w, n_ok,
                              first if n_ok else 2**31 - 1, last))
        serving.flush()
    twin.flush()
    entries = lanes.entries()
    planes = twin.family_rows("map") if serving_cls is ShardedServing \
        else twin.map_state
    present, value = np.asarray(planes.present), np.asarray(planes.value)
    twin_vals = {s: int(v) for s, v in enumerate(value[0])
                 if present[0][s]}
    seqs = (serving.family_rows("seq").seq
            if serving_cls is ShardedServing
            else np.asarray(serving.seq_state.seq))
    return (mega_acks, twin_acks, entries, twin_vals,
            [int(seqs[row]) for row in lane_rows])


def test_megadoc_lanes_match_single_row_twin_and_jax():
    from fluidframework_tpu.parallel.serving import \
        MegaDocLanes as JaxLanes
    lane_rows = [0, 3, 4, 7]  # spread over the port's 4 shards
    want = _megadoc_lanes_run(JaxServing, JaxLanes,
                              jax_make_mesh(jax.devices()[:JAX_SHARDS]),
                              lane_rows)
    got = _megadoc_lanes_run(ShardedServing, MegaDocLanes,
                             make_mesh(["cpu"] * 4), lane_rows)
    assert got == want
    mega_acks, twin_acks, entries, twin_vals, seqs = got
    assert [a[:5] for a in mega_acks] == twin_acks
    assert entries == twin_vals and entries
    assert sum(1 for s in seqs if s > 4) > 1  # past the 4 joins: spread


def test_cuda_entry_point_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from fluidframework_tpu_torch.parallel.mesh import make_mesh as mm
    with pytest.raises(RuntimeError, match="cuda"):
        mm()
