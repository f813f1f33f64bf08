"""Differential: the port's all-family ``_mixed_tick`` against the JAX
package's, exactly (every output plane equal, no tolerance).

The same numpy-seeded tick inputs — the [B, 6] scalar pack, the map words
and the text, matrix and tree packs — go through both ticks over several
ticks, for each family alone and for all four together, with a dedup
resend and a stale-gap batch among them. Every one of the 12 outputs is
compared: the five states plane by plane, n_seq/first/last/msn, the tree
overflow counts, the text first-overflow indices and the kstats vector
(whose rebalance cells move: the block geometry is small enough for the
maintenance ladder to fire). The port runs the kernels' plain versions on
the CPU; the JAX mixed tick runs its XLA legs (its map leg in interpret
mode on the CPU).

The tree leg also runs with ``tree_steps`` from ``subtree_steps`` of the
host's pack (the serving path's call), which must change nothing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fluidframework_tpu.ops import map_kernel as jmk
from fluidframework_tpu.ops import matrix_kernel as jmxk
from fluidframework_tpu.ops import mergetree_blocks as jmtb
from fluidframework_tpu.ops import mergetree_kernel as jmtk
from fluidframework_tpu.ops import sequencer as jseqk
from fluidframework_tpu.ops import tree_kernel as jtk
from fluidframework_tpu.server import storm as jstorm
from fluidframework_tpu_torch.ops import map_kernel as mk
from fluidframework_tpu_torch.ops import matrix_kernel as mxk
from fluidframework_tpu_torch.ops import mergetree_blocks as mtb
from fluidframework_tpu_torch.ops import sequencer as seqk
from fluidframework_tpu_torch.ops import tree_kernel as tk
from fluidframework_tpu_torch.parallel.mesh import tree_leaves
from fluidframework_tpu_torch.protocol.messages import MessageType
from fluidframework_tpu_torch.server import storm
from tests.test_torch_multihost import CLIENTS, FAMILIES, SHAPE, Script


def _jax_mixed():
    return jax.jit(jstorm._mixed_tick.__wrapped__)


# -- states on both sides -------------------------------------------------------


def _joined_seq(mod, n):
    state = mod.init_state(n, CLIENTS + 1, **({"device": "cpu"}
                                              if mod is seqk else {}))
    ops = mod.make_op_batch(
        [[dict(kind=int(MessageType.CLIENT_JOIN), slot=-1, target=c,
               timestamp=1) for c in range(CLIENTS)] for _ in range(n)],
        n, CLIENTS, **({"device": "cpu"} if mod is seqk else {}))
    return mod.process_batch(state, ops)[0]


def states(n, fams, shape=None):
    """(jax states, port states) for ``n`` rows with the families present
    in ``fams`` configured (the others None)."""
    sh = dict(SHAPE, **(shape or {}))
    present = set(fams)
    w = jmtk.overlap_words_for(CLIENTS)
    j = [_joined_seq(jseqk, n), jmk.init_state(n, sh["map_slots"]),
         jmtb.init_state(n, sh["text_blocks"], sh["text_bk"], 4, w)
         if "text" in present else None,
         jmxk.init_state(n, sh["vec_slots"], sh["cell_slots"], w)
         if "matrix" in present else None,
         jtk.init_state(n, sh["tree_slots"]) if "tree" in present else None]
    t = [_joined_seq(seqk, n), mk.init_state(n, sh["map_slots"], "cpu"),
         mtb.init_state(n, sh["text_blocks"], sh["text_bk"], 4, w, "cpu")
         if "text" in present else None,
         mxk.init_state(n, sh["vec_slots"], sh["cell_slots"], w, "cpu")
         if "matrix" in present else None,
         tk.init_state(n, sh["tree_slots"], "cpu")
         if "tree" in present else None]
    return j, t


def assert_same(jax_tree, torch_tree, ctx) -> None:
    ja = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_tree)]
    tb = [x.numpy() for x in tree_leaves(torch_tree) if x is not None]
    assert len(ja) == len(tb), ctx
    for i, (a, b) in enumerate(zip(ja, tb)):
        assert a.shape == b.shape and a.dtype == b.dtype, (ctx, i, a.dtype,
                                                           b.dtype)
        assert np.array_equal(a, b), (ctx, i)


def run_both(fams, seed, ticks, modes=None, steps_from_pack=False,
             shape=None):
    n = len(fams)
    script = Script(fams, seed, shape)
    (js, jm, jt, jx, jr), (ts, tm, tt, tx, tr) = states(n, fams, shape)
    mixed = _jax_mixed()
    present = set(fams)
    fired = 0
    for t in range(ticks):
        mode = (modes or {}).get(t, "fresh")
        scalars, words, packs, _subs = script.tick(t, mode)
        jpk = {f: (jnp.asarray(packs[f]) if f in present else None)
               for f in packs}
        jout = mixed(js, jm, jt, jx, jr, jnp.asarray(scalars),
                     jnp.asarray(words), jpk["text"], jpk["matrix"],
                     jpk["tree"])
        tpk = {f: (torch.from_numpy(packs[f]) if f in present else None)
               for f in packs}
        steps = None
        if steps_from_pack and "tree" in present:
            p = packs["tree"]
            steps = [bool(((p[:, 0, i] != 0)
                           & np.isin(p[:, 1, i], list(tk.SUBTREE_KINDS)))
                          .any()) for i in range(p.shape[2])]
        tout = storm._mixed_tick(
            ts, tm, tt, tx, tr, torch.from_numpy(scalars),
            torch.from_numpy(words.view(np.int32)), tpk["text"],
            tpk["matrix"], tpk["tree"], tree_steps=steps)
        assert len(tout) == len(jout) == 12
        for i, (a, b) in enumerate(zip(jout, tout)):
            if a is None or b is None:
                assert a is None and b is None, (t, i)
                continue
            assert_same(a, b, (seed, t, i))
        js, jm, jt, jx, jr = jout[:5]
        ts, tm, tt, tx, tr = tout[:5]
        fired += int(tout[11][storm.KSTAT_REBALANCE_FIRED])
        if mode == "fresh":
            script.ack(tout[7].numpy())
    return fired


import torch  # noqa: E402


@pytest.mark.parametrize("family", FAMILIES)
def test_each_family_alone_matches_jax(family):
    run_both([family] * 4, seed=3, ticks=5, modes={3: "resend"})


@pytest.mark.parametrize("seed", range(2))
def test_all_families_together_match_jax(seed):
    fams = [FAMILIES[r % 4] for r in range(8)]
    fired = run_both(fams, seed=10 + seed, ticks=7,
                     modes={2: "resend", 4: "gap"})
    assert fired > 0  # the block-table ladder ran inside the tick


def test_tree_steps_from_the_host_pack_change_nothing():
    # The all-family layout: one reference compile with the test above.
    run_both([FAMILIES[r % 4] for r in range(8)], seed=5, ticks=5,
             steps_from_pack=True)


def test_text_leg_fires_the_full_rebalance():
    """Long head-concentrated text at a tight geometry drives the ladder
    through both its branches; every tick still matches."""
    fired = run_both(["text"] * 2, seed=8, ticks=9,
                     shape=dict(text_blocks=2, text_bk=24))
    assert fired > 0


def test_ticket_window_matches_jax():
    rng = np.random.default_rng(2)
    counts = rng.integers(0, 8, 12).astype(np.int32)
    dups = rng.integers(0, 4, 12).astype(np.int32)
    n_seq = rng.integers(0, 8, 12).astype(np.int32)
    before = rng.integers(0, 100, 12).astype(np.int32)
    jw, js = jstorm._ticket_window(*(jnp.asarray(x) for x in (
        counts,)), 8, *(jnp.asarray(x) for x in (dups, n_seq, before)))
    tw, ts = storm._ticket_window(torch.from_numpy(counts), 8,
                                  *(torch.from_numpy(x)
                                    for x in (dups, n_seq, before)))
    assert np.array_equal(np.asarray(jw), tw.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert storm.TEXT_PACK == jstorm.TEXT_PACK
    assert storm.MATRIX_PACK == jstorm.MATRIX_PACK
    assert storm.TREE_PACK == jstorm.TREE_PACK
    assert storm.SCALAR_PACK == jstorm.SCALAR_PACK
