"""The plain reference against the serving tick, run on the CPU (the
kernels' plain versions) at a few documents: every cell's run comes out
correct; with the timed path broken underneath (state left unchanged,
half the batch left out, an answer altered where it is produced) it
comes out not correct; and the control (the reference in the program's
place, a tick's ops out of order) fails the comparison."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench.harness import bench
from perfbench.tests.small import CELLS

E2E = {"merged_ops_per_s": "ops/s", "tick_p95_ms": "ms", "setup_s": "s"}
SECONDS = 4.0


def run(name: str, seed: int = 2**31 + 11, control: bool = False) -> dict:
    return bench.run_cell(name, seed, SECONDS, False, torch.device("cpu"),
                          time.perf_counter(), E2E, control=control)


@pytest.mark.parametrize("name", CELLS)
def test_serving_tick_matches_reference(small_cells, name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert out["compared_docs"] > 0 and out["epochs"] >= 2
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == set(E2E)


def _frozen(real):
    def tick(*args, **kw):
        out = real(*args, **kw)
        return tuple(args[:5]) + tuple(out[5:])
    return tick


def _half(real):
    def tick(seq, m, t, x, tr, scalars, *rest, **kw):
        cut = scalars.clone()
        cut[scalars.shape[0] // 2:, 4:] = 0
        return real(seq, m, t, x, tr, cut, *rest, **kw)
    return tick


def _altered(real):
    def tick(*args, **kw):
        out = list(real(*args, **kw))
        text = out[2]
        bump = torch.zeros_like(text.pool_start)
        bump[:, 0, 0] = 1
        out[2] = text._replace(pool_start=text.pool_start + bump)
        return tuple(out)
    return tick


@pytest.mark.parametrize("fault", [_frozen, _half, _altered])
@pytest.mark.parametrize("name", ["mixed_8k.seeded", "text_8k.scattered"])
def test_broken_tick_is_not_correct(small_cells, monkeypatch, name, fault):
    from fluidframework_tpu_torch.server import storm
    monkeypatch.setattr(storm, "_mixed_tick", fault(storm._mixed_tick))
    out = run(name)
    assert not out["correct"]
    assert out["checks"]["state_diffs"]["value"] \
        + out["checks"]["harvest_diffs"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(small_cells, name):
    out = run(name, control=True)
    assert out["control"] and not out["correct"]
    assert out["compared_docs"] > 0
    checks = out["checks"]
    assert checks["state_diffs"]["value"] > 0
    assert checks["harvest_diffs"]["value"] == 0
    assert checks["sets_unchecked"]["value"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_card_run_matches_reference(small_cells, card, name):
    out = bench.run_cell(name, 2**31 + 12, SECONDS, False, card,
                         time.perf_counter(), E2E)
    assert out["correct"], out["checks"]
    assert out["memory_peak_bytes"] > 0
