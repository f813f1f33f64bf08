"""The port's kill-and-recover chaos harness (``fluidframework_tpu_torch/
tools/chaos.py``) on ``device="cpu"``, against the JAX package's.

Each serving life is a child process, hard-killed at a crashpoint,
restarted over the same directory, and its recovered planes — sequenced
history, map state, sequencer checkpoints — must equal an uninterrupted
twin's with no durably-acked op lost. The port's twin digest must equal
the JAX twin's for the same seeded workload, and the in-process fault
classes (fsync failure, poisoned doc) must report what JAX reports.

Tier-1 runs the smoke config of ``tests/test_chaos.py`` at one kill point
per failure class and two overlap-window points; the full kill-point x
seed matrix is the ``slow`` soak (about 26 child lives a seed, each
importing torch).
"""

import json

import pytest

from fluidframework_tpu.tools import chaos as jax_chaos
from fluidframework_tpu_torch.tools import chaos
from fluidframework_tpu_torch.utils import faults

_CFG = dict(seed=0, docs=2, k=8, ticks=5, cp_every=2)

#: (kill point, hit count chosen so the plan actually fires mid-run)
_SMOKE = [("storm.mid_tick", 3), ("wal.pre_fsync", 2),
          ("snapshot.pre_publish", 1)]
_OVERLAP_SMOKE = [("storm.overlap_dispatch", 2),
                  ("storm.readback_pre_wal", 2)]


@pytest.fixture(scope="module")
def twin_digest(tmp_path_factory):
    """One uninterrupted port twin run, shared by every scenario."""
    life = chaos._spawn_life(
        str(tmp_path_factory.mktemp("twin")), resume_from=None,
        kill_env=None, timeout=300, device="cpu", **_CFG)
    assert life["returncode"] == 0, life["stderr"]
    assert life["digest"] is not None
    assert sorted(life["acked"]) == list(range(_CFG["ticks"]))
    return life["digest"]


@pytest.fixture(scope="module")
def jax_twin_digest(tmp_path_factory):
    """One uninterrupted JAX child life of the same workload."""
    life = jax_chaos._spawn_life(
        str(tmp_path_factory.mktemp("jax_twin")), resume_from=None,
        kill_env=None, timeout=300, **_CFG)
    assert life["returncode"] == 0, life["stderr"]
    return life["digest"]


def test_twin_digest_equals_jax_twin(twin_digest, jax_twin_digest):
    assert json.dumps(twin_digest, sort_keys=True) \
        == json.dumps(jax_twin_digest, sort_keys=True)


def test_twin_digest_covers_every_plane(twin_digest):
    """History, map and sequencer planes are all present and non-trivial
    (the diff must never compare empty dicts)."""
    docs = twin_digest["docs"]
    assert len(docs) == _CFG["docs"]
    for planes in docs.values():
        ops = [h for h in planes["history"] if h[4] == 8]  # OPERATION
        assert len(ops) == _CFG["ticks"] * _CFG["k"]
        assert planes["map"]
        assert planes["sequencer"]["clients"]
        assert planes["sequencer"]["sequence_number"] > 0


@pytest.mark.parametrize("point,hits", _SMOKE, ids=[p for p, _ in _SMOKE])
def test_chaos_smoke_recovers_byte_identical(point, hits, tmp_path,
                                             twin_digest):
    report = chaos.run_chaos(str(tmp_path), point, kill_hits=hits,
                             twin_digest=twin_digest, device="cpu", **_CFG)
    assert report["killed"], report
    assert report["lives"] >= 2
    assert report["acked_rounds"] == list(range(_CFG["ticks"]))


@pytest.mark.parametrize("point,hits", _OVERLAP_SMOKE,
                         ids=[p for p, _ in _OVERLAP_SMOKE])
def test_overlap_chaos_smoke_recovers_byte_identical(point, hits, tmp_path,
                                                     twin_digest):
    """Kill inside the dispatch/fsync overlap window of the PIPELINED
    tick; the shared twin ran unpipelined, so digest equality also
    proves pipelined serving converges like barrier serving."""
    report = chaos.run_chaos(str(tmp_path), point, kill_hits=hits,
                             twin_digest=twin_digest, pipelined=True,
                             device="cpu", **_CFG)
    assert report["killed"], report
    assert report["lives"] >= 2
    assert report["acked_rounds"] == list(range(_CFG["ticks"]))


def test_pipelined_clean_run_matches_unpipelined_twin(tmp_path,
                                                      twin_digest):
    life = chaos._spawn_life(str(tmp_path), resume_from=None,
                             kill_env=None, timeout=300, pipelined=True,
                             device="cpu", **_CFG)
    assert life["returncode"] == 0, life["stderr"]
    assert json.dumps(life["digest"], sort_keys=True) \
        == json.dumps(twin_digest, sort_keys=True)
    assert sorted(life["acked"]) == list(range(_CFG["ticks"]))


def test_wal_fsync_failure_matches_jax(tmp_path):
    kw = dict(num_docs=2, k=8, rounds=2)
    report = chaos.run_fsync_failure(str(tmp_path / "torch"),
                                     device="cpu", **kw)
    want = jax_chaos.run_fsync_failure(str(tmp_path / "jax"), **kw)
    assert report["events"] == want["events"] == {
        "degraded_entered": True, "acks_withheld": True, "healed": True,
        "acks_after_heal": 2}
    assert report["degraded_rejects"] == want["degraded_rejects"]
    assert report["breaker_opens"] >= 1 and want["breaker_opens"] >= 1


def test_poison_doc_quarantine_matches_jax(tmp_path):
    kw = dict(num_docs=3, k=8, rounds=4)
    report = chaos.run_poison_quarantine(str(tmp_path / "torch"),
                                         device="cpu", **kw)
    want = jax_chaos.run_poison_quarantine(str(tmp_path / "jax"), **kw)
    for r in (report, want):
        r.pop("readmit_ms")  # wall clock
    assert report == want
    assert report["stats"] == {"quarantined_docs": 1, "readmitted_docs": 1}


def test_kill_exit_code_is_the_references():
    from fluidframework_tpu.utils import faults as jax_faults
    assert faults.KILL_EXIT_CODE == jax_faults.KILL_EXIT_CODE == 137


@pytest.mark.parametrize("scenario", ["netsplit"])
def test_scenarios_needing_unported_planes_refuse(tmp_path, monkeypatch,
                                                  scenario):
    """No scenario is refused any more: ``run_chaos`` takes no
    ``netsplit`` keyword, as the reference's takes none (the scenario has
    its own entry, ``run_netsplit``), and ``--netsplit`` reaches it."""
    for harness, kw in ((chaos, {"device": "cpu"}), (jax_chaos, {})):
        with pytest.raises(TypeError):
            harness.run_chaos(str(tmp_path), "storm.mid_tick",
                              **{scenario: True}, **kw)
    seen = {}
    monkeypatch.setattr(chaos, f"run_{scenario}",
                        lambda *a, **kw: seen.update(kw) or {})
    chaos.main(["--workdir", str(tmp_path), f"--{scenario}"])
    assert seen["device"] == "cuda"


def test_entry_point_defaults_to_the_card(monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(chaos, "run_chaos",
                        lambda *a, **kw: seen.update(kw) or {})
    chaos.main(["--workdir", str(tmp_path), "--kill-point", "x"])
    assert seen["device"] == "cuda"


@pytest.mark.soak
@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1])
def test_chaos_full_matrix(seed, tmp_path):
    """Every kill point x two hit positions, per seed, plus the overlap
    points pipelined (the soak tier: each life is a process importing
    torch)."""
    reports = chaos.run_matrix(str(tmp_path / "plain"),
                               points=chaos.KILL_POINTS, seeds=(seed,),
                               hit_positions=(1, 2), docs=2, k=8, ticks=6,
                               cp_every=2, device="cpu")
    reports += chaos.run_matrix(str(tmp_path / "overlap"),
                                points=chaos.OVERLAP_KILL_POINTS,
                                seeds=(seed,), hit_positions=(1, 2),
                                docs=2, k=8, ticks=6, cp_every=2,
                                pipelined=True, device="cpu")
    killed = [r for r in reports if r["killed"]]
    assert len(killed) >= len(reports) // 2, \
        [(r["kill_point"], r["kill_hits"], r["killed"]) for r in reports]
