"""The port's chaos harness on its cluster placement plane, on
``device="cpu"``, against the JAX package's harness.

Migration kills: the child serves a two-host cluster (per-host WAL, bus
and state over one shared snapshot store and durable placement
directory) and live-migrates doc 0 at round 2 (``tests/test_chaos.py``'s
``_CLUSTER_CFG`` and ``_MIGRATION_SMOKE``). A killed-and-recovered life
must roll the migration forward and equal the never-migrated twin's
digest with no durably-acked op lost; a clean migrating life must equal
it too; and the port's twin digest must equal the JAX harness's for the
same seeded workload.
"""

import json

import pytest

from fluidframework_tpu.tools import chaos as jax_chaos
from fluidframework_tpu_torch.tools import chaos

_CFG = dict(seed=0, docs=2, k=8, ticks=5, cp_every=2)

_SMOKE = [("placement.post_evict", 1)]


def dumps(digest) -> str:
    return json.dumps(digest, sort_keys=True)


@pytest.fixture(scope="module")
def twin_digest(tmp_path_factory):
    """The port's never-migrated twin cluster."""
    life = chaos._spawn_life(
        str(tmp_path_factory.mktemp("cluster_twin")), resume_from=None,
        kill_env=None, timeout=300, device="cpu", cluster=True,
        migrate_at=-1, **_CFG)
    assert life["returncode"] == 0, life["stderr"]
    assert life["acked"] == list(range(_CFG["ticks"]))
    return life["digest"]


def test_twin_digest_equals_jax_twin(tmp_path, twin_digest):
    life = jax_chaos._spawn_life(str(tmp_path), resume_from=None,
                                 kill_env=None, timeout=300, cluster=True,
                                 migrate_at=-1, **_CFG)
    assert life["returncode"] == 0, life["stderr"]
    assert dumps(twin_digest) == dumps(life["digest"])
    assert sorted(twin_digest["docs"]) == ["chaos-doc-0", "chaos-doc-1"]


def test_cluster_clean_run_matches_never_migrated_twin(tmp_path,
                                                       twin_digest):
    life = chaos._spawn_life(str(tmp_path), resume_from=None,
                             kill_env=None, timeout=300, device="cpu",
                             cluster=True, migrate_at=2, **_CFG)
    assert life["returncode"] == 0, life["stderr"]
    assert dumps(life["digest"]) == dumps(twin_digest)
    assert life["acked"] == list(range(_CFG["ticks"]))


@pytest.mark.parametrize("point,hits", _SMOKE, ids=[p for p, _ in _SMOKE])
def test_migration_chaos_smoke_recovers_byte_identical(point, hits,
                                                       tmp_path,
                                                       twin_digest):
    report = chaos.run_chaos(str(tmp_path), point, kill_hits=hits,
                             twin_digest=twin_digest, cluster=True,
                             migrate_at=2, device="cpu", **_CFG)
    assert report["killed"], report
    assert report["lives"] >= 2
    assert report["acked_rounds"] == list(range(_CFG["ticks"]))
    assert report["cluster"] and report["migrate_at"] == 2


def test_kill_points_are_the_references():
    assert chaos.MIGRATION_KILL_POINTS == jax_chaos.MIGRATION_KILL_POINTS
    assert chaos.CLUSTER_HOSTS == jax_chaos.CLUSTER_HOSTS


def test_cluster_refuses_other_planes(tmp_path):
    for other in (dict(residency=1), dict(pipelined=True),
                  dict(megadoc=2), dict(qos=True), dict(history=True)):
        with pytest.raises(ValueError):
            chaos.run_chaos(str(tmp_path), "wal.pre_fsync", cluster=True,
                            device="cpu", **other, **_CFG)


def test_cli_takes_the_cluster_flags(monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(chaos, "run_chaos",
                        lambda *a, **kw: seen.update(kw) or {})
    chaos.main(["--workdir", str(tmp_path), "--kill-point", "x",
                "--cluster", "--migrate-at", "3"])
    assert seen["cluster"] and seen["migrate_at"] == 3
    assert seen["device"] == "cuda"
