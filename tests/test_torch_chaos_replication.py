"""The port's chaos harness on its replication plane, on ``device="cpu"``,
against the JAX package's harness.

Replication kills: the child serves a two-host cluster whose doc-0
genesis owner is a quorum-replicated leader over two follower
directories, and live-migrates doc 0 to the plain host at round 3
(``tests/test_chaos.py``'s ``_REPL_CFG`` and ``_REPL_SMOKE``). The
resumed life promotes the most advanced follower under the same label
and prints its blackout. It must equal the never-killed, never-migrated
twin's digest with no acked-replicated op lost; a clean migrating life
must equal it too; and the port's twin digest must equal the JAX
harness's for the same seeded workload.
"""

import json

import pytest

from fluidframework_tpu.tools import chaos as jax_chaos
from fluidframework_tpu_torch.tools import chaos

_CFG = dict(seed=0, docs=2, k=8, ticks=6, cp_every=2)

_SMOKE = [(chaos.REPLICATION_SMOKE_POINT, 2)]


def dumps(digest) -> str:
    return json.dumps(digest, sort_keys=True)


@pytest.fixture(scope="module")
def twin_digest(tmp_path_factory):
    """The port's never-killed, never-migrated replicated twin."""
    life = chaos._spawn_life(
        str(tmp_path_factory.mktemp("repl_twin")), resume_from=None,
        kill_env=None, timeout=300, device="cpu", replication=True,
        migrate_at=-1, **_CFG)
    assert life["returncode"] == 0, life["stderr"]
    assert life["acked"] == list(range(_CFG["ticks"]))
    assert life["failovers"] == []
    return life["digest"]


def test_twin_digest_equals_jax_twin(tmp_path, twin_digest):
    life = jax_chaos._spawn_life(str(tmp_path), resume_from=None,
                                 kill_env=None, timeout=300,
                                 replication=True, migrate_at=-1, **_CFG)
    assert life["returncode"] == 0, life["stderr"]
    assert dumps(twin_digest) == dumps(life["digest"])


def test_replicated_clean_run_matches_never_migrated_twin(tmp_path,
                                                          twin_digest):
    life = chaos._spawn_life(str(tmp_path), resume_from=None,
                             kill_env=None, timeout=300, device="cpu",
                             replication=True, migrate_at=3, **_CFG)
    assert life["returncode"] == 0, life["stderr"]
    assert dumps(life["digest"]) == dumps(twin_digest)
    assert life["failovers"] == []


@pytest.mark.parametrize("point,hits", _SMOKE, ids=[p for p, _ in _SMOKE])
def test_replication_chaos_smoke_promotes_follower(point, hits, tmp_path,
                                                   twin_digest):
    report = chaos.run_chaos(str(tmp_path), point, kill_hits=hits,
                             twin_digest=twin_digest, replication=True,
                             migrate_at=3, device="cpu", **_CFG)
    assert report["killed"], report
    assert report["lives"] >= 2
    assert report["acked_rounds"] == list(range(_CFG["ticks"]))
    blackouts = report["failover_blackouts_ms"]
    assert len(blackouts) == report["lives"] - 1  # one per promotion
    assert all(0 < b < 30_000 for b in blackouts), blackouts


def test_replication_constants_are_the_references():
    for name in ("REPLICATION_CHAOS_POINTS", "REPLICATION_SMOKE_POINT",
                 "REPLICATION_FOLLOWERS"):
        assert getattr(chaos, name) == getattr(jax_chaos, name), name


def test_replication_refuses_other_planes(tmp_path):
    for other in (dict(cluster=True), dict(residency=1),
                  dict(pipelined=True), dict(megadoc=2), dict(qos=True),
                  dict(history=True)):
        with pytest.raises(ValueError):
            chaos.run_chaos(str(tmp_path), "wal.pre_fsync",
                            replication=True, device="cpu", **other,
                            **_CFG)
