"""The port's chaos harness on its read-replica tier, on
``device="cpu"``, against the JAX package's harness.

Read-replica kills: the child serves a replicated leader with a
``ReadReplica`` tailing follower 0 in-process and serving the read
surface every round, re-homing doc 0's viewer room onto it at round 3
(``tests/test_chaos.py``'s ``_REPLICAS_CFG`` and ``_REPLICAS_SMOKE``).
``replica.mid_apply`` kills with the tick's records indexed but its
viewer broadcast not yet published; the resumed life restarts the
replica fresh over the durable follower WAL. It must equal the
replica-less twin's digest (every read served by the leader) with no
acked op lost, and the port's twin must equal the JAX harness's for the
same seeded workload.
"""

import json

import pytest

from fluidframework_tpu.tools import chaos as jax_chaos
from fluidframework_tpu_torch.tools import chaos

_CFG = dict(seed=0, docs=2, k=8, ticks=6, cp_every=2)

_SMOKE = [(chaos.REPLICAS_SMOKE_POINT, 2)]


def dumps(digest) -> str:
    return json.dumps(digest, sort_keys=True)


@pytest.fixture(scope="module")
def twin_digest(tmp_path_factory):
    """The port's replica-less twin: same frames, every digest read
    served by the leader."""
    life = chaos._spawn_life(
        str(tmp_path_factory.mktemp("replicas_twin")), resume_from=None,
        kill_env=None, timeout=300, device="cpu", replicas="off",
        migrate_at=-1, **_CFG)
    assert life["returncode"] == 0, life["stderr"]
    assert life["acked"] == list(range(_CFG["ticks"]))
    assert life["digest"] is not None
    return life["digest"]


def test_twin_digest_equals_jax_twin(tmp_path, twin_digest):
    life = jax_chaos._spawn_life(str(tmp_path), resume_from=None,
                                 kill_env=None, timeout=300,
                                 replicas="off", migrate_at=-1, **_CFG)
    assert life["returncode"] == 0, life["stderr"]
    assert dumps(twin_digest) == dumps(life["digest"])


def test_replica_served_clean_run_matches_replica_less_twin(tmp_path,
                                                             twin_digest):
    life = chaos._spawn_life(str(tmp_path), resume_from=None,
                             kill_env=None, timeout=300, device="cpu",
                             replicas="serve", migrate_at=3, **_CFG)
    assert life["returncode"] == 0, life["stderr"]
    assert life["acked"] == list(range(_CFG["ticks"]))
    assert dumps(life["digest"]) == dumps(twin_digest)


@pytest.mark.parametrize("point,hits", _SMOKE, ids=[p for p, _ in _SMOKE])
def test_replicas_chaos_smoke_rebuilds_read_surface(point, hits, tmp_path,
                                                    twin_digest):
    report = chaos.run_chaos(str(tmp_path), point, kill_hits=hits,
                             twin_digest=twin_digest, replicas=True,
                             migrate_at=3, device="cpu", **_CFG)
    assert report["killed"], report
    assert report["lives"] >= 2
    assert report["acked_rounds"] == list(range(_CFG["ticks"]))


@pytest.mark.soak
@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1])
def test_replicas_chaos_full_matrix(seed, tmp_path):
    reports = chaos.run_matrix(
        str(tmp_path), points=chaos.REPLICAS_CHAOS_POINTS, seeds=(seed,),
        hit_positions=(1, 2), replicas=True, migrate_at=3, device="cpu",
        **{k: v for k, v in _CFG.items() if k != "seed"})
    killed = [r for r in reports if r["killed"]]
    assert len(killed) >= len(reports) // 2, \
        [(r["kill_point"], r["kill_hits"], r["killed"]) for r in reports]


def test_replicas_constants_are_the_references():
    for name in ("REPLICAS_CHAOS_POINTS", "REPLICAS_SMOKE_POINT",
                 "REPLICAS_LABEL"):
        assert getattr(chaos, name) == getattr(jax_chaos, name), name


def test_replicas_refuse_other_planes(tmp_path):
    for other in (dict(replication=True), dict(cluster=True),
                  dict(residency=1), dict(pipelined=True),
                  dict(megadoc=2), dict(qos=True), dict(history=True)):
        with pytest.raises(ValueError):
            chaos.run_chaos(str(tmp_path), "wal.pre_fsync", replicas=True,
                            device="cpu", **other, **_CFG)


def test_replicas_cli_reaches_the_scenario(tmp_path, monkeypatch):
    """``--replicas serve|off`` is accepted and reaches ``run_chaos``
    (``--netsplit``, no longer refused, reaches its own scenario)."""
    seen = {}
    monkeypatch.setattr(chaos, "run_chaos",
                        lambda *a, **kw: seen.update(kw) or {})
    chaos.main(["--workdir", str(tmp_path), "--replicas", "serve",
                "--kill-point", chaos.REPLICAS_SMOKE_POINT])
    assert seen["replicas"] is True
    monkeypatch.setattr(chaos, "run_netsplit",
                        lambda *a, **kw: seen.update(netsplit=kw) or {})
    chaos.main(["--workdir", str(tmp_path), "--netsplit"])
    assert seen["netsplit"]["device"] == "cuda"
    with pytest.raises(SystemExit):
        chaos.main(["--workdir", str(tmp_path), "--replicas", "bogus"])
