"""The port's netsplit chaos scenario — the leader replicating over real
TCP links to follower child processes with scripted link faults — on
``device="cpu"``, against the JAX package's harness.

``tests/test_chaos.py``'s tier-1 smoke shape (F = 1, seed 3, docs 2, K 4,
6 ticks, lease 0.4): a full partition outlives the lease, the rounds
written in the blackout park (never shed, never falsely acked), the heal
drains them, and the final digest equals the in-process fault-free
twin's, with the incarnation fence proven on the wire. The port's twin
must equal the reference's twin for the same seeded workload. The full
F = 2 matrix with a ``kill -9`` of the leader and a promotion over the
wire is the reference's slow soak.
"""

import json

import pytest

from fluidframework_tpu.tools import chaos as jax_chaos
from fluidframework_tpu_torch.tools import chaos, launch_cluster

_SMOKE = dict(seed=3, docs=2, k=4, ticks=6, cp_every=3)
_LEASE_S = 0.4


def dumps(digest) -> str:
    return json.dumps(digest, sort_keys=True)


def _twin(harness, root, **kw):
    life = harness._spawn_net_life(
        str(root), [], [str(root / "f0")], [], None, _SMOKE["seed"],
        _SMOKE["docs"], _SMOKE["k"], _SMOKE["ticks"], _SMOKE["cp_every"],
        240.0, _LEASE_S, **kw)
    assert life["returncode"] == 0, life["stderr"]
    assert life["acked"] == list(range(_SMOKE["ticks"]))
    assert life["digest"] is not None
    return life["digest"]


@pytest.fixture(scope="module")
def twin_digest(tmp_path_factory):
    """The port's fault-free in-process twin of the smoke workload."""
    return _twin(chaos, tmp_path_factory.mktemp("net_twin"), device="cpu")


@pytest.fixture(scope="module")
def jax_twin_digest(tmp_path_factory):
    return _twin(jax_chaos, tmp_path_factory.mktemp("jax_net_twin"))


def test_twin_digest_equals_jax_twin(twin_digest, jax_twin_digest):
    assert dumps(twin_digest) == dumps(jax_twin_digest)


def test_netsplit_smoke_partition_parks_then_drains(tmp_path, twin_digest):
    try:
        report = chaos.run_netsplit(
            str(tmp_path), followers=1, timeout=240.0, lease_s=_LEASE_S,
            script=chaos.netsplit_smoke_script(_LEASE_S),
            twin_digest=twin_digest, device="cpu", **_SMOKE)
    finally:
        launch_cluster.reap_all()
    assert report["lives"] == 1 and not report["killed"]
    assert report["acked_rounds"] == list(range(_SMOKE["ticks"]))
    assert 1 in report["parked_rounds"], report
    assert report["zombie_fenced"] >= 1


def test_netsplit_constants_and_scripts_are_the_references():
    assert chaos.NETSPLIT_FOLLOWERS == jax_chaos.NETSPLIT_FOLLOWERS
    assert chaos.NETSPLIT_LEASE_S == jax_chaos.NETSPLIT_LEASE_S
    for lease in (0.4, chaos.NETSPLIT_LEASE_S):
        assert chaos.netsplit_smoke_script(lease) \
            == jax_chaos.netsplit_smoke_script(lease)
        assert chaos.netsplit_matrix_script(lease) \
            == jax_chaos.netsplit_matrix_script(lease)


def test_netsplit_cli_defaults_to_the_card(monkeypatch, tmp_path):
    """``--netsplit`` reaches ``run_netsplit`` with the reference's walk
    (12 ticks, checkpoints every 4, the kill at round 9) on the card."""
    seen = {}
    monkeypatch.setattr(chaos, "run_netsplit",
                        lambda *a, **kw: seen.update(kw) or {})
    chaos.main(["--workdir", str(tmp_path), "--netsplit"])
    assert seen["device"] == "cuda"
    assert (seen["ticks"], seen["cp_every"], seen["kill_at"]) == (12, 4, 9)


@pytest.mark.soak
@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1])
def test_netsplit_full_matrix_kill_leader_promotes_over_wire(seed,
                                                             tmp_path):
    try:
        report = chaos.run_netsplit(
            str(tmp_path), followers=2, seed=seed, docs=2, k=8, ticks=12,
            cp_every=4, timeout=420.0, kill_at=9, device="cpu")
    finally:
        launch_cluster.reap_all()
    assert report["killed"] and report["lives"] >= 2
    assert report["acked_rounds"] == list(range(12))
    assert 4 in report["parked_rounds"], report
    blackouts = report["failover_blackouts_ms"]
    assert len(blackouts) == report["lives"] - 1
    assert all(0 < b < 30_000 for b in blackouts), blackouts
    assert report["zombie_fenced"] >= 2
