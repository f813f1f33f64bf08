"""The port's chaos harness on multi-tenant QoS, and its overload
scenario, on ``device="cpu"``, against the JAX package's harness.

QoS kills: three tenants, the first at 10x, composed through the deficit
scheduler with a tick slot budget (``tests/test_chaos.py``'s ``_QOS_CFG``
and ``_QOS_SMOKE``). A killed-and-recovered life must equal the
tenant-blind twin's digest with no durably-acked op lost; a clean fair
life must equal it too; and the port's twin digest must equal the JAX
harness's. ``run_overload`` is held to the JAX harness's report fields,
not its wall-clock timings.
"""

import json

import pytest

from fluidframework_tpu.tools import chaos as jax_chaos
from fluidframework_tpu_torch.tools import chaos

_CFG = dict(seed=0, docs=2, k=8, ticks=4, cp_every=2)

_SMOKE = [("storm.qos_mid_compose", 2), ("wal.pre_fsync", 1)]


def dumps(digest) -> str:
    return json.dumps(digest, sort_keys=True)


@pytest.fixture(scope="module")
def twin_digest(tmp_path_factory):
    """The port's tenant-blind twin (same frames, no fairness)."""
    life = chaos._spawn_life(
        str(tmp_path_factory.mktemp("qos_twin")), resume_from=None,
        kill_env=None, timeout=300, device="cpu", qos="blind", **_CFG)
    assert life["returncode"] == 0, life["stderr"]
    assert sorted(life["acked"]) == list(range(_CFG["ticks"]))
    return life["digest"]


def test_twin_digest_equals_jax_twin(tmp_path, twin_digest):
    life = jax_chaos._spawn_life(str(tmp_path), resume_from=None,
                                 kill_env=None, timeout=300, qos="blind",
                                 **_CFG)
    assert life["returncode"] == 0, life["stderr"]
    assert dumps(twin_digest) == dumps(life["digest"])
    assert len(twin_digest["docs"]) == (chaos.QOS_ABUSE_FACTOR + 2) \
        * _CFG["docs"]


def test_fair_clean_run_matches_tenant_blind_twin(tmp_path, twin_digest):
    life = chaos._spawn_life(str(tmp_path), resume_from=None,
                             kill_env=None, timeout=300, device="cpu",
                             qos="fair", **_CFG)
    assert life["returncode"] == 0, life["stderr"]
    assert dumps(life["digest"]) == dumps(twin_digest)
    assert life["acked"] == list(range(_CFG["ticks"]))


@pytest.mark.parametrize("point,hits", _SMOKE, ids=[p for p, _ in _SMOKE])
def test_qos_chaos_smoke_recovers_byte_identical(point, hits, tmp_path,
                                                 twin_digest):
    report = chaos.run_chaos(str(tmp_path), point, kill_hits=hits,
                             twin_digest=twin_digest, qos=True,
                             device="cpu", **_CFG)
    assert report["killed"], report
    assert report["lives"] >= 2
    assert report["acked_rounds"] == list(range(_CFG["ticks"]))
    assert report["qos"] == "fair"


_OVERLOAD_FIELDS = ("scenario", "offered_x_capacity", "shed_rate",
                    "acked_frames", "shed_frames")


def test_throttle_under_storm_report_fields_equal_jax(tmp_path):
    """The overflow wave sheds in full as busy-nacks and every admitted
    round acks, in both packages (the tick-time bars are wall-clock:
    neither side is held to them here)."""
    got = chaos.run_overload(str(tmp_path / "torch"), num_docs=8, k=16,
                             rounds=6, p99_factor=None, device="cpu")
    want = jax_chaos.run_overload(str(tmp_path / "jax"), num_docs=8, k=16,
                                  rounds=6, p99_factor=None)
    assert {f: got[f] for f in _OVERLOAD_FIELDS} == \
        {f: want[f] for f in _OVERLOAD_FIELDS}
    assert got["shed_rate"] == 0.5
    assert got["acked_frames"] == got["shed_frames"] == 48
    assert set(got) == set(want)

