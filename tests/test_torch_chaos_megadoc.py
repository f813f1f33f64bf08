"""The port's chaos harness on its mega-doc plane, on ``device="cpu"``,
against the JAX package's harness.

Mega-doc kills: the child serves one doc co-written by four writers
through two promote → serve → demote cycles on 2 lanes, killed inside
the promotion window and the combiner window (``tests/test_chaos.py``'s
``_MEGA_CFG`` and ``_MEGA_SMOKE``). Each recovered life must equal the
uninterrupted twin's digest with no durably-acked op lost, and the
port's twin digest must equal the JAX harness's for the same seeded
workload.
"""

import json

import pytest

from fluidframework_tpu.tools import chaos as jax_chaos
from fluidframework_tpu_torch.tools import chaos

_CFG = dict(docs=1, k=8, ticks=4, cp_every=2, megadoc=2, seed=0)

_SMOKE = [("megadoc.mid_promotion", 1), ("megadoc.mid_combine", 3)]


@pytest.fixture(scope="module")
def twin_digest(tmp_path_factory):
    life = chaos._spawn_life(
        str(tmp_path_factory.mktemp("twin")), resume_from=None,
        kill_env=None, timeout=300, device="cpu", **_CFG)
    assert life["returncode"] == 0, life["stderr"]
    assert sorted(life["acked"]) == list(range(_CFG["ticks"]))
    return life["digest"]


def test_twin_digest_equals_jax_twin(tmp_path, twin_digest):
    life = jax_chaos._spawn_life(str(tmp_path), resume_from=None,
                                 kill_env=None, timeout=300, **_CFG)
    assert life["returncode"] == 0, life["stderr"]
    assert json.dumps(twin_digest, sort_keys=True) \
        == json.dumps(life["digest"], sort_keys=True)
    # The digest's map is the scalar fold of its own sequenced history.
    from fluidframework_tpu_torch.dds.map_data import MapData
    for planes in twin_digest["docs"].values():
        ops = [json.loads(h[6]) for h in planes["history"] if h[4] == 8]
        assert ops
        data = MapData()
        for op in ops:
            data.process(op["contents"]["contents"], False, None)
        assert dict(data.items()) == planes["map"]


@pytest.mark.parametrize("point,hits", _SMOKE, ids=[p for p, _ in _SMOKE])
def test_chaos_smoke_recovers_byte_identical(point, hits, tmp_path,
                                             twin_digest):
    report = chaos.run_chaos(str(tmp_path), point, kill_hits=hits,
                             twin_digest=twin_digest, device="cpu", **_CFG)
    assert report["killed"], report
    assert report["lives"] >= 2
    assert report["acked_rounds"] == list(range(_CFG["ticks"]))
