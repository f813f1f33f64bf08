"""The port's chaos harness on its history plane, on ``device="cpu"``,
against the JAX package's harness.

History kills: the child serves 2 docs with a ``HistoryPlane`` that
compacts every ~2 rounds with tail retention 1 (trims fire under the
checkpoint watermark) and forks one branch mid-run whose seeded writer
co-serves (``tests/test_chaos.py``'s ``_HIST_CFG`` and ``_HIST_SMOKE``).
A killed-and-recovered life must equal the never-compacted twin's
digest with no durably-acked op lost; a clean compacting life must equal
it too; and the port's twin digest must equal the JAX harness's for the
same seeded workload.
"""

import json

import pytest

from fluidframework_tpu.tools import chaos as jax_chaos
from fluidframework_tpu_torch.tools import chaos

_CFG = dict(seed=0, docs=2, k=8, ticks=6, cp_every=2)

_SMOKE = [("history.mid_compaction", 1), ("history.mid_fork", 1)]


def dumps(digest) -> str:
    return json.dumps(digest, sort_keys=True)


@pytest.fixture(scope="module")
def twin_digest(tmp_path_factory):
    """The port's never-compacted twin (same frames, same fork)."""
    life = chaos._spawn_life(
        str(tmp_path_factory.mktemp("hist_twin")), resume_from=None,
        kill_env=None, timeout=300, device="cpu", history="plain", **_CFG)
    assert life["returncode"] == 0, life["stderr"]
    assert sorted(life["acked"]) == list(range(_CFG["ticks"]))
    return life["digest"]


def test_twin_digest_equals_jax_twin(tmp_path, twin_digest):
    life = jax_chaos._spawn_life(str(tmp_path), resume_from=None,
                                 kill_env=None, timeout=300,
                                 history="plain", **_CFG)
    assert life["returncode"] == 0, life["stderr"]
    assert dumps(twin_digest) == dumps(life["digest"])
    assert twin_digest["branches"]["branches"] == {
        chaos.HISTORY_BRANCH: {"parent": "chaos-doc-0", "seq": 25,
                               "name": chaos.HISTORY_BRANCH}}


def test_compacting_clean_run_matches_plain_twin(tmp_path, twin_digest):
    life = chaos._spawn_life(str(tmp_path), resume_from=None,
                             kill_env=None, timeout=300, device="cpu",
                             history="compact", **_CFG)
    assert life["returncode"] == 0, life["stderr"]
    assert dumps(life["digest"]) == dumps(twin_digest)
    assert life["acked"] == list(range(_CFG["ticks"]))


@pytest.mark.parametrize("point,hits", _SMOKE, ids=[p for p, _ in _SMOKE])
def test_history_chaos_smoke_recovers_byte_identical(point, hits, tmp_path,
                                                     twin_digest):
    report = chaos.run_chaos(str(tmp_path), point, kill_hits=hits,
                             twin_digest=twin_digest, history=True,
                             device="cpu", **_CFG)
    assert report["killed"], report
    assert report["lives"] >= 2
    assert report["acked_rounds"] == list(range(_CFG["ticks"]))
    assert report["history"] == "compact"


def test_history_refuses_other_planes(tmp_path):
    with pytest.raises(ValueError):
        chaos.run_chaos(str(tmp_path), "wal.pre_fsync", history=True,
                        qos=True, device="cpu", **_CFG)
