"""The served path's driver (``perfbench/drivers/served_map.py``), run on
the CPU (the program's plain versions) at a few documents: its runs come
out correct on two seeds, every later epoch equal to the first of its
set; the control and the timed path broken underneath (state left
unchanged, half the batch left out, an answer altered where it is
produced) come out not correct; the closed epochs' tick blobs are
trimmed to fillers; and a cell without a driver takes the serving tick's
path."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from perfbench.drivers import served_map
from perfbench.harness import bench, cell
from perfbench.metrics import _stages, _work_fold
from perfbench.tests.small import SERVED_CELLS, TICK_CELLS, shrink

E2E = {"merged_ops_per_s": "ops/s", "tick_p95_ms": "ms", "setup_s": "s"}
PER_LAYER = {"stage_ms.ingress": "ms", "stage_ms.scatter": "ms",
             "stage_ms.dispatch": "ms", "stage_ms.readback": "ms",
             "stage_ms.harvest": "ms", "device_idle_share": "%"}
SECONDS = 3.0
NAME = SERVED_CELLS[0]


def run(seed: int = 2**31 + 21, control: bool = False, trace: bool = False,
        seconds: float = SECONDS) -> dict:
    return bench.run_cell(NAME, seed, seconds, trace, torch.device("cpu"),
                          time.perf_counter(),
                          PER_LAYER if trace else E2E, control=control)


@pytest.mark.parametrize("seed", [2**31 + 21, 7])
def test_served_matches_reference(small_cells, seed):
    out = run(seed)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values())
    # Every later epoch was held to the first of its set.
    assert out["epochs"] > 2 and out["compared_docs"] == 2 * 4
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["trimmed_blobs"] > 0
    assert set(out["metrics"]) == set(E2E)


def test_served_traced_run(small_cells):
    out = run(trace=True)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == set(PER_LAYER)
    assert out["window_s"] > 0 and out["breakdown"]["idle_gaps"]
    stages = sum(out["metrics"][m]["value"] for m in PER_LAYER
                 if m.startswith("stage_ms."))
    assert stages <= out["round_ms_quartiles"][1]


def test_served_control_fails(small_cells):
    out = run(control=True)
    assert out["control"] and not out["correct"]
    checks = out["checks"]
    assert checks["state_diffs"]["value"] > 0
    assert checks["harvest_diffs"]["value"] == 0
    assert checks["sets_unchecked"]["value"] == 0


def _frozen(real):
    def tick(*args):
        out = real(*args)
        return tuple(args[:2]) + tuple(out[2:])
    return tick


def _half(real):
    def tick(seq, m, slot, cseq0, ref, ts, seq_counts, gather, words,
             map_counts):
        cut = seq_counts.clone()
        cut[seq_counts.shape[0] // 2:] = 0
        mcut = map_counts.clone()
        mcut[map_counts.shape[0] // 2:] = 0
        return real(seq, m, slot, cseq0, ref, ts, cut, gather, words, mcut)
    return tick


def _altered(real):
    def tick(*args):
        out = list(real(*args))
        m = out[1]
        out[1] = m._replace(value=m.value + m.present.to(m.value.dtype))
        return tuple(out)
    return tick


@pytest.mark.parametrize("fault", [_frozen, _half, _altered])
def test_broken_served_tick_is_not_correct(small_cells, monkeypatch, fault):
    from fluidframework_tpu_torch.server import storm
    monkeypatch.setattr(storm, "_storm_tick", fault(storm._storm_tick))
    out = run()
    assert not out["correct"]
    assert out["checks"]["state_diffs"]["value"] \
        + out["checks"]["harvest_diffs"]["value"] > 0


def test_closed_epochs_trimmed_to_fillers():
    work, config = shrink(*cell.load_cell(NAME))
    device = torch.device("cpu")
    sets = [served_map.generate(config, work, 5, i, device)
            for i in range(work["input_sets"])]
    served = served_map.Served(config, served_map.Stack(config, device),
                               sets)
    storm = served.storm
    for _ in range(3 * config["epoch_rounds"] + 1):
        served.step()
    served.settle()
    closed = 3 * config["epoch_rounds"]
    for tick in range(storm._tick_counter):
        header, _off = storm._parse_header(storm._read_blob(tick))
        assert (header["docs"] == []) == (tick < closed), tick
    # The catch-up index holds the open epoch's tick alone.
    assert {t for dt in storm._doc_ticks.values() for _f, _l, t in dt} \
        == {closed}


def test_generation_is_the_seeds():
    work, config = shrink(*cell.load_cell(NAME))
    device = torch.device("cpu")
    a = served_map.generate(config, work, 2**31 + 5, 1, device)
    b = served_map.generate(config, work, 2**31 + 5, 1, device)
    c = served_map.generate(config, work, 2**31 + 6, 1, device)
    for key in ("scalars", "words", "sample"):
        assert np.array_equal(a[key], b[key])
    assert not np.array_equal(a["words"], c["words"])
    kind = a["words"].view(np.uint32) & 3
    slot = (a["words"].view(np.uint32) >> 2) & 0x3FF
    assert kind.max() <= 2 and slot.max() < config["key_slots"]


def test_served_files_are_no_tick_cell():
    """The served configuration cannot be read as a serving-tick cell:
    a harness without the driver seam stops at once."""
    work, config = cell.load_cell(NAME)
    assert "families" not in config and work["driver"] == "served_map"
    with pytest.raises(KeyError):
        cell.generate_sets(config, work, 1)


@pytest.mark.parametrize("name", TICK_CELLS)
def test_cell_without_driver_takes_the_tick_path(small_cells, monkeypatch,
                                                 name):
    def refuse(*_args, **_kw):
        raise AssertionError("a tick cell reached a driver")
    monkeypatch.setattr(served_map, "run", refuse)
    out = bench.run_cell(name, 2**31 + 11, 1.0, False, torch.device("cpu"),
                         time.perf_counter(), E2E)
    assert "driver" not in cell.load_cell(name)[0]
    assert out["correct"] and out["ticks"] > 0


def test_fold_bytes_pinned():
    # kind | slot << 2 | value << 12: set 1, set 2, clear, set 3, del 1.
    words = np.array([[0 | 1 << 2 | 9 << 12, 0 | 2 << 2, 2,
                       0 | 3 << 2 | 5 << 12, 1 | 1 << 2]], np.int32)
    # 5 words, the window, slots 3 and 1 after the clear, its stamp.
    assert _work_fold.fold_bytes(words) == 5 * 4 + 12 + 2 * 5 + 4
    no_clear = np.array([[0 | 4 << 2, 0 | 4 << 2]], np.int32)
    assert _work_fold.fold_bytes(no_clear) == 2 * 4 + 12 + 5


def test_stage_reader_medians_the_rounds():
    recs = [{"scatter": 2_000_000, "readback": 1_000_000},
            {"scatter": 4_000_000, "readback": 0},
            {"scatter": 3_000_000, "readback": 5_000_000}]
    assert _stages.p50_ms({"stages": recs}, "scatter") == 3.0
    assert _stages.p50_ms({"stages": recs}, "scatter", "readback") == 4.0
    assert _stages.p50_ms({"stages": []}, "scatter") is None
    assert _stages.p50_ms({}, "scatter") is None


@pytest.mark.cuda
def test_card_served_run_matches_reference(small_cells, card):
    out = bench.run_cell(NAME, 2**31 + 12, SECONDS, False, card,
                         time.perf_counter(), E2E)
    assert out["correct"], json.dumps(out["checks"])
    assert out["launches"]["map_fold"] == out["rounds"]
