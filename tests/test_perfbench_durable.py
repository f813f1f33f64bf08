"""The benchmark's durable served cell (``map_storm_10k_durable.served``,
``perfbench/drivers/served_map_durable.py``) on the CPU at a few
documents: it comes out correct on two seeds with the auto depth and the
recovery step run; its control, and programs broken where durability
lives (an ack pushed ahead of its fsync, a WAL record altered after the
window, a WAL tail cut before ``recover()``), come out not correct; the
plain WAL reader (``perfbench/reference/wal.py``) reads what the
program's WAL wrote and refuses a flipped CRC; the new readers median or
mean their records. The served driver's CPU tests
(``perfbench/tests/test_perfbench_served.py``) are collected here too."""

from __future__ import annotations

import copy
import pathlib
import struct
import time
import zlib

import numpy as np
import pytest
import torch

from perfbench.drivers import served_map, served_map_durable as durable
from perfbench.harness import bench, cell
from perfbench.reference import wal as ref_wal
from perfbench.tests.conftest import card, small_cells  # noqa: F401
from perfbench.tests.small import TICK_CELLS
from perfbench.tests.test_perfbench_served import *  # noqa: F401,F403

from fluidframework_tpu_torch.server import durable_store
from fluidframework_tpu_torch.utils import faults

NAME = "map_storm_10k_durable.served"
E2E = {"merged_ops_per_s": "ops/s", "tick_p95_ms": "ms", "setup_s": "s"}
WAL_LAYER = {"stage_ms.commit_wait": "ms", "wal_write_ms": "ms",
             "wal_fsync_ms": "ms", "wal_records_per_fsync": "count"}
SECONDS = 2.0


@pytest.mark.parametrize("name", TICK_CELLS)
def test_cell_without_driver_takes_the_tick_path(small_cells, monkeypatch,
                                                 name):
    """``test_perfbench_served``'s case of this name, collected with a 4 s
    window in place of its 1 s one: the check needs each input set's
    first epoch inside the window, and with the test command's six
    workers on eight cores a mixed tick at this size can take a third of
    a second, so 1 s held one epoch of two (``sets_unchecked`` 1)."""
    def refuse(*_args, **_kw):
        raise AssertionError("a tick cell reached a driver")
    monkeypatch.setattr(served_map, "run", refuse)
    out = bench.run_cell(name, 2**31 + 11, 4.0, False, torch.device("cpu"),
                         time.perf_counter(), E2E)
    assert "driver" not in cell.load_cell(name)[0]
    assert out["correct"] and out["ticks"] > 0, out["checks"]


def shrink_durable(work: dict, config: dict) -> tuple[dict, dict]:
    """The durable cell at 64 documents, 2 clients, K 16, 2 frames a round,
    2-round epochs and 2 input sets."""
    docs, clients = 64, 2
    stack = copy.deepcopy(config["stack"])
    stack["sequencer"].update(num_slots=clients, initial_capacity=docs)
    stack["merge_host"]["row_capacity"] = docs
    stack["storm"]["flush_threshold_docs"] = docs
    return (dict(work, input_sets=2, sample=8),
            dict(config, docs=docs, clients=clients, k=16,
                 frames_per_round=2, epoch_rounds=2, stack=stack))


@pytest.fixture
def small_durable(monkeypatch):
    real = cell.load_cell
    monkeypatch.setattr(bench, "load_cell",
                        lambda name: shrink_durable(*real(name)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    assert not (durable.ROOT / "perfbench_spill").exists()


def run(seed: int = 2**31 + 41, control: bool = False,
        trace: bool = False) -> dict:
    return bench.run_cell(NAME, seed, SECONDS, trace, torch.device("cpu"),
                          time.perf_counter(),
                          {**WAL_LAYER, "stage_ms.harvest": "ms"} if trace
                          else E2E, control=control)


@pytest.mark.parametrize("seed", [2**31 + 41, 3])
def test_durable_matches_reference(small_durable, seed):
    out = run(seed)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert out["epochs"] > 2 and out["failed"] == 0
    # 8 sampled rows of each set's first epoch and 8 recovered ones.
    assert out["compared_docs"] == 3 * 8
    assert set(out["metrics"]) == set(E2E)
    assert out["wal_fs"] != "unknown"
    # The auto depth decided in the warm-up; the window's rounds ran at
    # what it settled on, and every acked op of the check epoch was
    # replayed from the WAL.
    assert out["pipeline_depth"]["rounds"] \
        and set(out["pipeline_depth"]["rounds"]) <= {0, 1}
    assert out["recovery"]["replayed_ticks"] == 2
    wal = out["wal"]
    assert wal["early_acks"] == 0 and wal["tick_faults"] == 0
    assert wal["window"]["records"] >= out["rounds"] > 0
    assert wal["bytes_max"] > 0


def test_durable_traced_run_reports_the_wal(small_durable):
    out = run(trace=True)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == set(WAL_LAYER) | {"stage_ms.harvest"}
    assert out["metrics"]["wal_records_per_fsync"]["value"] >= 1
    assert all(n > 0 for n in out["ranges"].values()), out["ranges"]


def test_durable_control_fails(small_durable):
    out = run(control=True)
    assert out["control"] and not out["correct"]
    assert out["checks"]["state_diffs"]["value"] > 0


def test_ack_before_fsync_is_not_correct(small_durable, monkeypatch):
    """The watermark run ahead of the fsync: acks go out as soon as their
    tick is appended."""
    monkeypatch.setattr(durable_store.GroupCommitLog, "durable_len",
                        property(lambda self: self._next))
    real = faults.failpoint

    def slow_fsync(name):
        if name == "wal.fsync":
            time.sleep(0.02)
        return real(name)
    monkeypatch.setattr(faults, "failpoint", slow_fsync)
    out = run()
    assert not out["correct"]
    assert out["checks"]["harvest_diffs"]["value"] > 0
    assert out["wal"]["early_acks"] > 0


def _frames(data: bytes) -> list[tuple[int, int]]:
    """(payload offset, length) of every frame of a WAL file's bytes."""
    out, pos = [], 0
    while pos < len(data):
        length, _crc = struct.unpack_from("<II", data, pos)
        out.append((pos + 8, length))
        pos += 8 + length
    return out


def test_record_altered_after_the_window_is_not_correct(small_durable,
                                                        monkeypatch):
    """The live WAL's last record gets one op word changed, and a CRC that
    matches, when the log is closed after the window."""
    real = durable_store.GroupCommitLog.close
    done = []

    def close_and_alter(self):
        real(self)
        if done:
            return
        done.append(self._path)
        data = bytearray(self._path.read_bytes())
        offset, length = _frames(bytes(data))[-1]
        data[offset + length - 1] ^= 0x40
        struct.pack_into("<I", data, offset - 4,
                         zlib.crc32(data[offset:offset + length]))
        self._path.write_bytes(bytes(data))
    monkeypatch.setattr(durable_store.GroupCommitLog, "close",
                        close_and_alter)
    out = run()
    assert done and not out["correct"]
    assert out["checks"]["state_diffs"]["value"] > 0


def test_wal_tail_cut_before_recover_is_not_correct(small_durable,
                                                    monkeypatch):
    """The WAL file loses its last bytes before the fresh stack opens it."""
    real = durable_store.GroupCommitLog.__init__
    cut = []

    def open_cut(self, path, *args, **kwargs):
        path = pathlib.Path(path)
        if path.exists() and path.stat().st_size:
            with open(path, "r+b") as f:
                f.truncate(path.stat().st_size - 5)
            cut.append(path)
        real(self, path, *args, **kwargs)
    monkeypatch.setattr(durable_store.GroupCommitLog, "__init__", open_cut)
    out = run()
    assert cut and not out["correct"]
    assert out["checks"]["state_diffs"]["value"] > 0
    assert out["recovery"]["replayed_ticks"] == 1


def test_failed_run_leaves_no_spill_folder(small_durable, monkeypatch):
    def fail(*_args, **_kwargs):
        raise RuntimeError("the check failed")
    monkeypatch.setattr(durable, "check_durability", fail)
    with pytest.raises(RuntimeError, match="the check failed"):
        run()


def test_program_without_wal_counters_stops_at_once(small_durable,
                                                    monkeypatch):
    from fluidframework_tpu_torch.server.storm import StormController
    monkeypatch.delattr(StormController, "wal_counters")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="wal_counters"):
        run()
    assert time.perf_counter() - t0 < 5


def _served_wal(tmp_path) -> tuple:
    """A small durable stack that served one epoch of one input set, its
    acks settled: (the controller, the stack's names, the set)."""
    work, config = shrink_durable(*cell.load_cell(NAME))
    config = durable.durable_config(config, tmp_path)
    device = torch.device("cpu")
    sets = [durable.generate(config, work, 9, 0, device)]
    stack = durable.Stack(config, device)
    served = durable.DurableServed(config, stack, sets,
                                   tmp_path / "spill" / durable.WAL_FILE)
    for _ in range(config["epoch_rounds"]):
        served.serve_round()
    served.settle()
    return stack.storm, stack.names, sets[0]


def test_plain_reader_reads_what_the_wal_wrote(tmp_path):
    storm, names, s = _served_wal(tmp_path)
    try:
        port = [np.frombuffer(storm.read_tick_words(t), np.uint32)
                for t in range(storm._tick_counter)]
    finally:
        storm._group_wal.close()
    ticks = ref_wal.read(tmp_path / "spill" / durable.WAL_FILE)
    assert len(ticks) == len(port) == 2
    for r, (tick, words) in enumerate(zip(ticks, port)):
        assert tick["docs"] == names
        assert np.array_equal(np.concatenate(tick["ops"]), words)
        assert np.array_equal(np.stack(tick["ops"]),
                              s["words"][r].view(np.uint32))
        assert np.array_equal(tick["scalars"][:, :2],
                              s["scalars"][r, :, 1:3])


def test_plain_reader_refuses_a_flipped_crc(tmp_path):
    storm, _names, _s = _served_wal(tmp_path)
    storm._group_wal.close()
    path = tmp_path / "spill" / durable.WAL_FILE
    data = bytearray(path.read_bytes())
    offset, length = _frames(bytes(data))[1]
    data[offset - 4] ^= 1  # the second record's CRC
    path.write_bytes(bytes(data))
    payloads, fault = ref_wal.records(path)
    assert len(payloads) == 1 and "CRC" in fault
    with pytest.raises(ref_wal.WalError, match="CRC"):
        ref_wal.read(path)
    with pytest.raises(ref_wal.WalError):
        ref_wal.decode(b"\xff\xff\x00\x00{")


def test_wal_readers_median_or_mean_their_batches():
    # (first, records, bytes, write ns, fsync ns)
    batches = [(0, 1, 10, 2_000_000, 9_000_000),
               (1, 3, 30, 6_000_000, 1_000_000),
               (4, 2, 20, 4_000_000, 5_000_000)]
    run_ = {"wal_batches": batches}
    assert bench.read_metric("wal_write_ms", run_) == 4.0
    assert bench.read_metric("wal_fsync_ms", run_) == 5.0
    assert bench.read_metric("wal_records_per_fsync", run_) == 2.0
    stages = [{"wal_commit_wait": n} for n in (3_000_000, 1_000_000,
                                               7_000_000, 5_000_000)]
    assert bench.read_metric("stage_ms.commit_wait",
                             {"stages": stages}) == 4.0
    for name in WAL_LAYER:
        assert bench.read_metric(name, {}) is None
        assert bench.read_metric(name, {"wal_batches": [],
                                        "stages": []}) is None


def test_wal_fs_names_the_mount_of_a_path(tmp_path):
    mounts = [line.split() for line in open("/proc/mounts")]
    root = next(f[2] for f in mounts if f[1] == "/")
    assert durable.wal_fs(pathlib.Path("/")) == root
    assert durable.wal_fs(tmp_path) in {f[2] for f in mounts}
