"""The port's group-commit WAL as the durable served cell reads it: the
writer's counters and per-batch records sum to what was appended and
fsynced (and stay 0 without a WAL), a tick fsynced after its harvest
acks at the next admitted frame, its ``wal.write`` / ``wal.fsync``
ranges and the drain's ``storm.durable_drain`` reach a profile of every
thread, and a trim rewrites the log reading only the records it keeps
(the rewrite used to read every record it replaced, the whole epoch's
42 MB blobs at the served cell's width), and a record given as parts is
written as their join without joining them."""

from __future__ import annotations

import itertools
import time

import numpy as np
import pytest

from fluidframework_tpu_torch import native
from fluidframework_tpu_torch.server.durable_store import (
    WAL_COUNTERS, GitSnapshotStore, GroupCommitLog, rewrite_oplog_records)
from fluidframework_tpu_torch.server.kernel_host import KernelSequencerHost
from fluidframework_tpu_torch.server.merge_host import KernelMergeHost
from fluidframework_tpu_torch.server.routerlicious import \
    RouterliciousService
from fluidframework_tpu_torch.server.storm import StormController
from fluidframework_tpu_torch.utils import faults

DOCS = [f"doc{i}" for i in range(4)]
K = 8


def _controller(root=None, depth=1):
    """A controller over DOCS, one client each joined, with its tick WAL
    and snapshots under ``root`` (none without one)."""
    seq = KernelSequencerHost(num_slots=1, initial_capacity=len(DOCS),
                              device="cpu")
    merge = KernelMergeHost(flush_threshold=10**9, device="cpu")
    svc = RouterliciousService(merge_host=merge, batched_deli_host=seq,
                               auto_pump=False)
    storm = StormController(
        svc, seq, merge, flush_threshold_docs=len(DOCS),
        pipeline_depth=depth,
        spill_dir=None if root is None else str(root / "spill"),
        snapshots=None if root is None else GitSnapshotStore(root / "git"))
    svc._clock = itertools.count(1000, 7).__next__
    clients = [svc.connect(d, lambda m: None).client_id for d in DOCS]
    svc.pump()
    return storm, clients


def _serve(storm, clients, rounds: int, acks: list) -> None:
    rng = np.random.default_rng(5)
    for r in range(rounds):
        slots = rng.integers(0, 16, (len(DOCS), K)).astype(np.uint32)
        words = slots << 2  # sets of value 0
        storm.submit_frame(acks.append, {"rid": r, "docs": [
            [d, c, 1 + r * K, 1, K] for d, c in zip(DOCS, clients)]},
            memoryview(words.reshape(-1)).cast("B"))
    storm.flush()


def test_counters_sum_to_what_was_appended_and_fsynced(tmp_path):
    log = GroupCommitLog(tmp_path / "wal.log")
    try:
        sizes = []
        for i in range(12):
            part = bytes([i]) * (10 + i)
            parts = [b"head", part, np.arange(i, dtype=np.uint32)]
            log.append(parts if i % 2 else b"".join(
                bytes(memoryview(p)) for p in parts))
            sizes.append(4 + len(part) + 4 * i)
        log.sync()
        c = log.counters()
        batches = log.batches()
        assert set(c) == set(WAL_COUNTERS)
        assert c["records"] == 12 == log.durable_len
        assert c["bytes"] == sum(sizes)
        assert c["batches"] == len(batches) >= 1
        assert [b[0] for b in batches] == list(itertools.accumulate(
            [0] + [b[1] for b in batches[:-1]]))
        assert sum(b[1] for b in batches) == 12
        assert sum(b[2] for b in batches) == c["bytes"]
        assert sum(b[3] for b in batches) == c["write_ns"] > 0
        assert sum(b[4] for b in batches) == c["fsync_ns"] > 0
        assert c["append_wait_ns"] == 0
        assert [len(log.read(i)) for i in range(12)] == sizes
    finally:
        log.close()
    # Reopened records are durable history, not counted work.
    again = GroupCommitLog(tmp_path / "wal.log")
    try:
        assert len(again) == 12
        assert again.counters() == dict.fromkeys(WAL_COUNTERS, 0)
        assert again.batches() == []
    finally:
        again.close()


def test_append_wait_counts_a_full_queue(tmp_path, monkeypatch):
    real = faults.failpoint

    def slow_fsync(name):
        if name == "wal.fsync":
            time.sleep(0.02)
        return real(name)
    monkeypatch.setattr(faults, "failpoint", slow_fsync)
    log = GroupCommitLog(tmp_path / "wal.log", max_queue=1)
    try:
        for i in range(4):
            log.append(b"x" * 64)
        log.sync()
        c = log.counters()
        assert c["append_wait_ns"] > 0
        assert c["records"] == 4 and c["fsync_ns"] >= c["batches"] * 15e6
    finally:
        log.close()


def test_controller_counters_stay_zero_without_a_wal(tmp_path):
    storm, clients = _controller()
    acks = []
    _serve(storm, clients, 3, acks)
    assert len(acks) == 3 and storm.durable_watermark is None
    assert storm.wal_counters() == dict.fromkeys(WAL_COUNTERS, 0)


def test_controller_counters_follow_its_ticks(tmp_path):
    storm, clients = _controller(tmp_path)
    try:
        assert storm.wal_counters() == dict.fromkeys(WAL_COUNTERS, 0)
        acks = []
        _serve(storm, clients, 3, acks)
        c = storm.wal_counters()
        assert c["records"] == storm._tick_counter == 3
        # Each frame (one a tick) acked past its tick's fsync.
        assert [a["rid"] for a in acks] == [0, 1, 2]
        assert all(a["dw"] > t for t, a in enumerate(acks))
        on_disk = sum(len(storm._group_wal.read(t)) for t in range(3))
        assert c["bytes"] == on_disk
    finally:
        storm._group_wal.close()


def test_next_frame_drains_a_fsynced_tick(tmp_path, monkeypatch):
    """A tick fsynced after its harvest acks at the next admitted frame,
    with no round run in between; one not yet fsynced stays withheld."""
    real = faults.failpoint

    def slow_fsync(name):
        if name == "wal.fsync":
            time.sleep(0.3)
        return real(name)
    monkeypatch.setattr(faults, "failpoint", slow_fsync)
    storm, clients = _controller(tmp_path)
    try:
        acks = []
        words = np.zeros(K, np.uint32)
        for r in range(2):
            storm.submit_frame(acks.append, {"rid": r, "docs": [
                [d, c, 1 + r * K, 1, K] for d, c in zip(DOCS, clients)]},
                memoryview(np.tile(words, len(DOCS))).cast("B"))
        storm._harvest()
        assert acks == [] and len(storm._unacked) == 2
        storm._group_wal.sync()

        def partial(rid):  # two of the four docs: below the threshold
            storm.submit_frame(acks.append, {"rid": rid, "docs": [
                [d, c, 1 + 2 * K, 1, K]
                for d, c in zip(DOCS[:2], clients[:2])]},
                memoryview(np.tile(words, 2)).cast("B"))
        ticks = storm._tick_counter
        partial(2)
        assert storm._tick_counter == ticks
        assert [a["rid"] for a in acks] == [0, 1]
        assert all(a["dw"] > t for t, a in enumerate(acks))
        storm.flush()
        assert [a["rid"] for a in acks] == [0, 1, 2]
    finally:
        storm._group_wal.close()


def test_ranges_reach_a_profile_of_every_thread(tmp_path):
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    storm, clients = _controller(tmp_path)
    try:
        _serve(storm, clients, 1, [])  # the writer thread is running
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            _serve(storm, clients, 2, [])
        threads = {}
        for e in prof.events():
            threads.setdefault(e.name, set()).add(e.thread)
        assert threads["wal.write"] and threads["wal.fsync"]
        assert threads["storm.durable_drain"]
        # The writer's ranges lie on the writer's thread.
        assert threads["wal.fsync"].isdisjoint(
            threads["storm.durable_drain"])
    finally:
        storm._group_wal.close()


def _backends(tmp_path):
    """(log, its path) of each OpLog backend this machine has."""
    out = [(native._PythonOpLog, tmp_path / "py.log")]
    if native.native_available():
        out.append((native._NativeOpLog, tmp_path / "native.log"))
    return [(kind(str(path)), path) for kind, path in out]


def test_record_len_reads_the_index(tmp_path):
    for log, _path in _backends(tmp_path):
        for n in (0, 5, 300):
            log.append(b"z" * n)
        assert [log.record_len(i) for i in range(3)] == [0, 5, 300]
        with pytest.raises(IndexError):
            log.record_len(3)
        log.close()


def test_append_parts_writes_the_joined_record(tmp_path):
    """A record appended as parts (contiguous or not, empty or not) is the
    record of their join, byte for byte in the file, on each backend."""
    arr = np.arange(10, dtype=np.uint32)
    parts = [b"head", arr, memoryview(arr)[2:5], b"",
             np.arange(12, dtype=np.uint32).reshape(3, 4)[:, 1]]
    joined = b"".join(bytes(p) for p in parts)
    files = []
    for log, path in _backends(tmp_path):
        assert log.append_parts(parts) == 0
        assert log.append(joined) == 1
        assert bytes(log.read(0)) == bytes(log.read(1)) == joined
        log.sync()
        log.close()
        data = path.read_bytes()
        half = len(data) // 2
        assert data[:half] == data[half:]
        files.append(data)
    assert all(f == files[0] for f in files)


def test_rewrite_reads_only_the_records_it_keeps(tmp_path):
    for log, path in _backends(tmp_path):
        for n in range(6):
            log.append(bytes([n]) * (100 + n))
        read = []
        real = log.read
        log.read = lambda i: read.append(i) or real(i)
        seen = []

        def transform(idx, length):
            seen.append((idx, length))
            return b"f" if idx % 2 else None
        fresh, changed = rewrite_oplog_records(log, path, transform)
        assert changed == 3 and read == [0, 2, 4]
        assert seen == [(i, 100 + i) for i in range(6)]
        assert [bytes(fresh.read(i)) for i in range(6)] == [
            b"f" if i % 2 else bytes([i]) * (100 + i) for i in range(6)]
        fresh.close()


def test_trim_reads_no_trimmed_blob(tmp_path, monkeypatch):
    storm, clients = _controller(tmp_path)
    try:
        _serve(storm, clients, 4, [])
        want = storm._group_wal.read(3)
        read = []
        log = storm._group_wal._log
        real = log.read
        monkeypatch.setattr(log, "read",
                            lambda i: read.append(i) or real(i))
        assert storm.trim_tick_blobs({0, 1, 2}) == 3
        assert read == [3]
        assert storm._group_wal.read(3) == want
        headers = [storm._parse_header(storm._read_blob(t))[0]
                   for t in range(4)]
        assert [h["docs"] == [] for h in headers] == [True] * 3 + [False]
    finally:
        storm._group_wal.close()

