"""The port's durable storage against the JAX package's: the CRC-framed
op log (native and Python), the group-commit WAL, the durable bus, the
state store and the content-addressed snapshot store.

Every case of ``tests/test_durable.py`` that exercises these modules runs
here as a differential: the same steps go through both packages
(``side``), and where the result is a file, the files each package
writes for the same records must be byte-equal and each must open the
other's.
"""

from __future__ import annotations

import importlib
import struct

import pytest

PACKAGES = {"jax": "fluidframework_tpu", "torch": "fluidframework_tpu_torch"}
SIDES = list(PACKAGES)


def native(side: str):
    return importlib.import_module(f"{PACKAGES[side]}.native")


def store(side: str):
    return importlib.import_module(f"{PACKAGES[side]}.server.durable_store")


def oplog(side: str, impl: str, path):
    """An op log of ``side`` by implementation: "native" (the g++-built
    library), "python" (the pure-Python twin) or "auto" (``OpLog``)."""
    mod = native(side)
    if impl == "native":
        assert mod.native_available()
        return mod._NativeOpLog(str(path))
    if impl == "python":
        return mod._PythonOpLog(str(path))
    return mod.OpLog(path)


def records(log) -> list[bytes]:
    return [bytes(log.read(i)) for i in range(len(log))]


def tree(root) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


IMPLS = ["native", "python"]


# -- op log ---------------------------------------------------------------------


@pytest.mark.parametrize("side", SIDES)
def test_native_toolchain_builds(side):
    assert native(side).native_available(), "g++ oplog build failed"


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("side", SIDES)
def test_append_read_reopen(tmp_path, side, impl):
    path = tmp_path / "a.log"
    log = oplog(side, impl, path)
    assert log.append(b"one") == 0
    assert log.append(b"two" * 1000) == 1
    log.sync()
    log.close()
    log = oplog(side, impl, path)
    assert len(log) == 2
    assert records(log) == [b"one", b"two" * 1000]
    log.close()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("side", SIDES)
def test_torn_tail_every_offset(tmp_path, side, impl):
    """Truncating inside the last frame at EVERY byte offset recovers
    exactly the complete records, and appends land on the cut tail."""
    path = tmp_path / "w.log"
    log = oplog(side, impl, path)
    log.append(b"first-record")
    log.append(b"second-record-" + b"x" * 40)
    log.close()
    full = path.read_bytes()
    probe = tmp_path / "probe.log"
    for cut in range(8 + len(b"first-record"), len(full)):
        probe.write_bytes(full[:cut])
        log = oplog(side, impl, probe)
        assert records(log) == [b"first-record"], cut
        log.append(b"post")
        assert log.read(1) == b"post"
        log.close()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("side", SIDES)
def test_corrupt_crc_truncates(tmp_path, side, impl):
    path = tmp_path / "a.log"
    log = oplog(side, impl, path)
    log.append(b"aaaa")
    log.append(b"bbbb")
    log.close()
    data = bytearray(path.read_bytes())
    data[-1] ^= 0xFF  # flip a byte in the last payload
    path.write_bytes(data)
    log = oplog(side, impl, path)
    assert records(log) == [b"aaaa"]
    log.close()


@pytest.mark.parametrize("side", SIDES)
def test_python_and_native_formats_interoperate(tmp_path, side):
    path = tmp_path / "x.log"
    py_log = oplog(side, "python", path)
    py_log.append(b"from-python")
    py_log.close()
    nat = oplog(side, "native", path)
    assert nat.read(0) == b"from-python"
    nat.append(b"from-native")
    nat.close()
    py_log = oplog(side, "python", path)
    assert records(py_log) == [b"from-python", b"from-native"]
    py_log.close()


PAYLOADS = [b"", b"a", b"\x00\xff" * 3000, bytes(range(256)) * 5]


@pytest.mark.parametrize("writer_impl", IMPLS)
def test_log_files_are_byte_equal_across_packages(tmp_path, writer_impl):
    """The port's log of the same records is the JAX log, byte for byte,
    and each package opens (and extends) the other's."""
    files = {}
    for side in SIDES:
        files[side] = tmp_path / f"{side}.log"
        log = oplog(side, writer_impl, files[side])
        for p in PAYLOADS:
            log.append(p)
        log.sync()
        log.close()
    assert files["torch"].read_bytes() == files["jax"].read_bytes()
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        for impl in IMPLS:
            log = oplog(reader, impl, files[writer])
            assert records(log) == PAYLOADS
            log.close()
        log = oplog(reader, "auto", files[writer])
        log.append(reader.encode())
        log.close()
    assert files["torch"].read_bytes() != files["jax"].read_bytes()
    for side in SIDES:
        log = oplog(side, "auto", files["jax"])
        assert records(log) == PAYLOADS + [b"torch"]
        log.close()


# -- group-commit WAL -------------------------------------------------------------


@pytest.mark.parametrize("side", SIDES)
def test_group_commit_watermark_callbacks_and_reopen(tmp_path, side):
    path = tmp_path / "g.log"
    log = store(side).GroupCommitLog(path)
    durable = []
    i0 = log.append(b"alpha", on_durable=durable.append)
    i1 = log.append([b"be", b"ta"], on_durable=durable.append)
    assert (i0, i1) == (0, 1)
    # Reads serve queued records without waiting for the fsync.
    assert log.read(1) == b"beta"
    log.sync()
    assert log.durable_len == 2
    assert sorted(durable) == [0, 1]
    log.close()
    log = store(side).GroupCommitLog(path)
    assert len(log) == 2 and log.durable_len == 2
    assert records(log) == [b"alpha", b"beta"]
    log.close()


@pytest.mark.parametrize("side", SIDES)
def test_group_commit_interoperates_with_plain_oplog(tmp_path, side):
    path = tmp_path / "g.log"
    log = store(side).GroupCommitLog(path)
    log.append(b"from-group")
    log.sync()
    log.close()
    plain = oplog(side, "auto", path)
    assert plain.read(0) == b"from-group"
    plain.append(b"from-plain")
    plain.close()
    log = store(side).GroupCommitLog(path)
    assert records(log) == [b"from-group", b"from-plain"]
    log.close()


def test_group_commit_files_are_byte_equal_across_packages(tmp_path):
    """The same multi-part records through each package's writer thread
    make the same file, and each package's writer reopens the other's."""
    for side in SIDES:
        log = store(side).GroupCommitLog(tmp_path / f"{side}.log")
        for i in range(20):
            log.append([struct.pack("<I", i), b"w" * (i * 37)])
        log.sync()
        log.close()
    jax_bytes = (tmp_path / "jax.log").read_bytes()
    assert (tmp_path / "torch.log").read_bytes() == jax_bytes
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        log = store(reader).GroupCommitLog(tmp_path / f"{writer}.log")
        assert log.durable_len == 20
        assert log.read(7) == struct.pack("<I", 7) + b"w" * 259
        log.close()


@pytest.mark.parametrize("side", SIDES)
def test_group_commit_fsync_failure_opens_and_heals(tmp_path, side):
    """A failed fsync opens the breaker (the barrier refuses instead of
    waiting), keeps the batch queued and readable, and the half-open
    probe heals it; nothing is appended twice."""
    faults = importlib.import_module(f"{PACKAGES[side]}.utils.faults")
    mod = store(side)
    log = mod.GroupCommitLog(tmp_path / "g.log",
                             breaker=mod.CircuitBreaker(cooldown_s=0.01))
    try:
        faults.install_failure("wal.fsync", times=2)
        faults.arm()
        log.append(b"held")
        import time
        deadline = time.monotonic() + 10
        while not log.breaker.is_open and time.monotonic() < deadline:
            time.sleep(0.002)
        assert log.breaker.is_open
        assert log.read(0) == b"held"
        while log.breaker.is_open and time.monotonic() < deadline:
            time.sleep(0.002)
        assert not log.breaker.is_open
        log.sync()
        assert log.durable_len == 1
        assert log.breaker.stats["opens"] >= 1
    finally:
        faults.clear()
        log.close()
    log = oplog(side, "auto", tmp_path / "g.log")
    assert records(log) == [b"held"]
    log.close()


@pytest.mark.parametrize("side", SIDES)
def test_commit_groups_partition_fsyncs(tmp_path, side):
    """Offsets never claim records the data log could lose: commit()
    syncs the dirty partition before journaling the offset."""
    bus = store(side).DurableMessageBus(tmp_path)
    bus.create_topic("t", 1)
    part = bus._topics["t"].partitions[0]
    for i in range(8):
        bus.produce("t", "doc", i)
    assert part.dirty
    bus.commit("t", "g", 0, 8)
    assert not part.dirty
    bus.close()


# -- durable bus and state store -------------------------------------------------


def _bus_script(bus) -> None:
    bus.create_topic("t", 2)
    bus.produce("t", "doc-a", {"n": 1})
    bus.produce("t", "doc-a", {"n": 2})
    bus.produce("t", "doc-b", [1, "two", None])
    bus.commit("t", "g", 0, 1)
    bus.commit("t", "g", 1, 1)


@pytest.mark.parametrize("side", SIDES)
def test_bus_produce_survives_reopen_with_offsets(tmp_path, side):
    bus = store(side).DurableMessageBus(tmp_path)
    _bus_script(bus)
    bus.close()
    bus = store(side).DurableMessageBus(tmp_path)
    topic = bus.create_topic("t", 2)
    msgs = [m for p in range(2) for m in topic.read(p, 0)]
    assert sorted(str(m.value) for m in msgs) == sorted(
        str(v) for v in ({"n": 1}, {"n": 2}, [1, "two", None]))
    assert [bus.committed("t", "g", p) for p in range(2)] == [1, 1]
    bus.close()


@pytest.mark.parametrize("side", SIDES)
def test_bus_partition_count_pinned_at_creation(tmp_path, side):
    bus = store(side).DurableMessageBus(tmp_path)
    bus.create_topic("t", 8)
    for i in range(16):
        bus.produce("t", f"doc-{i}", i)
    bus.close()
    bus = store(side).DurableMessageBus(tmp_path)
    topic = bus.create_topic("t", 4)
    assert topic.num_partitions == 8
    assert sorted(m.value for p in range(8) for m in topic.read(p, 0)) \
        == list(range(16))
    bus.close()


@pytest.mark.parametrize("side", SIDES)
def test_bus_offset_log_compacts(tmp_path, side):
    bus = store(side).DurableMessageBus(tmp_path)
    bus.OFFSET_COMPACT_THRESHOLD = 8
    bus.create_topic("t", 1)
    for i in range(200):
        bus.commit("t", "g", 0, i + 1)
    assert len(bus._offset_log) < 50
    bus.close()
    bus = store(side).DurableMessageBus(tmp_path)
    assert bus.committed("t", "g", 0) == 200
    bus.close()


def test_bus_directories_are_byte_equal_across_packages(tmp_path):
    for side in SIDES:
        bus = store(side).DurableMessageBus(tmp_path / side)
        _bus_script(bus)
        bus.close()
    assert tree(tmp_path / "torch") == tree(tmp_path / "jax")
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        bus = store(reader).DurableMessageBus(tmp_path / writer)
        topic = bus.create_topic("t", 2)
        assert sorted(str(m.value) for p in range(2)
                      for m in topic.read(p, 0)) == sorted(
            str(v) for v in ({"n": 1}, {"n": 2}, [1, "two", None]))
        assert [bus.committed("t", "g", p) for p in range(2)] == [1, 1]
        bus.close()


@pytest.mark.parametrize("side", SIDES)
def test_durable_partition_every_offset(tmp_path, side):
    mod = store(side)
    path = tmp_path / "t-0.log"
    part = mod._DurablePartition(path)
    part.append("doc-a", {"n": 1})
    part.append("doc-a", {"payload": "y" * 64})
    part.close()
    full = path.read_bytes()
    (first_len,) = struct.unpack_from("<I", full, 0)
    probe = tmp_path / "probe-0.log"
    for cut in range(8 + first_len, len(full)):
        probe.write_bytes(full[:cut])
        part = mod._DurablePartition(probe)
        assert [m.value for m in part.log] == [{"n": 1}], cut
        part.close()


def _state_script(st) -> None:
    st.put("a", {"x": 1})
    st.append("log", [1, 2])
    st.append("log", [3])
    st.put("a", {"x": 2})


@pytest.mark.parametrize("side", SIDES)
def test_state_store_put_append_reopen_compact(tmp_path, side):
    mod = store(side)
    st = mod.FileStateStore(tmp_path)
    _state_script(st)
    st.close()
    st = mod.FileStateStore(tmp_path)
    assert st.get("a") == {"x": 2} and st.get("log") == [1, 2, 3]
    st.compact()
    st.close()
    st = mod.FileStateStore(tmp_path)
    assert st.get("a") == {"x": 2} and st.get("log") == [1, 2, 3]
    assert st.keys() == ["a", "log"]
    st.close()


@pytest.mark.parametrize("side", SIDES)
def test_state_store_auto_compacts(tmp_path, side):
    st = store(side).FileStateStore(tmp_path)
    st.COMPACT_THRESHOLD = 16
    for i in range(500):
        st.put("clock", i)
    assert len(st._journal) < 100
    st.close()
    st = store(side).FileStateStore(tmp_path)
    assert st.get("clock") == 499
    st.close()


@pytest.mark.parametrize("compact", [False, True])
def test_state_store_files_are_byte_equal_across_packages(tmp_path, compact):
    for side in SIDES:
        st = store(side).FileStateStore(tmp_path / side)
        _state_script(st)
        if compact:
            st.compact()
        st.close()
    assert tree(tmp_path / "torch") == tree(tmp_path / "jax")
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        st = store(reader).FileStateStore(tmp_path / writer)
        assert st.get("a") == {"x": 2} and st.get("log") == [1, 2, 3]
        st.close()


# -- content-addressed snapshot store --------------------------------------------


SNAPSHOTS = [{"sequence_number": 5, "tree": {"k": "v" * 100_000}},
             {"sequence_number": 6, "tree": {"k": "v" * 100_000,
                                             "k2": list(range(50))}},
             {"kind": "storm-checkpoint", "tick_watermark": 3}]


@pytest.mark.parametrize("side", SIDES)
def test_snapshot_upload_get_head_dedup(tmp_path, side):
    git = store(side).GitSnapshotStore(tmp_path)
    snap = SNAPSHOTS[0]
    h1 = git.upload("doc", snap)
    h2 = git.upload("doc", snap)
    assert h1 == h2  # content-addressed dedup
    assert git.get("doc", h1) == snap
    assert git.head("doc") is None
    git.set_head("doc", h1)
    assert git.head("doc") == h1
    assert git.get("doc", "0" * 64) is None


@pytest.mark.parametrize("side", SIDES)
def test_snapshot_traversal_handles_rejected(tmp_path, side):
    git = store(side).GitSnapshotStore(tmp_path / "git")
    outside = tmp_path / "secret.json"
    outside.write_text('{"chunks": []}')
    for evil in ("../secret.json", "../../etc/passwd", "a/b",
                 "A" * 64, "", None, 5):
        assert git.get("doc", evil) is None


def test_snapshot_object_stores_are_byte_equal_across_packages(tmp_path):
    handles = {}
    for side in SIDES:
        git = store(side).GitSnapshotStore(tmp_path / side)
        handles[side] = [git.upload("doc", s) for s in SNAPSHOTS]
        git.set_head("doc", handles[side][1])
        git.release("doc", handles[side][0])
    assert handles["torch"] == handles["jax"]
    assert tree(tmp_path / "torch") == tree(tmp_path / "jax")
    for reader, writer in (("torch", "jax"), ("jax", "torch")):
        git = store(reader).GitSnapshotStore(tmp_path / writer)
        assert git.head("doc") == handles[writer][1]
        assert [git.get("doc", h) for h in handles[writer][1:]] \
            == SNAPSHOTS[1:]
