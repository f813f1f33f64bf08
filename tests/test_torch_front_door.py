"""The port's front door and its native hops — ``native/fanout``,
``native/shuttle`` with ``server/native_bus.py``, and ``server/alfred.py``
— against the JAX package's, on the CPU.

The deli's trace breadcrumbs and the service clock are pinned on each
side. The cases of ``tests/test_fanout.py`` and ``tests/test_native_bus.py``
run once per package (the same implementation class on each side) and
must observe the same things. Alfred is held to the reference over real
localhost sockets: each package's ``AlfredServer`` serves an assembly
with a pinned service clock on an event-loop thread, one scripted raw
client drives it, and every frame the client reads must be byte-equal
(storm acks are compared by rid and rows: their ``dw`` is thread-timed).
Where a case drives a client stack, it runs twice: once with the
reference's JAX-free client (``drivers/local_driver``,
``drivers/network_driver``, ``runtime/container``, ``dds/map``) against
each package's server, and once (``*_own_client``) with each package's
own client against its own server.
"""

from __future__ import annotations

import asyncio
import itertools
import os
import random
import socket
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from fluidframework_tpu.dds.map import SharedMap
from fluidframework_tpu.drivers.local_driver import LocalDocumentService
from fluidframework_tpu.native import fanout as j_fanout
from fluidframework_tpu.protocol import codec as j_codec
from fluidframework_tpu.protocol import messages as j_messages
from fluidframework_tpu.protocol.messages import DocumentMessage, MessageType
from fluidframework_tpu.runtime.container import Container
from fluidframework_tpu.server import alfred as j_alfred
from fluidframework_tpu.server import bus as j_bus
from fluidframework_tpu.server import durable_store as j_ds
from fluidframework_tpu.server import kernel_host as j_kh
from fluidframework_tpu.server import merge_host as j_mh
from fluidframework_tpu.server import native_bus as j_nbus
from fluidframework_tpu.server import read_replica as j_rr
from fluidframework_tpu.server import routerlicious as j_rl
from fluidframework_tpu.server import sequencer as j_seq
from fluidframework_tpu.server import storm as j_storm
from fluidframework_tpu_torch.dds.map import SharedMap as t_SharedMap
from fluidframework_tpu_torch.drivers import network_driver as t_network
from fluidframework_tpu_torch.drivers.local_driver import (
    LocalDocumentService as t_LocalDocumentService)
from fluidframework_tpu_torch.native import fanout as t_fanout
from fluidframework_tpu_torch.protocol import codec as t_codec
from fluidframework_tpu_torch.protocol import messages as t_messages
from fluidframework_tpu_torch.server import alfred as t_alfred
from fluidframework_tpu_torch.server import bus as t_bus
from fluidframework_tpu_torch.server import durable_store as t_ds
from fluidframework_tpu_torch.server import kernel_host as t_kh
from fluidframework_tpu_torch.server import merge_host as t_mh
from fluidframework_tpu_torch.server import native_bus as t_nbus
from fluidframework_tpu_torch.server import read_replica as t_rr
from fluidframework_tpu_torch.server import routerlicious as t_rl
from fluidframework_tpu_torch.server import sequencer as t_seq
from fluidframework_tpu_torch.runtime.container import (
    Container as t_Container)
from fluidframework_tpu_torch.server import storm as t_storm

PKG = {
    "jax": SimpleNamespace(
        fanout=j_fanout, codec=j_codec, messages=j_messages,
        alfred=j_alfred, bus=j_bus, ds=j_ds, kh=j_kh,
        mh=j_mh, nbus=j_nbus, rr=j_rr, rl=j_rl,
        seq=j_seq, storm=j_storm, dev={},
        module="fluidframework_tpu.server.alfred"),
    "torch": SimpleNamespace(
        fanout=t_fanout, codec=t_codec, messages=t_messages,
        alfred=t_alfred, bus=t_bus, ds=t_ds, kh=t_kh,
        mh=t_mh, nbus=t_nbus, rr=t_rr, rl=t_rl,
        seq=t_seq, storm=t_storm, dev={"device": "cpu"},
        module="fluidframework_tpu_torch.server.alfred"),
}
SIDES = ("jax", "torch")


def client_stack(side: str, own: bool) -> SimpleNamespace:
    """The client a case drives against ``side``'s server: the
    reference's, or (``own``) the package's own."""
    if own and side == "torch":
        return SimpleNamespace(
            Container=t_Container, LocalDocumentService=t_LocalDocumentService,
            SharedMap=t_SharedMap, network=t_network)
    from fluidframework_tpu.drivers import network_driver
    return SimpleNamespace(
        Container=Container, LocalDocumentService=LocalDocumentService,
        SharedMap=SharedMap, network=network_driver)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def both(scenario, *args, **kw):
    """Run ``scenario(side, ...)`` for each package; the records must be
    equal. Returns the port's record. The deli's trace breadcrumbs read
    the host's monotonic clock: each side runs with it pinned."""
    got = {}
    for side in SIDES:
        mod = PKG[side].messages
        saved = mod.time
        mod.time = SimpleNamespace(monotonic=itertools.count(1).__next__)
        try:
            got[side] = scenario(side, *args, **kw)
        finally:
            mod.time = saved
    assert got["torch"] == got["jax"]
    return got["torch"]


def pin(service):
    service._clock = itertools.count(1000, 7).__next__
    return service


# -- the fan-out service (tests/test_fanout.py) -------------------------------


def _fanout(side, impl):
    mod = PKG[side].fanout
    if impl == "python":
        return mod.PyFanout()
    fan = mod.make_fanout()
    assert fan.is_native, "the native fan-out must build here"
    return fan


def _rooms_fifo_and_membership(f):
    a, b = f.connect(), f.connect()
    f.join(a, "doc1")
    f.join(b, "doc1")
    f.join(b, "doc2")
    out = [f.publish("doc1", b"m1"), f.publish("doc2", b"m2"),
           f.publish("nobody-home", b"m3"), f.pending(a), f.poll(a),
           f.poll(a), f.poll(b), f.poll(b)]
    f.leave(a, "doc1")
    out += [f.publish("doc1", b"m4"), f.poll(b)]
    assert out == [2, 1, 0, 1, b"m1", None, b"m1", b"m2", 1, b"m4"]
    return out


def _disconnect_cleans_rooms_and_queue(f):
    a = f.connect()
    f.join(a, "doc")
    f.publish("doc", b"x")
    f.disconnect(a)
    out = [f.poll(a), f.publish("doc", b"y")]
    with pytest.raises(KeyError):
        f.join(a, "doc")
    assert out == [None, 0]
    return out


def _empty_payload_drains(f):
    a = f.connect()
    f.join(a, "empty-room")
    f.publish("empty-room", b"")
    f.publish("empty-room", b"after")
    out = [f.poll(a), f.poll(a), f.poll(a)]
    f.disconnect(a)
    assert out == [b"", b"after", None]
    return out


def _large_payload_roundtrip(f):
    a = f.connect()
    f.join(a, "big")
    payload = bytes(range(256)) * 4096  # 1 MiB binary
    out = [f.publish("big", payload), f.poll(a) == payload]
    assert out == [1, True]
    return out


def _delivered_total(f):
    before = f.delivered_total()
    a, b = f.connect(), f.connect()
    f.join(a, "r")
    f.join(b, "r")
    f.publish("r", b"z")
    assert f.delivered_total() == before + 2
    return [before, f.delivered_total()]


def _room_membership_under_churn(f):
    rooms_before = f.room_count()
    subs = [f.connect() for _ in range(8)]
    for i, sub in enumerate(subs):
        f.join(sub, "churn-a")
        if i % 2:
            f.join(sub, "churn-b")
    out = [f.room_size("churn-a"), f.room_size("churn-b"),
           f.room_count() - rooms_before]
    f.leave(subs[0], "churn-a")
    f.disconnect(subs[1])
    f.join(subs[0], "churn-b")
    out += [f.room_size("churn-a"), f.room_size("churn-b")]
    f.disconnect(subs[2])
    out += [f.publish("churn-a", b"alive"), f.poll(subs[3])]
    with pytest.raises(KeyError):
        f.join(subs[1], "churn-a")
    out.append(f.poll(subs[1]))
    for sub in subs:
        f.leave(sub, "churn-a")
        f.disconnect(sub)
    out += [f.room_size("churn-a"), f.room_size("churn-b"),
            f.room_count() - rooms_before, f.publish("churn-a", b"nobody")]
    assert out == [8, 4, 2, 6, 4, 5, b"alive", None, 0, 0, 0, 0]
    return out


def _per_subscriber_queue_limit(f):
    viewer, writer = f.connect(), f.connect()
    f.join(viewer, "lim")
    f.join(writer, "lim")
    f.set_queue_limit(viewer, 3)
    for i in range(5):
        f.publish("lim", b"m%d" % i)
    out = [f.was_evicted(viewer), f.was_evicted(writer), f.pending(writer)]
    with pytest.raises(KeyError):
        f.set_queue_limit(viewer, None)
    fresh = f.connect()
    f.join(fresh, "lim")
    f.set_queue_limit(fresh, 2)
    f.set_queue_limit(fresh, None)
    for _ in range(4):
        f.publish("lim", b"x")
    out.append(f.was_evicted(fresh))
    for sub in (viewer, writer, fresh):
        f.disconnect(sub)
    assert out == [True, False, 5, False]
    return out


def _publish_batch_matches_sequential_publishes(f):
    a, b = f.connect(), f.connect()
    f.join(a, "batch-1")
    f.join(b, "batch-1")
    f.join(b, "batch-2")
    out = [f.publish_batch([
        ("batch-1", b"\x00storm1:8:1"), ("batch-2", b"\x00storm9:16:2"),
        ("batch-empty-room", b"zzz"), ("batch-1", b"")])]
    out += [f.poll(a), f.poll(a)] + [f.poll(b) for _ in range(3)]
    out.append(f.publish_batch([]))
    f.disconnect(a)
    f.disconnect(b)
    assert out == [5, b"\x00storm1:8:1", b"", b"\x00storm1:8:1",
                   b"\x00storm9:16:2", b"", 0]
    return out


def _slow_consumer_evicted(f, limit):
    slow, ok = f.connect(), f.connect()
    f.join(slow, "room")
    f.join(ok, "room")
    for _ in range(limit + 2):
        f.publish("room", b"p")
        assert f.poll(ok) is not None, "healthy subscriber starved"
    out = [f.was_evicted(slow), f.was_evicted(ok), f.poll(slow),
           f.publish("room", b"tail"), f.poll(ok)]
    f.disconnect(slow)
    out.append(f.was_evicted(slow))
    assert out == [True, False, None, 1, b"tail", False]
    return out


FANOUT_CASES = {
    "rooms_fifo_and_membership": _rooms_fifo_and_membership,
    "disconnect_cleans_rooms_and_queue": _disconnect_cleans_rooms_and_queue,
    "empty_payload_drains": _empty_payload_drains,
    "large_payload_roundtrip": _large_payload_roundtrip,
    "delivered_total": _delivered_total,
    "room_membership_under_churn": _room_membership_under_churn,
    "per_subscriber_queue_limit": _per_subscriber_queue_limit,
    "publish_batch_matches_sequential_publishes":
        _publish_batch_matches_sequential_publishes,
    "slow_consumer_evicted": None,
}


@pytest.mark.parametrize("impl", ["python", "native"])
@pytest.mark.parametrize("case", list(FANOUT_CASES))
def test_fanout_case_matches_reference(case, impl):
    def scenario(side):
        f = _fanout(side, impl)
        if case == "slow_consumer_evicted":
            return _slow_consumer_evicted(f, PKG[side].fanout.MAX_QUEUE)
        return FANOUT_CASES[case](f)

    both(scenario)


def test_native_fanout_builds_here():
    fan = t_fanout.make_fanout()
    assert fan.is_native
    assert not t_fanout.make_fanout(force_python=True).is_native
    assert t_fanout.MAX_QUEUE == j_fanout.MAX_QUEUE


def _make_doc(service, doc_id, C):
    container = C.Container.create_detached(
        C.LocalDocumentService(service, doc_id))
    ds = container.runtime.create_datastore("default")
    ds.create_channel("root", C.SharedMap.channel_type)
    container.attach()
    return container


def _broadcast_through_fanout(force_python, own):
    def scenario(side):
        P, C = PKG[side], client_stack(side, own)
        service = pin(P.rl.RouterliciousService(
            fanout=P.fanout.make_fanout(force_python)))
        assert service.fanout.is_native is (not force_python)
        c1 = _make_doc(service, "doc", C)
        c2 = C.Container.load(C.LocalDocumentService(service, "doc"))
        m1 = c1.runtime.get_datastore("default").get_channel("root")
        m2 = c2.runtime.get_datastore("default").get_channel("root")
        m1.set("x", 1)
        m2.set("y", 2)
        assert m1.get("y") == 2 and m2.get("x") == 1
        delivered = service.fanout.delivered_total()
        assert delivered > 0
        c2.close()
        m1.set("z", 3)
        assert m1.get("z") == 3
        return [delivered, service.fanout.delivered_total(),
                sorted(m1.items()), c1.summarize()]

    both(scenario)


@pytest.mark.parametrize("force_python", [True, False])
def test_service_broadcast_through_fanout(force_python):
    _broadcast_through_fanout(force_python, own=False)


@pytest.mark.parametrize("force_python", [True, False])
def test_service_broadcast_through_fanout_own_client(force_python):
    _broadcast_through_fanout(force_python, own=True)


# -- the shuttle bus (tests/test_native_bus.py) -------------------------------


def test_shuttle_bus_differential_against_python_bus():
    def scenario(side):
        P = PKG[side]
        rng = random.Random(0)
        native, python = P.nbus.NativeMessageBus(), P.bus.MessageBus()
        for bus in (native, python):
            bus.create_topic("t", num_partitions=4)
        keys = [f"doc-{i}" for i in range(10)]
        produced = []
        for step in range(300):
            key = rng.choice(keys)
            value = {"step": step, "payload": rng.randrange(1000)}
            got = native.produce("t", key, value)
            assert got == python.produce("t", key, value)
            produced.append(got)
        logs = []
        for partition in range(4):
            got = [(m.offset, m.key, m.value)
                   for m in native.topic("t").read(partition, 0)]
            assert got == [(m.offset, m.key, m.value)
                           for m in python.topic("t").read(partition, 0)]
            logs.append(got)
        return produced, logs

    both(scenario)


def test_shuttle_partitioner_matches_crc32():
    def scenario(side):
        P = PKG[side]
        bus = P.nbus.NativeMessageBus()
        bus.create_topic("t", num_partitions=8)
        out = []
        for key in ("a", "doc-123", "ü-unicode", ""):
            pid, _ = bus.produce("t", key, {"v": 1})
            assert pid == P.bus.partition_for(key, 8)
            out.append(pid)
        return out

    both(scenario)


def test_shuttle_consumer_group_offsets_independent():
    def scenario(side):
        P = PKG[side]
        bus = P.nbus.NativeMessageBus()
        bus.create_topic("t", num_partitions=1)
        for i in range(5):
            bus.produce("t", "k", i)
        a = P.bus.Consumer(bus, "t", "group-a")
        b = P.bus.Consumer(bus, "t", "group-b")
        out = [[m.value for m in a.poll(0)]]
        a.commit(0, 3)
        out += [[m.value for m in a.poll(0)], [m.value for m in b.poll(0)],
                [m.value for m in a.poll(0, max_messages=1)]]
        assert out == [[0, 1, 2, 3, 4], [3, 4], [0, 1, 2, 3, 4], [3]]
        return out

    both(scenario)


def test_shuttle_wire_codec_roundtrips_protocol_objects():
    def scenario(side):
        P = PKG[side]
        bus = P.nbus.NativeMessageBus()
        bus.create_topic("t", num_partitions=2)
        raw = P.seq.RawOperation(client_id="c1", type=MessageType.OPERATION,
                                 client_seq=1, ref_seq=0, timestamp=5,
                                 contents={"x": [1, 2]})
        pid, off = bus.produce("t", "doc", raw)
        message = bus.topic("t").read(pid, 0)[0]
        assert message.value == raw
        return [pid, off, P.codec.to_wire(message.value)]

    both(scenario)


def _end_to_end_on_native_bus(own):
    def scenario(side):
        P, C = PKG[side], client_stack(side, own)
        bus = P.nbus.make_message_bus()
        assert isinstance(bus, P.nbus.NativeMessageBus)
        service = pin(P.rl.RouterliciousService(bus=bus))
        c1 = _make_doc(service, "doc", C)
        ds = c1.runtime.get_datastore("default")
        c2 = C.Container.load(C.LocalDocumentService(service, "doc"))
        ds.get_channel("root").set("a", 1)
        c2.runtime.get_datastore("default").get_channel("root").set("b", 2)
        root1 = ds.get_channel("root")
        root2 = c2.runtime.get_datastore("default").get_channel("root")
        assert dict(root1.items()) == dict(root2.items()) == \
            {"a": 1, "b": 2}
        assert c1.summarize() == c2.summarize()
        return [c1.summarize(), [P.codec.to_wire(m) for m in
                                 service.get_deltas("doc", 0)]]

    both(scenario)


def test_service_end_to_end_on_native_bus():
    _end_to_end_on_native_bus(own=False)


def test_service_end_to_end_on_native_bus_own_client():
    _end_to_end_on_native_bus(own=True)


# -- alfred over a real localhost socket --------------------------------------


class Door:
    """One package's ``AlfredServer`` on its own event-loop thread; its
    clients are closed before the server (a closing server waits for its
    connections)."""

    def __init__(self, side, service):
        self.P = PKG[side]
        self.clients: list[Client] = []
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.server = self.P.alfred.AlfredServer(service, "127.0.0.1", 0)
        self.port = self.run(self.server.start())

    def run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(60)

    def call(self, fn):
        """Run ``fn()`` on the loop's thread (service state lives there)."""
        async def wrap():
            return fn()
        return self.run(wrap())

    def client(self):
        self.clients.append(Client(self.P, self.port))
        return self.clients[-1]

    def close(self):
        for c in self.clients:
            c.close()
        self.run(self.server.close())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


class Client:
    """A blocking raw-frame client: every frame it reads is kept."""

    def __init__(self, P, port):
        self.P = P
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=60)
        self.rid = 0
        self.frames: list[bytes] = []

    def send(self, body: bytes) -> None:
        self.sock.sendall(self.P.codec.frame_body(body))

    def read(self) -> bytes:
        body = self.P.alfred.read_frame_raw_sync(self.sock)
        self.frames.append(body)
        return body

    def decode(self, body):
        codec = self.P.codec
        if codec.is_storm_body(body):
            return codec.decode_storm_push(body)
        return codec.decode_body(body)

    def call(self, op, **kw):
        """One request; reads frames up to its response (events pushed
        before it stay in ``frames``)."""
        self.rid += 1
        rid = self.rid
        self.send(self.P.codec.encode_body({"rid": rid, "op": op, **kw}))
        while True:
            msg = self.decode(self.read())
            if isinstance(msg, dict) and msg.get("rid") == rid \
                    and not msg.get("storm"):
                return msg

    def close(self):
        self.sock.close()


def _doc_message(cseq, contents, P=None):
    cls = DocumentMessage if P is None else P.messages.DocumentMessage
    return cls(type=MessageType.OPERATION, contents=contents,
               client_sequence_number=cseq, reference_sequence_number=0)


def test_alfred_json_session_frames_match_reference():
    """The per-op path over the socket: writer connect, submits, signal,
    snapshot upload and read, get_deltas, a viewer's hello and its live
    ``ops`` stream, ``viewer_resume``, an unknown op and disconnects —
    every frame byte-equal between the two packages' front doors."""
    def scenario(side):
        P = PKG[side]
        service = pin(P.alfred.build_default_service(merge_host=False,
                                                     native_fanout=True,
                                                     **P.dev))
        door = Door(side, service)
        try:
            writer, viewer = door.client(), door.client()
            hello_w = writer.call("connect", doc_id="wdoc")
            hello_v = viewer.call("connect", doc_id="wdoc", mode="viewer")
            assert hello_v["viewer"] is True
            for i in range(3):
                writer.call("submit", messages=[
                    _doc_message(i + 1, {"k": i}, P)])
            writer.call("signal", content={"cursor": 3})
            writer.call("upload_snapshot", snapshot={"tree": {"a": 1}})
            writer.call("get_latest_snapshot")
            deltas = writer.call("get_deltas", from_seq=0)
            assert [m.sequence_number for m in deltas["messages"]] \
                == [1, 2, 3, 4]
            writer.call("no_such_op")
            door.call(lambda: service.viewers.drain_all())
            resumed = viewer.call("viewer_resume")
            assert resumed["seq"] == 4
            viewer.call("disconnect")
            writer.call("disconnect")
            return [hello_w, writer.frames, viewer.frames]
        finally:
            door.close()

    both(scenario)


def _storm_service(P, docs):
    seq_host = P.kh.KernelSequencerHost(num_slots=2,
                                        initial_capacity=max(4, len(docs)),
                                        **P.dev)
    merge_host = P.mh.KernelMergeHost(flush_threshold=10**9, **P.dev)
    service = pin(P.rl.RouterliciousService(merge_host=merge_host,
                                            batched_deli_host=seq_host,
                                            auto_pump=False))
    storm = P.storm.StormController(service, seq_host, merge_host,
                                    flush_threshold_docs=10**9)
    return service, storm


def _storm_words(seed, k):
    rng = np.random.default_rng(seed)
    kinds = rng.choice([0, 0, 0, 1], size=k).astype(np.uint32)
    slots = rng.integers(0, 16, k).astype(np.uint32)
    vals = rng.integers(0, 1 << 20, k).astype(np.uint32)
    return (kinds | (slots << 2) | (vals << 12)).astype(np.uint32)


def test_alfred_storm_frames_viewers_and_read_redirect(tmp_path):
    """The storm path over the socket (the front door's chip phase in
    miniature): one client submits binary storm frames for every doc and
    ``storm_flush``; viewers connected over the socket receive each tick's
    frame byte-equal to the in-process ``encode_viewer_tick_body``; a
    socket ``get_deltas`` equals the in-process call; and a viewer dialing
    a directory-assigned doc answers ``moved`` with the replica's label."""
    docs = [f"doc-{i}" for i in range(4)]
    K = 8

    def scenario(side):
        P = PKG[side]
        service, storm = _storm_service(P, docs)
        clients = {d: service.connect(d, lambda m: None).client_id
                   for d in docs}
        service.pump()
        git = P.ds.GitSnapshotStore(str(tmp_path / side / "git"))
        directory = P.rr.ReplicaDirectory(git)
        directory.register("replica0")
        directory.assign_room("doc-3", ["replica0"])
        service.read_router = P.rr.ReplicaRouter(directory,
                                                 local_label="hostA")
        door = Door(side, service)
        try:
            viewers = {d: door.client() for d in docs[:2]}
            for d, v in viewers.items():
                v.call("connect", doc_id=d, mode="viewer")
            moved = door.client().call("connect", doc_id="doc-3",
                                       mode="viewer")
            assert moved["error"] == "moved"
            assert moved["moved_to"] == "replica0"
            writer = door.client()
            acks, words_by_tick = [], []
            for t in range(2):
                entries = [[d, clients[d], 1 + t * K, 1, K] for d in docs]
                words = [_storm_words([t, i], K) for i in range(len(docs))]
                words_by_tick.append(words)
                writer.send(P.codec.encode_storm_body(
                    {"rid": t, "docs": entries},
                    b"".join(w.tobytes() for w in words)))
                writer.call("storm_flush")
            for body in writer.frames:
                msg = writer.decode(body)
                if isinstance(msg, dict) and msg.get("storm"):
                    acks.append([msg["rid"], msg["acks"]])
            assert [a[0] for a in acks] == [0, 1]
            deltas = writer.call("get_deltas", doc_id="doc-0", from_seq=0)
            local = door.call(lambda: service.get_deltas("doc-0", 0))
            assert P.codec.encode_body(deltas["messages"]) \
                == P.codec.encode_body(local)
            ticks = {}
            for i, (d, v) in enumerate(viewers.items()):
                got = [b for b in v.frames if P.codec.is_storm_body(b)]
                while len(got) < 2:
                    body = v.read()
                    if P.codec.is_storm_body(body):
                        got.append(body)
                want = []
                for t in range(2):
                    n, first, last, msn = acks[t][1][i]
                    want.append(bytes(P.codec.encode_viewer_tick_body(
                        d, n, first, last, msn, K,
                        words_by_tick[t][i].tobytes())))
                assert [bytes(b) for b in got] == want
                ticks[d] = got
            return [acks, ticks, P.codec.encode_body(deltas["messages"]),
                    moved, service.viewers.stats]
        finally:
            door.close()

    both(scenario)


def _spawn_alfred(module, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    proc = subprocess.Popen([sys.executable, "-m", module, "--port", "0",
                             *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)
    line = proc.stdout.readline()
    if not line.startswith("READY "):
        proc.kill()
        raise AssertionError((line, proc.stderr.read()))
    return proc, int(line.split()[1])


def _viewer_stream_over_the_wire(own):
    import time

    def scenario(side):
        net = client_stack(side, own).network
        NetworkDocumentService, ViewerStream = (net.NetworkDocumentService,
                                                net.ViewerStream)
        proc, port = _spawn_alfred(PKG[side].module, "--no-merge-host")
        try:
            svc = NetworkDocumentService("127.0.0.1", port, "live-doc")
            stream = ViewerStream(svc)
            hello = stream.connect()
            assert hello["viewer"] is True
            assert hello["client_id"].startswith("viewer-")
            writer_svc = NetworkDocumentService("127.0.0.1", port,
                                                "live-doc")
            writer = writer_svc.connect(lambda m: None)
            writer.submit([_doc_message(1, {"k": 1},
                                        PKG[side] if own else None)])
            deadline = time.monotonic() + 30
            while stream.stats["ops"] == 0 \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            assert stream.stats["ops"] >= 1
            assert stream.last_seq >= 1
            stream.lagged = True
            stream.last_seq = 0
            caught_up = stream.resync()
            seqs = [m.sequence_number for m in caught_up]
            assert seqs
            assert not stream.lagged
            writer_svc.close()
            svc.close()
            return [sorted(hello), hello["client_id"], seqs]
        finally:
            proc.terminate()
            proc.wait(timeout=10)

    both(scenario)


def test_viewer_stream_over_the_wire():
    """tests/test_broadcaster.py's wire case against each package's
    standalone front door: a ``mode="viewer"`` hello, the live ``ops``
    stream, and the ``get_deltas`` + ``viewer_resume`` resync dance,
    through the reference's network driver."""
    _viewer_stream_over_the_wire(own=False)


def test_viewer_stream_over_the_wire_own_client():
    """The same through each package's own network driver."""
    _viewer_stream_over_the_wire(own=True)


def test_standalone_alfred_with_native_hops_on_cpu():
    """``python -m fluidframework_tpu_torch.server.alfred --cadence-ms 10
    --native-fanout --native-bus`` (here with ``--device cpu``): both
    kernel hosts on the asked device, the bus and the fan-out the native
    libraries, and a writer and a viewer served
    over raw frames, as the reference's standalone door serves them."""
    def scenario(side):
        P = PKG[side]
        args = ["--cadence-ms", "10", "--native-fanout", "--native-bus"]
        if side == "torch":
            args += ["--device", "cpu"]
        proc, port = _spawn_alfred(P.module, *args)
        try:
            if side == "torch":
                assert proc.stdout.readline().split() \
                    == ["DEVICE", "cpu", "cpu"]
                assert proc.stdout.readline().split() \
                    == ["HOPS", "NativeMessageBus", "NativeFanout"]
            writer, viewer = Client(P, port), Client(P, port)
            writer.call("connect", doc_id="sdoc")
            viewer.call("connect", doc_id="sdoc", mode="viewer")
            for i in range(4):
                writer.call("submit", messages=[
                    _doc_message(i + 1, {"k": i}, P)])
            deadline = 200
            while True:
                got = writer.call("get_deltas", from_seq=0)["messages"]
                if len(got) == 5 or not deadline:
                    break
                deadline -= 1
                threading.Event().wait(0.05)
            ops = []
            while len(ops) < 4:
                msg = viewer.decode(viewer.read())
                if isinstance(msg, dict) and msg.get("event") == "ops":
                    ops += [m for m in msg["messages"]
                            if m.type == MessageType.OPERATION]
            writer.close()
            viewer.close()
            rows = [[m.sequence_number, m.client_sequence_number,
                     int(m.type), P.codec.to_wire(m.contents)]
                    for m in got]
            assert [r[1] for r in rows if r[2] == MessageType.OPERATION] \
                == [1, 2, 3, 4]
            return [rows, [[m.sequence_number, P.codec.to_wire(m.contents)]
                           for m in ops]]
        finally:
            proc.terminate()
            proc.wait(timeout=10)

    both(scenario)


def test_build_default_service_puts_both_hosts_on_the_device():
    service = t_alfred.build_default_service(batched_cadence=True,
                                             device="cpu")
    assert str(service.merge_host.device) == "cpu"
    assert str(service._batched_deli_host.device) == "cpu"
    assert service.viewers is not None
