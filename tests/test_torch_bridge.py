"""The port's native front door — ``native/bridge.{cpp,py}`` and
``server/bridge_host.py`` — against the JAX package's, on the CPU.

The cases of ``tests/test_bridge.py`` and ``tests/test_native_smoke.py``
run against the port's door, driven by the reference's JAX-free client
(``drivers/tinylicious_driver``, ``runtime/container``, ``dds/map``) or
by raw frames; where their observations are deterministic they run once
per package and must be equal. Then the port's door is held to its own
other paths: a storm tick through the bridge acks exactly as an
in-process twin of the same stack, and a scripted request/response
session reads the same frames, byte for byte, over the bridge as over
the port's ``AlfredServer``. The deli's trace clock and the service
clock are pinned on each side.
"""

from __future__ import annotations

import asyncio
import hashlib
import itertools
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from fluidframework_tpu.dds.map import SharedMap
from fluidframework_tpu.drivers.tinylicious_driver import (
    TinyliciousDocumentServiceFactory,
)
from fluidframework_tpu.native import bridge as j_bridge
from fluidframework_tpu.native import fanout as j_fanout
from fluidframework_tpu.protocol import codec as j_codec
from fluidframework_tpu.protocol import messages as j_messages
from fluidframework_tpu.protocol.messages import MessageType
from fluidframework_tpu.runtime.container import Container
from fluidframework_tpu.server import alfred as j_alfred
from fluidframework_tpu.server import bridge_host as j_bh
from fluidframework_tpu.server import kernel_host as j_kh
from fluidframework_tpu.server import merge_host as j_mh
from fluidframework_tpu.server import routerlicious as j_rl
from fluidframework_tpu.server import storm as j_storm
from fluidframework_tpu_torch.native import _loader as t_loader
from fluidframework_tpu_torch.native import bridge as t_bridge
from fluidframework_tpu_torch.native import fanout as t_fanout
from fluidframework_tpu_torch.protocol import codec as t_codec
from fluidframework_tpu_torch.protocol import messages as t_messages
from fluidframework_tpu_torch.server import alfred as t_alfred
from fluidframework_tpu_torch.server import bridge_host as t_bh
from fluidframework_tpu_torch.server import kernel_host as t_kh
from fluidframework_tpu_torch.server import merge_host as t_mh
from fluidframework_tpu_torch.server import routerlicious as t_rl
from fluidframework_tpu_torch.server import storm as t_storm

PKG = {
    "jax": SimpleNamespace(
        bridge=j_bridge, fanout=j_fanout, codec=j_codec,
        messages=j_messages, alfred=j_alfred, bh=j_bh, kh=j_kh, mh=j_mh,
        rl=j_rl, storm=j_storm, dev={},
        module="fluidframework_tpu.server.bridge_host"),
    "torch": SimpleNamespace(
        bridge=t_bridge, fanout=t_fanout, codec=t_codec,
        messages=t_messages, alfred=t_alfred, bh=t_bh, kh=t_kh, mh=t_mh,
        rl=t_rl, storm=t_storm, dev={"device": "cpu"},
        module="fluidframework_tpu_torch.server.bridge_host"),
}
SIDES = ("jax", "torch")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def both(scenario, *args, **kw):
    """Run ``scenario(side, ...)`` for each package with the deli's trace
    clock pinned; the records must be equal. Returns the port's."""
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


def wait_for(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"{what} never held"
        time.sleep(0.01)


# -- the bridge library -------------------------------------------------------


def test_native_bridge_builds_from_the_ports_source():
    """g++ builds the port's own ``bridge.cpp`` into ``_build/native/``,
    named by the source's hash, and it starts a listener."""
    src = Path(t_bridge.__file__).with_name("bridge.cpp")
    assert src.read_bytes() == Path(j_bridge.__file__).with_name(
        "bridge.cpp").read_bytes()
    assert t_bridge._load_library() is not None
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    assert (t_loader._BUILD_DIR / f"libbridge.{digest}.so").exists()
    bridge = t_bridge.start_bridge()
    assert bridge is not None and bridge.port > 0
    bridge.stop()
    assert (t_bridge.EV_OPEN, t_bridge.EV_DATA, t_bridge.EV_CLOSE) == \
        (j_bridge.EV_OPEN, j_bridge.EV_DATA, j_bridge.EV_CLOSE) == (0, 1, 2)


def test_door_refuses_without_the_bridge(monkeypatch):
    """No toolchain, no door: the port raises rather than serving through
    another front door."""
    monkeypatch.setattr(t_bh, "start_bridge", lambda port=0: None)
    with pytest.raises(RuntimeError, match="native bridge unavailable"):
        t_bh.BridgeFrontDoor(t_rl.RouterliciousService())


def _echo(side):
    bridge = PKG[side].bridge.start_bridge()
    events = []
    try:
        with socket.create_connection(("127.0.0.1", bridge.port)) as sock:
            sock.sendall(len(b"hello").to_bytes(4, "big") + b"hello")
            data = None
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and data is None:
                event = bridge.poll(wait_ms=50)
                if event is None:
                    continue
                events.append(event[1])
                if event[1] == 1:
                    data = event
            assert data is not None and bytes(data[2]) == b"hello"
            rc = bridge.send(data[0], b"world")
            header = sock.recv(4)
            body = sock.recv(5)
        closed = False
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not closed:
            event = bridge.poll(wait_ms=50)
            closed = event is not None and event[1] == 2
        assert closed
        return [events, rc, int.from_bytes(header, "big"), body]
    finally:
        bridge.stop()


def test_bridge_echo_roundtrip():
    assert both(_echo) == [[0, 1], 0, 5, b"world"]


def _outbox_bound(side):
    bridge = PKG[side].bridge.start_bridge(0)
    try:
        viewer_sock = socket.create_connection(("127.0.0.1", bridge.port))
        writer_sock = socket.create_connection(("127.0.0.1", bridge.port))
        conns = []
        deadline = time.monotonic() + 15
        while len(conns) < 2 and time.monotonic() < deadline:
            ev = bridge.poll(wait_ms=50)
            if ev is not None and ev[1] == 0:
                conns.append(ev[0])
        viewer_conn, writer_conn = conns
        out = [bridge.set_conn_max_outbox(viewer_conn, 3),
               bridge.set_conn_max_outbox(999999, 3)]
        body = b"x" * 65536
        viewer_rc = writer_rc = 0
        for _ in range(64):
            if viewer_rc == 0:
                viewer_rc = bridge.send(viewer_conn, body)
            writer_rc = bridge.send(writer_conn, body)
            if viewer_rc == -2:
                break
        out += [viewer_rc, writer_rc,
                bridge.set_conn_max_outbox(viewer_conn, None)]
        viewer_sock.close()
        writer_sock.close()
        return out
    finally:
        bridge.stop()


def test_per_connection_outbox_bound_is_class_scoped():
    assert both(_outbox_bound) == [0, -1, -2, 0, 0]


# -- the door under the reference's client ------------------------------------


def _client_stack(side):
    P = PKG[side]
    service = pin(P.rl.RouterliciousService())
    front = P.bh.BridgeFrontDoor(service)
    try:
        factory = TinyliciousDocumentServiceFactory(port=front.port)
        svc1 = factory("bdoc")
        c1 = Container.create_detached(svc1)
        ds = c1.runtime.create_datastore("default")
        ds.create_channel("root", SharedMap.channel_type)
        with svc1.dispatch_lock:
            c1.attach()
            ds.get_channel("root").set("k", "via-bridge")
        wait_for(lambda: not c1.runtime.pending.has_pending, what="ack")
        svc2 = factory("bdoc")
        c2 = Container.load(svc2)
        with svc2.dispatch_lock:
            got = (c2.runtime.get_datastore("default")
                   .get_channel("root").get("k"))
        with svc1.dispatch_lock:
            ds.get_channel("root").set("k2", 7)

        def remote():
            with svc2.dispatch_lock:
                return (c2.runtime.get_datastore("default")
                        .get_channel("root").get("k2"))
        wait_for(lambda: remote() == 7, what="live broadcast")
        wait_for(lambda: not c1.runtime.pending.has_pending, what="ack")
        with svc1.dispatch_lock, svc2.dispatch_lock:
            out = [got, remote(), sorted(ds.get_channel("root").items()),
                   sorted(c2.runtime.get_datastore("default")
                          .get_channel("root").items())]
        svc1.close()
        svc2.close()
        return out
    finally:
        front.close()


def test_full_client_stack_over_bridge():
    rec = both(_client_stack)
    assert rec[:2] == ["via-bridge", 7]
    assert rec[2] == rec[3] == [("k", "via-bridge"), ("k2", 7)]


def _service_disconnect(side):
    P = PKG[side]
    service = pin(P.rl.RouterliciousService())
    front = P.bh.BridgeFrontDoor(service)
    try:
        factory = TinyliciousDocumentServiceFactory(port=front.port)
        svc = factory("dropdoc")
        c = Container.create_detached(svc)
        ds = c.runtime.create_datastore("default")
        ds.create_channel("root", SharedMap.channel_type)
        with svc.dispatch_lock:
            c.attach()
        client_id = c.delta_manager.client_id
        dropped = []
        svc.events.on("disconnect", lambda: dropped.append(True))
        service.disconnect("dropdoc", client_id)
        wait_for(lambda: dropped, 15, "the server-side drop")
        return [client_id is not None, dropped]
    finally:
        front.close()


def test_service_initiated_disconnect_drops_transport():
    assert both(_service_disconnect) == [True, [True]]


def test_stalled_reader_is_disconnected_not_silently_dropped():
    service = t_rl.RouterliciousService()
    front = t_bh.BridgeFrontDoor(service)
    try:
        front._bridge.set_max_outbox(4)
        sock = socket.create_connection(("127.0.0.1", front.port))
        sock.settimeout(30)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        body = b'{"rid": 1, "op": "connect", "doc_id": "slowdoc"}'
        sock.sendall(len(body).to_bytes(4, "big") + body)
        wait_for(lambda: any(s.connection is not None
                             for s in list(front._sessions.values())),
                 15, "the connect")
        session = next(iter(front._sessions.values()))
        payload = {"event": "signal", "signal": {"pad": "x" * 8192}}
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and session.connection is not None:
            session.push(payload)
        assert session.connection is None
        assert front.metrics.counter("bridge.slow_consumer_drops").value >= 1
        sock.settimeout(15)
        got = b"\x00"
        try:
            while got:
                got = sock.recv(65536)
        except (ConnectionResetError, socket.timeout):
            got = b""
        assert got == b""
        sock.close()
    finally:
        front.close()


def _spawn_door(module, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    proc = subprocess.Popen([sys.executable, "-m", module, "--port", "0",
                             *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    line = proc.stdout.readline()
    if not line.startswith("READY "):
        proc.kill()
        raise AssertionError((line, proc.stderr.read()))
    return proc, int(line.split()[1])


def test_bridge_standalone_service_on_cpu():
    """``python -m fluidframework_tpu_torch.server.bridge_host --device
    cpu``: READY, its merge host on the asked device, and the reference's
    client served through it as through the reference's standalone
    door."""
    def scenario(side):
        P = PKG[side]
        args = ["--device", "cpu"] if side == "torch" else []
        proc, port = _spawn_door(P.module, *args)
        try:
            if side == "torch":
                assert proc.stdout.readline().split() == ["DEVICE", "cpu"]
            factory = TinyliciousDocumentServiceFactory(port=port)
            svc = factory("sdoc")
            container = Container.create_detached(svc)
            ds = container.runtime.create_datastore("default")
            ds.create_channel("root", SharedMap.channel_type)
            with svc.dispatch_lock:
                container.attach()
                ds.get_channel("root").set("x", 1)
            wait_for(lambda: not container.runtime.pending.has_pending, 60,
                     "the standalone door's ack")
            with svc.dispatch_lock:
                got = ds.get_channel("root").get("x")
            svc.close()
            return got
        finally:
            proc.terminate()
            proc.wait(timeout=10)

    assert both(scenario) == 1


def test_standalone_door_defaults_to_the_card(monkeypatch):
    seen = {}

    def fake_build(data_dir=None, merge_host=True, device=None, **kw):
        seen["device"] = device
        raise SystemExit(0)

    monkeypatch.setattr(t_alfred, "build_default_service", fake_build)
    with pytest.raises(SystemExit):
        t_bh.main(["--port", "0"])
    assert seen["device"] == "cuda"


# -- one storm tick over both native components (test_native_smoke) -----------


def _read_frame(s):
    length = struct.unpack(">I", s.recv(4, socket.MSG_WAITALL))[0]
    return s.recv(length, socket.MSG_WAITALL)


def _storm_stack(P, docs, fanout=True, **storm_kw):
    seq_host = P.kh.KernelSequencerHost(num_slots=2,
                                        initial_capacity=max(4, len(docs)),
                                        **P.dev)
    merge_host = P.mh.KernelMergeHost(flush_threshold=10**9, **P.dev)
    service = pin(P.rl.RouterliciousService(
        merge_host=merge_host, batched_deli_host=seq_host, auto_pump=False,
        **({"fanout": P.fanout.make_fanout()} if fanout else {})))
    storm = P.storm.StormController(service, seq_host, merge_host,
                                    **storm_kw)
    return service, storm


def _native_smoke(side):
    P = PKG[side]
    codec = P.codec
    docs = ["smoke-a", "smoke-b"]
    service, storm = _storm_stack(P, docs, flush_threshold_docs=2)
    fanout = service.fanout
    assert isinstance(fanout, P.fanout.NativeFanout) and fanout.is_native
    front = P.bh.BridgeFrontDoor(service, 0)
    try:
        clients = {d: service.connect(d, lambda m: None).client_id
                   for d in docs}
        service.pump()
        subs = {d: fanout.connect() for d in docs}
        for d, sub in subs.items():
            fanout.join(sub, d)
        viewer_sock = socket.create_connection(("127.0.0.1", front.port))
        viewer_sock.settimeout(30)
        hello_req = json.dumps({"rid": 7, "op": "connect",
                                "doc_id": "smoke-a",
                                "mode": "viewer"}).encode()
        viewer_sock.sendall(len(hello_req).to_bytes(4, "big") + hello_req)
        frames = [_read_frame(viewer_sock) for _ in range(2)]
        hello = next(codec.decode_body(f) for f in frames
                     if not codec.is_storm_body(f) and b'"rid"' in bytes(f))
        assert hello["viewer"] is True
        assert hello["client_id"].startswith("viewer-")
        k = 8
        words = codec.pack_map_words([0] * k, list(range(k)), [7] * k)
        sock = socket.create_connection(("127.0.0.1", front.port))
        sock.settimeout(30)
        sock.sendall(codec.encode_storm_frame(
            {"op": "storm", "rid": 1,
             "docs": [[d, clients[d], 1, 1, k] for d in docs]},
            words.astype(np.uint32).tobytes() * len(docs)))
        body = _read_frame(sock)
        assert codec.is_storm_body(body), "ack must be a binary storm push"
        ack = codec.decode_storm_push(body)
        assert ack["rid"] == 1
        assert [a[0] for a in ack["acks"]] == [k, k]
        tick = None
        deadline = time.monotonic() + 15
        while tick is None and time.monotonic() < deadline:
            frame = _read_frame(viewer_sock)
            if codec.is_storm_body(frame):
                decoded = codec.decode_storm_push(frame)
                if decoded.get("event") == "storm_tick":
                    tick = decoded
                    tick_body = bytes(frame)
        assert tick is not None and tick["doc"] == "smoke-a"
        assert tick["n"] == k and list(tick["words"]) == list(words)
        viewer_sock.close()
        wait_for(lambda: all(fanout.pending(s) for s in subs.values()), 10,
                 "the room publish")
        published = {d: bytes(fanout.poll(s)) for d, s in subs.items()}
        assert all(p[:1] == b"\x00" for p in published.values())
        sock.close()
        return [hello["viewer"], np.asarray(ack["acks"]).tolist(),
                tick_body, published]
    finally:
        front.close()


def test_bridge_and_fanout_serve_one_storm_tick_together():
    both(_native_smoke)


# -- the port's door against its own other paths ------------------------------


def _storm_tick_frames(docs, clients, ticks, k):
    out = []
    for t in range(ticks):
        entries = [[d, clients[d], 1 + t * k, 1, k] for d in docs]
        words = [t_codec.pack_map_words(
            (np.arange(k) + i + t) % 2, (np.arange(k) * 3 + i) % 16,
            np.arange(k) + 100 * t + i) for i in range(len(docs))]
        out.append(({"rid": t, "docs": entries},
                    b"".join(w.astype(np.uint32).tobytes() for w in words)))
    return out


def test_storm_ticks_through_the_bridge_ack_as_the_in_process_twin():
    """Storm frames over the bridge socket (with a ``storm_flush`` after
    each) ack exactly as the same frames submitted in process to a twin
    stack; the device planes end equal."""
    docs = [f"doc-{i}" for i in range(4)]
    k = 8
    acks = {}
    maps = {}
    for arm in ("bridge", "in_process"):
        service, storm = _storm_stack(PKG["torch"], docs, fanout=False,
                                      flush_threshold_docs=10**9)
        clients = {d: service.connect(d, lambda m: None).client_id
                   for d in docs}
        service.pump()
        frames = _storm_tick_frames(docs, clients, 3, k)
        if arm == "in_process":
            got = []
            for hdr, payload in frames:
                storm.submit_frame(got.append, hdr, memoryview(payload))
                storm.flush()
            acks[arm] = [[p["rid"], np.asarray(p.rows).tolist()]
                         for p in got]
        else:
            front = t_bh.BridgeFrontDoor(service, 0)
            try:
                sock = socket.create_connection(("127.0.0.1", front.port))
                sock.settimeout(60)
                got = []
                for rid, (hdr, payload) in enumerate(frames):
                    sock.sendall(t_codec.frame_body(
                        t_codec.encode_storm_body(hdr, payload)))
                    sock.sendall(t_codec.encode_frame(
                        {"rid": 100 + rid, "op": "storm_flush"}))
                    while True:
                        msg = _decode(_read_frame(sock))
                        if msg.get("storm"):
                            got.append([msg["rid"], msg["acks"]])
                        elif msg.get("rid") == 100 + rid:
                            break
                sock.close()
            finally:
                front.close()
            acks[arm] = [[r, np.asarray(a).tolist()] for r, a in got]
        maps[arm] = {d: storm.merge_host.map_entries(
            d, storm.datastore, storm.channel) for d in docs}
    assert [a[0] for a in acks["bridge"]] == [0, 1, 2]
    assert acks["bridge"] == acks["in_process"]
    assert maps["bridge"] == maps["in_process"]


def _decode(body):
    if t_codec.is_storm_body(body):
        return t_codec.decode_storm_push(body)
    return t_codec.decode_body(body)


class _AlfredDoor:
    """The port's ``AlfredServer`` on its own event-loop thread."""

    def __init__(self, service):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.server = t_alfred.AlfredServer(service, "127.0.0.1", 0)
        self.port = asyncio.run_coroutine_threadsafe(
            self.server.start(), self.loop).result(60)

    def close(self):
        asyncio.run_coroutine_threadsafe(self.server.close(),
                                         self.loop).result(60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


def _session_frames(door_kind):
    """One scripted writer session's every frame, over ``door_kind``."""
    service = pin(t_alfred.build_default_service(merge_host=False,
                                                 device="cpu"))
    door = (t_bh.BridgeFrontDoor(service, 0) if door_kind == "bridge"
            else _AlfredDoor(service))
    frames = []
    try:
        sock = socket.create_connection(("127.0.0.1", door.port))
        sock.settimeout(60)
        rid = itertools.count(1)

        def call(op, **kw):
            r = next(rid)
            sock.sendall(t_codec.encode_frame({"rid": r, "op": op, **kw}))
            while True:
                body = bytes(_read_frame(sock))
                frames.append(body)
                msg = _decode(body)
                if isinstance(msg, dict) and msg.get("rid") == r:
                    return msg
        call("connect", doc_id="wdoc")
        for i in range(3):
            call("submit", messages=[t_messages.DocumentMessage(
                type=MessageType.OPERATION, contents={"k": i},
                client_sequence_number=i + 1, reference_sequence_number=0)])
        call("signal", content={"cursor": 3})
        call("upload_snapshot", snapshot={"tree": {"a": 1}})
        call("get_latest_snapshot")
        deltas = call("get_deltas", from_seq=0)
        assert [m.sequence_number for m in deltas["messages"]] == \
            [1, 2, 3, 4]
        call("get_metrics")
        call("no_such_op")
        call("disconnect")
        sock.close()
    finally:
        door.close()
    return frames


def test_request_frames_over_the_bridge_equal_alfreds():
    """A scripted session (connect, submits, a signal, a snapshot upload
    and read, ``get_deltas``, an unknown op, a disconnect) reads the same
    frames over the bridge as over the port's ``AlfredServer``, the
    metrics scrape's timing gauges aside."""
    saved = t_messages.time
    got = {}
    for kind in ("bridge", "alfred"):
        t_messages.time = SimpleNamespace(
            monotonic=itertools.count(1).__next__)
        try:
            got[kind] = _session_frames(kind)
        finally:
            t_messages.time = saved
    assert len(got["bridge"]) == len(got["alfred"]) > 8

    def metric_free(frames):
        out = []
        for body in frames:
            msg = _decode(body)
            if isinstance(msg, dict) and "metrics" in msg:
                out.append(sorted(msg["metrics"]))
            else:
                out.append(body)
        return out
    assert metric_free(got["bridge"]) == metric_free(got["alfred"])
