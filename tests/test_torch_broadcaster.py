"""The port's broadcast viewer plane (``server/broadcaster.py``, the
storm harvest's viewer rooms and ``connect(mode="viewer")``) against the
JAX package's, on ``device="cpu"``.

The cases of ``tests/test_broadcaster.py`` as differentials: each runs
once per package with the service clock and the deli's trace clock
pinned, makes the reference test's own assertions on its side, and
returns what it observed — every payload a viewer received, as the wire
carries it (frame bytes), the plane's ``stats``, acks (rid and rows: a
storm ack's ``dw`` is thread-timed), resync and presence directives,
join-ladder admission times on a pinned clock, and catch-up reads in
wire form. The two records must be equal. The wire case (a viewer over a
real socket) is in ``tests/test_torch_front_door.py``.
"""

from __future__ import annotations

import heapq
import itertools
from types import SimpleNamespace

import numpy as np
import pytest

from fluidframework_tpu.protocol import codec as j_codec
from fluidframework_tpu.protocol import messages as j_messages
from fluidframework_tpu.server import audience as j_aud
from fluidframework_tpu.server import broadcaster as j_bc
from fluidframework_tpu.server import bus as j_bus
from fluidframework_tpu.server import durable_store as j_ds
from fluidframework_tpu.server import kernel_host as j_kh
from fluidframework_tpu.server import merge_host as j_mh
from fluidframework_tpu.server import residency as j_res
from fluidframework_tpu.server import routerlicious as j_rl
from fluidframework_tpu.server import storm as j_storm
from fluidframework_tpu_torch.protocol import codec as t_codec
from fluidframework_tpu_torch.protocol import messages as t_messages
from fluidframework_tpu_torch.server import audience as t_aud
from fluidframework_tpu_torch.server import broadcaster as t_bc
from fluidframework_tpu_torch.server import bus as t_bus
from fluidframework_tpu_torch.server import durable_store as t_ds
from fluidframework_tpu_torch.server import kernel_host as t_kh
from fluidframework_tpu_torch.server import merge_host as t_mh
from fluidframework_tpu_torch.server import residency as t_res
from fluidframework_tpu_torch.server import routerlicious as t_rl
from fluidframework_tpu_torch.server import storm as t_storm

PKG = {
    "jax": SimpleNamespace(codec=j_codec, messages=j_messages, aud=j_aud,
                           bc=j_bc, bus=j_bus, ds=j_ds, kh=j_kh, mh=j_mh,
                           res=j_res, rl=j_rl, storm=j_storm, dev={}),
    "torch": SimpleNamespace(codec=t_codec, messages=t_messages, aud=t_aud,
                             bc=t_bc, bus=t_bus, ds=t_ds, kh=t_kh, mh=t_mh,
                             res=t_res, rl=t_rl, storm=t_storm,
                             dev={"device": "cpu"}),
}
SIDES = ("jax", "torch")
OP = j_messages.MessageType.OPERATION


def both(scenario, *args, **kw):
    """Run ``scenario(side, ...)`` for each package with the deli's trace
    clock pinned; the records must be equal."""
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


def _storm_stack(P, num_docs: int = 4, **storm_kw):
    seq_host = P.kh.KernelSequencerHost(num_slots=2,
                                        initial_capacity=max(4, num_docs),
                                        **P.dev)
    merge_host = P.mh.KernelMergeHost(flush_threshold=10**9, **P.dev)
    service = pin(P.rl.RouterliciousService(merge_host=merge_host,
                                            batched_deli_host=seq_host,
                                            auto_pump=False))
    storm = P.storm.StormController(service, seq_host, merge_host,
                                    flush_threshold_docs=10**9, **storm_kw)
    return service, storm


def _words(P, k: int, seed: int = 0):
    return P.codec.pack_map_words([0] * k, [(seed + i) % 16
                                            for i in range(k)],
                                  [7 + seed] * k).astype(np.uint32)


def _tick(P, storm, doc_clients, cseq0: int, k: int = 8, push=None, rid=0):
    entries = [[d, c, cseq0, 1, k] for d, c in doc_clients]
    payload = b"".join(_words(P, k, i).tobytes()
                       for i in range(len(doc_clients)))
    storm.submit_frame(push, {"rid": rid, "docs": entries},
                       memoryview(payload))
    storm.flush()


class _CollectingViewer:
    """In-process viewer transport: keeps every payload (frame bytes as
    the wire carries them, dicts in wire form) and decodes wire-shaped
    frames the way a socket client would."""

    def __init__(self, P):
        self.P = P
        self.raw = []
        self.events = []

    def __call__(self, payload):
        codec = self.P.codec
        if isinstance(payload, (bytes, bytearray)):
            self.raw.append(bytes(payload))
            self.events.append(codec.decode_storm_push(payload)
                               if codec.is_storm_body(payload)
                               else codec.decode_body(payload))
        else:
            self.raw.append(codec.to_wire(payload))
            self.events.append(payload)

    def of(self, kind):
        return [e for e in self.events if isinstance(e, dict)
                and e.get("event") == kind]


def _acks(acks):
    return [[a["rid"], a["acks"]] if a.get("storm") else a for a in acks]


def _wire_ops(P, messages):
    return [P.codec.to_wire(m) for m in messages]


# -- the viewer stream -------------------------------------------------------


def test_viewer_receives_storm_tick_frames():
    def scenario(side):
        P = PKG[side]
        service, storm = _storm_stack(P)
        writer = service.connect("doc", lambda m: None)
        service.pump()
        viewer = _CollectingViewer(P)
        conn = service.connect("doc", viewer, mode="viewer")
        assert conn.client_id.startswith("viewer-")
        assert conn.mode == "viewer"
        with pytest.raises(PermissionError):
            conn.submit([])
        _tick(P, storm, [("doc", writer.client_id)], cseq0=1)
        ticks = viewer.of("storm_tick")
        assert len(ticks) == 1
        t = ticks[0]
        assert t["doc"] == "doc" and t["n"] == 8
        assert t["last"] - t["first"] + 1 == 8
        assert list(t["words"]) == list(_words(P, 8, 0))
        assert conn.client_id not in service._connections_for("doc")
        conn.close()
        _tick(P, storm, [("doc", writer.client_id)], cseq0=9)
        assert len(viewer.of("storm_tick")) == 1
        return [conn.client_id, viewer.raw, service.viewers.stats]

    both(scenario)


def test_serialize_once_invariant_encodes_per_tick_is_hot_docs():
    def scenario(side):
        P = PKG[side]
        service, storm = _storm_stack(P)
        docs = ["doc-a", "doc-b"]
        writers = {d: service.connect(d, lambda m: None).client_id
                   for d in docs}
        service.pump()
        viewers = [_CollectingViewer(P) for _ in range(64)]
        for i, v in enumerate(viewers):
            service.connect(docs[i % 2], v, mode="viewer")
        plane = service.viewers
        before = plane.stats["tick_encodes"]
        for t in range(3):
            _tick(P, storm, [(d, writers[d]) for d in docs],
                  cseq0=1 + t * 8)
        encodes = plane.stats["tick_encodes"] - before
        assert encodes == 3 * len(docs)
        for i, v in enumerate(viewers):
            frames = v.of("storm_tick")
            assert len(frames) == 3
            assert all(f["doc"] == docs[i % 2] for f in frames)
        # Serialized once: every viewer of a doc got the same bytes.
        ticks = {d: [b for b in viewers[i].raw if isinstance(b, bytes)
                     and P.codec.is_storm_body(b)]
                 for i, d in enumerate(docs)}
        for i, v in enumerate(viewers):
            assert [b for b in v.raw if isinstance(b, bytes)
                    and P.codec.is_storm_body(b)] == ticks[docs[i % 2]]
        return [encodes, ticks, plane.stats]

    both(scenario)


def test_per_op_path_shares_one_encode_per_batch():
    def scenario(side):
        P = PKG[side]
        service = pin(P.rl.RouterliciousService())
        writer = service.connect("jdoc", lambda m: None)
        viewers = [_CollectingViewer(P) for _ in range(32)]
        for v in viewers:
            service.connect("jdoc", v, mode="viewer")
        before = P.codec.ops_event_encode_count()
        writer.submit([P.messages.DocumentMessage(
            type=OP, contents={"x": 1}, client_sequence_number=1,
            reference_sequence_number=0)])
        service.pump()
        encodes = P.codec.ops_event_encode_count() - before
        assert encodes <= 2
        for v in viewers:
            assert len(v.of("ops")) >= 1
        return [encodes, viewers[0].raw, viewers[-1].raw,
                service.viewers.stats]

    both(scenario)


# -- lag drops ---------------------------------------------------------------


def test_stalled_viewer_resyncs_without_stalling_writer():
    def scenario(side):
        P = PKG[side]
        service, storm = _storm_stack(P)
        writer = service.connect("doc", lambda m: None)
        service.pump()
        healthy = _CollectingViewer(P)
        service.connect("doc", healthy, mode="viewer")
        stalled = _CollectingViewer(P)
        plane = service.viewers
        hello = plane.join("doc", stalled, pending_probe=lambda: 10**9)
        acks = []
        ticks = 4
        for t in range(ticks):
            _tick(P, storm, [("doc", writer.client_id)], cseq0=1 + t * 8,
                  push=acks.append, rid=t)
        storm_acks = [a for a in acks if a.get("storm")]
        assert len(storm_acks) == ticks
        assert all(a["acks"][0][0] == 8 for a in storm_acks)
        assert plane.stats["lag_drops"] == 1
        resyncs = stalled.of("viewer_resync")
        assert len(resyncs) == 1 and resyncs[0]["doc"] == "doc"
        assert len(healthy.of("storm_tick")) == ticks
        assert plane.room_size("doc") == 1
        caught_up = service.get_deltas("doc", 0)
        seqs = [m.sequence_number for m in caught_up]
        assert seqs == list(range(seqs[0], seqs[0] + len(seqs)))
        assert seqs[-1] == 1 + ticks * 8
        resumed = plane.resume(hello["viewer_id"])
        assert resyncs[0]["seq"] == 9
        assert resumed["seq"] == 1 + ticks * 8
        record = [hello, _acks(acks), stalled.raw, healthy.raw,
                  _wire_ops(P, caught_up), resumed, dict(plane.stats)]
        stalled.raw.clear(), stalled.events.clear()
        plane._viewers[hello["viewer_id"]].pending_probe = None
        _tick(P, storm, [("doc", writer.client_id)], cseq0=1 + ticks * 8)
        assert len(stalled.of("storm_tick")) == 1
        return record + [stalled.raw, plane.stats]

    both(scenario)


def test_fanout_backlog_eviction_lag_drops():
    def scenario(side):
        P = PKG[side]
        service = pin(P.rl.RouterliciousService())
        plane = P.bc.ViewerPlane(service, max_lag_frames=4)
        v = _CollectingViewer(P)
        hello = plane.join("doc", v)
        sub = plane._viewers[hello["viewer_id"]].sub
        for i in range(6):
            plane.fanout.publish(plane._room("doc"), b"x%d" % i)
        assert plane.fanout.was_evicted(sub)
        plane._drain(["doc"])
        assert plane.stats["lag_drops"] == 1
        assert len(v.of("viewer_resync")) == 1
        return [hello, v.raw, plane.stats, plane.fanout.is_native]

    both(scenario)


def test_resync_gap_serves_from_cold_tier_without_hydrating(tmp_path):
    def scenario(side):
        P = PKG[side]
        root = tmp_path / side
        service, storm = _storm_stack(
            P, spill_dir=f"{root}/spill", durability="group",
            snapshots=P.ds.GitSnapshotStore(f"{root}/git"))
        res = P.res.ResidencyManager(storm, idle_evict_s=1e9)
        writer = service.connect("cdoc", lambda m: None)
        service.pump()
        _tick(P, storm, [("cdoc", writer.client_id)], cseq0=1)
        service.disconnect("cdoc", writer.client_id)
        service.pump()
        res.evict("cdoc")
        assert not res.is_resident("cdoc")
        caught_up = service.get_deltas("cdoc", 0)
        ops = [m for m in caught_up if m.type == OP]
        assert len(ops) == 8
        assert not res.is_resident("cdoc")
        storm._group_wal.close()
        return [_wire_ops(P, ops), res.stats]

    both(scenario)


# -- join storms -------------------------------------------------------------


def test_join_storm_ladders_at_bucket_rate():
    def scenario(side):
        P = PKG[side]
        clk = [0.0]
        service = pin(P.rl.RouterliciousService())
        rate = 50.0
        plane = P.bc.ViewerPlane(service, join_rate_per_s=rate,
                                 clock=lambda: clk[0])
        n = 400
        events = [(0.0, i) for i in range(n)]
        heapq.heapify(events)
        admitted_at: dict[int, float] = {}
        while events:
            t, i = heapq.heappop(events)
            clk[0] = t
            retry = plane.admit_join("event-doc", f"client-{i}")
            if retry is None:
                admitted_at[i] = t
            else:
                heapq.heappush(events, (t + retry, i))
        assert len(admitted_at) == n
        per_sec: dict[int, int] = {}
        for t in admitted_at.values():
            per_sec[int(t)] = per_sec.get(int(t), 0) + 1
        assert max(per_sec.values()) <= rate + plane.joins.burst
        assert max(admitted_at.values()) <= n / rate * 1.5
        return [admitted_at, plane.stats]

    both(scenario)


def test_claimed_reservation_is_not_redebited():
    def scenario(side):
        P = PKG[side]
        clk = [0.0]
        service = pin(P.rl.RouterliciousService())
        plane = P.bc.ViewerPlane(service, join_rate_per_s=1.0,
                                 join_burst=1.0, clock=lambda: clk[0])
        out = [plane.admit_join("d", "a")]
        retry = plane.admit_join("d", "b")
        assert out[0] is None and retry is not None
        early = plane.admit_join("d", "b")
        assert early == pytest.approx(retry, abs=1e-6)
        clk[0] = retry + 1e-6
        out += [retry, early, plane.admit_join("d", "b")]
        assert out[-1] is None
        assert plane.stats["join_nacks"] == 2
        return [out, plane.stats]

    both(scenario)


# -- presence ----------------------------------------------------------------


def test_interest_sampled_presence_bounded():
    def scenario(side):
        P = PKG[side]
        service = pin(P.rl.RouterliciousService())
        plane = P.bc.ViewerPlane(service, roster_sample=8)
        viewers = []
        n = 200
        for _ in range(n):
            v = _CollectingViewer(P)
            plane.join("big-doc", v)
            viewers.append(v)
        first_snapshot = viewers[-1].of("viewer_presence")[0]
        assert first_snapshot["total"] == n
        assert len(first_snapshot["sample"]) <= 8
        assert plane.stats["presence_updates"] < 50
        assert len(viewers[0].of("viewer_presence")) < 60
        return [viewers[0].raw, viewers[-1].raw, plane.stats]

    both(scenario)


def test_writer_audience_roster_is_bounded():
    def scenario(side):
        P = PKG[side]

        class _Conn:
            def __init__(self, cid):
                self.client_id = cid
                self.mode = "write"
                self.signals = []

            def on_signal(self, s):
                self.signals.append(s)

        conns = {f"c{i}": _Conn(f"c{i}") for i in range(20)}
        members, total = P.aud.roster_sample(conns, limit=5)
        assert len(members) == 5 and total == 20
        newcomer = _Conn("new")
        conns["new"] = newcomer
        P.aud.announce_connect(conns, newcomer, max_roster=5)
        snap = newcomer.signals[0]["content"]
        assert snap["event"] == "snapshot"
        assert len(snap["members"]) == 5 and snap["total"] == 21
        for c in conns.values():
            if c is newcomer:
                continue
            assert [s["content"]["event"] for s in c.signals] == ["count"]
            assert c.signals[0]["content"]["total"] == 21
        del conns["new"]
        P.aud.announce_leave(conns, "new", max_roster=5)
        last = conns["c0"].signals[-1]["content"]
        assert last["event"] == "count"
        assert last["total"] == 20 and last["left"] == "new"
        return [members, total, newcomer.signals,
                {c: conn.signals for c, conn in conns.items()}]

    both(scenario)


# -- service-plane retention -------------------------------------------------


def test_bus_partitions_trim_below_slowest_group():
    def scenario(side):
        P = PKG[side]
        bus = P.bus.MessageBus(retention_messages=8)
        bus.create_topic("t", 1)
        fast = P.bus.Consumer(bus, "t", "fast")
        slow = P.bus.Consumer(bus, "t", "slow")
        for i in range(100):
            bus.produce("t", "k", i)
        msgs = fast.poll(0)
        fast.commit(0, msgs[-1].offset + 1)
        part = bus.topic("t").partitions[0]
        out = [len(part.log)]
        half = slow.poll(0)[:50]
        slow.commit(0, half[-1].offset + 1)
        out += [part.base, len(part.log)]
        slow.commit(0, 100)
        out.append(len(part.log))
        for i in range(3):
            bus.produce("t", "k", 100 + i)
        out.append([m.value for m in slow.poll(0)])
        assert out[:3] == [100, 50, 50] and out[3] <= 8
        assert out[4] == [100, 101, 102]
        return out

    both(scenario)


def test_service_ops_store_horizon_bounds_history():
    def scenario(side):
        P = PKG[side]
        service = pin(P.rl.RouterliciousService(ops_retention=16))
        writer = service.connect("rdoc", lambda m: None)
        for i in range(64):
            writer.submit([P.messages.DocumentMessage(
                type=OP, contents={"i": i}, client_sequence_number=i + 1,
                reference_sequence_number=0)])
        log = service.store.get("ops/rdoc", [])
        assert len(log) <= 32
        tail = service.get_deltas("rdoc", log[0].sequence_number)
        seqs = [m.sequence_number for m in tail]
        assert seqs == list(range(seqs[0], seqs[0] + len(seqs)))
        return [len(log), _wire_ops(P, tail)]

    both(scenario)


def test_restored_offsets_pin_retention_after_restart(tmp_path):
    def scenario(side):
        P = PKG[side]
        path = tmp_path / side / "bus"
        bus = P.ds.DurableMessageBus(path, retention_messages=4)
        bus.create_topic("t", 1)
        fast = P.bus.Consumer(bus, "t", "fast")
        slow = P.bus.Consumer(bus, "t", "slow")
        for i in range(50):
            bus.produce("t", "k", i)
        fast.commit(0, 50)
        slow.commit(0, 10)
        bus.close()
        bus2 = P.ds.DurableMessageBus(path, retention_messages=4)
        bus2.create_topic("t", 1)
        fast2 = P.bus.Consumer(bus2, "t", "fast")
        for i in range(50, 60):
            bus2.produce("t", "k", i)
        fast2.commit(0, 60)
        slow2 = P.bus.Consumer(bus2, "t", "slow")
        values = [m.value for m in slow2.poll(0)]
        assert values[:3] == [10, 11, 12]
        assert len(values) == 50
        bus2.close()
        return values

    both(scenario)


def test_bus_retention_keeps_service_plane_ram_bounded():
    def scenario(side):
        P = PKG[side]
        bus = P.bus.MessageBus(retention_messages=32)
        service = pin(P.rl.RouterliciousService(bus=bus, ops_retention=32))
        writer = service.connect("bdoc", lambda m: None)
        for i in range(200):
            writer.submit([P.messages.DocumentMessage(
                type=OP, contents={"i": i}, client_sequence_number=i + 1,
                reference_sequence_number=0)])
        retained = sum(len(p.log) for t in bus._topics.values()
                       for p in t.partitions)
        assert retained <= 4 * 2 * 32 + 64
        return retained

    both(scenario)
