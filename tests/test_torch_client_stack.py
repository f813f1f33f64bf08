"""One seeded client session through both packages' client stacks.

The same session — four Containers editing a map, a directory, a cell, a
counter, a SharedString (inserts, removes, annotates, an interval), a
SharedMatrix (row and column inserts, cell writes) and a SharedTree; one
client disconnecting, editing offline and reconnecting; a summary uploaded
and acked; a late joiner loading from that summary plus the trailing
deltas — runs once through the JAX package's Containers over its own
service and once through the port's over the port's. At every step each
client's summary, quorum members and pending-state queue must be equal
across the packages, and at the end every sequenced message of
``get_deltas(doc, 0)`` field by field.

It runs over ``LocalCollabServer`` and again over ``RouterliciousService``
with the batched deli host and the merge host (the port's on the CPU,
where its kernels' plain versions run): there the merge host's rows (text,
matrix, map, tree) must equal JAX's and every client's DDS.

Then a port Container and a JAX Container edit one document over a
localhost socket, through the port's ``AlfredServer`` and through JAX's,
and converge with equal summaries.
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import importlib
import itertools
import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import fluidframework_tpu.protocol.messages as j_messages
from fluidframework_tpu.drivers.local_driver import (
    LocalDocumentService as j_LocalDocumentService)
from fluidframework_tpu.drivers.network_driver import (
    NetworkDocumentService as j_NetworkDocumentService)
from fluidframework_tpu.protocol.codec import to_wire as j_to_wire
from fluidframework_tpu.runtime.container import Container as j_Container
from fluidframework_tpu.runtime.summarizer import (
    SummaryConfig as j_SummaryConfig, SummaryManager as j_SummaryManager)
from fluidframework_tpu.server import alfred as j_alfred
from fluidframework_tpu.server.kernel_host import (
    KernelSequencerHost as j_KernelSequencerHost)
from fluidframework_tpu.server.local_server import (
    LocalCollabServer as j_LocalCollabServer)
from fluidframework_tpu.server.merge_host import (
    KernelMergeHost as j_KernelMergeHost)
from fluidframework_tpu.server.routerlicious import (
    RouterliciousService as j_RouterliciousService)

import fluidframework_tpu_torch.protocol.messages as t_messages
from fluidframework_tpu_torch.drivers.local_driver import (
    LocalDocumentService as t_LocalDocumentService)
from fluidframework_tpu_torch.drivers.network_driver import (
    NetworkDocumentService as t_NetworkDocumentService)
from fluidframework_tpu_torch.protocol.codec import to_wire as t_to_wire
from fluidframework_tpu_torch.runtime.container import Container as t_Container
from fluidframework_tpu_torch.runtime.summarizer import (
    SummaryConfig as t_SummaryConfig, SummaryManager as t_SummaryManager)
from fluidframework_tpu_torch.server import alfred as t_alfred
from fluidframework_tpu_torch.server.kernel_host import (
    KernelSequencerHost as t_KernelSequencerHost)
from fluidframework_tpu_torch.server.local_server import (
    LocalCollabServer as t_LocalCollabServer)
from fluidframework_tpu_torch.server.merge_host import (
    KernelMergeHost as t_KernelMergeHost)
from fluidframework_tpu_torch.server.routerlicious import (
    RouterliciousService as t_RouterliciousService)

PKG = {
    "jax": SimpleNamespace(
        messages=j_messages, Container=j_Container,
        LocalDocumentService=j_LocalDocumentService,
        NetworkDocumentService=j_NetworkDocumentService,
        SummaryConfig=j_SummaryConfig, SummaryManager=j_SummaryManager,
        LocalCollabServer=j_LocalCollabServer,
        RouterliciousService=j_RouterliciousService,
        KernelSequencerHost=j_KernelSequencerHost,
        KernelMergeHost=j_KernelMergeHost, alfred=j_alfred,
        to_wire=j_to_wire, dev={}),
    "torch": SimpleNamespace(
        messages=t_messages, Container=t_Container,
        LocalDocumentService=t_LocalDocumentService,
        NetworkDocumentService=t_NetworkDocumentService,
        SummaryConfig=t_SummaryConfig, SummaryManager=t_SummaryManager,
        LocalCollabServer=t_LocalCollabServer,
        RouterliciousService=t_RouterliciousService,
        KernelSequencerHost=t_KernelSequencerHost,
        KernelMergeHost=t_KernelMergeHost, alfred=t_alfred,
        to_wire=t_to_wire, dev={"device": "cpu"}),
}
SIDES = ("jax", "torch")
DOC = "session"

#: The session's channels: id -> (module of ``dds``, class).
CHANNELS = {"root": ("map", "SharedMap"),
            "dir": ("directory", "SharedDirectory"),
            "cell": ("cell", "SharedCell"),
            "clicks": ("counter", "SharedCounter"),
            "text": ("sequence", "SharedString"),
            "grid": ("matrix", "SharedMatrix"),
            "tree": ("tree", "SharedTree")}


def channel_type(side: str, channel: str) -> str:
    package = ("fluidframework_tpu" if side == "jax"
               else "fluidframework_tpu_torch")
    module, cls = CHANNELS[channel]
    return getattr(importlib.import_module(f"{package}.dds.{module}"),
                   cls).channel_type


def plain(value, depth: int = 0):
    """``value`` as package-free data: protocol objects and dataclasses by
    their fields (eight deep: a pending op's metadata may link segments),
    enums as ints, other objects by their class name."""
    if isinstance(value, enum.Enum):
        return value.value
    if value is None or isinstance(value, (bool, int, float, str, bytes)):
        return value
    if isinstance(value, dict):
        return {plain(k, depth): plain(v, depth) for k, v in value.items()}
    if isinstance(value, (list, tuple, set, frozenset)):
        items = [plain(v, depth) for v in value]
        return (type(value).__name__,
                sorted(items, key=repr) if isinstance(value, (set, frozenset))
                else items)
    if dataclasses.is_dataclass(value) and depth < 8:
        return (type(value).__name__,
                {f.name: plain(getattr(value, f.name), depth + 1)
                 for f in dataclasses.fields(value)})
    return type(value).__name__


# -- the stacks ----------------------------------------------------------------


class Stack:
    """One package's service with a document on it."""

    def __init__(self, side: str, kind: str) -> None:
        self.P = P = PKG[side]
        self.side, self.kind = side, kind
        if kind == "local":
            self.service = P.LocalCollabServer()
            self.merge_host = None
        else:
            self.merge_host = P.KernelMergeHost(flush_threshold=10**9,
                                                **P.dev)
            self.service = P.RouterliciousService(
                auto_pump=False, merge_host=self.merge_host,
                batched_deli_host=P.KernelSequencerHost(num_slots=8,
                                                        **P.dev))
            self.service._clock = itertools.count(1000, 7).__next__

    def settle(self) -> None:
        if self.kind != "local":
            self.service.pump()

    def open(self):
        container = self.P.Container.load(
            self.P.LocalDocumentService(self.service, DOC))
        self.settle()
        return container

    def create(self):
        P = self.P
        container = P.Container.create_detached(
            P.LocalDocumentService(self.service, DOC))
        datastore = container.runtime.create_datastore("default")
        for channel in CHANNELS:
            datastore.create_channel(channel, channel_type(self.side,
                                                           channel))
        container.attach()
        self.settle()
        return container


def chan(container, channel):
    return container.runtime.get_datastore("default").get_channel(channel)


def node(nid, payload):
    return {"id": nid, "definition": "n", "payload": payload, "traits": {}}


def end_of_root():
    return {"referenceTrait": {"parent": "root", "label": "children"},
            "side": "end"}


def edit(container, rng, who: int, step: int) -> None:
    """One client's seeded edits of every channel."""
    r = [int(x) for x in rng.integers(0, 1 << 16, 8)]
    chan(container, "root").set(f"k{r[0] % 6}", [who, step])
    if r[1] % 5 == 0:
        chan(container, "root").delete(f"k{r[1] % 6}")
    directory = chan(container, "dir")
    sub = (directory.get_sub_directory("s")
           or directory.create_sub_directory("s"))
    sub.set(f"d{r[2] % 3}", step)
    directory.set("top", who)
    chan(container, "cell").set({"who": who, "step": step})
    chan(container, "clicks").increment(1 + r[3] % 3)
    text = chan(container, "text")
    length = len(text.get_text())
    text.insert_text(r[4] % (length + 1), f"<{who}.{step}>")
    length = len(text.get_text())
    if length > 12 and r[5] % 3 == 0:
        start = r[5] % (length - 4)
        text.remove_text(start, start + 1 + r[5] % 3)
    length = len(text.get_text())
    if length > 4:
        start = r[6] % (length - 2)
        text.annotate_range(start, start + 2, {"bold": who})
    grid = chan(container, "grid")
    if r[7] % 3 == 0 or grid.row_count < 2:
        grid.insert_rows(r[7] % (grid.row_count + 1), 1)
    else:
        grid.insert_cols(r[7] % (grid.col_count + 1), 1)
    if grid.row_count and grid.col_count:
        grid.set_cell(r[0] % grid.row_count, r[1] % grid.col_count,
                      f"v{who}.{step}")
    if step % 3 == who % 3:
        chan(container, "tree").insert_node(node(f"n{who}.{step}", step),
                                            end_of_root())


def views(container) -> dict:
    """What every DDS shows its client."""
    grid = chan(container, "grid")
    return {
        "root": dict(chan(container, "root").items()),
        "cell": chan(container, "cell").get(),
        "clicks": chan(container, "clicks").value,
        "text": chan(container, "text").get_text(),
        "grid": [[grid.get_cell(r, c) for c in range(grid.col_count)]
                 for r in range(grid.row_count)],
        "tree": chan(container, "tree").current_view.serialize(),
    }


def record(containers) -> dict:
    return plain({
        "summaries": [c.summarize() for c in containers],
        "quorum": [sorted(c.protocol.quorum.get_members())
                   for c in containers],
        "pending": [list(c.runtime.pending._pending) for c in containers],
        "views": [views(c) for c in containers],
        "seq": [c.last_processed_seq for c in containers],
    })


def session(side: str, kind: str, seed: int = 5) -> list:
    """The seeded session; returns its records, step by step."""
    stack = Stack(side, kind)
    rng = np.random.default_rng(seed)
    records = []
    c1 = stack.create()
    clients = [c1] + [stack.open() for _ in range(3)]
    records.append(record(clients))
    for step in range(6):
        # Concurrency: on the in-process server a paused client edits
        # blind; the batched service sequences a whole round per pump.
        blind = clients[step % 4]
        if kind == "local":
            blind.inbound.pause()
        for who, container in enumerate(clients):
            edit(container, rng, who, step)
        if kind == "local":
            records.append(record(clients))  # the blind client's pending
            blind.inbound.resume()
        stack.settle()
        records.append(record(clients))
    text = chan(c1, "text")
    comments = text.get_interval_collection("comments")
    comments.add(1, 5, {"note": "first"})
    stack.settle()
    records.append(record(clients))
    # Offline: client 4 edits while disconnected, the others go on.
    offline = clients[3]
    offline.disconnect()
    for step in range(6, 8):
        for who, container in enumerate(clients):
            edit(container, rng, who, step)
        stack.settle()
    records.append(record(clients))
    offline.reconnect()
    stack.settle()
    stack.settle()
    records.append(record(clients))
    # A summary uploaded and acked, then trailing ops.
    manager = stack.P.SummaryManager(c1, stack.P.SummaryConfig(
        max_ops=10_000))
    handle = manager.summarize_now(reason="session")
    assert handle is not None
    stack.settle()
    assert [e.kind for e in manager.events] == ["generated", "acked"]
    for who, container in enumerate(clients):
        edit(container, rng, who, 8)
    stack.settle()
    late = stack.open()
    clients.append(late)
    edit(late, rng, 4, 9)
    stack.settle()
    records.append(record(clients))
    _, summaries = records[-1]["summaries"]
    assert all(summary == summaries[0] for summary in summaries)
    records.append([stack.P.to_wire(m)
                    for m in stack.service.get_deltas(DOC, 0)])
    if stack.merge_host is not None:
        mh = stack.merge_host
        device = {
            "text": mh.text(DOC, "default", "text"),
            "grid": mh.matrix_grid(DOC, "default", "grid"),
            "root": mh.map_entries(DOC, "default", "root"),
            "tree": mh.tree_snapshot(DOC, "default", "tree"),
        }
        for container in clients:
            seen = views(container)
            assert device == {k: seen[k] for k in device}
        records.append(plain(device))
    return records


@pytest.fixture(autouse=True)
def pinned_trace_clocks():
    """The deli stamps every sequenced message's ``Trace`` with the host's
    monotonic clock: pin it in both packages."""
    saved = [PKG[side].messages.time for side in SIDES]
    for side in SIDES:
        PKG[side].messages.time = SimpleNamespace(
            monotonic=itertools.count(1).__next__)
    yield
    for side, mod in zip(SIDES, saved):
        PKG[side].messages.time = mod


@pytest.mark.parametrize("kind", ["local", "routerlicious"])
def test_session_is_the_same_in_both_packages(kind):
    got = {}
    for side in SIDES:
        PKG[side].messages.time.monotonic = itertools.count(1).__next__
        got[side] = session(side, kind)
    assert len(got["torch"]) == len(got["jax"])
    for step, (t, j) in enumerate(zip(got["torch"], got["jax"])):
        assert t == j, f"step {step} differs"


def test_session_exercises_every_part():
    """The session really holds what it claims: offline edits replayed
    by a reconnect, an interval, a summary ack, a late joiner."""
    records = session("torch", "local")
    deltas = records[-1]
    types = {m["type"] for m in deltas}
    MT = t_messages.MessageType
    assert {int(MT.CLIENT_JOIN), int(MT.CLIENT_LEAVE), int(MT.SUMMARIZE),
            int(MT.SUMMARY_ACK), int(MT.OPERATION)} <= types
    final = records[-2]
    _, summaries = final["summaries"]
    assert len(summaries) == 5
    _, shown = final["views"]
    view = shown[0]
    _, rows = view["grid"]
    assert view["clicks"] > 0 and view["tree"]
    assert any(row[1] for row in rows)
    assert "comments" in repr(summaries[0])
    # Client 4's offline edits reached every replica after its reconnect.
    assert "<3.6>" in view["text"] or "<3.7>" in view["text"]


# -- across the packages, over the wire -------------------------------------


class Door:
    """One package's ``AlfredServer`` on its own event-loop thread."""

    def __init__(self, side: str) -> None:
        P = PKG[side]
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        service = P.alfred.build_default_service(merge_host=True, **P.dev)
        self.server = P.alfred.AlfredServer(service, "127.0.0.1", 0)
        self.port = self.run(self.server.start())

    def run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(60)

    def close(self) -> None:
        self.run(self.server.close())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


def wait_until(cond, timeout: float = 20.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError("timed out")


@pytest.mark.parametrize("door_side", SIDES)
def test_port_and_jax_containers_converge_over_the_wire(door_side):
    door = Door(door_side)
    services = []
    try:
        ends = {}
        for side in ("torch", "jax"):
            P = PKG[side]
            svc = P.NetworkDocumentService("127.0.0.1", door.port, "wire")
            services.append(svc)
            with svc.dispatch_lock:
                if side == "torch":
                    container = P.Container.create_detached(svc)
                    ds = container.runtime.create_datastore("default")
                    for channel in ("root", "text", "grid", "clicks"):
                        ds.create_channel(channel,
                                          channel_type(side, channel))
                    container.attach()
                else:
                    container = P.Container.load(svc)
            ends[side] = (svc, container)
        for round_ in range(4):
            for who, side in enumerate(("torch", "jax")):
                svc, container = ends[side]
                with svc.dispatch_lock:
                    chan(container, "root").set(f"{side}{round_}", round_)
                    chan(container, "clicks").increment(who + 1)
                    chan(container, "text").insert_text(0, f"[{side}]")
                    grid = chan(container, "grid")
                    if round_ == 0 and side == "torch":
                        grid.insert_rows(0, 2)
                        grid.insert_cols(0, 2)
                    elif grid.row_count and grid.col_count:
                        grid.set_cell(who, round_ % 2, f"{side}{round_}")

        def converged():
            (s1, c1), (s2, c2) = ends["torch"], ends["jax"]
            with s1.dispatch_lock, s2.dispatch_lock:
                return (c1.last_processed_seq == c2.last_processed_seq
                        and not c1.runtime.pending.has_pending
                        and not c2.runtime.pending.has_pending)

        wait_until(converged)
        (s1, c1), (s2, c2) = ends["torch"], ends["jax"]
        with s1.dispatch_lock, s2.dispatch_lock:
            assert plain(c1.summarize()) == plain(c2.summarize())
            assert chan(c1, "clicks").value == 12
            assert len(chan(c1, "text").get_text()) == 4 * (7 + 5)
            assert (dict(chan(c1, "root").items())
                    == dict(chan(c2, "root").items()))
            assert chan(c1, "text").get_text() == chan(c2, "text").get_text()
    finally:
        # A reader thread blocked in recv keeps a closed socket open: shut
        # it down first (as the reference's dead-socket case does), or the
        # closing server waits for the connection.
        for svc in services:
            svc._sock.shutdown(socket.SHUT_RDWR)
            svc.close()
        door.close()
