"""Differential: the tree half of the port's KernelMergeHost against the
JAX package's.

The JAX client stack drives the scenarios of ``tests/test_tree_host.py``
(SharedTree replicas on a ``LocalCollabServer`` over a JAX host) while a
wrapper on that host's ``ingest`` records every ``(doc, message)`` it
sees: the replica farms of seeds 0-3, slot pressure (reclaim, then
growth), an unsupported edit shape (→ the scalar route), rank
exhaustion and a subtree past the pass cap (→ the overflow route),
invalid concurrent edits, and two long streams that cross the edit-log
trim (``_TREE_LOG_TRIM``) before each scalar route. Each recorded stream
is replayed into a fresh JAX host and a port host (``device="cpu"``);
the tree planes, every ``_TreeRow`` map, ``tree_snapshot`` (also against
the replicas' views), ``stats``, ``summarize`` and ``export_state`` must
be equal. Export/import carries the other channels both ways and skips
tree channels (they come back from a replay of the op log), and the
same tree traffic through both packages' ``RouterliciousService``,
restarted over the same bus and store, rebuilds the same tree.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import random

import numpy as np
import pytest

from fluidframework_tpu.drivers.local_driver import LocalDocumentService
from fluidframework_tpu.ops.tree_kernel import MAX_DEPTH_PASSES
from fluidframework_tpu.protocol import messages as jmsg
from fluidframework_tpu.runtime.container import Container
from fluidframework_tpu.server import merge_host as jmh
from fluidframework_tpu.server.local_server import LocalCollabServer
from fluidframework_tpu.server.merge_host import \
    KernelMergeHost as JaxMergeHost
from fluidframework_tpu.server.routerlicious import \
    RouterliciousService as JaxService
from fluidframework_tpu_torch import convert
from fluidframework_tpu_torch.dds.tree_core import (
    ROOT_ID,
    VALID,
    Transaction,
    TreeSnapshot,
)
from fluidframework_tpu_torch.protocol import messages as tmsg
from fluidframework_tpu_torch.server import merge_host as tmh
from fluidframework_tpu_torch.server.merge_host import \
    KernelMergeHost as TorchMergeHost
from fluidframework_tpu_torch.server.routerlicious import \
    RouterliciousService as TorchService
from tests.test_tree_host import (
    end_of,
    get_tree,
    make_tree_doc,
    node,
    random_tree_edit,
    range_of,
)

TREE = ("default", "tree")


class Recorder:
    """A JAX host on a local server whose ``ingest`` calls are recorded,
    with the scenario's own snapshot reads as events of their own."""

    def __init__(self, **kwargs) -> None:
        self.kwargs = kwargs
        self.events: list[tuple] = []
        self.host = JaxMergeHost(**kwargs)
        inner = self.host.ingest

        def ingest(doc_id, message):
            self.events.append(("ingest", doc_id, message))
            inner(doc_id, message)
        self.host.ingest = ingest
        self.server = LocalCollabServer(merge_host=self.host)
        self.views: dict[str, dict] = {}

    def snap(self, doc: str, container) -> None:
        """Read the host's tree (a flush) and note the replica's view."""
        view = get_tree(container).current_view.serialize()
        self.events.append(("snap", doc, view))
        assert self.host.tree_snapshot(doc, *TREE) == view
        self.views[doc] = view


def farm(seed: int) -> Recorder:
    rec = Recorder(flush_threshold=16)
    rng = random.Random(seed)
    counter = itertools.count()
    c1 = make_tree_doc(rec.server, "doc")
    replicas = [c1] + [Container.load(LocalDocumentService(rec.server, "doc"))
                       for _ in range(2)]
    for _round in range(6):
        paused = [c for c in replicas if rng.random() < 0.3]
        for c in paused:
            c.inbound.pause()
        for _ in range(rng.randrange(4, 10)):
            random_tree_edit(rng, get_tree(rng.choice(replicas)), counter)
        for c in paused:
            c.inbound.resume()
    rec.snap("doc", c1)
    return rec


def slot_pressure() -> Recorder:
    rec = Recorder(flush_threshold=4, tree_slots=8)
    c1 = make_tree_doc(rec.server, "doc")
    t1 = get_tree(c1)
    for i in range(6):
        t1.insert_node(node(f"tmp{i}"), end_of(ROOT_ID))
        t1.delete_range(range_of(f"tmp{i}"))
    for i in range(20):
        t1.insert_node(node(f"live{i}", payload=i), end_of(ROOT_ID))
    rec.snap("doc", c1)
    return rec


def unsupported_shape() -> Recorder:
    rec = Recorder(flush_threshold=4)
    c1 = make_tree_doc(rec.server, "doc")
    c2 = Container.load(LocalDocumentService(rec.server, "doc"))
    t1, t2 = get_tree(c1), get_tree(c2)
    t1.insert_node(node("a", payload=1), end_of(ROOT_ID))
    t1.insert_node(node("b", payload=2), end_of(ROOT_ID))
    t2.apply_edit([{"type": "set_value", "node": "a", "payload": 10},
                   {"type": "set_value", "node": "b", "payload": 20}])
    rec.snap("doc", c1)
    t1.insert_node(node("c"), end_of("a", "sub"))
    t2.move_range(range_of("b"), {"referenceSibling": "a", "side": "before"})
    rec.snap("doc", c1)
    return rec


def rank_exhaustion() -> Recorder:
    rec = Recorder(flush_threshold=2)
    c1 = make_tree_doc(rec.server, "doc")
    t1 = get_tree(c1)
    t1.insert_node(node("anchor"), end_of(ROOT_ID))
    for i in range(24):
        t1.insert_node(node(f"w{i}"),
                       {"referenceSibling": "anchor", "side": "before"})
    rec.snap("doc", c1)
    t1.set_payload("anchor", "end")
    rec.snap("doc", c1)
    return rec


def depth_cap() -> Recorder:
    rec = Recorder(flush_threshold=4)
    c1 = make_tree_doc(rec.server, "doc")
    t1 = get_tree(c1)
    depth = MAX_DEPTH_PASSES + 8
    spec = node(f"c{depth - 1}", payload=depth - 1)
    for i in reversed(range(depth - 1)):
        spec = node(f"c{i}", payload=i, kids=[spec])
    t1.insert_node(spec, end_of(ROOT_ID))
    rec.snap("doc", c1)
    t1.delete_range(range_of("c0"))
    rec.snap("doc", c1)
    return rec


def invalid_concurrent() -> Recorder:
    rec = Recorder(flush_threshold=100)
    c1 = make_tree_doc(rec.server, "doc")
    c2 = Container.load(LocalDocumentService(rec.server, "doc"))
    t1, t2 = get_tree(c1), get_tree(c2)
    t1.insert_node(node("a"), end_of(ROOT_ID))
    t1.insert_node(node("b"), end_of("a", "sub"))
    c2.inbound.pause()
    t1.delete_range(range_of("a"))
    t2.set_payload("b", "doomed")
    t2.insert_node(node("c"), end_of("b", "sub"))
    c2.inbound.resume()
    rec.snap("doc", c1)
    return rec


def log_trim() -> Recorder:
    """Two docs whose rows each take more than ``_TREE_LOG_TRIM`` edits
    (the log folds into a device-read base), then leave the device: doc
    "shape" through an unsupported edit shape, doc "rank" through rank
    exhaustion; both scalar routes replay base + the remaining log."""
    rec = Recorder(flush_threshold=16)
    rng = random.Random(9)
    counter = itertools.count()
    docs = {name: make_tree_doc(rec.server, name) for name in ("shape",
                                                               "rank")}
    for _ in range(jmh._TREE_LOG_TRIM + 40):
        for c in docs.values():
            random_tree_edit(rng, get_tree(c), counter)
    for name, c in docs.items():
        rec.snap(name, c)
    t = get_tree(docs["shape"])
    live = [n for n in t.current_view.nodes if n != ROOT_ID][:2]
    t.apply_edit([{"type": "set_value", "node": n, "payload": i}
                  for i, n in enumerate(live)])
    t = get_tree(docs["rank"])
    t.insert_node(node("anchor"), end_of(ROOT_ID))
    for i in range(24):
        t.insert_node(node(f"w{i}"),
                      {"referenceSibling": "anchor", "side": "before"})
    for _ in range(10):
        for c in docs.values():
            random_tree_edit(rng, get_tree(c), counter)
    for name, c in docs.items():
        rec.snap(name, c)
    return rec


SCENARIOS = {
    **{f"farm{seed}": (lambda seed=seed: farm(seed)) for seed in range(4)},
    "slot_pressure": slot_pressure,
    "unsupported_shape": unsupported_shape,
    "rank_exhaustion": rank_exhaustion,
    "depth_cap": depth_cap,
    "invalid_concurrent": invalid_concurrent,
    "log_trim": log_trim,
}


@pytest.fixture(scope="module")
def recorded() -> dict[str, Recorder]:
    """Every scenario driven once through the JAX client stack (the JAX
    host compiles one tick per shape, so the tests share this run)."""
    return {name: drive() for name, drive in SCENARIOS.items()}


def to_port(m: jmsg.SequencedDocumentMessage
            ) -> tmsg.SequencedDocumentMessage:
    """The port's copy of a JAX sequenced message (nothing shared)."""
    kw = {f.name: copy.deepcopy(getattr(m, f.name))
          for f in dataclasses.fields(m)}
    kw["type"] = tmsg.MessageType(int(m.type))
    kw["traces"] = tuple(tmsg.Trace(t.service, t.action, t.timestamp)
                         for t in m.traces)
    return tmsg.SequencedDocumentMessage(**kw)


def tree_planes(host) -> dict | None:
    if host._tree_state is None:
        return None
    if isinstance(host, TorchMergeHost):
        return convert.state_to_numpy(host._tree_state)
    return {f: np.asarray(getattr(host._tree_state, f))
            for f in host._tree_state._fields}


def row_maps(row) -> dict:
    return {name: (getattr(row, name).serialize()
                   if name == "scalar" and row.scalar is not None
                   else getattr(row, name))
            for name in tmh._TreeRow.__slots__}


def assert_hosts_equal(jh, th) -> None:
    """Tree planes, rows and counters equal (no flush)."""
    a, b = tree_planes(jh), tree_planes(th)
    assert (a is None) == (b is None)
    if a is not None:
        for f in a:
            assert b[f].dtype == a[f].dtype and np.array_equal(b[f], a[f]), f
    assert (th._tree_capacity, th._tree_slots) \
        == (jh._tree_capacity, jh._tree_slots)
    assert [tuple(k) for k in th._tree_rows] \
        == [tuple(k) for k in jh._tree_rows]
    for key, jrow in jh._tree_rows.items():
        assert row_maps(th._tree_rows[tuple(key)]) == row_maps(jrow), key
    assert th.stats == jh.stats
    assert th._val_rev == jh._val_rev


def replay(rec: Recorder, jh, th) -> None:
    for event in rec.events:
        if event[0] == "ingest":
            _, doc, m = event
            jh.ingest(doc, m)
            th.ingest(doc, to_port(m))
        else:
            _, doc, view = event
            assert_hosts_equal(jh, th)
            assert th.tree_snapshot(doc, *TREE) \
                == jh.tree_snapshot(doc, *TREE) == view


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tree_host_matches_jax(recorded, name):
    rec = recorded[name]
    jh = JaxMergeHost(**rec.kwargs)
    th = TorchMergeHost(device="cpu", **rec.kwargs)
    replay(rec, jh, th)
    assert_hosts_equal(jh, th)
    for doc in rec.views:
        assert th.summarize(doc) == jh.summarize(doc)
    assert th.export_state() == jh.export_state()
    assert th.stats == rec.host.stats
    assert th.stats["device_ops"] + th.stats["scalar_ops"] > 0


def test_scenarios_take_every_route(recorded):
    """The recorded scenarios reach what they are named for."""
    stats = {name: rec.host.stats for name, rec in recorded.items()}
    for seed in range(4):
        assert stats[f"farm{seed}"]["device_ops"] > 0
    assert stats["slot_pressure"]["compactions"] > 0
    assert recorded["slot_pressure"].host._tree_slots > 8
    for name in ("unsupported_shape", "rank_exhaustion", "depth_cap"):
        assert stats[name]["overflow_routed"] >= 1, name
    rows = recorded["log_trim"].host._tree_rows
    assert stats["log_trim"]["overflow_routed"] == 2
    assert stats["log_trim"]["compactions"] >= 2
    assert all(r.scalar is not None and r.base is not None
               for r in rows.values())


@pytest.mark.parametrize("origin", ["jax", "torch"])
def test_tree_keys_export_import_both_ways(recorded, origin):
    """A snapshot naming tree channels imports into either package's host
    (the tree rows are skipped, not refused); replaying the op log then
    rebuilds them alike."""
    rec = recorded["farm1"]
    jh = JaxMergeHost(**rec.kwargs)
    th = TorchMergeHost(device="cpu", **rec.kwargs)
    replay(rec, jh, th)
    snap = (jh if origin == "jax" else th).export_state()
    assert snap["tree_keys"] == [["doc", *TREE]]
    jback = JaxMergeHost(**rec.kwargs)
    jback.import_state(copy.deepcopy(snap))
    tback = convert.merge_host_from_export(copy.deepcopy(snap), "cpu",
                                           **rec.kwargs)
    assert tback._tree_rows == {} and jback._tree_rows == {}
    replay(rec, jback, tback)
    assert_hosts_equal(jback, tback)
    assert tback.tree_snapshot("doc", *TREE) == rec.views["doc"]
    assert tback.export_state() == jback.export_state()


# -- through the service -------------------------------------------------------


def wire_edit(rng: random.Random, view: TreeSnapshot, counter, client: str
              ) -> dict:
    """One wire edit in the mix of ``random_tree_edit`` (insert 45%,
    set_value 20%, delete 15%, move 20%), against ``view``."""
    attached = [nid for nid in view.nodes
                if nid == ROOT_ID or view.nodes[nid].parent is not None]
    non_root = [n for n in attached if n != ROOT_ID]
    roll = rng.random()
    if roll < 0.45 or not non_root:
        nid = f"n{next(counter)}"
        spec = node(nid, payload=rng.randrange(100))
        if rng.random() < 0.3:
            spec["traits"]["kids"] = [node(f"{nid}k{i}")
                                      for i in range(rng.randrange(1, 3))]
        anchor = rng.choice(attached)
        if anchor != ROOT_ID and rng.random() < 0.5:
            place = {"referenceSibling": anchor,
                     "side": rng.choice(["before", "after"])}
        else:
            place = {"referenceTrait": {"parent": anchor,
                                        "label": rng.choice(["children",
                                                             "kids"])},
                     "side": rng.choice(["start", "end"])}
        changes = [{"type": "build", "source": [spec],
                    "destination": f"b-{nid}"},
                   {"type": "insert", "source": f"b-{nid}",
                    "destination": place}]
    elif roll < 0.65:
        changes = [{"type": "set_value", "node": rng.choice(non_root),
                    "payload": rng.randrange(1000)}]
    elif roll < 0.8:
        changes = [{"type": "detach",
                    "source": range_of(rng.choice(non_root))}]
    else:
        dest = rng.choice(attached)
        if dest != ROOT_ID and rng.random() < 0.5:
            place = {"referenceSibling": dest,
                     "side": rng.choice(["before", "after"])}
        else:
            place = {"referenceTrait": {"parent": dest,
                                        "label": "children"},
                     "side": rng.choice(["start", "end"])}
        mid = f"m-{next(counter)}"
        changes = [{"type": "detach",
                    "source": range_of(rng.choice(non_root)),
                    "destination": mid},
                   {"type": "insert", "source": mid, "destination": place}]
    return {"type": "edit",
            "edit": {"id": f"{client}-e{next(counter)}", "changes": changes}}


def test_tree_through_routerlicious_and_restart_matches_jax():
    """Rounds of concurrent wire edits from connected clients reach each
    package's host through its service; every round's edits target the
    tree as the previous round left it. A second service over the same
    bus and store, with a fresh host, rebuilds the tree from the durable
    op log when a client connects."""
    out = []
    for service_cls, mod, make in (
            (JaxService, jmsg, lambda: JaxMergeHost(flush_threshold=16)),
            (TorchService, tmsg,
             lambda: TorchMergeHost(flush_threshold=16, device="cpu"))):
        host = make()
        service = service_cls(merge_host=host, auto_pump=False)
        service._clock = itertools.count(1000, 7).__next__
        conns = [service.connect("doc", lambda m: None) for _ in range(4)]
        service.pump()
        rng = random.Random(5)
        counter = itertools.count()
        view = TreeSnapshot()
        cseq = {c.client_id: 0 for c in conns}
        for _round in range(12):
            head = len(service.get_deltas("doc", 0))
            for c in conns:
                cseq[c.client_id] += 1
                op = wire_edit(rng, view, counter, c.client_id)
                c.submit([mod.DocumentMessage(
                    client_sequence_number=cseq[c.client_id],
                    reference_sequence_number=head,
                    type=mod.MessageType.OPERATION,
                    contents={"address": TREE[0],
                              "contents": {"address": TREE[1],
                                           "contents": op}})])
            service.pump()
            view = TreeSnapshot()
            for m in service.get_deltas("doc", 0):
                if m.type == mod.MessageType.OPERATION:
                    txn = Transaction(view)
                    if txn.apply_edit(
                            m.contents["contents"]["contents"]["edit"]) \
                            == VALID:
                        view = txn.snapshot
        tree = host.tree_snapshot("doc", *TREE)
        assert tree == view.serialize()
        restarted = make()
        service2 = service_cls(bus=service.bus, store=service.store,
                               merge_host=restarted, auto_pump=False)
        service2.connect("doc", lambda m: None)
        service2.pump()
        assert restarted.tree_snapshot("doc", *TREE) == tree
        out.append((tree, host.summarize("doc"), host.stats,
                    host.export_state(), restarted.export_state()))
    assert out[0] == out[1]
    assert out[0][2]["device_ops"] > 20
