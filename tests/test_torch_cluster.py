"""Live placement of the port (``parallel/placement.py`` and the storm's
placement hook) against the JAX package's, on ``device="cpu"``.

The cases of ``tests/test_cluster.py`` that do not need the network
driver, as differentials: each scenario runs once
per package over its own directories with one pinned service clock per
host, makes the reference test's own assertions on its side, and
returns what it observed — digests (merged history, map rows, sequencer
checkpoints), acks and nacks (``moved_to``, ``retry_after_s``), the
``__placement__`` directory head and every host's ``__storm__`` head
(the store is content-addressed, so equal handles are equal bytes),
migration phases, rebalance and drain reports, ``get_deltas`` seqs, and
a re-homed viewer's directives and frame bytes.
The two records must be equal. The ``PlacementController`` rebalance of
``ShardResidency`` (``tests/test_sharded_serving.py``) closes the file.
"""

from __future__ import annotations

import itertools
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from fluidframework_tpu.parallel import placement as j_pl
from fluidframework_tpu.server import broadcaster as j_bc
from fluidframework_tpu.server import durable_store as j_ds
from fluidframework_tpu.tools import chaos as j_chaos
from fluidframework_tpu_torch.parallel import placement as t_pl
from fluidframework_tpu_torch.server import broadcaster as t_bc
from fluidframework_tpu_torch.server import durable_store as t_ds
from fluidframework_tpu_torch.tools import chaos as t_chaos

PKG = {
    "jax": SimpleNamespace(pl=j_pl, bc=j_bc, ds=j_ds, chaos=j_chaos,
                           dev={}),
    "torch": SimpleNamespace(pl=t_pl, bc=t_bc, ds=t_ds, chaos=t_chaos,
                             dev={"device": "cpu"}),
}
SIDES = ("jax", "torch")


def both(tmp_path, scenario, **kw):
    """Run ``scenario(side, root, **kw)`` for each package; the records
    must be equal. Returns the port's record."""
    got = {side: scenario(side, tmp_path / side, **kw) for side in SIDES}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _words(seed, k=4):
    rng = np.random.default_rng(seed)
    kinds = rng.choice([0, 0, 1], size=k).astype(np.uint32)
    slots = rng.integers(0, 16, k).astype(np.uint32)
    vals = rng.integers(0, 1 << 20, k).astype(np.uint32)
    return (kinds | (slots << 2) | (vals << 12)).astype(np.uint32)


def _build(side, root, labels=("hostA", "hostB"), active=None):
    P = PKG[side]
    git = P.ds.GitSnapshotStore(str(root / "git"))
    hosts = {}
    for label in labels:
        storm = P.pl.make_cluster_host(label, str(root / label), git,
                                       num_docs=8, **P.dev)
        storm.service._clock = itertools.count(1000, 7).__next__
        hosts[label] = storm
    return git, hosts, P.pl.StormCluster(hosts, git, active=active)


def _connect(cluster, docs):
    clients = {}
    for d in docs:
        storm = cluster.storm_for(d)
        clients[d] = storm.service.connect(d, lambda m: None).client_id
        storm.service.pump()
    return clients


def _serve_round(cluster, docs, clients, cseq, r, k=4, sink=None):
    for i, d in enumerate(docs):
        storm = cluster.storm_for(d)
        w = _words([r, i], k)
        storm.submit_frame(
            sink or (lambda p: None),
            {"rid": (r, d), "docs": [[d, clients[d], cseq[d], 1, k]]},
            memoryview(w.tobytes()))
        storm.flush()
        cseq[d] += k


def record(p) -> dict:
    """An ack or nack as a comparable record (``dw`` is thread-timed)."""
    if hasattr(p, "rows"):
        return {"rid": repr(p.get("rid")),
                "rows": np.asarray(p.rows).tolist()}
    return {k: repr(v) for k, v in p.items() if k != "dw"}


def heads(git, cluster) -> dict:
    """The directory head and every host's storm snapshot head."""
    keys = [j_pl.StormClusterDirectory.KEY] + [
        f"__storm__::{label}" for label in cluster.labels]
    return {key: git.head(key) for key in keys}


def digest(side, cluster, docs) -> dict:
    return PKG[side].chaos._cluster_digest(cluster, docs)


def close(cluster) -> None:
    for storm in cluster.hosts.values():
        if storm._group_wal is not None:
            storm._group_wal.close()


def test_port_module_keeps_the_references_names():
    assert t_pl.MIGRATION_KILL_POINTS == j_pl.MIGRATION_KILL_POINTS
    assert t_chaos.MIGRATION_KILL_POINTS == j_chaos.MIGRATION_KILL_POINTS
    assert t_chaos.CLUSTER_HOSTS == j_chaos.CLUSTER_HOSTS
    assert t_pl.__all__ == j_pl.__all__
    assert t_pl.StormClusterDirectory.KEY == j_pl.StormClusterDirectory.KEY


def test_make_cluster_host_defaults_to_the_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default serves on it")
    with pytest.raises(RuntimeError, match="cuda"):
        t_pl.make_cluster_host("hostA", str(tmp_path / "a"),
                               t_ds.GitSnapshotStore(str(tmp_path / "g")))


def _migration_under_writes(side, root):
    docs = [f"doc-{i}" for i in range(3)]

    def play(sub, migrate):
        git, hosts, cluster = _build(side, root / sub)
        clients = _connect(cluster, docs)
        cseq = {d: 1 for d in docs}
        acks = []
        for r in range(2):
            _serve_round(cluster, docs, clients, cseq, r,
                         sink=lambda p: acks.append(record(p)))
        if migrate:
            src = cluster.owner_of(docs[0])
            dst = next(h for h in cluster.labels if h != src)
            blackout = cluster.migrate(docs[0], dst)
            assert blackout > 0
            assert cluster.owner_of(docs[0]) == dst
        for r in range(2, 4):
            _serve_round(cluster, docs, clients, cseq, r,
                         sink=lambda p: acks.append(record(p)))
        out = {"digest": digest(side, cluster, docs), "acks": acks,
               "heads": heads(git, cluster),
               "stats": dict(cluster.stats),
               "migrating": dict(cluster.directory.migrating),
               "owners": dict(cluster.directory.owners)}
        close(cluster)
        return out

    migrated = play("migrated", migrate=True)
    twin = play("twin", migrate=False)
    assert migrated["digest"] == twin["digest"]
    return {"migrated": migrated, "twin": twin}


def test_migration_under_writes_matches_never_migrated_twin(tmp_path):
    got = both(tmp_path, _migration_under_writes)
    assert got["migrated"]["stats"]["migrations"] == 1


def _redirect_hints(side, root):
    docs = ["doc-0"]
    git, hosts, cluster = _build(side, root)
    clients = _connect(cluster, docs)
    cseq = {docs[0]: 1}
    _serve_round(cluster, docs, clients, cseq, 0)
    d = docs[0]
    src = cluster.owner_of(d)
    dst = next(h for h in cluster.labels if h != src)
    nacks = []

    def submit_to(label):
        w = _words([9], 4)
        cluster.hosts[label].submit_frame(
            nacks.append, {"rid": "x", "docs": [[d, clients[d],
                                                 cseq[d], 1, 4]]},
            memoryview(w.tobytes()))

    submit_to(dst)  # wrong host pre-migration
    assert nacks[-1]["error"] == "moved"
    assert nacks[-1]["moved_to"] == {d: src}
    assert nacks[-1]["retryable"] and nacks[-1]["retry_after_s"] > 0
    phases = []

    def on_phase(phase):
        phases.append(phase)
        if phase in ("frozen", "evicted", "hydrated"):
            for label in cluster.labels:
                submit_to(label)
                assert nacks[-1]["error"] == "migrating", (phase, label)
                assert nacks[-1]["retry_after_s"] > 0

    cluster.migrate(d, dst, on_phase=on_phase)
    assert phases == ["frozen", "evicted", "hydrated", "completed"]
    submit_to(src)  # old owner now redirects
    assert nacks[-1]["error"] == "moved"
    assert nacks[-1]["moved_to"] == {d: dst}
    acks = []
    w = _words([10], 4)
    cluster.hosts[dst].submit_frame(
        acks.append, {"rid": "ok", "docs": [[d, clients[d],
                                             cseq[d], 1, 4]]},
        memoryview(w.tobytes()))
    cluster.hosts[dst].flush()
    assert acks and not acks[-1].get("error")
    out = {"nacks": [record(p) for p in nacks], "phases": phases,
           "acks": [record(p) for p in acks], "heads": heads(git, cluster),
           "shed": {lb: cluster.hosts[lb].stats["shed_frames"]
                    for lb in cluster.labels},
           "digest": digest(side, cluster, docs)}
    close(cluster)
    return out


def test_moved_and_migrating_nacks_carry_redirect_hints(tmp_path):
    got = both(tmp_path, _redirect_hints)
    assert [n["error"] for n in got["nacks"]].count("'migrating'") == 6


def _cold_read_gap(side, root):
    docs = ["doc-0"]
    git, hosts, cluster = _build(side, root)
    clients = _connect(cluster, docs)
    cseq = {docs[0]: 1}
    for r in range(3):
        _serve_round(cluster, docs, clients, cseq, r)
    d = docs[0]
    src = cluster.owner_of(d)
    dst = next(h for h in cluster.labels if h != src)
    want = [m.sequence_number for m in cluster.get_deltas(d, 0)]
    assert len(want) >= 13  # join + 3 rounds of 4
    seen = {}

    def on_phase(phase):
        if phase == "completed":
            return
        seen[phase] = [m.sequence_number for m in cluster.get_deltas(d, 0)]
        if phase in ("evicted", "hydrated"):
            assert not cluster.hosts[src].residency.is_resident(d)

    cluster.migrate(d, dst, on_phase=on_phase)
    for phase in ("frozen", "evicted", "hydrated"):
        assert seen[phase] == want, phase
    after = [m.sequence_number for m in cluster.get_deltas(d, 0)]
    assert after == want
    src_only = [m.sequence_number
                for m in cluster.hosts[src].service.get_deltas(d, 0)]
    assert src_only == want
    out = {"want": want, "seen": seen, "src_only": src_only,
           "res_stats": {lb: dict(cluster.hosts[lb].residency.stats)
                         for lb in cluster.labels},
           "heads": heads(git, cluster)}
    close(cluster)
    return out


def test_cold_read_serves_gap_mid_migration_on_both_hosts(tmp_path):
    both(tmp_path, _cold_read_gap)


def _rebalance_2_to_4(side, root):
    labels = ("hostA", "hostB", "hostC", "hostD")
    git, hosts, cluster = _build(side, root, labels=labels,
                                 active=["hostA", "hostB"])
    docs = [f"doc-{i}" for i in range(8)]
    clients = _connect(cluster, docs)
    assert {cluster.owner_of(d) for d in docs} <= {"hostA", "hostB"}
    cseq = {d: 1 for d in docs}
    _serve_round(cluster, docs, clients, cseq, 0)
    cluster.activate_host("hostC")
    cluster.activate_host("hostD")
    ctrl = PKG[side].pl.PlacementController(cluster, max_moves_per_round=8)
    report = ctrl.rebalance()
    assert report["converged"], report
    assert report["doc_spread"] <= 1
    assert set(report["docs_per_host"]) == set(labels)
    assert report["moves"] >= 2
    acks = []
    _serve_round(cluster, docs, clients, cseq, 1, sink=acks.append)
    assert len([a for a in acks if not a.get("error")]) == len(docs)
    report.pop("elapsed_s")
    assert len(report.pop("blackout_s")) == report["moves"]
    # Which doc moves where is planned from each host's ledger tick cost
    # (wall clock) in either package: the records hold the converged
    # counts, the acks and the placement-agnostic digest.
    out = {"report": report, "acks": [record(p) for p in acks],
           "digest": digest(side, cluster, docs)}
    close(cluster)
    return out


def test_viewer_room_rehomes_with_moved_hint(tmp_path):
    """Migrating a doc drops its source viewer room with a ``moved_to``
    directive; the viewer catches the gap through ``get_deltas`` and
    resumes on the target's plane, whose harvest broadcasts the next
    tick."""
    def scenario(side, root):
        P = PKG[side]
        docs = ["doc-0"]
        git, hosts, cluster = _build(side, root)
        clients = _connect(cluster, docs)
        cseq = {docs[0]: 1}
        d = docs[0]
        src = cluster.owner_of(d)
        dst = next(h for h in cluster.labels if h != src)
        src_plane = P.bc.ViewerPlane(cluster.hosts[src].service)
        dst_plane = P.bc.ViewerPlane(cluster.hosts[dst].service)
        events = []
        src_plane.join(d, events.append)
        _serve_round(cluster, docs, clients, cseq, 0)
        assert not [e for e in events if isinstance(e, dict)
                    and e.get("event") == "viewer_resync"]
        cluster.migrate(d, dst)
        directives = [e for e in events if isinstance(e, dict)
                      and e.get("event") == "viewer_resync"]
        assert directives and directives[-1]["moved_to"] == dst
        assert directives[-1]["reason"] == "moved"
        assert cluster.stats["rehomed_viewers"] == 1
        gap = cluster.get_deltas(d, directives[-1]["seq"])
        hello = dst_plane.join(d, events.append)
        assert hello["viewer_id"]
        encodes0 = dst_plane.stats["tick_encodes"]
        _serve_round(cluster, docs, clients, cseq, 1)
        assert dst_plane.stats["tick_encodes"] > encodes0
        close(cluster)
        return [[bytes(e) if isinstance(e, (bytes, bytearray)) else e
                 for e in events],
                [m.sequence_number for m in gap], hello,
                src_plane.stats, dst_plane.stats, cluster.stats]

    both(tmp_path, scenario)


def test_rebalance_2_to_4_hosts_converges(tmp_path):
    both(tmp_path, _rebalance_2_to_4)


def _drain(side, root):
    git, hosts, cluster = _build(side, root)
    docs = [f"doc-{i}" for i in range(4)]
    clients = _connect(cluster, docs)
    cseq = {d: 1 for d in docs}
    _serve_round(cluster, docs, clients, cseq, 0)
    hot = max(cluster.labels, key=lambda h: len(cluster.owned(h)))
    assert cluster.owned(hot)
    report = PKG[side].pl.PlacementController(cluster).drain(hot)
    assert report["remaining"] == 0
    assert not cluster.owned(hot)
    report.pop("elapsed_s")
    out = {"report": report, "owners": {d: cluster.owner_of(d)
                                        for d in docs},
           "heads": heads(git, cluster),
           "digest": digest(side, cluster, docs)}
    close(cluster)
    return out


def test_drain_host_moves_every_doc(tmp_path):
    both(tmp_path, _drain)


def _intent_rolls_forward(side, root):
    docs = ["doc-0"]
    git, hosts, cluster = _build(side, root)
    clients = _connect(cluster, docs)
    cseq = {docs[0]: 1}
    _serve_round(cluster, docs, clients, cseq, 0)
    d = docs[0]
    src = cluster.owner_of(d)
    dst = next(h for h in cluster.labels if h != src)
    cluster.directory.freeze(d, src, dst)
    cluster.hosts[src].residency.evict(d, reason="migration")
    code, _ = cluster._route(d, src)
    assert code == "migrating"
    completed = cluster.recover()
    assert completed == [d]
    assert cluster.owner_of(d) == dst
    assert cluster.hosts[dst].residency.is_resident(d)
    acks = []
    _serve_round(cluster, docs, clients, cseq, 1, sink=acks.append)
    assert acks and not acks[-1].get("error")
    out = {"completed": completed, "acks": [record(p) for p in acks],
           "heads": heads(git, cluster),
           "digest": digest(side, cluster, docs)}
    close(cluster)
    return out


def test_directory_intent_rolls_forward(tmp_path):
    both(tmp_path, _intent_rolls_forward)


def test_migration_kill_points_registered():
    assert t_pl.MIGRATION_KILL_POINTS == (
        "placement.pre_evict", "placement.post_evict",
        "placement.post_hydrate")


def _round_trip(side, root):
    docs = ["doc-0"]
    git, hosts, cluster = _build(side, root)
    clients = _connect(cluster, docs)
    cseq = {docs[0]: 1}
    d = docs[0]
    for r in range(2):
        _serve_round(cluster, docs, clients, cseq, r)
    src = cluster.owner_of(d)
    dst = next(h for h in cluster.labels if h != src)
    cluster.migrate(d, dst)
    for r in range(2, 4):
        _serve_round(cluster, docs, clients, cseq, r)
    cluster.migrate(d, src)  # back home
    for r in range(4, 6):
        _serve_round(cluster, docs, clients, cseq, r)
    want = list(range(1, 1 + 1 + 6 * 4))  # join + 6 rounds of 4
    got = [m.sequence_number for m in cluster.get_deltas(d, 0)]
    assert got == want
    cluster.hosts[src].residency.evict(d, reason="idle")
    got_cold = [m.sequence_number for m in cluster.get_deltas(d, 0)]
    assert got_cold == want
    out = {"got": got, "got_cold": got_cold, "heads": heads(git, cluster),
           "per_host": {lb: [m.sequence_number for m in
                             cluster.hosts[lb].service.get_deltas(d, 0)]
                        for lb in cluster.labels},
           "digest": digest(side, cluster, docs)}
    close(cluster)
    return out


def test_round_trip_migration_keeps_full_history_readable(tmp_path):
    both(tmp_path, _round_trip)


def _activation_survives(side, root):
    labels = ("hostA", "hostB", "hostC", "hostD")
    git, hosts, cluster = _build(side, root, labels=labels,
                                 active=["hostA", "hostB"])
    cluster.activate_host("hostC")
    cluster.activate_host("hostD")
    rebuilt = PKG[side].pl.StormCluster(hosts, git)
    assert sorted(rebuilt.active) == sorted(labels)
    assert sorted(rebuilt.hosts_list()) == sorted(labels)
    out = {"active": rebuilt.active, "heads": heads(git, rebuilt)}
    close(cluster)
    return out


def test_activation_survives_cluster_rebuild(tmp_path):
    both(tmp_path, _activation_survives)


class _TenantBackend:
    """Deterministic duck-typed backend: three hosts, per-doc tenants,
    static signals — plan() is pure in these."""

    def __init__(self, owned, tenants, loads=None):
        self._owned = {h: list(ds) for h, ds in owned.items()}
        self._tenants = tenants
        self._loads = loads or {}

    def hosts_list(self):
        return sorted(self._owned)

    def owned(self, host):
        return list(self._owned[host])

    def load_signals(self, host):
        tload = {}
        for d in self._owned[host]:
            t = self._tenants.get(d)
            if t is not None:
                tload[t] = tload.get(t, 0) + 1
        return {"docs": len(self._owned[host]), "queue_depth": 0,
                "tick_cost_ms": self._loads.get(host, 0.0),
                "tenant_load": tload}

    def doc_tenant(self, host, doc):
        return self._tenants.get(doc)

    def migrate(self, doc, dst):
        for ds in self._owned.values():
            if doc in ds:
                ds.remove(doc)
        self._owned[dst].append(doc)


def _tenant_plans(side, _root):
    tenants = {f"h{i}": "hot" for i in range(6)}
    tenants.update({f"b{i}": "quiet" for i in range(3)})
    owned = {"A": [f"h{i}" for i in range(6)],
             "B": ["h5x", "b0", "b1"], "C": ["b2", "q0", "q1"]}
    backend = _TenantBackend(
        owned=owned, tenants=dict(tenants, h5x="hot", q0="quiet",
                                  q1="quiet"))
    ctrl = PKG[side].pl.PlacementController(backend, max_moves_per_round=2)
    plan = ctrl.plan()
    assert plan, "over-count host must shed"
    for doc, src, _dst in plan:
        assert src == "A"
        assert backend.doc_tenant(src, doc) == "hot"
    assert [dst for _d, _s, dst in plan] == ["C", "B"], plan

    class _Blind(_TenantBackend):
        doc_tenant = None
    blind = _Blind(owned=owned, tenants={})
    del _Blind.doc_tenant
    blind_plan = PKG[side].pl.PlacementController(
        blind, max_moves_per_round=2).plan()
    assert [doc for doc, *_ in blind_plan] == ["h0", "h1"]
    # A loaded backend: the tick cost picks the donor among over-count
    # hosts, and the rebalance converges on the same moves.
    loaded = _TenantBackend(owned=owned, tenants={},
                            loads={"A": 4.0, "B": 1.0, "C": 9.0})
    ctrl2 = PKG[side].pl.PlacementController(loaded, max_moves_per_round=3)
    sigs = ctrl2.signals()
    report = ctrl2.rebalance()
    report.pop("elapsed_s")
    report.pop("blackout_s")
    return {"plan": plan, "blind": blind_plan, "signals": sigs,
            "report": report,
            "moves": [(m.doc, m.src, m.dst) for m in ctrl2.moves]}


def test_plan_spreads_hot_tenant_across_hosts(tmp_path):
    both(tmp_path, _tenant_plans)


def _tenant_signals(side, root):
    git, hosts, cluster = _build(side, root)
    docs = ["doc-0", "doc-1"]
    clients = _connect(cluster, docs)
    cseq = {d: 1 for d in docs}
    for i, d in enumerate(docs):
        storm = cluster.storm_for(d)
        storm.submit_frame(
            lambda p: None,
            {"rid": d, "docs": [[d, clients[d], cseq[d], 1, 4]]},
            memoryview(_words([9, i]).tobytes()),
            tenant_id="tn-hot")
        storm.flush()
    total = {}
    sigs = {}
    for label in cluster.labels:
        sig = cluster.load_signals(label)
        sigs[label] = {k: sig[k] for k in ("docs", "queue_depth",
                                           "tenant_load")}
        for t, n in sig["tenant_load"].items():
            total[t] = total.get(t, 0) + n
        for d in cluster.owned(label):
            if d in docs:
                assert cluster.doc_tenant(label, d) == "tn-hot"
    assert total == {"tn-hot": 2}
    close(cluster)
    return {"total": total, "signals": sigs}


def test_cluster_load_signals_carry_tenant_load(tmp_path):
    both(tmp_path, _tenant_signals)


def _batch_drain(side, root):
    docs = [f"doc-{i}" for i in range(4)]
    git, hosts, cluster = _build(side, root)
    clients = _connect(cluster, docs)
    cseq = {d: 1 for d in docs}
    _serve_round(cluster, docs, clients, cseq, 0)
    hot = max(cluster.labels, key=lambda h: len(cluster.owned(h)))
    n_docs = len(cluster.owned(hot))
    assert n_docs >= 2
    saves = []
    cls = type(cluster.directory)
    orig = cls._save

    def counting_save(self):
        saves.append(1)
        return orig(self)

    cls._save = counting_save
    try:
        report = PKG[side].pl.PlacementController(cluster).drain(hot)
    finally:
        cls._save = orig
    assert report["remaining"] == 0
    assert report["moves"] == n_docs
    assert report["directory_writes"] == 2
    assert len(saves) == 2, saves
    assert not cluster.directory.migrating
    _serve_round(cluster, docs, clients, cseq, 1)
    dg = digest(side, cluster, docs)
    for d in docs:
        assert dg["docs"][d]["map"]
    report.pop("elapsed_s")
    out = {"report": report, "saves": len(saves), "digest": dg,
           "heads": heads(git, cluster)}
    close(cluster)
    return out


def test_batch_drain_uses_two_directory_writes(tmp_path):
    both(tmp_path, _batch_drain)


def _batch_recovery(side, root):
    docs = ["doc-0", "doc-1", "doc-2"]
    git, hosts, cluster = _build(side, root)
    clients = _connect(cluster, docs)
    cseq = {d: 1 for d in docs}
    _serve_round(cluster, docs, clients, cseq, 0)
    hot = max(cluster.labels, key=lambda h: len(cluster.owned(h)))
    dst = next(h for h in cluster.labels if h != hot)
    mine = list(cluster.owned(hot))
    cluster.directory.freeze_many([(d, hot, dst) for d in mine])
    for d in mine:
        assert cluster._route(d, hot)[0] == "migrating"
        if cluster.hosts[hot].residency.is_resident(d):
            cluster.hosts[hot].residency.evict(d, reason="migration")
    completed = cluster.recover()
    assert sorted(completed) == sorted(mine)
    for d in mine:
        assert cluster.owner_of(d) == dst
    _serve_round(cluster, docs, clients, cseq, 1)
    out = {"completed": completed, "heads": heads(git, cluster),
           "digest": digest(side, cluster, docs)}
    close(cluster)
    return out


def test_batch_drain_recovery_rolls_each_intent_forward(tmp_path):
    both(tmp_path, _batch_recovery)


def test_shard_residency_rebalance_2_to_4_matches_jax():
    """``tests/test_sharded_serving.py``'s live placement of the
    device-lane tier: genesis on 2 of 4 host ranges, activation, then the
    port's ``PlacementController`` rebalances the port's
    ``ShardResidency`` exactly as the reference's does its own."""
    from fluidframework_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from fluidframework_tpu.parallel.serving import \
        ShardedServing as JaxServing
    from fluidframework_tpu.parallel.serving import \
        ShardResidency as JaxResidency
    from fluidframework_tpu_torch.parallel.mesh import make_mesh
    from fluidframework_tpu_torch.parallel.serving import (
        ShardedServing,
        ShardResidency,
    )

    docs = [f"doc-{i}" for i in range(8)]
    got = {}
    for side in SIDES:
        if side == "jax":
            serving = JaxServing(jax_make_mesh(jax.devices()[:1]),
                                 num_docs=8, k=4, num_hosts=4, map_slots=8)
            res = JaxResidency(serving, active_hosts=(0, 1))
        else:
            serving = ShardedServing(make_mesh(["cpu"]), num_docs=8, k=4,
                                     num_hosts=4, map_slots=8)
            res = ShardResidency(serving, active_hosts=(0, 1))
        want = {}
        for i, doc in enumerate(docs):
            row = res.resolve(doc)
            assert res.host_for(doc) in (0, 1)
            value = 10 + i
            serving.submit(row, np.array([(value << 12) | (1 << 2)],
                                         np.uint32), first_cseq=1)
            serving.tick()
            want[doc] = value
        serving.flush()
        before = {d: res.host_for(d) for d in docs}
        res.activate_host(2)
        res.activate_host(3)
        assert {d: res.host_for(d) for d in docs} == before
        ctrl = PKG[side].pl.PlacementController(res, max_moves_per_round=8)
        report = ctrl.rebalance()
        assert report["converged"], report
        assert set(report["docs_per_host"]) == {0, 1, 2, 3}
        assert res.stats["migrations"] >= 2
        assert len(res.blackouts_s) == res.stats["migrations"]
        values = {}
        for doc in docs:
            row = res.resolve(doc)
            assert serving.hosts[res.host_for(doc)].owns(row)
            if side == "jax":
                values[doc] = int(np.asarray(serving.map_state.value)[row, 1])
            else:
                values[doc] = int(serving.map_rows()[row, 1])
            assert values[doc] == want[doc], doc
        report.pop("elapsed_s")
        report.pop("blackout_s")
        got[side] = {"report": report, "values": values,
                     "moves": [(m.doc, m.src, m.dst) for m in ctrl.moves],
                     "placement": dict(res.placement),
                     "rows": {d: res.resolve(d) for d in docs},
                     "stats": dict(res.stats)}
    assert got["torch"] == got["jax"]
