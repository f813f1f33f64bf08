"""Mega-doc write scale-out of the port (``server/megadoc.py`` and the
storm's mega-doc hooks) against the JAX package's, on ``device="cpu"``.

``tests/test_megadoc.py`` and ``tests/test_megadoc_roundtrip.py`` as
differentials. Each scenario runs once per package with the reference
test's deterministic service clock and returns what it observed —
converged entries, per-frame ack quads, materialized history, sequencer
checkpoints, combiner state (``export_state``), WAL bytes, snapshot
handles (content-addressed: equal handles are equal bytes) — and the two
records must be equal. Inside each record the reference's own bars hold
too: promoted ≡ single-lane ≡ the scalar ``MapData`` fold. Recovery is
crossed: each side recovers the other's promoted WAL and snapshot.
"""

from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fluidframework_tpu.dds import map_data as j_md
from fluidframework_tpu.protocol import messages as j_msgs
from fluidframework_tpu.server import durable_store as j_ds
from fluidframework_tpu.server import kernel_host as j_kh
from fluidframework_tpu.server import megadoc as j_mg
from fluidframework_tpu.server import merge_host as j_mh
from fluidframework_tpu.server import residency as j_res
from fluidframework_tpu.server import routerlicious as j_rl
from fluidframework_tpu.server import sequencer as j_seq
from fluidframework_tpu.server import storm as j_storm
from fluidframework_tpu_torch.dds import map_data as t_md
from fluidframework_tpu_torch.ops import sequencer as t_seqk
from fluidframework_tpu_torch.protocol import messages as t_msgs
from fluidframework_tpu_torch.server import durable_store as t_ds
from fluidframework_tpu_torch.server import kernel_host as t_kh
from fluidframework_tpu_torch.server import megadoc as t_mg
from fluidframework_tpu_torch.server import merge_host as t_mh
from fluidframework_tpu_torch.server import residency as t_res
from fluidframework_tpu_torch.server import routerlicious as t_rl
from fluidframework_tpu_torch.server import sequencer as t_seq
from fluidframework_tpu_torch.server import storm as t_storm

PKG = {
    "jax": SimpleNamespace(ds=j_ds, kh=j_kh, mh=j_mh, mg=j_mg, rl=j_rl,
                           storm=j_storm, md=j_md, msgs=j_msgs, seq=j_seq,
                           res=j_res, dev={}),
    "torch": SimpleNamespace(ds=t_ds, kh=t_kh, mh=t_mh, mg=t_mg, rl=t_rl,
                             storm=t_storm, md=t_md, msgs=t_msgs,
                             seq=t_seq, res=t_res, dev={"device": "cpu"}),
}
SIDES = ("jax", "torch")
K = 6  # ops per frame in the fuzz


def build_stack(side, root=None, lanes=None, **storm_kw):
    P = PKG[side]
    seq = P.kh.KernelSequencerHost(num_slots=2, initial_capacity=4, **P.dev)
    mh = P.mh.KernelMergeHost(flush_threshold=10**9, **P.dev)
    kwargs = {}
    if root is not None:
        root = str(root)
        kwargs["bus"] = P.ds.DurableMessageBus(os.path.join(root, "bus"))
        kwargs["store"] = P.ds.FileStateStore(os.path.join(root, "state"))
        storm_kw.setdefault("spill_dir", os.path.join(root, "spill"))
        storm_kw.setdefault("durability", "group")
        storm_kw.setdefault("snapshots",
                            P.ds.GitSnapshotStore(os.path.join(root, "git")))
    svc = P.rl.RouterliciousService(merge_host=mh, batched_deli_host=seq,
                                    auto_pump=False,
                                    idle_check_interval=10**9, **kwargs)
    svc._clock = lambda: 5  # deterministic ts: clu planes must compare
    storm = P.storm.StormController(svc, seq, mh,
                                    flush_threshold_docs=10**9, **storm_kw)
    mgr = P.mg.MegaDocManager(storm, default_lanes=lanes) if lanes else None
    return SimpleNamespace(P=P, svc=svc, storm=storm, seq=seq, mh=mh,
                           mgr=mgr)


def close(s):
    if s.storm._group_wal is not None:
        s.storm._group_wal.close()


def storm_words(seed, r, w, k=K, slots=16):
    rng = np.random.default_rng([seed, r, w])
    kinds = rng.choice([0, 0, 0, 1], size=k).astype(np.uint32)
    kslots = rng.integers(0, slots, k).astype(np.uint32)
    vals = rng.integers(0, 1 << 20, k).astype(np.uint32)
    return (kinds | (kslots << 2) | (vals << 12)).astype(np.uint32)


def entries_of(s, doc):
    return s.mh.map_entries(doc, s.storm.datastore, s.storm.channel)


def checkpoint(s, doc, arrival_clock=True):
    cp = dataclasses.asdict(s.seq.checkpoint(doc))
    if not arrival_clock:
        cp.pop("log_offset", None)
        for c in cp["clients"]:
            c["last_update"] = 0
    return cp


def wal(root) -> bytes:
    return open(os.path.join(str(root), "spill",
                             "storm_tick_words.log"), "rb").read()


# -- the combiner's scalar ticket vs the closed form ---------------------------


def test_mirror_matches_storm_tickets_and_jax():
    """The port's DocSequencerMirror against the port's closed-form
    ``storm_tickets`` and against the JAX mirror, on random batches
    (fresh / dup / overlap / gap / stale-ref)."""
    rng = np.random.default_rng(11)
    n_clients = 3
    state = t_seqk.init_state(1, n_clients, "cpu")
    state = state._replace(active=torch.ones_like(state.active),
                           cref=torch.zeros_like(state.cref))
    mirrors = [j_mg.DocSequencerMirror(), t_mg.DocSequencerMirror()]
    for m in mirrors:
        for c in range(n_clients):
            m.adopt(f"c{c}", 1, clu=0)
    next_cseq = [1] * n_clients
    for step in range(80):
        c = int(rng.integers(n_clients))
        kind = rng.choice(["fresh", "dup", "overlap", "gap", "stale"],
                          p=[0.55, 0.15, 0.1, 0.1, 0.1])
        n = int(rng.integers(1, 5))
        cseq0 = {"fresh": next_cseq[c], "dup": max(1, next_cseq[c] - n),
                 "overlap": max(1, next_cseq[c] - 1),
                 "gap": next_cseq[c] + 2, "stale": next_cseq[c]}[kind]
        ref = 0 if kind == "stale" else int(rng.integers(1, 4))
        ts = 100 + step
        state, _dups, n_seq, msn = t_seqk.storm_tickets(
            state, torch.tensor([c]), torch.tensor([cseq0]),
            torch.tensor([ref]), torch.tensor([ts]), torch.tensor([n]))
        decs = [m.decide(f"c{c}", cseq0, ref, n, ts) for m in mirrors]
        assert decs[0] == decs[1], (step, kind)
        tm = mirrors[1]
        assert decs[1].n_seq == int(n_seq[0]), (step, kind)
        assert decs[1].msn == int(msn[0]), (step, kind)
        assert tm.seq == int(state.seq[0])
        for cc in range(n_clients):
            w = tm.writers[f"c{cc}"]
            assert w.cseq == int(state.cseq[0, cc])
            assert w.ref == int(state.cref[0, cc])
            assert w.nack == bool(state.cnack[0, cc])
        assert tm.last_sent_msn == int(state.last_sent_msn[0])
        assert mirrors[0].export() == tm.export()
        if decs[1].n_seq > 0:
            next_cseq[c] = cseq0 + n
    assert mirrors[1].seq > 0


# -- the serving-level differential fuzz ---------------------------------------


def _adversarial_frames(seed, writers, rounds):
    """The reference test's frame plans: mostly fresh batches, plus
    verbatim dup resends, partial overlaps, gaps and one stale ref."""
    rng = np.random.default_rng(seed)
    plans = []
    cseqs = {w: 1 for w in range(writers)}
    prev = {}
    stale_used = False
    for r in range(rounds):
        row = []
        for w in range(writers):
            action = rng.choice(["fresh", "fresh", "fresh", "dup",
                                 "overlap", "gap", "stale"])
            words = storm_words(seed, r, w)
            if action == "dup" and w in prev:
                cseq0, words = prev[w]
                ref = 1
            elif action == "overlap" and w in prev and cseqs[w] > K:
                p_cseq0, p_words = prev[w]
                cseq0 = p_cseq0 + K - 2
                words = np.concatenate([p_words[-2:], words])[:K + 2]
                cseqs[w] = cseq0 + len(words)
                ref = 1
            elif action == "gap":
                cseq0 = cseqs[w] + 3
                ref = 1
            elif action == "stale" and not stale_used and r > 1:
                stale_used = True
                cseq0 = cseqs[w]
                ref = 0
            else:
                cseq0 = cseqs[w]
                cseqs[w] = cseq0 + K
                ref = 1
                prev[w] = (cseq0, words)
            row.append((w, cseq0, ref, words))
        plans.append(row)
    return plans


def _play(side, plans, writers, mega_lanes):
    s = build_stack(side, lanes=mega_lanes)
    doc = "hot"
    clients = {w: s.svc.connect(doc, lambda m: None).client_id
               for w in range(writers)}
    s.svc.pump()
    if mega_lanes:
        s.mgr.promote(doc, lanes=mega_lanes)
    acks = {}
    for r, row in enumerate(plans):
        for w, cseq0, ref, words in row:
            s.storm.submit_frame(
                lambda p, key=(r, w): acks.__setitem__(key, p),
                {"rid": f"{r}-{w}",
                 "docs": [[doc, clients[w], int(cseq0), int(ref),
                           len(words)]]},
                memoryview(np.ascontiguousarray(words).tobytes()))
        s.storm.flush()
    s.storm.flush()
    if mega_lanes:
        entries = s.mgr.map_entries(doc)
        s.mgr.demote(doc)
        assert entries_of(s, doc) == entries  # the fold IS the read
    else:
        entries = entries_of(s, doc)
    recs = s.storm.records_overlapping(doc, 0)
    msgs = s.P.storm.materialize_storm_records(
        recs, s.storm.datastore, s.storm.channel,
        blob_reader=s.storm.read_tick_words)
    history = [(m.sequence_number, m.client_sequence_number, m.client_id,
                m.minimum_sequence_number, m.reference_sequence_number,
                repr(m.contents["contents"]["contents"])) for m in msgs]
    data = s.P.md.MapData()
    for m in msgs:
        data.process(m.contents["contents"]["contents"], False, None)
    assert dict(data.items()) == entries  # the scalar oracle
    ack_rows = {key: np.asarray(a.rows).tolist() for key, a in acks.items()}
    return (entries, ack_rows, history, checkpoint(s, doc),
            s.storm.stats["ticks"], dict(s.storm.stats))


@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_equals_single_lane_equals_scalar_and_jax(seed):
    writers, rounds, lanes = 5, 6, 2
    plans = _adversarial_frames(100 + seed, writers, rounds)
    runs = {(side, lanes_): _play(side, plans, writers, lanes_)
            for side in SIDES for lanes_ in (None, lanes)}
    for lanes_ in (None, lanes):
        assert runs[("torch", lanes_)] == runs[("jax", lanes_)]
    single, mega = runs[("torch", None)], runs[("torch", lanes)]
    assert single[:4] == mega[:4]
    assert mega[4] < single[4]  # lanes combined writer frames into ticks


def test_zero_op_outcomes_synthesize_identical_acks():
    plans = [
        [(0, 1, 1, storm_words(1, 0, 0)), (1, 1, 1, storm_words(1, 0, 1))],
        [(0, 1 + K, 1, storm_words(1, 1, 0)),
         (1, 1, 1, storm_words(1, 0, 1))],
        [(0, 1 + 2 * K, 0, storm_words(1, 2, 0)),
         (1, 1 + K + 5, 1, storm_words(1, 2, 1))],
    ]
    runs = {(side, lanes): _play(side, plans, 2, lanes)
            for side in SIDES for lanes in (None, 2)}
    assert runs[("torch", 2)] == runs[("jax", 2)]
    assert runs[("torch", None)] == runs[("jax", None)]
    assert runs[("torch", None)][:4] == runs[("torch", 2)][:4]
    a = runs[("torch", 2)][1]
    assert a[(1, 1)][0][0] == a[(2, 1)][0][0] == a[(2, 0)][0][0] == 0


# -- lifecycle -----------------------------------------------------------------


def _auto(side, _root):
    s = build_stack(side, lanes=2)
    s.mgr.writer_threshold = 3
    s.mgr.writer_window_ticks = 1
    s.mgr.demote_idle_ticks = 3
    hot, cold = "hot", "side"
    hclients = {w: s.svc.connect(hot, lambda m: None).client_id
                for w in range(3)}
    sclient = s.svc.connect(cold, lambda m: None).client_id
    s.svc.pump()
    cseqs = {w: 1 for w in range(3)}
    acks = []
    for r in range(2):
        for w in range(3):
            s.storm.submit_frame(acks.append, {
                "rid": f"{r}{w}",
                "docs": [[hot, hclients[w], cseqs[w], 1, K]]},
                memoryview(storm_words(5, r, w).tobytes()))
            cseqs[w] += K
        s.storm.flush()
    rec = {"promoted": s.mgr.is_promoted(hot)}
    sq, demoted_at = 1, None
    for r in range(8):
        s.storm.submit_frame(acks.append, {
            "rid": f"s{r}", "docs": [[cold, sclient, sq, 1, K]]},
            memoryview(storm_words(6, r, 0).tobytes()))
        sq += K
        s.storm.flush()
        if demoted_at is None and not s.mgr.is_promoted(hot):
            demoted_at = r
    m = s.mh.metrics
    rec.update(demoted_at=demoted_at, history=s.mgr.has_history(hot),
               acks=[np.asarray(a.rows).tolist() for a in acks],
               counters=(m.counter("megadoc.promotions").value,
                         m.counter("megadoc.demotions").value),
               state=s.mgr.export_state(), entries=entries_of(s, hot),
               stats=dict(s.storm.stats))
    return rec


def test_auto_promotion_and_idle_demotion_match_jax(tmp_path):
    j, t = (_auto(side, None) for side in SIDES)
    assert t == j
    assert t["promoted"] and t["demoted_at"] is not None
    assert t["history"] and t["counters"] == (1, 1)


def _recover_lifecycle(side, root):
    writers = 4
    s = build_stack(side, root, lanes=2)
    doc = "hot"
    clients = {w: s.svc.connect(doc, lambda m: None).client_id
               for w in range(writers)}
    s.svc.pump()
    s.storm.checkpoint()
    s.mgr.promote(doc, lanes=2)
    cseqs = {w: 1 for w in range(writers)}
    acks = []

    def serve(rounds):
        for r in rounds:
            for w in range(writers):
                s.storm.submit_frame(acks.append, {
                    "rid": f"{r}{w}",
                    "docs": [[doc, clients[w], cseqs[w], 1, K]]},
                    memoryview(storm_words(8, r, w).tobytes()))
                cseqs[w] += K
            s.storm.flush()

    serve(range(3))
    handle = s.storm.checkpoint()  # WITH the promoted combiner state
    snap = s.storm.snapshots.get(s.storm.SNAPSHOT_DOC, handle)
    serve(range(3, 5))
    rec = {"entries": s.mgr.map_entries(doc),
           "state": s.mgr.export_state(), "handle": handle,
           "has_megadoc": "megadoc" in snap,
           # ``dw`` is left out: each ack carries the durable watermark
           # at its push, which the writer thread's timing sets.
           "acks": [(a["rid"], np.asarray(a.rows).tolist())
                    for a in acks],
           "stats": dict(s.storm.stats)}
    close(s)
    rec["wal"] = wal(root)
    return rec


def _recover_into(side, root, want):
    s2 = build_stack(side, root, lanes=2)
    info = s2.storm.recover()
    assert info["restored_from"] is not None and info["replayed_ticks"] > 0
    assert s2.mgr.map_entries("hot") == want["entries"]
    assert s2.mgr.export_state() == want["state"]
    s2.mgr.demote("hot")
    assert entries_of(s2, "hot") == want["entries"]
    close(s2)


def test_recovered_promoted_lifecycle_matches_jax(tmp_path):
    """WAL (``mg`` control records included) and ``megadoc`` snapshots
    byte-equal to JAX's; every side recovers its own and the other's."""
    recs = {side: _recover_lifecycle(side, tmp_path / side)
            for side in SIDES}
    assert recs["torch"] == recs["jax"]
    assert recs["torch"]["has_megadoc"]
    assert b'"mg":{"op":"promote"' in recs["torch"]["wal"]
    for writer in SIDES:
        for reader in SIDES:
            root = tmp_path / f"{writer}-{reader}"
            import shutil
            shutil.copytree(tmp_path / writer, root)
            _recover_into(reader, root, recs[writer])


def test_residency_refuses_evicting_promoted_doc_like_jax(tmp_path):
    msgs = []
    for side in SIDES:
        s = build_stack(side, tmp_path / side, lanes=2)
        res = s.P.res.ResidencyManager(s.storm, max_resident=8,
                                       idle_evict_s=1e9,
                                       hydration_rate_per_s=1e9)
        client = s.svc.connect("hot", lambda m: None).client_id
        s.svc.pump()
        s.storm.checkpoint()
        s.mgr.promote("hot", lanes=2)
        s.storm.submit_frame(None, {"rid": 0,
                                    "docs": [["hot", client, 1, 1, K]]},
                             memoryview(storm_words(9, 0, 0).tobytes()))
        s.storm.flush()
        with pytest.raises(s.P.res.EvictionRefused,
                           match="mega-promoted") as err:
            res.evict("hot")
        msgs.append(str(err.value))
        s.mgr.demote("hot")
        res.evict("hot")
        close(s)
    assert msgs[0] == msgs[1]


# -- the cross-lane fold, lane hashing, ids ------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_fold_map_rows_matches_jax(seed):
    rng = np.random.default_rng(seed)
    sources = []
    for _ in range(int(rng.integers(1, 6))):
        s = 24
        vseq = rng.integers(-1, 40, s).astype(np.int64)
        sources.append({"present": rng.random(s) < 0.5,
                        "value": rng.integers(0, 1 << 20, s),
                        "vseq": vseq,
                        "cleared_seq": int(rng.integers(-1, 30))})
    a, b = j_mg.fold_map_rows(sources), t_mg.fold_map_rows(sources)
    assert a.keys() == b.keys()
    for f in a:
        assert np.array_equal(np.asarray(a[f]), np.asarray(b[f])), f
        assert np.asarray(a[f]).dtype == np.asarray(b[f]).dtype, f


def test_lane_ids_and_hash_match_jax():
    ids = [f"client-{i}" for i in range(200)] + ["", "x" * 40, "é"]
    for lanes in (1, 2, 3, 8):
        assert [t_mg.lane_of_writer(c, lanes) for c in ids] \
            == [j_mg.lane_of_writer(c, lanes) for c in ids]
    assert {t_mg.lane_of_writer(f"client-{i}", 4)
            for i in range(64)} == set(range(4))
    for doc, lane, epoch in (("d", 0, 0), ("a::b", 3, 0), ("d", 1, 2)):
        lid = t_mg.lane_id(doc, lane, epoch)
        assert lid == j_mg.lane_id(doc, lane, epoch)
        assert t_mg.parse_lane_full(lid) == j_mg.parse_lane_full(lid)
        assert t_mg.parse_lane(lid) == j_mg.parse_lane(lid)
    assert t_mg.parse_lane("plain") is None


def _mega_serve(s, doc, writers, rounds, r0=0, ref=-1):
    for r in range(r0, r0 + rounds):
        for w, client in enumerate(writers):
            s.storm.submit_frame(None, {
                "rid": f"{r}.{w}",
                "docs": [[doc, client, 1 + r * K, ref, K]]},
                memoryview(storm_words(11, r, w).tobytes()))
        s.storm.flush()


def _trim(side, trim):
    doc = "mega-trim"
    s = build_stack(side, lanes=2)
    s.mgr.trim_combine_logs = trim
    writers = [s.svc.connect(doc, lambda m: None).client_id
               for _ in range(2)]
    s.svc.pump()
    s.mgr.promote(doc, lanes=2)
    _mega_serve(s, doc, writers, 24)
    st = s.mgr.docs[doc]
    rec = {"entries": s.mgr.map_entries(doc),
           "segments": sum(len(log.lane_firsts) for log in st.logs),
           "floors": [(log.floor_lane, log.floor_doc) for log in st.logs],
           "state": s.mgr.export_state()}
    floor_doc = max(log.floor_doc for log in st.logs)
    rec["recent"] = len(s.storm.records_overlapping(doc, floor_doc))
    if trim:
        with pytest.raises(ValueError, match="reload from a snapshot"):
            s.storm.records_overlapping(doc, 0)
    return rec


def test_combine_log_trim_matches_jax():
    recs = {(side, trim): _trim(side, trim)
            for side in SIDES for trim in (True, False)}
    for trim in (True, False):
        assert recs[("torch", trim)] == recs[("jax", trim)]
    t, u = recs[("torch", True)], recs[("torch", False)]
    assert t["entries"] == u["entries"] and t["entries"]
    assert u["segments"] == 48 and t["segments"] <= 8
    assert any(f[0] > 0 for f in t["floors"]) and t["recent"]


def _digest(s, doc, kinds=False):
    return {
        "map": entries_of(s, doc),
        "history": [[m.sequence_number, m.client_sequence_number]
                    + ([int(m.type)] if kinds else []) + [m.client_id]
                    for m in s.svc.get_deltas(doc, 0)],
        "sequencer": checkpoint(s, doc, arrival_clock=False),
    }


def _epochs(side, root, promote):
    doc = "mega-epochs"
    s = build_stack(side, root, lanes=2)
    writers = [s.svc.connect(doc, lambda m: None).client_id
               for _ in range(2)]
    s.svc.pump()
    s.storm.checkpoint()
    if promote:
        s.mgr.promote(doc, lanes=2)
    _mega_serve(s, doc, writers, 2, r0=0)
    if promote:
        s.mgr.demote(doc)
        s.mgr.promote(doc, lanes=2)  # epoch 1
        assert all("::~mg1." in lid for lid in s.mgr.lane_ids(doc))
    _mega_serve(s, doc, writers, 2, r0=2)
    if promote:
        s.mgr.demote(doc)
    s.storm.flush()
    rec = {"digest": _digest(s, doc)}
    close(s)  # the group-commit writer has written every record
    rec["wal"] = wal(root)
    s2 = build_stack(side, root, lanes=2)
    s2.storm.recover()
    rec["recovered"] = _digest(s2, doc)
    st = s2.mgr.docs.get(doc)
    rec["epochs"] = (st.epoch if st is not None else None,
                     [p.epoch for p in s2.mgr.past_epochs.get(doc, [])])
    close(s2)
    return rec


def test_re_promotion_epochs_match_twin_and_jax(tmp_path):
    recs = {(side, p): _epochs(side, tmp_path / f"{side}-{p}", p)
            for side in SIDES for p in (True, False)}
    for p in (True, False):
        assert recs[("torch", p)] == recs[("jax", p)]
    cycled, plain = recs[("torch", True)], recs[("torch", False)]
    assert cycled["digest"] == plain["digest"] == cycled["recovered"]
    assert cycled["epochs"] == (1, [0])


def _join_mid(side, root, promote):
    doc = "mega-join"
    s = build_stack(side, root, lanes=2)

    def serve(participants, r0, rounds):
        for r in range(r0, r0 + rounds):
            for w, (client, base) in enumerate(participants):
                s.storm.submit_frame(None, {
                    "rid": f"{r}.{w}",
                    "docs": [[doc, client, 1 + (r - base) * K, -1, K]]},
                    memoryview(storm_words(21, r, w).tobytes()))
            s.storm.flush()

    writers = [s.svc.connect(doc, lambda m: None).client_id
               for _ in range(2)]
    s.svc.pump()
    s.storm.checkpoint()
    if promote:
        s.mgr.promote(doc, lanes=2)
    serve([(w, 0) for w in writers], 0, 2)
    late = s.svc.connect(doc, lambda m: None).client_id
    s.svc.pump()
    if promote:
        assert late in s.mgr.docs[doc].mirror.writers
    serve([(w, 0) for w in writers] + [(late, 2)], 2, 2)
    if promote:
        s.mgr.demote(doc)
    s.storm.flush()
    rec = {"digest": _digest(s, doc, kinds=True)}
    close(s)  # the group-commit writer has written every record
    rec["wal"] = wal(root)
    s2 = build_stack(side, root, lanes=2)
    s2.storm.recover()
    rec["recovered"] = _digest(s2, doc, kinds=True)
    close(s2)
    return rec


def test_join_mid_promotion_matches_twin_and_jax(tmp_path):
    recs = {(side, p): _join_mid(side, tmp_path / f"{side}-{p}", p)
            for side in SIDES for p in (True, False)}
    for p in (True, False):
        assert recs[("torch", p)] == recs[("jax", p)]
    sharded, plain = recs[("torch", True)], recs[("torch", False)]
    assert sharded["digest"] == plain["digest"] == sharded["recovered"]
    joins = [h for h in sharded["digest"]["history"]
             if h[2] == int(t_msgs.MessageType.CLIENT_JOIN)]
    assert len(joins) == 3


def _idle_eject(side, root):
    P = PKG[side]
    doc = "mega-defer"
    s = build_stack(side, root, lanes=2)
    writers = [s.svc.connect(doc, lambda m: None).client_id
               for _ in range(2)]
    s.svc.pump()
    s.storm.checkpoint()
    s.mgr.promote(doc, lanes=2)
    for r in range(2):
        for w, client in enumerate(writers):
            s.storm.submit_frame(None, {
                "rid": f"{r}.{w}",
                "docs": [[doc, client, 1 + r * K, -1, K]]},
                memoryview(storm_words(21, r, w).tobytes()))
        s.storm.flush()
    leave = P.seq.RawOperation(client_id=None,
                               type=P.msgs.MessageType.CLIENT_LEAVE,
                               data=writers[1], timestamp=5)
    s.storm._in_round = True
    try:
        s.svc._order_membership(doc, leave)
    finally:
        s.storm._in_round = False
    rec = {"deferred": len(s.mgr._deferred_members),
           "still_active": s.mgr.docs[doc].mirror.writers[writers[1]].active}
    s.storm.flush()
    rec["drained"] = not s.mgr._deferred_members
    rec["mirror_seq"] = s.mgr.docs[doc].mirror.seq
    rec["leaves"] = [m.sequence_number for m in s.svc.get_deltas(doc, 0)
                     if m.type == P.msgs.MessageType.CLIENT_LEAVE]
    s.storm.submit_frame(None, {
        "rid": "post", "docs": [[doc, writers[0], 1 + 2 * K, -1, K]]},
        memoryview(storm_words(21, 2, 0).tobytes()))
    s.storm.flush()
    s.mgr.demote(doc)
    s.storm.flush()
    rec["live"] = entries_of(s, doc)
    close(s)
    rec["wal"] = wal(root)
    s2 = build_stack(side, root, lanes=2)
    s2.storm.recover()
    rec["recovered"] = entries_of(s2, doc)
    close(s2)
    return rec


def test_idle_eject_inside_round_defers_membership_like_jax(tmp_path):
    j, t = (_idle_eject(side, tmp_path / side) for side in SIDES)
    assert t == j
    assert t["deferred"] == 1 and t["still_active"] and t["drained"]
    assert t["leaves"] == [t["mirror_seq"]]
    assert t["recovered"] == t["live"]


def _refnack_pipelined(side, root):
    s = build_stack(side, root, lanes=2, pipeline_depth=2)
    doc = "hot"
    c1 = s.svc.connect(doc, lambda m: None).client_id
    c2 = s.svc.connect(doc, lambda m: None).client_id
    s.svc.pump()
    s.storm.checkpoint()
    s.mgr.promote(doc, lanes=2)
    for rid, c, ref in ((0, c1, 1), (1, c2, 2)):
        s.storm.submit_frame(None, {"rid": rid,
                                    "docs": [[doc, c, 1, ref, K]]},
                             memoryview(storm_words(21, rid, 0).tobytes()))
    s.storm.flush()
    s.storm.submit_frame(None, {"rid": 2,
                                "docs": [[doc, c1, 1 + K, 2, K]]},
                         memoryview(storm_words(22, 0, 0).tobytes()))
    s.storm._flush_round()
    inflight = bool(s.storm._inflight)
    s.storm.submit_frame(None, {"rid": 3,
                                "docs": [[doc, c2, 1 + K, 1, K]]},
                         memoryview(storm_words(22, 1, 0).tobytes()))
    s.storm._flush_round()
    s.storm.flush()
    live = s.mgr.export_state()
    close(s)
    s2 = build_stack(side, root, lanes=2, pipeline_depth=2)
    s2.storm.recover()
    rec = {"inflight": inflight, "live": live,
           "recovered": s2.mgr.export_state(), "wal": wal(root),
           "marked": live["docs"][doc]["mirror"]["writers"][c2][3]}
    close(s2)
    return rec


def test_refnack_mark_orders_after_inflight_ticks_like_jax(tmp_path):
    j, t = (_refnack_pipelined(side, tmp_path / side) for side in SIDES)
    assert t == j
    assert t["inflight"] and t["marked"] == 1
    assert t["recovered"] == t["live"]


def test_lane_reads_are_one_device_read_per_fold(tmp_path):
    """The port reads the baseline row and every lane row of a promoted
    doc in ONE gather and copy per fold."""
    s = build_stack("torch", lanes=4)
    writers = [s.svc.connect("d", lambda m: None).client_id
               for _ in range(6)]
    s.svc.pump()
    s.mgr.promote("d", lanes=4)
    _mega_serve(s, "d", writers, 2)
    before = s.mh.map_row_reads
    s.mgr.map_entries("d")
    assert s.mh.map_row_reads - before == 1
