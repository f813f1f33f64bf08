"""Slice-level differential: the port's map-storm serving tick against the
JAX StormController.

Both stacks are built as tests/test_storm.py builds the JAX one (WAL-less
``durability="none"`` serving, a pinned service clock), the port on
``device="cpu"`` where its kernels run their plain PyTorch versions. The
same connects and storm frames — a dup resend, a gap, clears and uneven
counts — go through both, at pipeline depth 0 and 1, and everything the
slice emits must be equal: pushed acks, sequencer and map planes,
``map_entries``, tick blobs, materialized records and catch-up deltas.
"""

import dataclasses
import itertools

import numpy as np
import pytest

from fluidframework_tpu.server.kernel_host import \
    KernelSequencerHost as JaxSeqHost
from fluidframework_tpu.server.merge_host import \
    KernelMergeHost as JaxMergeHost
from fluidframework_tpu.server.routerlicious import \
    RouterliciousService as JaxService
from fluidframework_tpu.server.storm import StormController as JaxStorm
from fluidframework_tpu.server.storm import \
    materialize_storm_records as jax_materialize
from fluidframework_tpu_torch.server.kernel_host import \
    KernelSequencerHost as TorchSeqHost
from fluidframework_tpu_torch.server.merge_host import \
    KernelMergeHost as TorchMergeHost
from fluidframework_tpu_torch.server.routerlicious import \
    RouterliciousService as TorchService
from fluidframework_tpu_torch.server.storm import StormController as TorchStorm
from fluidframework_tpu_torch.server.storm import \
    materialize_storm_records as torch_materialize

DOCS = [f"doc{i}" for i in range(6)]


def _stack(side: str, depth: int, num_docs: int = 4):
    """(service, storm, seq_host, merge_host) of one side. The initial
    capacities are small so rows and slots grow while serving."""
    if side == "jax":
        seq_host = JaxSeqHost(num_slots=1, initial_capacity=num_docs)
        merge_host = JaxMergeHost(flush_threshold=10**9)
        service = JaxService(merge_host=merge_host,
                             batched_deli_host=seq_host, auto_pump=False)
        storm = JaxStorm(service, seq_host, merge_host,
                         flush_threshold_docs=10**9, pipeline_depth=depth)
    else:
        seq_host = TorchSeqHost(num_slots=1, initial_capacity=num_docs,
                                device="cpu")
        merge_host = TorchMergeHost(flush_threshold=10**9, device="cpu")
        service = TorchService(merge_host=merge_host,
                               batched_deli_host=seq_host, auto_pump=False)
        storm = TorchStorm(service, seq_host, merge_host,
                           flush_threshold_docs=10**9, pipeline_depth=depth)
    service._clock = itertools.count(1000, 7).__next__
    return service, storm, seq_host, merge_host


def _words(rng, k, num_slots=16):
    kinds = rng.choice([0, 0, 0, 1, 2], size=k).astype(np.uint32)
    slots = rng.integers(0, num_slots, k).astype(np.uint32)
    vals = rng.integers(0, 1 << 20, k).astype(np.uint32)
    return (kinds | (slots << 2) | (vals << 12)).astype(np.uint32)


def _script(seed: int):
    """The frame plan both stacks serve: a list of rounds, each a list of
    (rid, [(doc, client_index, cseq0, ref, count)], words bytes)."""
    rng = np.random.default_rng(seed)
    cseq = {(d, c): 1 for d in DOCS for c in range(2)}
    rounds = []
    rid = itertools.count()
    for t in range(4):
        frames = []
        for part in (DOCS[:3], DOCS[3:]):
            entries, payload = [], b""
            for j, d in enumerate(part):
                if t == 2 and j == 2:
                    continue  # a doc absent from this round
                c = (t + j) % 2
                k = 16 if t % 2 == 0 else int(rng.integers(1, 16))
                c0 = cseq[(d, c)]
                if t == 3 and j == 0:
                    c0 = max(1, c0 - 5)  # dup resend of an acked tail
                if t == 3 and j == 1 and d == DOCS[1]:
                    c0 += 3  # gap: the whole batch nacks
                entries.append((d, c, c0, 1 if t < 2 else 3, k))
                payload += _words(rng, k).tobytes()
                if c0 >= cseq[(d, c)] or c0 + k > cseq[(d, c)]:
                    cseq[(d, c)] = max(cseq[(d, c)], c0 + k)
            frames.append((next(rid), entries, payload))
        rounds.append(frames)
    return rounds


def _serve(side: str, depth: int, seed: int):
    service, storm, seq_host, merge_host = _stack(side, depth)
    clients = {(d, c): service.connect(d, lambda m: None).client_id
               for d in DOCS for c in range(2)}
    service.pump()
    pushed = []
    for frames in _script(seed):
        for rid, entries, payload in frames:
            hdr = {"op": "storm", "rid": rid, "docs": [
                [d, clients[(d, c)], c0, ref, k]
                for d, c, c0, ref, k in entries]}
            storm.submit_frame(pushed.append, hdr, memoryview(payload))
        storm.flush()
    # Membership after serving: one client leaves, the sequencer's per-op
    # path runs again, and the storm keeps serving the others.
    service.disconnect(DOCS[0], clients[(DOCS[0], 0)])
    service.pump()
    return service, storm, seq_host, merge_host, pushed


def _ack(payload) -> dict:
    return {k: payload[k] for k in payload.keys()}


def _planes(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def _msgs(msgs) -> list:
    """Messages as dicts, without the wall-clock stamps of their traces."""
    out = []
    for m in msgs:
        d = dataclasses.asdict(m)
        d["traces"] = [(t["service"], t["action"]) for t in d["traces"]]
        out.append(d)
    return out


@pytest.mark.parametrize("depth", [0, 1])
def test_storm_slice_matches_jax(depth):
    j = _serve("jax", depth, seed=depth)
    t = _serve("torch", depth, seed=depth)
    (jsvc, jstorm, jseq, jmerge, jacks) = j
    (tsvc, tstorm, tseq, tmerge, tacks) = t

    assert [_ack(a) for a in tacks] == [_ack(a) for a in jacks]
    assert jstorm.stats["nacked_or_ignored_ops"] > 0  # dups + gap served
    assert tstorm.stats == jstorm.stats
    for a, b in ((jseq._state, tseq._state),
                 (jmerge._xstate, tmerge._xstate)):
        pa, pb = _planes(a), {f: getattr(b, f).numpy() for f in b._fields}
        for f in pa:
            assert pa[f].dtype == pb[f].dtype, f
            assert np.array_equal(pa[f], pb[f]), f
    assert tseq._rows == jseq._rows and tseq._slots == jseq._slots
    assert tstorm._tick_blobs == jstorm._tick_blobs
    assert tstorm._doc_ticks == jstorm._doc_ticks
    for d in DOCS:
        assert tmerge.map_entries(d, "default", "root") \
            == jmerge.map_entries(d, "default", "root"), d
        jrec = jstorm.records_overlapping(d, 0)
        trec = tstorm.records_overlapping(d, 0)
        assert trec == jrec
        assert _msgs(torch_materialize(trec, "default", "root",
                                       tstorm.read_tick_words)) \
            == _msgs(jax_materialize(jrec, "default", "root",
                                     jstorm.read_tick_words))
        assert _msgs(tsvc.get_deltas(d, 0)) == _msgs(jsvc.get_deltas(d, 0))
    assert tmerge.export_state() == jmerge.export_state()


def _poison(side: str, storm, merge_host, doc: str, slot: int = 40) -> None:
    """Clobber one doc's device map row the way a corrupted tick would: a
    present slot whose vseq drifted past the doc's head (the sentinel's
    invariant)."""
    row = merge_host._map_rows[storm_key(doc)].row
    if side == "jax":
        import jax.numpy as jnp

        from fluidframework_tpu.ops import map_kernel as jmk
        xs = merge_host._xstate
        merge_host._xstate = jmk.MapState(
            present=xs.present.at[row, slot].set(True), value=xs.value,
            vseq=xs.vseq.at[row, slot].set(jnp.int32(2**30)),
            cleared_seq=xs.cleared_seq)
    else:
        merge_host._xstate.present[row, slot] = True
        merge_host._xstate.vseq[row, slot] = 2**30


def storm_key(doc: str) -> tuple:
    return (doc, "default", "root")


def _quarantine_run(side: str):
    """Serve a round, poison doc1, then serve frames that share it (one
    ticked, one still buffered when the sentinel trips), a mixed frame
    after the freeze, and its peers' next frames."""
    service, storm, seq_host, merge_host = _stack(side, depth=0)
    clients = {d: service.connect(d, lambda m: None).client_id
               for d in DOCS[:4]}
    service.pump()
    rng = np.random.default_rng(4)
    pushed = []
    cseq = {d: 1 for d in DOCS[:4]}

    def frame(rid, docs, k=8):
        entries, payload = [], b""
        for d in docs:
            entries.append([d, clients[d], cseq[d], 1, k])
            # No clears: a clear would wipe the poisoned slot.
            payload += (_words(rng, k) & ~np.uint32(2)).tobytes()
            cseq[d] += k
        storm.submit_frame(pushed.append, {"rid": rid, "docs": entries},
                           memoryview(payload))

    frame(0, DOCS[:4])
    storm.flush()
    _poison(side, storm, merge_host, DOCS[1])
    frame(1, [DOCS[0], DOCS[1]])
    frame(2, [DOCS[1], DOCS[2]])  # collides on doc1: still buffered
    frame(3, [DOCS[3]])
    storm.flush()
    frame(4, [DOCS[1], DOCS[3]])  # a mixed frame after the freeze
    frame(5, [DOCS[0], DOCS[2], DOCS[3]])
    storm.flush()
    return storm, seq_host, merge_host, pushed


def test_quarantine_freeze_matches_jax():
    """A sentinel-tripped doc is frozen alone on both stacks: its ack
    says so, its buffered and later frames shed with the "quarantined"
    nack (every dropped doc listed), and its batch peers keep serving
    with identical planes."""
    jstorm, jseq, jmerge, jacks = _quarantine_run("jax")
    tstorm, tseq, tmerge, tacks = _quarantine_run("torch")
    assert [_ack(a) for a in tacks] == [_ack(a) for a in jacks]
    assert tstorm.quarantined == jstorm.quarantined
    assert list(tstorm.quarantined) == [DOCS[1]]
    assert tstorm.stats == jstorm.stats
    assert tstorm.stats["quarantined_docs"] == 1
    sheds = [a for a in tacks if a.get("error") == "quarantined"]
    assert [s["docs"] for s in sheds] == [[DOCS[1], DOCS[2]],
                                          [DOCS[1], DOCS[3]]]
    assert all(s["quarantined"] == [DOCS[1]] for s in sheds)
    flagged = [a for a in tacks if "quarantined" in a.keys()
               and "error" not in a.keys()]
    assert len(flagged) == 1 and flagged[0]["quarantined"] == [DOCS[1]]
    for a, b in ((jseq._state, tseq._state), (jmerge._xstate, tmerge._xstate)):
        pa, pb = _planes(a), {f: getattr(b, f).numpy() for f in b._fields}
        for f in pa:
            assert np.array_equal(pa[f], pb[f]), f
    assert tstorm._tick_blobs == jstorm._tick_blobs
    assert tstorm.doc_tick_counts == jstorm.doc_tick_counts
    # The frozen doc reads through the scalar fold of its records alike.
    assert tstorm.quarantined_map_entries(DOCS[1]) \
        == jstorm.quarantined_map_entries(DOCS[1])
    # Without a snapshot store neither side can rebuild it, and both say
    # so alike (tests/test_torch_storm_durability.py readmits from one).
    refusals = []
    for storm in (jstorm, tstorm):
        with pytest.raises(AssertionError) as err:
            storm.readmit_doc(DOCS[1])
        refusals.append(str(err.value))
    assert refusals[1] == refusals[0]


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_quarantined_doc_in_mixed_frame_nacks_every_dropped_doc(side):
    """A frame sharing a quarantined doc is refused WHOLE (acks are
    positional per frame): the nack lists every dropped doc and the
    quarantined subset."""
    service, storm, _seq, _merge = _stack(side, depth=1, num_docs=2)
    clients = {d: service.connect(d, lambda m: None).client_id
               for d in DOCS[:2]}
    service.pump()
    storm.quarantined[DOCS[0]] = {"reason": "test", "tick": 0}
    nacks = []
    words = _words(np.random.default_rng(5), 8)
    storm.submit_frame(
        nacks.append,
        {"rid": 7, "docs": [[DOCS[0], clients[DOCS[0]], 1, 1, 8],
                            [DOCS[1], clients[DOCS[1]], 1, 1, 8]]},
        memoryview(words.tobytes() * 2))
    assert len(nacks) == 1
    assert nacks[0]["error"] == "quarantined"
    assert nacks[0]["docs"] == [DOCS[0], DOCS[1]]
    assert nacks[0]["quarantined"] == [DOCS[0]]
    assert storm._pending_docs == 0
