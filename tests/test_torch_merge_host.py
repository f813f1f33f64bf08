"""Differential: the port's KernelMergeHost against the JAX package's.

Map half: sequenced set/delete/clear messages across several documents
and channels, row and key-slot growth, row release and reuse,
materialized entries, and export/import of the map planes both ways.

Text half: seeded SharedString streams through ``ingest`` on both hosts —
rounds of truly concurrent ops from up to 128 writers (one ref per round,
so the overlap planes grow to four words), inserts with props, markers,
removes and annotates — under capacity pressure (compaction, coalescing,
migration to bigger buckets, block rebalances), block-overflow replay,
the scalar route and readmission, a quarantined row, and export/import
both ways including a flat pool. Every text plane, the text pools,
``text``, ``rich_text``, ``summarize``, ``stats`` and ``export_state``
must be equal; the converged text must also equal a scalar MergeEngine
replay of the same messages.

Matrix half: seeded SharedMatrix streams through ``ingest`` on both
hosts — rounds of concurrent row/col inserts and removes and cell writes
from up to 40 writers (overlap planes of two words), flushes that hold
structural ops (the matrix op tick), all-cell flushes (the cell-run
append) and the switch between them, under row, vector-slot and cell-slot
growth with zamboni and cell-log compaction, the scalar route, and
export/import both ways. Every matrix plane, ``matrix_grid``,
``summarize``, ``stats`` and ``export_state`` must be equal, and the
grids must equal a scalar PermutationVector + LWW replay.

Tree channels are held to JAX in ``tests/test_torch_tree_host.py``.
"""

from __future__ import annotations

import itertools
import random

import numpy as np
import pytest

from fluidframework_tpu.ops import mergetree_blocks as jmtb
from fluidframework_tpu.protocol import messages as jmsg
from fluidframework_tpu.server import merge_host as jmh
from fluidframework_tpu.server.merge_host import \
    ChannelKey as JaxChannelKey
from fluidframework_tpu.server.merge_host import \
    KernelMergeHost as JaxMergeHost
from fluidframework_tpu.server.routerlicious import \
    RouterliciousService as JaxService
from fluidframework_tpu_torch import convert
from fluidframework_tpu_torch.dds.mergetree import MergeEngine
from fluidframework_tpu_torch.ops import _build
from fluidframework_tpu_torch.protocol import messages as tmsg
from fluidframework_tpu_torch.server import merge_host as tmh
from fluidframework_tpu_torch.server.merge_host import ChannelKey
from fluidframework_tpu_torch.server.merge_host import \
    KernelMergeHost as TorchMergeHost
from fluidframework_tpu_torch.server.routerlicious import \
    RouterliciousService as TorchService

CHANNELS = [("doc0", "ds", "m"), ("doc0", "ds", "n"), ("doc1", "ds", "m"),
            ("doc2", "other", "m"), ("doc3", "ds", "m")]


def _msg(mod, seq: int, channel_op: dict, datastore="ds", channel="m",
         client="c", ref=None, msn=0):
    return mod.SequencedDocumentMessage(
        client_id=client, sequence_number=seq, minimum_sequence_number=msn,
        client_sequence_number=seq,
        reference_sequence_number=seq - 1 if ref is None else ref,
        type=mod.MessageType.OPERATION,
        contents={"address": datastore,
                  "contents": {"address": channel, "contents": channel_op}})


def _ops(rng: random.Random, n: int):
    """(channel, op) pairs: sets of str/int/dict values over a key space
    wider than the initial slot count, deletes and clears."""
    out = []
    for _ in range(n):
        ch = rng.choice(CHANNELS)
        r = rng.random()
        key = f"key{rng.randrange(40)}"
        if r < 0.65:
            value = rng.choice([rng.randrange(100), f"v{rng.randrange(9)}",
                                {"n": rng.randrange(5)}, None])
            out.append((ch, {"type": "set", "key": key, "value": value}))
        elif r < 0.92:
            out.append((ch, {"type": "delete", "key": key}))
        else:
            out.append((ch, {"type": "clear"}))
    return out


def _planes(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def _assert_equal(jh, th):
    a = _planes(jh._xstate)
    b = {f: getattr(th._xstate, f).numpy() for f in th._xstate._fields}
    for f in a:
        assert a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f]), f
    for doc, ds, ch in CHANNELS:
        if JaxChannelKey(doc, ds, ch) in jh._map_rows:
            assert th.map_entries(doc, ds, ch) == jh.map_entries(doc, ds, ch)
    # Stats are per-process counters: an import does not carry them.
    ja, tb = jh.export_state(), th.export_state()
    ja.pop("stats"), tb.pop("stats")
    assert tb == ja


@pytest.mark.parametrize("seed", range(2))
def test_dict_path_matches_jax(seed):
    rng = random.Random(seed)
    jh = JaxMergeHost(map_slots=4, row_capacity=2, flush_threshold=17)
    th = TorchMergeHost(map_slots=4, row_capacity=2, flush_threshold=17,
                        device="cpu")
    seqs = {ch[0]: 0 for ch in CHANNELS}
    for (doc, ds, ch), op in _ops(rng, 220):
        seqs[doc] += 1
        jh.ingest(doc, _msg(jmsg, seqs[doc], op, ds, ch))
        th.ingest(doc, _msg(tmsg, seqs[doc], op, ds, ch))
        if rng.random() < 0.05:  # a bus replay of an applied message
            th.ingest(doc, _msg(tmsg, seqs[doc], op, ds, ch))
            jh.ingest(doc, _msg(jmsg, seqs[doc], op, ds, ch))
    jh.flush()
    th.flush()
    _assert_equal(jh, th)
    assert th.summarize("doc0") == jh.summarize("doc0")
    assert th.stats == jh.stats
    # Release a row and let a new channel take it.
    assert th.release_map_row(ChannelKey("doc1", "ds", "m")) \
        == jh.release_map_row(JaxChannelKey("doc1", "ds", "m"))
    op = {"type": "set", "key": "fresh", "value": 1}
    jh.ingest("doc9", _msg(jmsg, 1, op))
    th.ingest("doc9", _msg(tmsg, 1, op))
    assert th.map_entries("doc9", "ds", "m") \
        == jh.map_entries("doc9", "ds", "m")


def test_export_import_both_ways():
    rng = random.Random(5)
    jh = JaxMergeHost(map_slots=4, row_capacity=2)
    seqs = {ch[0]: 0 for ch in CHANNELS}
    for (doc, ds, ch), op in _ops(rng, 120):
        seqs[doc] += 1
        jh.ingest(doc, _msg(jmsg, seqs[doc], op, ds, ch))
    snap = jh.export_state()
    th = convert.merge_host_from_export(snap, device="cpu")
    _assert_equal(jh, th)
    back = JaxMergeHost()
    back.import_state(th.export_state())
    _assert_equal(back, th)
    # Both keep serving identically after the hand-over.
    for (doc, ds, ch), op in _ops(rng, 60):
        seqs[doc] += 1
        back.ingest(doc, _msg(jmsg, seqs[doc], op, ds, ch))
        th.ingest(doc, _msg(tmsg, seqs[doc], op, ds, ch))
    _assert_equal(back, th)


# -- the text half -------------------------------------------------------------


def _letters(rng: random.Random, n: int) -> str:
    return "".join(rng.choice("abcdefghij") for _ in range(n))


def text_rounds(rng: random.Random, rounds: int, writers: int,
                docs=("doc0",), channels=("text",), per_round=(1, 12),
                head=0.0, rich=True, msn_lag=3):
    """Sequenced SharedString traffic: per doc and round, a set of writers
    each sends ONE op at the round's head ref (truly concurrent), with
    positions valid in that frame. Yields (doc, channel, op, client, seq,
    ref, msn). A ``head`` fraction of inserts lands at position 0.

    The msn is the ref of the round ``msn_lag`` rounds back: both hosts
    compact a row at its newest msn BEFORE applying the flush's pending
    ops, so a flush must not hold ops whose ref is below it (the scalar
    engine, applying each op first, would then disagree)."""
    seq = {d: 0 for d in docs}
    refs = {d: [0] * msn_lag for d in docs}
    length = {(d, c): 0 for d in docs for c in channels}
    for _ in range(rounds):
        for d in docs:
            ref = seq[d]
            n = rng.randint(*per_round)
            removed: dict[str, list] = {c: [] for c in channels}
            grown = {c: 0 for c in channels}
            for w in rng.sample(range(writers), min(n, writers)):
                c = rng.choice(channels)
                L = length[(d, c)]
                r = rng.random()
                if L > 2 and r < 0.3:
                    s = rng.randrange(L - 1)
                    e = min(L, s + rng.randint(1, 8))
                    op = {"type": "remove", "start": s, "end": e}
                    removed[c].append((s, e))
                elif rich and L > 2 and r < 0.4:
                    s = rng.randrange(L - 1)
                    op = {"type": "annotate", "start": s,
                          "end": min(L, s + rng.randint(1, 6)),
                          "props": rng.choice([{"bold": True},
                                               {"color": "red", "bold": None},
                                               {"size": rng.randrange(3)}])}
                else:
                    pos = 0 if rng.random() < head else rng.randint(0, L)
                    if rich and rng.random() < 0.1:
                        op = {"type": "insert", "pos": pos,
                              "marker": {"ref_type": "simple", "id": None}}
                        grown[c] += 1
                    else:
                        text = _letters(rng, rng.randint(1, 8))
                        op = {"type": "insert", "pos": pos, "text": text}
                        if rich and rng.random() < 0.2:
                            op["props"] = {"bold": True}
                        grown[c] += len(text)
                seq[d] += 1
                yield d, c, op, f"w{w}", seq[d], ref, refs[d][0]
            for c in channels:
                gone = set()
                for s, e in removed[c]:
                    gone.update(range(s, e))
                length[(d, c)] += grown[c] - len(gone)
            refs[d] = refs[d][1:] + [ref]


def _feed(host, mod, traffic, datastore="default", flush_every=None):
    for i, (d, c, op, client, seq, ref, msn) in enumerate(traffic):
        host.ingest(d, _msg(mod, seq, op, datastore, c, client, ref, msn))
        if flush_every and (i + 1) % flush_every == 0:
            host.flush()
    host.flush()


def _oracle_text(traffic, doc, channel) -> str:
    engine = MergeEngine(local_client=None)
    for d, c, op, client, seq, ref, msn in traffic:
        if (d, c) == (doc, channel):
            engine.apply_remote(op, seq, ref, client)
    return engine.get_text()


def _assert_text_equal(jh, th):
    assert sorted(th._merge_pools) == sorted(jh._merge_pools)
    for slots, jp in jh._merge_pools.items():
        tp = th._merge_pools[slots]
        assert type(tp).__name__ == type(jp).__name__
        assert (tp.slots, tp.num_props, tp.overlap_words, tp.capacity) \
            == (jp.slots, jp.num_props, jp.overlap_words, jp.capacity)
        if hasattr(jp, "bk"):
            assert (tp.nb, tp.bk) == (jp.nb, jp.bk)
        a = _planes(jp.state)
        b = {f: getattr(tp.state, f).numpy() for f in tp.state._fields}
        for f in a:
            assert a[f].dtype == b[f].dtype, (slots, f)
            assert np.array_equal(a[f], b[f]), (slots, f)
        assert tp.text.chunks == jp.text.chunks and \
            tp.text.used == jp.text.used
        assert tp.free == jp.free
        assert [m is None for m in tp.members] \
            == [m is None for m in jp.members]
    for key in jh._merge_rows:
        assert th.text(*key) == jh.text(*key), key
        assert th.rich_text(*key) == jh.rich_text(*key), key
    for doc in {k.doc_id for k in jh._merge_rows}:
        assert th.summarize(doc) == jh.summarize(doc)
    assert th.stats == jh.stats
    assert th.export_state() == jh.export_state()


def _hosts(**kw):
    return (JaxMergeHost(**kw), TorchMergeHost(device="cpu", **kw))


FARM_DOCS = ("doc0", "doc1", "doc2")


@pytest.fixture(scope="module")
def farm():
    """One seeded text farm served by both hosts, with blocks of 16 slots
    so small buckets hold several blocks: doc0 and doc1 take rounds of up
    to 32 concurrent ops from 128 writers over two channels (overlap
    planes grow to four words; compaction, coalescing, migration and
    block rebalances run), doc2 takes head-concentrated bursts that
    overflow a block mid-tick. The JAX host compiles once per shape, so
    the scenarios share this one run."""
    with pytest.MonkeyPatch.context() as m:
        for mod in (jmh, tmh):
            m.setattr(mod._BlockMergePool, "BK", 16)
        traffic = list(text_rounds(random.Random(0), 10, 128,
                                   docs=FARM_DOCS[:2],
                                   channels=("text", "notes"),
                                   per_round=(10, 32)))
        traffic += list(text_rounds(random.Random(1), 8, 40,
                                    docs=FARM_DOCS[2:], per_round=(8, 20),
                                    head=0.8, rich=False, msn_lag=8))
        jh, th = _hosts(merge_slots=128, row_capacity=8, flush_threshold=60)
        _feed(jh, jmsg, traffic)
        _feed(th, tmsg, traffic)
        yield jh, th, traffic


def test_text_host_matches_jax(farm):
    jh, th, traffic = farm
    _assert_text_equal(jh, th)
    for key in jh._merge_rows:
        assert th.text(*key) == _oracle_text(traffic, key.doc_id,
                                             key.channel), key
    for stat in ("migrations", "compactions", "rebalances",
                 "block_overflow_replays"):
        assert th.stats[stat] > 0, stat
    assert th.stats["scalar_ops"] == 0
    assert max(p.overlap_words for p in th._merge_pools.values()) == 4


def test_scalar_route_and_readmission_match_jax():
    """More writers than ``max_client_slots`` route the channel to the
    scalar engine; once the departed writers' segments compact away it
    readmits to a device row and serves there again."""
    jh, th = _hosts(merge_slots=64, flush_threshold=8, max_client_slots=32)
    seq = itertools.count(1)
    traffic = []

    def add(op, client, msn=None):
        s = next(seq)
        traffic.append(("doc", "text", op, client, s, s - 1,
                        s - 1 if msn is None else msn))

    for i in range(37):
        add({"type": "insert", "pos": 0, "text": f"<{i}>"}, f"w{i}")
    for host, mod in ((jh, jmsg), (th, tmsg)):
        _feed(host, mod, traffic)
    assert th.stats["overflow_routed"] == 1
    _assert_text_equal(jh, th)
    start = len(traffic)
    length = len(th.text("doc", "default", "text"))
    add({"type": "remove", "start": 0, "end": length}, "keeper-a")
    add({"type": "insert", "pos": 0, "text": "fresh "}, "keeper-b")
    add({"type": "annotate", "start": 0, "end": 5,
         "props": {"kept": True}}, "keeper-a", msn=len(traffic))
    add({"type": "insert", "pos": 6, "text": "start"}, "keeper-a",
        msn=len(traffic))
    add({"type": "insert", "pos": 5, "text": "er"}, "keeper-b",
        msn=len(traffic))
    for host, mod in ((jh, jmsg), (th, tmsg)):
        _feed(host, mod, traffic[start:])
    assert th.stats["readmissions"] == 1
    _assert_text_equal(jh, th)
    assert th.text("doc", "default", "text") \
        == _oracle_text(traffic, "doc", "text")


def test_quarantined_row_matches_jax(monkeypatch):
    """An overflow replay that fails quarantines ONE channel onto its
    scalar engine with an exact tail replay; its peer channel stays
    device-served. The failure is injected on both hosts alike."""
    def boom(self, row, rest):
        raise RuntimeError("injected per-row tick failure")

    def frozen(pool_self, batch):
        out = np.full(pool_self.capacity, 2**31 - 1, np.int32)
        out[0] = 0  # row 0 froze before its first pending op
        pool_self.last_overflow = out
        return pool_self.state

    jh, th = _hosts(merge_slots=16, flush_threshold=10**9)
    rng = random.Random(9)
    first = list(text_rounds(rng, 3, 6, docs=("doc0", "doc1"),
                             per_round=(2, 4)))
    for host, mod in ((jh, jmsg), (th, tmsg)):
        _feed(host, mod, first)
    second = [(d, c, op, cl, s + 100, r + 100, m)
              for d, c, op, cl, s, r, m in text_rounds(
                  random.Random(10), 2, 6, docs=("doc0", "doc1"),
                  per_round=(2, 4))]
    with monkeypatch.context() as m:
        m.setattr(JaxMergeHost, "_replay_block_overflow", boom)
        m.setattr(TorchMergeHost, "_replay_block_overflow", boom)
        m.setattr(jmh._BlockMergePool, "apply", frozen)
        m.setattr(tmh._BlockMergePool, "apply", frozen)
        for host, mod in ((jh, jmsg), (th, tmsg)):
            for d, c, op, client, seq, ref, msn in second:
                host.ingest(d, _msg(mod, seq, op, "default", c, client,
                                    ref, msn))
            host.flush()
    assert th.stats["quarantined_channels"] == 1
    key = ChannelKey("doc0", "default", "text")
    assert th._merge_rows[key].scalar is not None
    _assert_text_equal(jh, th)


@pytest.mark.parametrize("error", [
    _build.KernelError("mergetree_flat_kernel: CUDA launch failed with "
                       "cudaError 700"),
    _build.KernelInputError("flat merge tick: op kind must be a contiguous "
                            "int32 tensor"),
    _build.KernelError("nvcc failed for csrc/mergetree_flat.cu")],
    ids=["launch", "input", "build"])
def test_kernel_error_in_overflow_replay_is_not_quarantined(monkeypatch,
                                                            error):
    """A kernel that cannot build, take its input or launch is no per-row
    fault: the error leaves ``flush()`` and no channel moves to the scalar
    engine (it would otherwise be served on the host unnoticed)."""
    def frozen(pool_self, batch):
        out = np.full(pool_self.capacity, 2**31 - 1, np.int32)
        out[0] = 0
        pool_self.last_overflow = out
        return pool_self.state

    def broken(state, ops):
        raise error

    th = TorchMergeHost(device="cpu", merge_slots=16,
                        flush_threshold=10**9)
    _feed(th, tmsg, list(text_rounds(random.Random(9), 2, 6,
                                     docs=("doc0", "doc1"),
                                     per_round=(2, 4))))
    monkeypatch.setattr(tmh._BlockMergePool, "apply", frozen)
    monkeypatch.setattr(tmh, "mtc", type("Broken", (), {
        "apply_tick_best": staticmethod(broken)}))
    for d, c, op, client, seq, ref, msn in text_rounds(
            random.Random(10), 1, 6, docs=("doc0", "doc1"),
            per_round=(2, 4)):
        th.ingest(d, _msg(tmsg, seq + 100, op, "default", c, client,
                          ref + 100, msn))
    with pytest.raises(type(error)) as got:
        th.flush()
    assert got.value is error
    assert th.stats["quarantined_channels"] == 0
    assert all(r.scalar is None for r in th._merge_rows.values())


def _flat_snapshot(jh: JaxMergeHost) -> dict:
    """The JAX host's export with its block pools rewritten as flat pools
    (packed planes, the layout a flat pool serves)."""
    snap = jh.export_state()
    for p, (_slots, pool) in zip(snap["merge_pools"],
                                 sorted(jh._merge_pools.items())):
        flat = jmtb.to_flat(pool.state, slots=pool.slots)
        p["kind"] = "flat"
        p.pop("block_geometry")
        p["planes"] = {f: jmh._nd_pack(np.asarray(getattr(flat, f)))
                       for f in flat._fields}
    return snap


@pytest.mark.parametrize("kind", ["block", "flat"])
def test_text_export_import_both_ways(farm, kind):
    """The farm's JAX export (block pools, or the same rows as flat
    pools) loads into the port and back; all three hosts keep serving
    identically."""
    jh = farm[0]
    snap = jh.export_state() if kind == "block" else _flat_snapshot(jh)
    src = JaxMergeHost()
    src.import_state(snap)
    th = convert.merge_host_from_export(snap, device="cpu")
    back = JaxMergeHost()
    back.import_state(th.export_state())
    _assert_text_equal(src, th)
    _assert_text_equal(back, th)
    more = [(d, c, op, cl, s + 5000, r + 5000, m + 5000)
            for d, c, op, cl, s, r, m in text_rounds(
                random.Random(22), 2, 40, docs=FARM_DOCS[:2],
                channels=("text", "notes"), per_round=(3, 10))]
    for host, mod in ((src, jmsg), (th, tmsg), (back, jmsg)):
        _feed(host, mod, more)
    _assert_text_equal(src, th)
    _assert_text_equal(back, th)


def test_autotune_block_geometry_matches_jax(farm):
    """Re-blocking every pool to the head-concentrated geometry (larger
    Bk, same slots) lays the planes out identically on both hosts, and
    both keep serving identically."""
    snap = farm[0].export_state()
    jh = JaxMergeHost()
    jh.import_state(snap)
    th = convert.merge_host_from_export(snap, device="cpu")
    got = th.autotune_block_geometry(min_observations=0, head_fraction=1.0)
    assert got == jh.autotune_block_geometry(min_observations=0,
                                             head_fraction=1.0)
    assert got and th.stats["geometry_retunes"] == len(got)
    _assert_text_equal(jh, th)
    more = [(d, c, op, cl, s + 9000, r + 9000, m + 9000)
            for d, c, op, cl, s, r, m in text_rounds(
                random.Random(23), 2, 40, docs=FARM_DOCS[:2],
                channels=("text", "notes"), per_round=(3, 10))]
    for host, mod in ((jh, jmsg), (th, tmsg)):
        _feed(host, mod, more)
    _assert_text_equal(jh, th)


def test_text_through_routerlicious_matches_jax():
    """SharedString ops submitted by connected clients reach the merge
    host through the service's merger lambda on both stacks."""
    out = []
    for service_cls, mod, host in (
            (JaxService, jmsg, JaxMergeHost(flush_threshold=16)),
            (TorchService, tmsg, TorchMergeHost(flush_threshold=16,
                                                device="cpu"))):
        service = service_cls(merge_host=host, auto_pump=False)
        service._clock = itertools.count(1000, 7).__next__
        conns = [service.connect("doc", lambda m: None) for _ in range(5)]
        service.pump()
        rng = random.Random(4)
        head = len(service.get_deltas("doc", 0))
        cseq = {c.client_id: 0 for c in conns}
        for _round in range(6):
            for c in rng.sample(conns, 3):
                cseq[c.client_id] += 1
                op = {"type": "insert", "pos": 0,
                      "text": _letters(rng, rng.randint(1, 5))}
                c.submit([mod.DocumentMessage(
                    client_sequence_number=cseq[c.client_id],
                    reference_sequence_number=head,
                    type=mod.MessageType.OPERATION,
                    contents={"address": "default",
                              "contents": {"address": "text",
                                           "contents": op}})])
            service.pump()
            head = len(service.get_deltas("doc", 0))
        host.flush()
        out.append((host.text("doc", "default", "text"), host.summarize("doc"),
                    host.stats, host.export_state()))
    assert out[0] == out[1]
    assert len(out[0][0]) > 0


# -- the matrix half -----------------------------------------------------------


def matrix_rounds(rng: random.Random, modes, writers: int,
                  docs=("doc0",), channels=("grid",), per_round=(4, 12),
                  cell_share=0.5, msn_lag=3):
    """Sequenced SharedMatrix traffic, one round per entry of ``modes``:
    per doc and round a set of distinct writers each sends ONE op at one
    shared ref (truly concurrent), positions valid in that frame. A "mix"
    round sends cell writes (``cell_share``) and row/col inserts of 1-3
    and removes of 1-2; a "cells" round only cell writes at the head ref;
    a "stale" round only cell writes at the PREVIOUS round's ref, below
    that round's structural ops. Yields (round, doc, channel, op, client,
    seq, ref, msn); the msn trails ``msn_lag`` rounds."""
    seq = {d: 0 for d in docs}
    refs = {d: [0] * msn_lag for d in docs}
    length = {(d, c, a): 0 for d in docs for c in channels
              for a in ("rows", "cols")}
    for n_round, mode in enumerate(modes):
        for d in docs:
            ref = refs[d][-1] if mode == "stale" else seq[d]
            removed = {key: [] for key in length if key[0] == d}
            grown = {key: 0 for key in length if key[0] == d}
            n = rng.randint(*per_round)
            for w in rng.sample(range(writers), min(n, writers)):
                c = rng.choice(channels)
                rows, cols = length[(d, c, "rows")], length[(d, c, "cols")]
                if mode != "mix" or (rows and cols
                                     and rng.random() < cell_share):
                    op = {"type": "set", "target": "cell",
                          "row": rng.randrange(max(rows, 1)),
                          "col": rng.randrange(max(cols, 1)),
                          "value": rng.choice([rng.randrange(50),
                                               f"v{rng.randrange(9)}",
                                               None])}
                else:
                    axis = rng.choice(("rows", "cols"))
                    size = length[(d, c, axis)]
                    if size > 3 and rng.random() < 0.35:
                        s0 = rng.randrange(size - 1)
                        e0 = min(size, s0 + rng.randint(1, 2))
                        op = {"type": "remove", "target": axis,
                              "start": s0, "end": e0}
                        removed[(d, c, axis)].append((s0, e0))
                    else:
                        count = rng.randint(1, 3)
                        op = {"type": "insert", "target": axis,
                              "pos": rng.randint(0, size), "count": count}
                        grown[(d, c, axis)] += count
                seq[d] += 1
                yield n_round, d, c, op, f"w{w}", seq[d], ref, refs[d][0]
            for key in grown:
                length[key] += grown[key] - union_len(
                    [a for a, _ in removed[key]],
                    [b for _, b in removed[key]])
            if mode != "stale":
                refs[d] = refs[d][1:] + [ref]


def union_len(starts, ends) -> int:
    covered = set()
    for a, b in zip(starts, ends):
        covered.update(range(a, b))
    return len(covered)


def _feed_rounds(host, mod, traffic, datastore="default"):
    """Ingest round by round, one flush after each round."""
    last = None
    for n_round, d, c, op, client, seq, ref, msn in traffic:
        if last is not None and n_round != last:
            host.flush()
        last = n_round
        host.ingest(d, _msg(mod, seq, op, datastore, c, client, ref, msn))
    host.flush()


def _oracle_grid(traffic, doc, channel) -> list[list]:
    """The converged grid of a scalar replay: two PermutationVectors and
    an LWW dict, as the hosts' scalar route applies them."""
    from fluidframework_tpu_torch.dds.matrix import PermutationVector
    rows, cols, cells = PermutationVector(None), PermutationVector(None), {}
    for _r, d, c, op, client, seq, ref, _msn in traffic:
        if (d, c) != (doc, channel):
            continue
        if op["target"] in ("rows", "cols"):
            (rows if op["target"] == "rows" else cols).apply_remote(
                op, seq, ref, client)
        else:
            rh = rows.handle_at(op["row"], ref, client)
            ch = cols.handle_at(op["col"], ref, client)
            if rh is not None and ch is not None:
                cells[(rh, ch)] = op["value"]

    def live(vec):
        return [h for seg in vec.engine.segments if seg.removed_seq is None
                for h in seg.content]
    return [[cells.get((r, c)) for c in live(cols)] for r in live(rows)]


def _matrix_planes(state) -> dict:
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        if isinstance(v, tuple):
            out.update({f"{f}.{g}": getattr(v, g) for g in v._fields})
        else:
            out[f] = v
    return {f: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for f, v in out.items()}


def _assert_matrix_equal(jh, th):
    assert (th._matrix_capacity, th._matrix_vec_slots,
            th._matrix_cell_slots, th._matrix_overlap_words) \
        == (jh._matrix_capacity, jh._matrix_vec_slots,
            jh._matrix_cell_slots, jh._matrix_overlap_words)
    assert (th._matrix_state is None) == (jh._matrix_state is None)
    if jh._matrix_state is not None:
        a = _matrix_planes(jh._matrix_state)
        b = _matrix_planes(th._matrix_state)
        assert a.keys() == b.keys()
        for f in a:
            assert a[f].dtype == b[f].dtype, f
            assert np.array_equal(a[f], b[f]), f
    for key in jh._matrix_rows:
        assert th.matrix_grid(*key) == jh.matrix_grid(*key), key
    for doc in {k.doc_id for k in jh._matrix_rows}:
        assert th.summarize(doc) == jh.summarize(doc)
    assert th.stats == jh.stats
    assert th.export_state() == jh.export_state()


MATRIX_DOCS = ("doc0", "doc1", "doc2")
#: Structural rounds, then cell-only rounds (the cell-run append; the cell
#: log fills, compacts and grows), a structural round and a round of
#: cells at a stale ref below it (the op tick again, through
#: last_vec_seq), then mixed rounds.
MATRIX_MODES = ["mix"] * 5 + ["cells"] * 5 + ["mix", "stale"] + ["mix"] * 2


@pytest.fixture(scope="module")
def matrix_farm():
    """One seeded matrix farm served by both hosts: three docs with two
    matrix channels each (six rows from a row capacity of 2), 40 writers
    (overlap planes of two words), the rounds of MATRIX_MODES; the vector
    tables pass 64 slots and the cell log 128 entries, both compact and
    grow."""
    traffic = list(matrix_rounds(random.Random(3), MATRIX_MODES, 40,
                                 docs=MATRIX_DOCS, channels=("grid", "sheet"),
                                 per_round=(16, 40), cell_share=0.3))
    jh, th = _hosts(row_capacity=2, flush_threshold=10**9)
    for host in (jh, th):
        # A 128-slot cell log (before the lazy state exists), so the cell
        # runs fill it, compact it and grow it.
        host._matrix_cell_slots = 128
    _feed_rounds(jh, jmsg, traffic)
    _feed_rounds(th, tmsg, traffic)
    yield jh, th, traffic


def test_matrix_host_matches_jax(matrix_farm):
    jh, th, traffic = matrix_farm
    _assert_matrix_equal(jh, th)
    for key in jh._matrix_rows:
        assert th.matrix_grid(*key) == _oracle_grid(
            traffic, key.doc_id, key.channel), key
    assert th.stats["cell_run_ticks"] >= 5
    assert th.stats["flushes"] == len(MATRIX_MODES)
    assert th.stats["compactions"] > 0 and th.stats["scalar_ops"] == 0
    assert th._matrix_capacity == 8 and th._matrix_overlap_words == 2
    assert th._matrix_vec_slots > 64 and th._matrix_cell_slots > 128
    assert sum(len(g) for k in th._matrix_rows
               for g in th.matrix_grid(*k)) > 0


@pytest.mark.parametrize("origin", ["jax", "port"])
def test_matrix_export_import_both_ways(matrix_farm, origin):
    """The farm's export (from either host) loads into the other package
    and back (``convert.merge_host_from_export`` for the port); all hosts
    keep serving identically."""
    jh, th0 = matrix_farm[:2]
    snap = (jh if origin == "jax" else th0).export_state()
    src = JaxMergeHost()
    src.import_state(snap)
    th = convert.merge_host_from_export(snap, device="cpu")
    back = JaxMergeHost()
    back.import_state(th.export_state())
    _assert_matrix_equal(src, th)
    _assert_matrix_equal(back, th)
    more = [(r, d, c, op, cl, s + 5000, ref + 5000, m + 5000)
            for r, d, c, op, cl, s, ref, m in matrix_rounds(
                random.Random(8), ["cells", "mix"], 40, docs=MATRIX_DOCS,
                channels=("grid",), per_round=(3, 8))]
    for host, mod in ((src, jmsg), (th, tmsg), (back, jmsg)):
        _feed_rounds(host, mod, more)
    _assert_matrix_equal(src, th)
    _assert_matrix_equal(back, th)


def test_matrix_scalar_route_matches_jax():
    """A matrix channel whose writers pass ``max_client_slots`` moves to
    the scalar permutation vectors (seeded from the device row, the
    unapplied tail replayed); it keeps serving there, its device row is
    blanked, and it exports and imports as a scalar row."""
    jh, th = _hosts(flush_threshold=10**9, max_client_slots=32)
    traffic = list(matrix_rounds(random.Random(6), ["mix"] * 3 + ["cells"],
                                 30, docs=("doc0", "doc1"),
                                 per_round=(8, 20)))
    late = [(r + 4, d, c, op, cl, s, ref, m) for r, d, c, op, cl, s, ref, m
            in matrix_rounds(random.Random(7), ["mix"] * 2, 40,
                             docs=("doc0",), per_round=(30, 40))]
    seq0 = max(t[5] for t in traffic if t[1] == "doc0")
    late = [(r, d, c, op, cl, s + seq0, ref + seq0, m + seq0)
            for r, d, c, op, cl, s, ref, m in late]
    for host, mod in ((jh, jmsg), (th, tmsg)):
        _feed_rounds(host, mod, traffic + late)
    assert th.stats["overflow_routed"] == 1 and th.stats["scalar_ops"] > 0
    key = ChannelKey("doc0", "default", "grid")
    assert th._matrix_rows[key].scalar is not None
    assert th._matrix_rows[ChannelKey("doc1", "default", "grid")].scalar \
        is None
    _assert_matrix_equal(jh, th)
    snap = jh.export_state()
    src = JaxMergeHost()
    src.import_state(snap)
    _assert_matrix_equal(src, convert.merge_host_from_export(snap,
                                                             device="cpu"))


def test_matrix_through_routerlicious_matches_jax():
    """SharedMatrix ops submitted by connected clients reach the merge
    host through the service's merger lambda on both stacks: client 0
    lays out the grid, then every client writes cells concurrently and
    some insert and remove rows and cols."""
    out = []
    for service_cls, mod, host in (
            (JaxService, jmsg, JaxMergeHost(flush_threshold=10**9)),
            (TorchService, tmsg, TorchMergeHost(flush_threshold=10**9,
                                                device="cpu"))):
        service = service_cls(merge_host=host, auto_pump=False)
        service._clock = itertools.count(1000, 7).__next__
        conns = [service.connect("doc", lambda m: None) for _ in range(6)]
        service.pump()
        rng = random.Random(11)
        cseq = {c.client_id: 0 for c in conns}

        def send(c, op, ref):
            cseq[c.client_id] += 1
            c.submit([mod.DocumentMessage(
                client_sequence_number=cseq[c.client_id],
                reference_sequence_number=ref,
                type=mod.MessageType.OPERATION,
                contents={"address": "default",
                          "contents": {"address": "grid",
                                       "contents": op}})])

        head = len(service.get_deltas("doc", 0))
        send(conns[0], {"type": "insert", "target": "rows", "pos": 0,
                        "count": 8}, head)
        send(conns[0], {"type": "insert", "target": "cols", "pos": 0,
                        "count": 8}, head + 1)
        service.pump()
        for n_round in range(5):
            head = len(service.get_deltas("doc", 0))
            for c in conns:
                if n_round % 2 and rng.random() < 0.3:
                    op = rng.choice([
                        {"type": "insert", "target": "rows",
                         "pos": rng.randint(0, 8), "count": 2},
                        {"type": "remove", "target": "cols",
                         "start": 1, "end": 2}])
                else:
                    op = {"type": "set", "target": "cell",
                          "row": rng.randrange(8), "col": rng.randrange(7),
                          "value": rng.randrange(100)}
                send(c, op, head)
            service.pump()
        host.flush()
        out.append((host.matrix_grid("doc", "default", "grid"),
                    host.summarize("doc"), host.stats, host.export_state()))
    assert out[0] == out[1]
    assert out[0][2]["device_ops"] > 30 and out[0][2]["cell_run_ticks"] > 0
