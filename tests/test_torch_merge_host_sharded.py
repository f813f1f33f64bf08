"""Differential: the port's sequence-parallel and mega-doc merge pools
against the JAX package's, exactly.

Both hosts take the same sequenced SharedString traffic through ``ingest``
(``text_rounds`` of ``tests/test_torch_merge_host.py``): the port with a
``seg_mesh`` of 8 CPU shards (a virtual mesh), the reference with one over
the suite's 8 virtual devices.

* A document whose segment table outgrows the single-device buckets
  migrates into a ``_ShardedMergePool`` and keeps serving there.
* A document whose pending writer set crosses ``megadoc_writer_threshold``
  promotes into a mega pool at the next flush, and demotes back to its
  block bucket after ``megadoc_demote_idle_flushes`` idle flushes.

Every pool's planes (size tier and mega tier), text pools, free lists,
``text``, ``stats`` and ``export_state`` must be equal, the texts must equal
a scalar ``MergeEngine`` replay, and each side must import the other's
snapshot (sharded pools included) and serve on identically.
"""

from __future__ import annotations

import random

import jax
import numpy as np
import pytest

from fluidframework_tpu.ops.mergetree_sharded import \
    make_seg_mesh as jax_seg_mesh
from fluidframework_tpu.protocol import messages as jmsg
from fluidframework_tpu.server.merge_host import \
    KernelMergeHost as JaxMergeHost
from fluidframework_tpu_torch.ops.mergetree_sharded import make_seg_mesh
from fluidframework_tpu_torch.protocol import messages as tmsg
from fluidframework_tpu_torch.server.merge_host import \
    KernelMergeHost as TorchMergeHost
from tests.test_torch_merge_host import _feed, _oracle_text, text_rounds


@pytest.fixture(autouse=True)
def _small_blocks(monkeypatch):
    """Blocks of 16 slots in both packages (as the text farm of
    ``tests/test_torch_merge_host.py``): a 32-slot bucket holds two, so
    rows migrate out of block pools with gaps, and every test of this
    file compiles the reference's programs at the same shapes."""
    from fluidframework_tpu.server import merge_host as jmh
    from fluidframework_tpu_torch.server import merge_host as tmh
    for mod in (jmh, tmh):
        monkeypatch.setattr(mod._BlockMergePool, "BK", 16)


def hosts(**kw):
    jh = JaxMergeHost(seg_mesh=jax_seg_mesh(jax.devices()[:8]), **kw)
    th = TorchMergeHost(seg_mesh=make_seg_mesh(["cpu"] * 8), device="cpu",
                        **kw)
    return jh, th


def _pools_equal(jpools: dict, tpools: dict) -> None:
    assert sorted(tpools) == sorted(jpools)
    for slots, jp in jpools.items():
        tp = tpools[slots]
        assert type(tp).__name__ == type(jp).__name__, slots
        assert getattr(tp, "mega", False) == getattr(jp, "mega", False)
        assert (tp.slots, tp.num_props, tp.overlap_words, tp.capacity) \
            == (jp.slots, jp.num_props, jp.overlap_words, jp.capacity)
        for f in type(jp.state)._fields:
            a = np.asarray(getattr(jp.state, f))
            b = getattr(tp.state, f).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), (slots, f)
        assert tp.text.chunks == jp.text.chunks
        assert tp.text.used == jp.text.used
        assert tp.free == jp.free


def assert_hosts_equal(jh, th) -> None:
    _pools_equal(jh._merge_pools, th._merge_pools)
    _pools_equal(jh._mega_pools, th._mega_pools)
    for key in jh._merge_rows:
        assert th.text(*key) == jh.text(*key), key
        assert th.is_mega_row(key) == jh.is_mega_row(key), key
    assert th.stats == jh.stats
    assert th.export_state() == jh.export_state()


def test_huge_doc_migrates_to_the_sharded_pool():
    jh, th = hosts(merge_slots=32, sharded_slot_threshold=64,
                   flush_threshold=10_000)
    traffic = list(text_rounds(random.Random(3), 10, 6, per_round=(3, 6),
                               rich=False))
    _feed(jh, jmsg, traffic, flush_every=12)
    _feed(th, tmsg, traffic, flush_every=12)
    assert_hosts_equal(jh, th)
    (key,) = th._merge_rows
    assert type(th._merge_rows[key].pool).__name__ == "_ShardedMergePool"
    assert th.stats["migrations"] >= 1
    assert th.text(*key) == _oracle_text(traffic, key.doc_id, key.channel)
    assert th.metrics.counter("megadoc.sharded_ops").value > 0

    # Each side imports the other's snapshot, sharded pool included, and
    # both serve on identically.
    more = list(text_rounds(random.Random(4), 4, 6, per_round=(2, 4),
                            rich=False))
    shift = max(t[4] for t in traffic)
    more = [(d, c, op, w, seq + shift, ref + shift, msn + shift)
            for d, c, op, w, seq, ref, msn in more]
    back_j, back_t = hosts(merge_slots=32, sharded_slot_threshold=64,
                           flush_threshold=10_000)
    back_j.import_state(th.export_state())
    back_t.import_state(jh.export_state())
    _feed(back_j, jmsg, more)
    _feed(back_t, tmsg, more)
    assert_hosts_equal(back_j, back_t)


def test_import_of_a_sharded_pool_needs_a_seg_mesh():
    jh, th = hosts(merge_slots=32, sharded_slot_threshold=64)
    traffic = list(text_rounds(random.Random(3), 10, 6, per_round=(3, 6),
                               rich=False))
    _feed(th, tmsg, traffic, flush_every=12)
    with pytest.raises(ValueError, match="seg_mesh"):
        TorchMergeHost(merge_slots=16, device="cpu").import_state(
            th.export_state())


def test_writer_count_promotes_and_idle_demotes():
    kw = dict(merge_slots=32, sharded_slot_threshold=4096,
              megadoc_demote_idle_flushes=2, flush_threshold=10_000)
    jh, th = hosts(megadoc_writer_threshold=3, **kw)
    twin = TorchMergeHost(device="cpu", **kw)  # no mesh: the tier is off
    traffic = list(text_rounds(random.Random(5), 6, 4, per_round=(3, 4),
                               rich=False))
    for h, mod in ((jh, jmsg), (th, tmsg), (twin, tmsg)):
        _feed(h, mod, traffic, flush_every=8)
    (key,) = th._merge_rows
    assert th.stats["megadoc_promotions"] >= 1
    assert_hosts_equal(jh, th)
    for h in (jh, th):
        for _ in range(3):
            h.flush()  # idle flushes: the cooling signal
    assert th.stats["megadoc_demotions"] >= 1
    assert not th.is_mega_row(key)
    assert_hosts_equal(jh, th)
    assert th.text(*key) == twin.text(*key) \
        == _oracle_text(traffic, key.doc_id, key.channel)
    # Explicit promotion and demotion.
    for h in (jh, th):
        h.promote_merge_row(key)
        h.promote_merge_row(key)  # idempotent
        assert h.is_mega_row(key)
    assert_hosts_equal(jh, th)
    assert th.demote_merge_row(key) == jh.demote_merge_row(key) is True
    assert_hosts_equal(jh, th)


def test_seg_mesh_checks_match_the_reference():
    with pytest.raises(ValueError, match="power of two"):
        TorchMergeHost(seg_mesh=make_seg_mesh(["cpu"] * 3), device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        JaxMergeHost(seg_mesh=jax_seg_mesh(jax.devices()[:3]))
    host = TorchMergeHost(seg_mesh=make_seg_mesh(["cpu"] * 8),
                          sharded_slot_threshold=2, device="cpu")
    assert host.sharded_slot_threshold == 16  # >= 2 slots per shard
    with pytest.raises(ValueError, match="host's device"):
        TorchMergeHost(seg_mesh=make_seg_mesh(["cuda:0", "cuda:1"]),
                       device="cpu")
    # Two names of one device make one virtual mesh.
    TorchMergeHost(seg_mesh=make_seg_mesh(["cpu:0"] * 2), device="cpu")


def _writer_rounds(rng, rounds: int, writers: int, lag: int):
    """Per round every writer sends ONE op at the round's head ref (an
    insert 9 in 10, else a remove), positions valid in that frame; the msn
    trails ``lag`` rounds. Yields ``_feed``'s (doc, channel, op, client,
    seq, ref, msn) tuples."""
    seq, length, refs = 0, 0, [0] * lag
    for _ in range(rounds):
        ref, grown, gone = seq, 0, set()
        for w in range(writers):
            if length > 8 and rng.random() < 0.1:
                s = rng.randrange(length - 2)
                e = min(length, s + rng.randint(1, 3))
                op = {"type": "remove", "start": s, "end": e}
                gone.update(range(s, e))
            else:
                text = "".join(rng.choice("abcdef")
                               for _ in range(rng.randint(1, 3)))
                op = {"type": "insert", "pos": rng.randint(0, length),
                      "text": text}
                grown += len(text)
            seq += 1
            yield "doc", "text", op, f"w{w}", seq, ref, refs[0]
        length += grown - len(gone)
        refs = refs[1:] + [ref]


def test_gapped_row_fault_is_the_references():
    """A block row migrated into a flat (sequence-parallel) pool keeps its
    block gaps, its slot count below its last segment; the flat tick then
    places an end-of-document insert at that count, among live segments,
    and the text departs from the MergeEngine replay. The reference does
    this; the port mirrors it plane for plane (ROADMAP Queue C)."""
    jh, th = hosts(merge_slots=32, sharded_slot_threshold=64,
                   flush_threshold=10_000)
    traffic = list(_writer_rounds(random.Random(0), 12, 6, 16))
    _feed(jh, jmsg, traffic, flush_every=6)
    _feed(th, tmsg, traffic, flush_every=6)
    assert_hosts_equal(jh, th)
    (key,) = th._merge_rows
    assert th.is_mega_row(key) is False
    assert type(th._merge_rows[key].pool).__name__ == "_ShardedMergePool"
    assert th.text(*key) != _oracle_text(traffic, "doc", "text")
