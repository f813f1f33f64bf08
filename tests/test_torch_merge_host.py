"""Differential: the map half of the port's KernelMergeHost against the JAX
package's, on the per-op (dict) path: sequenced set/delete/clear messages
across several documents and channels, row and key-slot growth, row
release and reuse, materialized entries, and export/import of the map
planes in both directions. Text, matrix and tree ops are not ported and
must raise naming their family.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from fluidframework_tpu.protocol import messages as jmsg
from fluidframework_tpu.server.merge_host import \
    ChannelKey as JaxChannelKey
from fluidframework_tpu.server.merge_host import \
    KernelMergeHost as JaxMergeHost
from fluidframework_tpu_torch import convert
from fluidframework_tpu_torch.protocol import messages as tmsg
from fluidframework_tpu_torch.server.merge_host import ChannelKey
from fluidframework_tpu_torch.server.merge_host import \
    KernelMergeHost as TorchMergeHost

CHANNELS = [("doc0", "ds", "m"), ("doc0", "ds", "n"), ("doc1", "ds", "m"),
            ("doc2", "other", "m"), ("doc3", "ds", "m")]


def _msg(mod, seq: int, channel_op: dict, datastore="ds", channel="m"):
    return mod.SequencedDocumentMessage(
        client_id="c", sequence_number=seq, minimum_sequence_number=0,
        client_sequence_number=seq, reference_sequence_number=seq - 1,
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


@pytest.mark.parametrize("family,op", [
    ("text", {"type": "insert", "pos": 0, "text": "hi"}),
    ("matrix", {"type": "set", "target": "cell", "row": 0, "col": 0}),
    ("tree", {"type": "edit", "edit": {}}),
])
def test_unported_families_raise(family, op):
    th = TorchMergeHost(device="cpu")
    with pytest.raises(NotImplementedError, match=family):
        th.ingest("doc", _msg(tmsg, 1, op))
