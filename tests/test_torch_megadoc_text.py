"""The mega-doc tier's text leg of the port against the JAX package's:
promote → serve → demote through a virtual ``seg_mesh``, over
``RouterliciousService`` (the reference's ``tests/test_megadoc.py``
drives its text round trip through ``local_server.py``, which the port
does not have).

One document, 8 writers joined through the service, SharedString ops
before, during and after a ``MegaDocManager`` promotion: the promotion
moves the doc's text row into the merge host's sequence-parallel pool
(8 CPU shards in the port, the suite's 8 virtual devices in the
reference) and demotion moves it back to its block bucket. Both packages
must agree exactly on text, ``stats`` and ``export_state`` at every
stage, and the promoted run must equal an unpromoted twin while the row
is promoted.
"""

from __future__ import annotations

import random

from fluidframework_tpu.ops import mergetree_sharded as j_mts
from fluidframework_tpu_torch.ops import mergetree_sharded as t_mts
from tests.test_torch_megadoc import PKG, SIDES


def _op_count(P, svc, doc) -> int:
    return sum(1 for m in svc.get_deltas(doc, 0)
               if m.type == P.msgs.MessageType.OPERATION)


def _text_round_trip(side, promote, mesh):
    """One doc co-written by 8 writers through RouterliciousService: text
    before, during and after a mega-doc promotion whose text row moves
    into the merge host's sequence-parallel pool and back."""
    P = PKG[side]
    seq = P.kh.KernelSequencerHost(num_slots=8, initial_capacity=2,
                                   **P.dev)
    mh = P.mh.KernelMergeHost(merge_slots=16, seg_mesh=mesh,
                              sharded_slot_threshold=4096, **P.dev)
    svc = P.rl.RouterliciousService(merge_host=mh, batched_deli_host=seq,
                                    auto_pump=False,
                                    idle_check_interval=10**9)
    clock = iter(range(1000, 1 << 30, 3))
    svc._clock = lambda: next(clock)
    storm = P.storm.StormController(svc, seq, mh,
                                    flush_threshold_docs=10**9)
    mgr = P.mg.MegaDocManager(storm, default_lanes=2)
    doc = "mega-text"
    conns = [svc.connect(doc, lambda m: None) for _ in range(8)]
    svc.pump()
    head, length = 8, 0
    rng = random.Random(7)
    stages = {}

    def rounds(n, r0):
        nonlocal head, length
        for r in range(r0, r0 + n):
            starts = []
            grown = 0
            for c in conns:
                if length > 2 and rng.random() < 0.3:
                    a = rng.randrange(length - 1)
                    b = min(length, a + rng.randint(1, 4))
                    op = {"type": "remove", "start": a, "end": b}
                    starts.append((a, b))
                else:
                    text = "".join(rng.choice("abcdefgh")
                                   for _ in range(rng.randint(1, 4)))
                    op = {"type": "insert", "pos": rng.randint(0, length),
                          "text": text}
                    grown += len(text)
                c.submit([P.msgs.DocumentMessage(
                    client_sequence_number=r + 1,
                    reference_sequence_number=head,
                    type=P.msgs.MessageType.OPERATION,
                    contents={"address": "default",
                              "contents": {"address": "text",
                                           "contents": op}})])
            svc.pump()
            head += len(conns)
            covered = set()
            for a, b in starts:
                covered.update(range(a, b))
            length += grown - len(covered)

    rounds(3, 0)
    stages["before"] = mh.text(doc, "default", "text")
    key = next(iter(mh._merge_rows))
    if promote:
        mgr.promote(doc, lanes=2)
        stages["promoted"] = mh.is_mega_row(key)
    rounds(3, 3)
    mh.flush()
    stages["during"] = mh.text(doc, "default", "text")
    if promote:
        mgr.demote(doc)
        stages["demoted"] = not mh.is_mega_row(key)
    stages["ops_during"] = _op_count(P, svc, doc)
    rounds(3, 6)
    mh.flush()
    stages["after"] = mh.text(doc, "default", "text")
    stages["ops_after"] = _op_count(P, svc, doc)
    stages["stats"] = {k: v for k, v in mh.stats.items()}
    stages["export"] = mh.export_state()
    return stages


def test_text_round_trip_through_seg_mesh_matches_twin_and_jax(
        cpu_mesh_devices):
    meshes = {"jax": j_mts.make_seg_mesh(cpu_mesh_devices[:8]),
              "torch": t_mts.make_seg_mesh(["cpu"] * 8)}
    recs = {(side, p): _text_round_trip(side, p, meshes[side])
            for side in SIDES for p in (True, False)}
    for p in (True, False):
        assert recs[("torch", p)] == recs[("jax", p)]
    mega, twin = recs[("torch", True)], recs[("torch", False)]
    assert mega["promoted"] and mega["demoted"]
    for stage in ("before", "during", "ops_during"):
        assert mega[stage] == twin[stage], stage
    assert mega["stats"]["megadoc_promotions"] == 1
    assert mega["stats"]["megadoc_demotions"] == 1
    # Reference fault (ROADMAP Queue C), mirrored exactly above: demotion
    # restores the doc's sequencer row from the combiner mirror, which
    # never saw the per-op text ops sequenced on the frozen doc row while
    # promoted — their writers' cseqs regress, so every later per-op op
    # nacks as a gap and the text stops where demotion left it.
    assert twin["ops_after"] == twin["ops_during"] + 24
    assert mega["ops_after"] == mega["ops_during"]
    assert mega["after"] == mega["during"] != twin["after"]
