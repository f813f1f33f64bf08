"""A reference fault the port mirrors, pinned on the CPU.

``server/routerlicious.py:BatchedDeliDocumentLambda._make_sequencer``
builds a document's deli lambda at the document's first per-op message of
a service life, and restores the store's ``deli/<doc>`` checkpoint over
the sequencer row. After ``StormController.recover()`` and storm frames
that checkpoint is stale: the row the frames advanced is rolled back, and
the next per-op message takes a sequence number the frames already took.

The same scenario runs through both packages (the chaos harness's
durable storm stack, the port's on the CPU): one writer joins and the
genesis checkpoint is taken, two storm frames are served and
checkpointed, a fresh stack recovers and serves a third frame, then a
second client joins per-op. Both packages diverge the same way on the
first diverging field, ``sequence_number``: the join is sequenced at 2
(the stale checkpoint's 1, plus one), not at the head plus one.
"""

from __future__ import annotations

import pytest

from fluidframework_tpu.protocol.messages import MessageType as j_MessageType
from fluidframework_tpu.tools import chaos as j_chaos
from fluidframework_tpu_torch.protocol.messages import (
    MessageType as t_MessageType)
from fluidframework_tpu_torch.tools import chaos as t_chaos

K = 8
SIDES = {
    "jax": (lambda root: j_chaos._build_stack(str(root), 1), j_chaos,
            j_MessageType),
    "torch": (lambda root: t_chaos._build_stack(str(root), 1, "cpu"),
              t_chaos, t_MessageType),
}


def _frames(storm, chaos, client: str, rounds) -> list:
    acks: list = []
    for r in rounds:
        storm.submit_frame(
            acks.append, {"rid": r, "docs": [["doc", client, 1 + r * K, 1, K]]},
            memoryview(chaos._tick_words(0, r, 0, K).tobytes()))
        storm.flush()
    return acks


def _scenario(side: str, root) -> dict:
    build, chaos, message_type = SIDES[side]
    service, storm, seq_host, _ = build(root)
    writer = service.connect("doc", lambda m: None).client_id
    service.pump()
    storm.checkpoint()
    stale = service._deli._lambda_for("doc")._store.get("deli/doc")
    _frames(storm, chaos, writer, range(2))
    storm.checkpoint()
    storm._group_wal.close()

    service, storm, seq_host, _ = build(root)
    storm.recover()
    recovered = seq_host.checkpoint("doc").sequence_number
    acks = _frames(storm, chaos, writer, range(2, 3))
    head = seq_host.checkpoint("doc").sequence_number
    joiner = service.connect("doc", lambda m: None).client_id
    service.pump()
    deltas = service.get_deltas("doc", 0)
    storm._group_wal.close()
    return {
        "stale_checkpoint_seq": stale["sequence_number"],
        "recovered_seq": recovered, "frame_acked": len(acks) == 1
        and not acks[0].get("error"), "head_before_join": head,
        "joins": [[m.sequence_number, m.client_id] for m in deltas
                  if m.type == message_type.CLIENT_JOIN],
        "seqs": sorted(m.sequence_number for m in deltas),
        "row_after_join": seq_host.checkpoint("doc").sequence_number,
        "joiner": joiner,
    }


def test_stale_deli_checkpoint_after_recover_is_the_references(tmp_path):
    got = {side: _scenario(side, tmp_path / side) for side in SIDES}
    assert got["torch"] == got["jax"]
    run = got["torch"]
    head = 1 + 3 * K
    assert run["stale_checkpoint_seq"] == 1
    assert run["recovered_seq"] == 1 + 2 * K
    assert run["frame_acked"] and run["head_before_join"] == head
    # The fault: the per-op join restores the stale deli/<doc> row and
    # takes sequence number 2, which a frame op already holds, where the
    # head plus one (26) is right.
    assert run["row_after_join"] == 2
    assert [seq for seq, _ in run["joins"]] == [1, 2]
    assert run["seqs"].count(2) == 2 and head + 1 not in run["seqs"]
