"""Sessions in front of the deli: which joined client submits each
document's batch in each tick, with its client sequence numbers and its
reference sequence number.

One batch per document per tick, from one client, sequenced whole: the
storm frame shape of the serving tick. Every tick sequences every op of
every batch, so a document's head before tick ``t`` is ``joins + t * k``
and each batch references that head."""

from __future__ import annotations

import numpy as np


def generate(rng: np.random.Generator, counts: np.ndarray, joined: int,
             ticks: int) -> dict:
    """[ticks, docs] planes ``slot``, ``cseq0`` and ``ref`` for documents
    that each send ``counts[d]`` ops a tick, each batch from one of the
    ``joined`` clients drawn from ``rng``; ``ts`` is [ticks]."""
    docs = counts.shape[0]
    slot = rng.integers(0, joined, (ticks, docs)).astype(np.int32)
    sent = np.zeros((docs, joined), np.int64)
    cseq0 = np.zeros((ticks, docs), np.int32)
    rows = np.arange(docs)
    for t in range(ticks):
        cseq0[t] = sent[rows, slot[t]] + 1
        sent[rows, slot[t]] += counts
    ref = (joined + np.arange(ticks)[:, None] * counts[None, :]).astype(
        np.int32)
    ts = (2 + np.arange(ticks)).astype(np.int32)
    return {"slot": slot, "cseq0": cseq0, "ref": ref, "ts": ts}
