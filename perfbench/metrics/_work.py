"""The work a tick's inputs need, counted from the inputs and the table
shapes alone (never from what an implementation launches or pads), and
the published peaks it is held to.

Each count is a floor that any implementation of the tick has to move:
every input byte of the ops in the batch read once, every output byte
written once. A roofline share is the least time these bytes take at the
peak bandwidth, divided by the measured time, so a faster implementation
of the same work reads a higher share and none can read above 100%."""

from __future__ import annotations

import numpy as np

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, bytes/s (at its 700 W limit).
HBM_BYTES_PER_S = 3.35e12


def k3_bytes(pack: np.ndarray, nb: int, bk: int, props: int,
             words: int) -> int:
    """Kernel 3 (the text merge) on one tick: ``pack`` i32[docs, 10, k]
    in the serving tick's text field order, the table (nb blocks of bk
    slots, ``props`` property and ``words`` overlap words a slot). Each
    valid op's ten fields and its valid flag are read once; a document
    with ops reads and rewrites its block summaries (4 planes) to find
    where its ops land, and reads and rewrites at least the one block
    they land in (6 planes, the properties and the overlap words a slot),
    and writes its overflow index."""
    valid = pack[:, 0] != 0
    docs = int(valid.any(axis=1).sum())
    slot = (6 + props + words) * 4
    return int(valid.sum()) * (10 * 4 + 1) \
        + docs * (2 * nb * 4 * 4 + 2 * bk * slot + 4)


def tree_bytes(pack: np.ndarray) -> int:
    """The tree tick on one tick: ``pack`` i32[docs, 6, k] in the serving
    tick's tree field order. Each valid op's five fields and its valid
    flag are read once, the node it names is read and written once (its
    exists flag, parent, trait, rank and payload) and its applied and
    overflow flags are written once."""
    ops = int((pack[:, 0] != 0).sum())
    return ops * ((5 * 4 + 1) + 2 * (1 + 4 * 4) + 2)


def least_s(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S
