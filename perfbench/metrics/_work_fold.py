"""The least bytes kernel 1 (the map fold) moves on one round of the
served path, counted from the round's words alone (never from what an
implementation launches or pads), by ``_work.py``'s rule: every input
byte of the ops in the batch read once, every output byte written once.
A faster fold of the same words reads a higher share of its roofline and
none can read above 100%."""

from __future__ import annotations

import numpy as np

CLEAR = 2


def fold_bytes(words: np.ndarray) -> int:
    """Kernel 1 on one round: ``words`` i32[docs, k], every document's
    ``k`` ops sequenced (the served cells' rounds sequence every op).

    Reads: each op's word once, and each document's window (its first
    and last op and its sequence number before them, 3 x 4 bytes).
    Writes: each slot that an op after the document's last clear of the
    round sets or deletes changes its present flag and its sequence
    stamp (1 + 4 bytes), and a document with a clear changes its
    cleared stamp (4 bytes). Slots that only the clear resets, and the
    values a set stores, are left out: whether they change depends on
    the state before the round, so they are no floor."""
    w = np.asarray(words).view(np.uint32)
    docs, k = w.shape
    kind = w & 3
    slot = (w >> 2) & 0x3FF
    is_clear = kind == CLEAR
    has_clear = is_clear.any(axis=1)
    last_clear = np.where(has_clear,
                          k - 1 - np.argmax(is_clear[:, ::-1], axis=1), -1)
    named = (np.arange(k)[None, :] > last_clear[:, None]) & (kind < CLEAR)
    touched = np.zeros((docs, 1 << 10), bool)
    rows = np.broadcast_to(np.arange(docs)[:, None], w.shape)
    touched[rows[named], slot[named]] = True
    return int(docs * k * 4 + docs * 3 * 4 + int(touched.sum()) * (1 + 4)
               + int(has_clear.sum()) * 4)
