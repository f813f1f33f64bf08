"""Plain replay of the deli's ticketing for the sessions of a run.

Follows the ordering service's rules (routerlicious deli lambda.ts): a
join takes the next sequence number and gives the client the current
minimum sequence number as its reference; a batch of ``n`` ops from a
joined client continues its client sequence numbers (a resent prefix is
dropped, a gap rejects the batch, a reference below the minimum sequence
number rejects it), the survivors take the next sequence numbers in
order, the client's reference becomes the batch's, and the minimum
sequence number becomes the least reference over joined clients."""

from __future__ import annotations

import numpy as np

INT32_MAX = 2**31 - 1


def replay(joined: int, scalars: np.ndarray) -> dict:
    """``scalars``: i32[ticks, docs, 6] (slot, cseq0, ref, ts, count, _)
    as sent. Returns [ticks, docs] planes ``n_seq``, ``first``, ``last``,
    ``msn`` and [ticks, 3] ``kstats`` (sequenced, duplicates dropped, 0)."""
    ticks, docs, _ = scalars.shape
    rows = np.arange(docs)
    seq = np.zeros(docs, np.int64)
    msn = np.zeros(docs, np.int64)
    cseq = np.zeros((docs, joined), np.int64)
    cref = np.zeros((docs, joined), np.int64)
    for _lane in range(joined):
        # Each join: seq + 1, the client's reference = the msn then.
        seq += 1
        msn = cref.min(axis=1)
    out = {name: np.zeros((ticks, docs), np.int64)
           for name in ("n_seq", "first", "last", "msn")}
    kstats = np.zeros((ticks, 3), np.int64)
    for t in range(ticks):
        slot, cseq0, ref, _ts, n, _m = (scalars[t, :, i].astype(np.int64)
                                        for i in range(6))
        n = np.maximum(n, 0)
        ok = (n > 0) & (slot >= 0) & (slot < joined)
        s = np.clip(slot, 0, joined - 1)
        expected = cseq[rows, s] + 1
        dups = np.minimum(np.maximum(expected - cseq0, 0), n)
        accept = ok & (cseq0 <= expected)
        m = np.where(accept, n - dups, 0)
        refnack = accept & (m > 0) & (ref != -1) & (ref < msn)
        n_seq = np.where(refnack, 0, m)
        before = seq.copy()
        seq = seq + n_seq
        up = n_seq > 0
        cseq[rows[up], s[up]] = (cseq0 + n - 1)[up]
        cref[rows[up], s[up]] = np.where(ref == -1, seq, ref)[up]
        marked = refnack
        cseq[rows[marked], s[marked]] = (cseq0 + dups)[marked]
        cref[rows[marked], s[marked]] = msn[marked]
        msn = np.where(up, cref.min(axis=1), msn)
        out["n_seq"][t] = n_seq
        out["first"][t] = np.where(up, before + 1, INT32_MAX)
        out["last"][t] = np.where(up, before + n_seq, 0)
        out["msn"][t] = msn
        kstats[t] = (np.where(n > 0, n_seq, 0).sum(),
                     np.where(n > 0, np.minimum(dups, n), 0).sum(), 0)
    return {**out, "kstats": kstats}
