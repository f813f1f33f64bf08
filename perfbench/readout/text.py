"""A SharedString row of the serving state (the block table) as the
reference's visible form, and their comparison.

Document order is block-major over each block's occupied prefix; a slot
whose remove stamp is the "never" sentinel is live and holds ``length``
characters from pool index ``pool_start`` on, with its properties."""

from __future__ import annotations

import numpy as np

NONE_SEQ = 2**31 - 1


def visible(planes: dict) -> dict:
    """``planes``: one document's ``length``, ``rem_seq``, ``pool_start``
    [NB, Bk], ``prop_val`` [NB, Bk, P] and ``blk_count`` [NB]."""
    nb, bk = np.asarray(planes["length"]).shape
    count = np.asarray(planes["blk_count"])
    occupied = np.arange(bk)[None, :] < count[:, None]
    live = occupied & (np.asarray(planes["rem_seq"]) == NONE_SEQ) \
        & (np.asarray(planes["length"]) > 0)
    length = np.asarray(planes["length"])[live].astype(np.int64)
    start = np.asarray(planes["pool_start"])[live].astype(np.int64)
    props = np.asarray(planes["prop_val"])[live].astype(np.int64)
    offset = np.arange(int(length.sum())) - np.repeat(np.cumsum(length)
                                                      - length, length)
    return {"names": np.repeat(start, length) + offset,
            "props": np.repeat(props, length, axis=0)}


def equal(got: dict, want: dict) -> bool:
    return (np.array_equal(got["names"], want["names"])
            and np.array_equal(got["props"], want["props"]))
