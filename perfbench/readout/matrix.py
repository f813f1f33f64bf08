"""A SharedMatrix row of the serving state as the reference's visible
form, and their comparison: the live row and column handles in order
(each vector a flat merge table in slot order) and the cell table."""

from __future__ import annotations

import numpy as np

NONE_SEQ = 2**31 - 1


def _handles(vec: dict) -> np.ndarray:
    live = np.asarray(vec["valid"]).astype(bool) \
        & (np.asarray(vec["rem_seq"]) == NONE_SEQ) \
        & (np.asarray(vec["length"]) > 0)
    length = np.asarray(vec["length"])[live].astype(np.int64)
    start = np.asarray(vec["pool_start"])[live].astype(np.int64)
    offset = np.arange(int(length.sum())) - np.repeat(np.cumsum(length)
                                                      - length, length)
    return np.repeat(start, length) + offset


def visible(planes: dict) -> dict:
    """``planes``: one document's ``rows`` and ``cols`` (dicts of
    ``valid``, ``length``, ``rem_seq``, ``pool_start``) and its
    ``cell_used``, ``cell_rh``, ``cell_ch``, ``cell_val``."""
    used = np.flatnonzero(np.asarray(planes["cell_used"]).astype(bool))
    cells = {(int(planes["cell_rh"][i]), int(planes["cell_ch"][i])):
             int(planes["cell_val"][i]) for i in used}
    return {"rows": _handles(planes["rows"]), "cols": _handles(planes["cols"]),
            "cells": cells}


def equal(got: dict, want: dict) -> bool:
    return (np.array_equal(got["rows"], want["rows"])
            and np.array_equal(got["cols"], want["cols"])
            and got["cells"] == want["cells"])
