"""A SharedMap row of the serving state as the reference's visible
form, and their comparison."""

from __future__ import annotations

import numpy as np


def visible(planes: dict) -> dict:
    """``planes``: one document's ``present``, ``value``, ``vseq`` and
    ``cleared_seq`` arrays."""
    present = np.asarray(planes["present"]).astype(bool)
    return {"present": present,
            "value": np.where(present, planes["value"], 0).astype(np.int64),
            "vseq": np.asarray(planes["vseq"], np.int64),
            "cleared_seq": int(planes["cleared_seq"])}


def equal(got: dict, want: dict) -> bool:
    return (got["cleared_seq"] == want["cleared_seq"]
            and all(np.array_equal(got[f], want[f])
                    for f in ("present", "value", "vseq")))
