"""SharedMap traffic: set, delete and clear words drawn per document.

Each op is one packed word, kind (2 bits) | slot (10 bits) | value (20
bits), as the storm frame carries it. Kinds are drawn with the cell's
``mix`` weights, slots uniformly over ``slots`` and values uniformly
over 1 .. 2**20 - 1."""

from __future__ import annotations

import numpy as np

KINDS = ("set", "delete", "clear")


def generate(rng: np.random.Generator, n: int, k: int, ticks: int,
             ctx: dict, params: dict) -> dict:
    """``words``: i32[ticks, n, k], the u32 words' bits."""
    weights = np.array([params["mix"][name] for name in KINDS], float)
    kind = rng.choice(len(KINDS), size=(ticks, n, k),
                      p=weights / weights.sum()).astype(np.uint32)
    slot = rng.integers(0, params["slots"], (ticks, n, k)).astype(np.uint32)
    value = rng.integers(1, 1 << 20, (ticks, n, k)).astype(np.uint32)
    words = (value << 12) | (slot << 2) | kind
    return {"words": words.view(np.int32)}
