"""SharedMap traffic drawn on the device: the words of ``traffic/map.py``
(kind with the cell's ``mix`` weights, slot uniform over ``slots``, value
uniform over 1 .. 2**20 - 1, packed kind | slot << 2 | value << 12), drawn
a round at a time by a ``torch.Generator`` on the run's device and copied
to the host, where the served path's frames carry them.

For streams of tens of millions of words a set: drawn on the host they
would take most of a run's set-up."""

from __future__ import annotations

import numpy as np

from perfbench.traffic.map import KINDS

#: Documents drawn at once.
BLOCK_DOCS = 1024


def generate(seed: int, rounds: int, docs: int, k: int, params: dict,
             device) -> np.ndarray:
    """i32[rounds, docs, k]: the u32 words' bits, the same for the same
    ``seed`` on the same kind of device."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    weights = torch.tensor([params["mix"][name] for name in KINDS],
                           dtype=torch.float64)
    edges = (weights.cumsum(0)[:-1] / weights.sum()).to(
        device=device, dtype=torch.float32)
    out = np.empty((rounds, docs, k), np.int32)
    for r in range(rounds):
        # A block of documents at a time: the draw's temporaries stay a
        # small part of the device memory that serving uses.
        for lo in range(0, docs, BLOCK_DOCS):
            shape = (min(BLOCK_DOCS, docs - lo), k)
            kind = torch.bucketize(
                torch.rand(shape, generator=gen, device=device), edges,
                right=True)
            slot = torch.randint(0, params["slots"], shape, generator=gen,
                                 device=device)
            value = torch.randint(1, 1 << 20, shape, generator=gen,
                                  device=device)
            word = (value << 12) | (slot << 2) | kind
            # The u32 word's bits as an i32.
            word = torch.where(word >= 1 << 31, word - (1 << 32), word)
            out[r, lo:lo + shape[0]] = word.to(torch.int32).cpu().numpy()
    return out
