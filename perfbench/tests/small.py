"""Cells shrunk for the CPU tests."""

from __future__ import annotations

CELLS = ("mixed_8k.seeded", "text_8k.scattered", "text_8k.typing")


def shrink(work: dict, config: dict, docs: int = 8, ticks: int = 2,
           sets: int = 2, sample: int = 2) -> tuple[dict, dict]:
    """A cell at ``docs`` documents and ``ticks``-tick epochs, its
    capacities resized by the configurations' own rules."""
    fams = {f: dict(v) for f, v in config["families"].items()}
    for f, v in fams.items():
        if f == "text":
            v["slots"] = 2 * v["k"] * ticks + 64
        if f == "matrix":
            v["vec_slots"] = 4 * ticks + 16
        if f == "tree":
            v["slots"] = v["k"] * ticks + 32
    return (dict(work, input_sets=sets, sample=sample),
            dict(config, docs=docs, epoch_ticks=ticks, families=fams))
