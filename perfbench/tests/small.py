"""Cells shrunk for the CPU tests."""

from __future__ import annotations

import copy

#: Cells that drive the serving tick on its states.
TICK_CELLS = ("mixed_8k.seeded", "text_8k.scattered", "text_8k.typing")
#: Cells served through the program's front door by a driver.
SERVED_CELLS = ("map_storm_10k.served",)
CELLS = TICK_CELLS + SERVED_CELLS


def shrink(work: dict, config: dict, docs: int = 8, ticks: int = 2,
           sets: int = 2, sample: int = 2) -> tuple[dict, dict]:
    """A cell at ``docs`` documents and ``ticks``-tick epochs, its
    capacities resized by the configurations' own rules; a served cell at
    its own small size (:func:`shrink_served`)."""
    if "stack" in config:
        return shrink_served(work, config)
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


def shrink_served(work: dict, config: dict, docs: int = 16, k: int = 8,
                  frames: int = 2, rounds: int = 2, sets: int = 2,
                  sample: int = 4) -> tuple[dict, dict]:
    """A served cell at ``docs`` documents, ``k`` ops a batch, ``frames``
    frames a round and ``rounds``-round epochs; the stack's capacities
    and flush threshold resized to the documents."""
    stack = copy.deepcopy(config["stack"])
    stack["sequencer"]["initial_capacity"] = docs
    stack["merge_host"]["row_capacity"] = docs
    stack["storm"]["flush_threshold_docs"] = docs
    return (dict(work, input_sets=sets, sample=sample),
            dict(config, docs=docs, k=k, frames_per_round=frames,
                 epoch_rounds=rounds, stack=stack))
