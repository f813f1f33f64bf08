"""The control of the check that decides ``correct``: the plain reference
put in the program's place with one stated guarantee broken, judged by
the same comparison as a run.

The configurations state total order per document. The control replays
each tick's ops in reverse order (with their sequence numbers as
sequenced), which breaks it: its harvest is the reference deli's, and
the visible state of every sampled document of every input set is the
reversed replay's. Run it as a cell is run, with ``--control 1``:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace 0 --control 1

The window runs the program at the cell's own size and load, then the
check judges the control's outputs in its place; the line has to read
``correct`` false."""

from __future__ import annotations

import numpy as np

from perfbench.harness import check
from perfbench.harness.cell import HARVEST, OVF_NONE


def reversed_order(_t: int, k: int):
    return range(k - 1, -1, -1)


def harvests(config: dict, tickets: list, like: dict) -> dict:
    """The reference deli's harvest of each (input set, tick) of ``like``
    (the program's first harvests, read only for their keys and buffer
    length), laid out as the window reads a harvest back."""
    docs = config["docs"]
    out = {}
    for (i, t), buf in like.items():
        want = tickets[i]
        flat = np.zeros(len(buf), np.int32)
        for c, name in enumerate(("n_seq", "first", "last", "msn")):
            flat[c * docs:(c + 1) * docs] = want[name][t]
        at = HARVEST.index("text_overflow") * docs
        flat[at:at + docs] = OVF_NONE
        at = len(HARVEST) * docs
        flat[at:at + 3] = want["kstats"][t]
        out[(i, t)] = flat
    return out


def states(config: dict, sets: list, tickets: list):
    """Every input set's judged states, replayed with each tick's ops in
    reverse (``check.state_diffs``'s ``states_of``)."""
    def states_of(i: int):
        s = sets[i]
        return lambda fam, row: check.replay_doc(
            config, fam, s["inputs"][fam][:, row],
            tickets[i]["first"][:, row], order=reversed_order)
    return states_of
