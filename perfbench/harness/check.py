"""What decides ``correct``: the window's outputs against the plain
reference, replayed from the same generated inputs.

* ``harvest_diffs``: fields of the first harvest of every (input set,
  tick) that differ from the reference deli's tickets (sequenced count,
  first and last sequence number, minimum sequence number, the sequenced
  and duplicate totals) or that report an overflow;
* ``state_diffs``: sampled documents whose converged, visible state after
  the first epoch of their input set differs from the reference's replay;
* ``repeat_diffs``: harvest fields and sampled state words of every later
  tick and epoch that differ from the first of their kind;
* ``sets_unchecked``: input sets whose epoch never completed in the
  window, so that no state of theirs was judged.

Every limit is 0: the guarantees are exact."""

from __future__ import annotations

import numpy as np

from .cell import FAMILIES, OVF_NONE, module
from .window import harvest_planes

LIMITS = {"harvest_diffs": 0, "state_diffs": 0, "repeat_diffs": 0,
          "sets_unchecked": 0}


def expected_tickets(config: dict, sets: list) -> list:
    deli = module("reference", "deli")
    return [deli.replay(config["clients"], s["scalars"]) for s in sets]


def harvest_diffs(config: dict, sets: list, tickets: list,
                  first_harvest: dict) -> int:
    docs = config["docs"]
    diffs = 0
    for (i, t), flat in first_harvest.items():
        got = harvest_planes(flat, docs)
        want = tickets[i]
        for name in ("n_seq", "first", "last", "msn"):
            diffs += int(np.count_nonzero(got[name] != want[name][t]))
        diffs += int(np.count_nonzero(got["kstats"][:3]
                                      != want["kstats"][t]))
        diffs += int(np.count_nonzero(got["text_overflow"] != OVF_NONE))
        diffs += int(np.count_nonzero(got["tree_overflow"] != 0))
    return diffs


def replay_doc(config: dict, family: str, inputs: np.ndarray,
               first: np.ndarray, order=None) -> dict:
    """The reference's visible state of one document of ``family``:
    ``inputs`` its [ticks, ...] tick inputs, ``first`` [ticks] the first
    sequence number of each tick."""
    ref = module("reference", family)
    fc = config["families"][family]
    if family == "map":
        return ref.replay(inputs, first, fc["slots"], order=order)
    if family == "text":
        return ref.replay(inputs, first, fc["props"],
                          max(config["writers"], config["clients"]),
                          order=order)
    if family == "matrix":
        return ref.replay(inputs, first, max(config["writers"],
                                             config["clients"]), order=order)
    return ref.replay(inputs, order=order)


def program_states(rows_of: list, planes_of):
    """The program's judged states for :func:`state_diffs`: ``planes_of(i)``
    gives input set ``i``'s captured rows (``None`` when it has none), one
    dict of planes by family per row of ``rows_of[i]``, which each
    family's readout turns into its visible state."""
    def states_of(i: int):
        planes = planes_of(i)
        if planes is None:
            return None
        at = {int(r): j for j, r in enumerate(rows_of[i])}
        return lambda fam, row: module("readout", fam).visible(
            planes[at[row]][fam])
    return states_of


def state_diffs(config: dict, sets: list, tickets: list,
                states_of) -> tuple[int, int]:
    """(documents whose state differs, documents compared). ``states_of(i)``
    gives input set ``i``'s judged states as a function (family, row) ->
    visible state, or ``None`` where the set has none."""
    diffs = compared = 0
    for i, s in enumerate(sets):
        visible = states_of(i)
        if visible is None:
            continue
        for fam in FAMILIES:
            if fam not in s["sample"]:
                continue
            read = module("readout", fam)
            for row in s["sample"][fam]:
                want = replay_doc(config, fam, s["inputs"][fam][:, row],
                                  tickets[i]["first"][:, row])
                compared += 1
                diffs += not read.equal(visible(fam, int(row)), want)
    return diffs, compared


def summary(values: dict) -> dict:
    """Each compared number beside its limit, and whether all hold."""
    checks = {name: {"value": int(values[name]), "limit": LIMITS[name]}
              for name in LIMITS}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return {"correct": ok, "checks": checks}
