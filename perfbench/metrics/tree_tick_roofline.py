"""tree_tick_roofline: the tree tick's share of its roofline over the
traced ticks, in %: the least time the edits in those ticks need at the
H100's peak bandwidth (``_work.tree_bytes``) over the tree leg's device
time between the tick's marks."""

from perfbench.metrics._work import least_s


def read(run: dict):
    ms = run["legs"].get("tree")
    work = run["work"].get("tree_bytes")
    if not ms or not work:
        return None
    return 100.0 * least_s(work) / (sum(ms) / 1e3)
