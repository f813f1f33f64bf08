"""ladder_fired_share: the share of the window's ticks, in %, in which the
block-table ladder fired, from the tick's kernel-stats counter (its
rebalance-fired cell, index 3)."""


def read(run: dict):
    kstats = run["kstats"]
    if not len(kstats) or "text" not in run["families"]:
        return None
    return 100.0 * sum(int(k[3]) > 0 for k in kstats) / len(kstats)
