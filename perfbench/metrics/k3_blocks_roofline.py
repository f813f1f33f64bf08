"""k3_blocks_roofline: kernel 3's (the text merge's) share of its
roofline over the traced ticks, in %: the least time the ops in those
ticks need at the H100's peak bandwidth (``_work.k3_bytes``) over kernel
3's device time in the trace, by kernel name."""

from perfbench.metrics._work import least_s


def read(run: dict):
    secs = sum(s for name, (s, _c) in run["kernels"].items()
               if "mergetree_blocks" in name)
    work = run["work"].get("k3_bytes")
    if not secs or not work:
        return None
    return 100.0 * least_s(work) / secs
