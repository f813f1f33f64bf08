"""k1_fold_roofline: kernel 1's (the map fold's) share of its roofline
over the profiled rounds of a served cell, in %: the least time the
rounds' folds need at the H100's peak bandwidth
(``_work_fold.fold_bytes``) over kernel 1's device time in the trace, by
kernel name."""

from perfbench.metrics._work import least_s


def read(run: dict):
    secs = sum(s for name, (s, _c) in run.get("kernels", {}).items()
               if "map_fold" in name)
    work = run.get("work", {}).get("k1_bytes")
    if not secs or not work:
        return None
    return 100.0 * least_s(work) / secs
