"""wal_fsync_ms: host ms of one fsync batch's fsync of the WAL file, on
the group-commit writer's thread, the median over the window's
unprofiled batches."""

import statistics

from perfbench.metrics._wal import column


def read(run: dict):
    ns = column(run, "fsync_ns")
    return statistics.median(ns) / 1e6 if ns else None
