"""wal_write_ms: host ms the group-commit writer spends writing one fsync
batch to the WAL file (each record's CRC and the write of its parts),
the median over the window's unprofiled batches."""

import statistics

from perfbench.metrics._wal import column


def read(run: dict):
    ns = column(run, "write_ns")
    return statistics.median(ns) / 1e6 if ns else None
