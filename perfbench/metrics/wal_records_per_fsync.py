"""wal_records_per_fsync: tick records one fsync of the WAL makes durable
(group commit's batching: above 1 where ticks come faster than fsyncs),
the mean over the window's unprofiled batches."""

import statistics

from perfbench.metrics._wal import column


def read(run: dict):
    records = column(run, "records")
    return statistics.mean(records) if records else None
