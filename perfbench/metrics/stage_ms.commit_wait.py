"""stage_ms.commit_wait: host ms from the end of a served round's
harvest to the durable drain that finds its tick fsynced and pushes its
acks (``wal_commit_wait``, amended at the drain; at depth 0 the inline
durability barrier), the median over the window's unprofiled rounds."""

from perfbench.metrics._stages import p50_ms


def read(run: dict):
    return p50_ms(run, "wal_commit_wait")
