"""The group-commit WAL writer's own records of its batches
(``GroupCommitLog.batches()``: first record index, records, bytes, write
ns, fsync ns, one a batch), over the batches whose records all belong to
the window's rounds that no profiler recorded. A run that kept none reads
as none."""

from __future__ import annotations

#: The fields of a batch's record, in order.
FIELDS = ("first", "records", "bytes", "write_ns", "fsync_ns")


def column(run: dict, field: str) -> list:
    """The ``field`` of every batch, or an empty list without any."""
    at = FIELDS.index(field)
    return [b[at] for b in run.get("wal_batches") or ()]
