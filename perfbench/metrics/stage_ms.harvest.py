"""stage_ms.harvest: host ms a served round's harvest spends after the
readback: the per-document ack rows, tick header and catch-up index
(``ack_pack``), the fan-out publish (``fanout_publish``) and the tick
blob record (``wal_append``), summed a round, the median over the
window's unprofiled rounds."""

from perfbench.metrics._stages import p50_ms


def read(run: dict):
    return p50_ms(run, "ack_pack", "fanout_publish", "wal_append")
