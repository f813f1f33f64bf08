"""stage_ms.readback: host ms a served round's harvest waits for the
tick's outputs to reach the host (the ledger's ``readback`` stage: at
pipeline depth 0 the device's time for the tick), the median over the
window's unprofiled rounds."""

from perfbench.metrics._stages import p50_ms


def read(run: dict):
    return p50_ms(run, "readback")
