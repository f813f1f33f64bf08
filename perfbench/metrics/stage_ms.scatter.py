"""stage_ms.scatter: host ms a served round spends in ``_flush_round``
resolving its documents' sequencer rows, client slots and map rows and
scattering the frames' words into the staging generation (the ledger's
``scatter`` stage), the median over the window's unprofiled rounds."""

from perfbench.metrics._stages import p50_ms


def read(run: dict):
    return p50_ms(run, "scatter")
