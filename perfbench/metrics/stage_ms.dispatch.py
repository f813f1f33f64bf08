"""stage_ms.dispatch: host ms a served round spends issuing the staged
inputs' copies and the device tick (the deli's closed-form tickets and
the map fold, kernel 1) and its readback copies (the ledger's
``device_dispatch`` stage), the median over the window's unprofiled
rounds."""

from perfbench.metrics._stages import p50_ms


def read(run: dict):
    return p50_ms(run, "device_dispatch")
