"""stage_ms.ingress: host ms a served round spends decoding and admitting
its frames inside ``StormController.submit_frame`` (the ledger's
``ingress_decode`` and ``admission`` stages, summed over the round's
frames), the median over the window's unprofiled rounds."""

from perfbench.metrics._stages import p50_ms


def read(run: dict):
    return p50_ms(run, "ingress_decode", "admission")
