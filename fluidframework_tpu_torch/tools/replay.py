"""Golden-snapshot replay harness.

Reference parity: packages/test/snapshots/src/replayMultipleFiles.ts:83-92
(Compare + Stress modes over recorded op logs via replay-driver) and
packages/tools/replay-tool. A golden directory holds:

  ops.json      — the document's full sequenced log (wire codec)
  summary.json  — the canonical converged summary (the golden)
  meta.json     — {"name", "description", "ops"}

``verify_golden`` replays the log through the REAL client stack
(Container over ReplayDocumentService) and compares the resulting summary
byte-for-byte against the golden (Compare mode); with ``stress=True`` it
additionally snapshots at every ``stride`` ops and reloads from that
snapshot + trailing deltas, asserting the same final summary (Stress
mode — validates every snapshot-load boundary, snapshotLoader parity).

Regenerate the corpus with tools/record_goldens.py (deterministic seeds);
the goldens are checked in so later changes regress against the committed
wire and summary formats. The port replays the reference package's
committed ``tests/goldens/`` and does not re-record them.
"""

from __future__ import annotations

import json
from pathlib import Path

from ..drivers.replay_driver import FileDocumentService, ReplayDocumentService
from ..runtime.container import Container


def canonical(obj) -> str:
    """Canonical JSON: tuples/lists and key order normalized."""
    return json.dumps(obj, sort_keys=True, default=list,
                      separators=(",", ":"))


def replay_summary(directory: str | Path,
                   up_to_seq: int | None = None) -> dict:
    """Replay a recorded document through the full stack; return its
    summary at the final (or truncated) sequence number."""
    service = FileDocumentService(directory, up_to_seq)
    container = Container.load(service, mode="read")
    return container.summarize()


def verify_golden(directory: str | Path, stress: bool = False,
                  stride: int = 7) -> None:
    """Raise AssertionError on any divergence from the golden."""
    directory = Path(directory)
    golden = canonical(json.loads((directory / "summary.json").read_text()))

    got = canonical(replay_summary(directory))
    assert got == golden, (
        f"{directory.name}: replayed summary diverges from golden\n"
        f"golden: {golden[:400]}\ngot:    {got[:400]}")

    if not stress:
        return
    service = FileDocumentService(directory)
    base = service.storage.get_latest_snapshot()
    messages = service.delta_storage.get_deltas(0)
    last_seq = messages[-1].sequence_number if messages else 0
    for cut in range(stride, last_seq, stride):
        # Summarize at the cut...
        mid = Container.load(
            ReplayDocumentService(messages, snapshot=base, up_to_seq=cut,
                                  blobs=service.blobs),
            mode="read")
        snapshot = mid.summarize()
        # ...then load FROM that snapshot + trailing deltas.
        resumed = Container.load(
            ReplayDocumentService(messages, snapshot=snapshot), mode="read")
        got = canonical(resumed.summarize())
        assert got == golden, (
            f"{directory.name}: snapshot boundary at seq {cut} diverges\n"
            f"golden: {golden[:400]}\ngot:    {got[:400]}")


def verify_corpus(root: str | Path, stress: bool = False) -> list[str]:
    """Verify every golden under root; returns the verified names."""
    root = Path(root)
    names = []
    for directory in sorted(p for p in root.iterdir() if p.is_dir()):
        verify_golden(directory, stress=stress)
        names.append(directory.name)
    assert names, f"no goldens under {root}"
    return names
