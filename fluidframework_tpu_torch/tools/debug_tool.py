"""Debug tool — step through a recorded document, inspecting state.

Reference parity: packages/tools/replay-tool's step mode + the debugger
driver UI (packages/drivers/debugger): load a recorded directory
(ops.json [+ snapshot.json], the replay/file-driver format), then advance
the cursor op by op, printing each delivered op and summarizing document
state at any stop point.

Usage::

    python -m fluidframework_tpu_torch.tools.debug_tool golden_dir --to 40
    python -m fluidframework_tpu_torch.tools.debug_tool golden_dir --step 5 -v
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..drivers.debug_driver import DebuggerDocumentService
from ..drivers.replay_driver import load_recorded
from ..runtime.container import Container
from .replay import canonical


def load_session(directory: str | Path, start_seq: int = 0):
    """(service, container) over a recorded directory, paused at start."""
    messages, snapshot = load_recorded(directory)
    service = DebuggerDocumentService(messages, snapshot, start_seq)
    container = Container.load(service, mode="read")
    return service, container


def _describe(message) -> str:
    contents = message.contents
    kind = getattr(message.type, "name", str(message.type))
    detail = ""
    if isinstance(contents, dict):
        inner = contents.get("contents")
        if isinstance(inner, dict) and isinstance(inner.get("contents"),
                                                  dict):
            channel_op = inner["contents"]
            detail = " " + json.dumps(channel_op, default=str)[:90]
    return (f"seq={message.sequence_number} ref={message.reference_sequence_number} "
            f"client={message.client_id} {kind}{detail}")


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("directory")
    parser.add_argument("--to", type=int, default=None,
                        help="play to this sequence number (default: end)")
    parser.add_argument("--step", type=int, default=None,
                        help="deliver N ops at a time, printing state "
                             "after each batch")
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="print every delivered op")
    args = parser.parse_args(argv)

    service, container = load_session(args.directory)
    target = args.to if args.to is not None else service.end_seq

    def report(batch):
        if args.verbose:
            for message in batch:
                print(f"  {_describe(message)}")
        print(f"@seq {service.cursor}: summary "
              f"{canonical(container.summarize())[:120]}...")

    if args.step:
        while service.cursor < target:
            # Clamp the batch to --to: never deliver past the requested
            # stop sequence number.
            upcoming = [m.sequence_number for m in service.messages
                        if service.cursor < m.sequence_number <= target]
            if not upcoming:
                break
            batch = service.play_to(
                upcoming[min(args.step, len(upcoming)) - 1])
            report(batch)
    else:
        report(service.play_to(target))


if __name__ == "__main__":
    main(sys.argv[1:])
