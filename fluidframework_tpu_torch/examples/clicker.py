"""Clicker — the canonical counter example app.

Reference parity: examples/data-objects/clicker/src/index.tsx — a
DataObject holding a SharedCounter under its root directory; every client
clicking increments the same counter and all replicas converge. This is
BASELINE config 1's smoke workload (clicker on tinylicious).

Run two simulated clients against an in-process service:

    python -m fluidframework_tpu_torch.examples.clicker

or against a running alfred front door (the tinylicious analog):

    python -m fluidframework_tpu_torch.server.alfred --port 7070 &
    python -m fluidframework_tpu_torch.examples.clicker --port 7070
"""

from __future__ import annotations

from ..dds.counter import SharedCounter
from ..framework.data_object import DataObject
from ..framework.data_object_factory import DataObjectFactory

COUNTER_ID = "clicks"


class Clicker(DataObject):
    """Counter on the root directory (clicker's counterKey pattern)."""

    def initializing_first_time(self, props=None) -> None:
        counter = self.runtime.create_channel(
            COUNTER_ID, SharedCounter.channel_type)
        self.root.set(COUNTER_ID, counter.handle)

    @property
    def counter(self) -> SharedCounter:
        return self.root.get(COUNTER_ID).get()

    def click(self, times: int = 1) -> None:
        for _ in range(times):
            self.counter.increment()

    @property
    def value(self) -> int:
        return self.counter.value


clicker_factory = DataObjectFactory("clicker", Clicker)


def main(argv: list[str] | None = None) -> None:
    import argparse

    from .host import open_document, parse_endpoint_args

    parser = argparse.ArgumentParser(description=__doc__)
    parse_endpoint_args(parser)
    parser.add_argument("--clicks", type=int, default=5)
    args = parser.parse_args(argv)

    with open_document("clicker", args) as session:
        creator, joiner = session.creator, session.joiner
        before = creator.value
        creator.click(args.clicks)
        joiner.click(args.clicks)
        session.settle()
        print(f"clicker: creator sees {creator.value}, "
              f"joiner sees {joiner.value}")
        assert creator.value == joiner.value == before + 2 * args.clicks


if __name__ == "__main__":
    main()
