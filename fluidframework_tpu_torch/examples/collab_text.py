"""CollabText — a collaborative text editor example app.

Reference parity: examples/data-objects/shared-text — a DataObject whose
document body is a SharedString; concurrent edits from any number of
clients converge through the merge-tree, annotations style ranges (bold
here), and an interval collection tracks a shared "comment" range that
rides the text through remote edits.

Run:  python -m fluidframework_tpu_torch.examples.collab_text
"""

from __future__ import annotations

from ..dds.sequence import SharedString
from ..framework.data_object import DataObject
from ..framework.data_object_factory import DataObjectFactory

TEXT_ID = "body"
COMMENTS_LABEL = "comments"


class CollabText(DataObject):
    def initializing_first_time(self, props=None) -> None:
        text = self.runtime.create_channel(
            TEXT_ID, SharedString.channel_type)
        self.root.set(TEXT_ID, text.handle)
        if props and props.get("initial_text"):
            text.insert_text(0, props["initial_text"])

    @property
    def text(self) -> SharedString:
        return self.root.get(TEXT_ID).get()

    # -- editor operations ----------------------------------------------------

    def type_text(self, pos: int, text: str) -> None:
        self.text.insert_text(pos, text)

    def delete(self, start: int, end: int) -> None:
        self.text.remove_text(start, end)

    def bold(self, start: int, end: int) -> None:
        self.text.annotate_range(start, end, {"bold": True})

    def comment(self, start: int, end: int, note: str) -> None:
        """Attach a note to a range; the interval follows the text."""
        self.text.get_interval_collection(COMMENTS_LABEL).add(
            start, end, props={"note": note})

    def comments(self) -> list[tuple[int, int, str]]:
        collection = self.text.get_interval_collection(COMMENTS_LABEL)
        return sorted((start, end, (props or {}).get("note"))
                      for start, end, props
                      in collection.resolved().values())

    def read(self) -> str:
        return self.text.get_text()


collab_text_factory = DataObjectFactory("collab-text", CollabText)


def main(argv: list[str] | None = None) -> None:
    import argparse

    from .host import open_document, parse_endpoint_args

    parser = argparse.ArgumentParser(description=__doc__)
    parse_endpoint_args(parser)
    args = parser.parse_args(argv)

    with open_document("collab-text", args,
                       props={"initial_text": "hello"}) as session:
        creator, joiner = session.creator, session.joiner
        joiner.type_text(len(joiner.read()), " world")
        creator.type_text(0, "doc: ")
        session.settle()
        creator.bold(0, 4)
        joiner.comment(5, 10, "greeting")
        session.settle()
        print(f"collab_text: {creator.read()!r} == {joiner.read()!r}, "
              f"comments={joiner.comments()}")
        assert creator.read() == joiner.read()
        if session.created:
            assert creator.read() == "doc: hello world"


if __name__ == "__main__":
    main()
