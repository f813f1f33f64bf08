"""RichTextEditor — the editor-grade shared-text example app.

Reference parity: examples/data-objects/shared-text/src (the reference's
flagship rich-text app class, plus the webflow/prosemirror-style document
model): a SharedString holds marker-structured paragraphs, formatting
annotates style character ranges, and interval collections carry comments
that ride the text through concurrent remote edits. This is the shape
that stresses annotate planes, markers and interval rebinds TOGETHER.

Document model
--------------
* Every paragraph is opened by a ``paragraph`` Marker carrying an id;
  paragraph text is the run of characters after its marker up to the
  next marker. An empty document has one initial paragraph.
* Formatting ops annotate arbitrary character ranges with LWW props
  (``bold``/``em``/``font``); removing formatting writes ``None``.
* Comments live in an interval collection: a comment anchors to a
  character range and follows it as concurrent inserts/removes shift,
  split, or slide the underlying segments.
* ``render()`` returns the structured document — paragraphs of styled
  runs with their comments — byte-identical across converged replicas.

Run:  python -m fluidframework_tpu_torch.examples.rich_text_editor
"""

from __future__ import annotations

import itertools

from ..dds.mergetree import Marker
from ..dds.sequence import SharedString
from ..framework.data_object import DataObject
from ..framework.data_object_factory import DataObjectFactory

TEXT_ID = "body"
COMMENTS_LABEL = "comments"
PARAGRAPH = "paragraph"

_ids = itertools.count()


class RichTextEditor(DataObject):
    """A collaborative rich-text document (paragraphs, styles, comments)."""

    def initializing_first_time(self, props=None) -> None:
        text = self.runtime.create_channel(
            TEXT_ID, SharedString.channel_type)
        self.root.set(TEXT_ID, text.handle)
        text.insert_marker(0, PARAGRAPH, self._new_paragraph_id())
        if props and props.get("initial_text"):
            text.insert_text(1, props["initial_text"])

    @property
    def text(self) -> SharedString:
        return self.root.get(TEXT_ID).get()

    def _new_paragraph_id(self) -> str:
        import uuid

        return f"p-{uuid.uuid4().hex[:8]}-{next(_ids)}"

    # -- structure -------------------------------------------------------------

    def split_paragraph(self, pos: int) -> str:
        """Press Enter at ``pos``: a new paragraph marker lands there."""
        pid = self._new_paragraph_id()
        self.text.insert_marker(pos, PARAGRAPH, pid)
        return pid

    def paragraphs(self) -> list[tuple[str, int]]:
        """(paragraph id, start position) in document order."""
        engine = self.text.engine
        out = []
        pos = 0
        for seg in engine.segments:
            vis = engine._vis_len(seg, engine.current_seq,
                                  engine.local_client)
            if vis and seg.is_marker and seg.content.ref_type == PARAGRAPH:
                out.append((seg.content.id, pos))
            pos += vis
        return out

    # -- editing ---------------------------------------------------------------

    def type_text(self, pos: int, text: str,
                  props: dict | None = None) -> None:
        self.text.insert_text(pos, text, props)

    def delete(self, start: int, end: int) -> None:
        self.text.remove_text(start, end)

    # -- formatting ------------------------------------------------------------

    def set_format(self, start: int, end: int, **styles) -> None:
        """Apply LWW formatting to [start, end): bold=True, em=True,
        font="mono", ...; a value of None removes the key."""
        self.text.annotate_range(start, end, dict(styles))

    def clear_format(self, start: int, end: int, *keys: str) -> None:
        self.text.annotate_range(start, end, {k: None for k in keys})

    # -- comments --------------------------------------------------------------

    def add_comment(self, start: int, end: int, note: str,
                    author: str | None = None) -> str:
        collection = self.text.get_interval_collection(COMMENTS_LABEL)
        interval = collection.add(start, end, props={
            "note": note,
            "author": author or self.text.engine.local_client})
        return interval.id

    def resolve_comment(self, comment_id: str) -> None:
        self.text.get_interval_collection(COMMENTS_LABEL).delete(
            comment_id)

    def comments_overlapping(self, start: int,
                             end: int) -> list[tuple[int, int, str]]:
        collection = self.text.get_interval_collection(COMMENTS_LABEL)
        out = []
        for interval in collection.find_overlapping_intervals(start, end):
            s, e, props = collection.resolved()[interval.id]
            out.append((s, e, (props or {}).get("note")))
        return sorted(out)

    # -- rendering -------------------------------------------------------------

    def render(self) -> list[dict]:
        """The structured document: one dict per paragraph with its
        styled runs and the comments anchored inside it. Converged
        replicas render identically (scenario tests assert equality)."""
        engine = self.text.engine
        collection = self.text.get_interval_collection(COMMENTS_LABEL)
        resolved = sorted(
            (s, e, (props or {}).get("note"))
            for s, e, props in collection.resolved().values())
        paragraphs: list[dict] = []
        current: dict | None = None
        pos = 0
        for seg in engine.segments:
            vis = engine._vis_len(seg, engine.current_seq,
                                  engine.local_client)
            if not vis:
                continue
            if seg.is_marker:
                if seg.content.ref_type == PARAGRAPH:
                    current = {"id": seg.content.id, "start": pos,
                               "runs": [], "comments": []}
                    paragraphs.append(current)
                pos += vis
                continue
            style = {k: v for k, v in (seg.props or {}).items()
                     if v is not None}
            if current is None:  # text before the first marker
                current = {"id": "p-implicit", "start": 0,
                           "runs": [], "comments": []}
                paragraphs.append(current)
            runs = current["runs"]
            key = tuple(sorted(style.items()))
            if runs and runs[-1][1] == key:
                runs[-1] = (runs[-1][0] + seg.content, key)
            else:
                runs.append((seg.content, key))
            pos += vis
        # Attach comments to the paragraph containing their start.
        for start, end, note in resolved:
            owner = None
            for para in paragraphs:
                if para["start"] <= start:
                    owner = para
                else:
                    break
            if owner is not None:
                owner["comments"].append((start, end, note))
        for para in paragraphs:
            para["runs"] = [(text, dict(style))
                            for text, style in para["runs"]]
        return paragraphs

    def read(self) -> str:
        return self.text.get_text()


rich_text_editor_factory = DataObjectFactory(
    "rich-text-editor", RichTextEditor)


def main(argv: list[str] | None = None) -> None:
    import argparse

    from .host import open_document, parse_endpoint_args

    parser = argparse.ArgumentParser(description=__doc__)
    parse_endpoint_args(parser)
    args = parser.parse_args(argv)

    with open_document("rich-text-editor", args,
                       props={"initial_text": "Rich text on TPU."}) \
            as session:
        creator, joiner = session.creator, session.joiner
        creator.set_format(1, 10, bold=True)
        joiner.split_paragraph(len(joiner.read()))
        joiner.type_text(len(joiner.read()), "Second paragraph.")
        session.settle()
        creator.add_comment(1, 10, "strong opener")
        joiner.set_format(1, 5, em=True, font="serif")
        session.settle()
        assert creator.render() == joiner.render()
        for para in creator.render():
            print(f"rich_text_editor: {para}")


if __name__ == "__main__":
    main()
