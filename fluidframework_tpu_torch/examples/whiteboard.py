"""Whiteboard — shared freehand drawing with sticky notes.

Reference parity: examples/data-objects/canvas (an Ink-backed drawing
surface) plus the sticky-note board shape of examples/data-objects/
board (SharedMap of positioned notes, LWW per note field). Strokes are
append-only Ink streams (ink/src/ink.ts:105 semantics: create-stroke +
append-point ops commute into the same picture on every replica); notes
are a SharedDirectory keyed by note id.

Run:  python -m fluidframework_tpu_torch.examples.whiteboard
"""

from __future__ import annotations

from ..dds.directory import SharedDirectory
from ..dds.ink import Ink
from ..framework.data_object import DataObject
from ..framework.data_object_factory import DataObjectFactory

CANVAS_ID = "canvas"
NOTES_ID = "notes"


class Whiteboard(DataObject):
    def initializing_first_time(self, props=None) -> None:
        canvas = self.runtime.create_channel(CANVAS_ID, Ink.channel_type)
        notes = self.runtime.create_channel(
            NOTES_ID, SharedDirectory.channel_type)
        self.root.set(CANVAS_ID, canvas.handle)
        self.root.set(NOTES_ID, notes.handle)

    @property
    def canvas(self) -> Ink:
        return self.root.get(CANVAS_ID).get()

    @property
    def notes(self) -> SharedDirectory:
        return self.root.get(NOTES_ID).get()

    # -- drawing ---------------------------------------------------------------

    def draw(self, points: list[tuple[float, float]],
             color: str = "black", width: int = 2) -> str:
        """One pen stroke through the given points."""
        stroke_id = self.canvas.create_stroke(
            {"color": color, "thickness": width})
        for t, (x, y) in enumerate(points):
            self.canvas.append_point(stroke_id, x, y, time_ms=t)
        return stroke_id

    def picture(self) -> dict[str, dict]:
        """Every stroke with its pen and point list (converged view)."""
        return {sid: self.canvas.get_stroke(sid)
                for sid in sorted(self.canvas.strokes)}

    # -- sticky notes ----------------------------------------------------------

    def add_note(self, note_id: str, text: str, x: int, y: int) -> None:
        sub = self.notes.create_sub_directory(note_id)
        sub.set("text", text)
        sub.set("x", x)
        sub.set("y", y)

    def move_note(self, note_id: str, x: int, y: int) -> None:
        sub = self.notes.get_sub_directory(note_id)
        sub.set("x", x)
        sub.set("y", y)

    def board(self) -> dict[str, dict]:
        out = {}
        for note_id in sorted(self.notes.root.subdirectories()):
            sub = self.notes.get_sub_directory(note_id)
            out[note_id] = {"text": sub.get("text"),
                            "x": sub.get("x"), "y": sub.get("y")}
        return out


whiteboard_factory = DataObjectFactory("whiteboard", Whiteboard)


def main(argv=None) -> None:
    import argparse

    from .host import open_document, parse_endpoint_args

    parser = argparse.ArgumentParser(description=__doc__)
    parse_endpoint_args(parser)
    args = parser.parse_args(argv)

    with open_document("whiteboard", args) as session:
        creator, joiner, settle = session
        creator.draw([(0, 0), (5, 5), (10, 0)], color="red")
        joiner.draw([(2, 2), (2, 8)], color="blue", width=4)
        creator.add_note("n1", "ship it", 10, 20)
        settle()  # the joiner must see the note before moving it
        joiner.move_note("n1", 30, 40)
        settle()
        assert creator.picture() == joiner.picture()
        assert len(creator.picture()) == 2
        assert creator.board() == joiner.board()
        assert creator.board()["n1"]["x"] == 30
        print(f"whiteboard: {len(creator.picture())} strokes, "
              f"notes={creator.board()}")


if __name__ == "__main__":
    main()
