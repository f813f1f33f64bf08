"""Ink DDS — append-only stroke/point stream for drawing.

Reference parity: packages/dds/ink/src/ink.ts:105: createStroke + append
points; appends to distinct strokes commute, appends within a stroke are
ordered by the total order.
"""

from __future__ import annotations

from typing import Any

from ..protocol.messages import SequencedDocumentMessage
from .shared_object import ChannelFactory, SharedObject


class Ink(SharedObject):
    channel_type = "https://graph.microsoft.com/types/ink"

    def __init__(self, channel_id: str, runtime=None, attributes=None) -> None:
        super().__init__(channel_id, runtime, attributes)
        # stroke_id -> {"pen": {...}, "points": [...]}  (insertion-ordered)
        self.strokes: dict[str, dict] = {}
        self._next_local = 0

    def create_stroke(self, pen: dict | None = None) -> str:
        self._next_local += 1
        container = (self.runtime.parent.container
                     if self.runtime is not None else None)
        owner = (container.client_id or "detached") if container else "detached"
        stroke_id = f"{owner}-{self._next_local}"
        self._create(stroke_id, pen or {})
        self.submit_local_message(
            {"type": "createStroke", "id": stroke_id, "pen": pen or {}})
        return stroke_id

    def append_point(self, stroke_id: str, x: float, y: float,
                     time_ms: int = 0, pressure: float = 0.5) -> None:
        """Points are applied at SEQUENCING (not eagerly): concurrent appends
        to one stroke must interleave identically on every replica."""
        point = {"x": x, "y": y, "time": time_ms, "pressure": pressure}
        assert stroke_id in self.strokes, f"unknown stroke {stroke_id!r}"
        attached = (self.runtime is not None
                    and self.runtime.parent.container.attached)
        if attached:
            self.submit_local_message(
                {"type": "stylus", "id": stroke_id, "point": point})
        else:
            # Detached: apply directly; it ships via the attach snapshot.
            self.strokes[stroke_id]["points"].append(point)

    def get_stroke(self, stroke_id: str) -> dict | None:
        return self.strokes.get(stroke_id)

    def _create(self, stroke_id: str, pen: dict) -> None:
        if stroke_id not in self.strokes:
            self.strokes[stroke_id] = {"pen": dict(pen), "points": []}

    def process_core(self, message: SequencedDocumentMessage, local: bool,
                     local_op_metadata: Any) -> None:
        op = message.contents
        if op["type"] == "createStroke":
            self._create(op["id"], op["pen"])  # idempotent for local acks
        else:
            self._create(op["id"], {})
            self.strokes[op["id"]]["points"].append(dict(op["point"]))

    def summarize_core(self) -> dict:
        return {"strokes": {sid: {"pen": dict(s["pen"]),
                                  "points": [dict(p) for p in s["points"]]}
                            for sid, s in sorted(self.strokes.items())}}

    def load_core(self, content: dict) -> None:
        self.strokes = {sid: {"pen": dict(s["pen"]),
                              "points": [dict(p) for p in s["points"]]}
                        for sid, s in content["strokes"].items()}

    def apply_stashed_op(self, contents: Any) -> Any:
        op = contents
        if op["type"] == "createStroke":
            self._create(op["id"], op["pen"])
        else:
            self._create(op["id"], {})
            self.strokes[op["id"]]["points"].append(dict(op["point"]))
        return None


class InkFactory(ChannelFactory):
    channel_type = Ink.channel_type
    shared_object_cls = Ink
