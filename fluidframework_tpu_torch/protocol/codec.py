"""Wire codec for protocol messages — JSON-framed, type-tagged.

Reference parity: the socket.io JSON payloads of the reference's delta
connection (driver-base/documentDeltaConnection.ts:35, alfred
index.ts:343-427). Dataclasses are tagged with ``_t`` so both ends of the
DCN hop rebuild the exact protocol types; op ``contents`` pass through as
plain JSON (tuples canonicalize to lists on the wire — DDS load paths
accept either).

Frames on the socket are ``4-byte big-endian length + utf-8 JSON``
(see server.alfred / drivers.network_driver).
"""

from __future__ import annotations

import json
import struct
from typing import Any

from .messages import (
    ClientDetail,
    DocumentMessage,
    MessageType,
    NackMessage,
    NackErrorType,
    SequencedDocumentMessage,
    Trace,
)

_LEN = struct.Struct(">I")
MAX_FRAME = 64 * 1024 * 1024

# Extension registry: layers above the protocol (e.g. the server's
# RawOperation) register their own tagged types without the protocol layer
# importing them. to_fn(obj) -> JSON-able dict body; from_fn(body) -> obj.
_EXT_BY_TYPE: dict[type, tuple[str, Any]] = {}
_EXT_BY_TAG: dict[str, Any] = {}


def register_codec(tag: str, cls: type, to_fn, from_fn) -> None:
    assert tag not in _EXT_BY_TAG or _EXT_BY_TAG[tag] is from_fn
    _EXT_BY_TYPE[cls] = (tag, to_fn)
    _EXT_BY_TAG[tag] = from_fn


def to_wire(obj: Any) -> Any:
    """Recursively convert protocol objects into JSON-able structures."""
    if isinstance(obj, SequencedDocumentMessage):
        return {"_t": "seq", "client_id": obj.client_id,
                "sequence_number": obj.sequence_number,
                "minimum_sequence_number": obj.minimum_sequence_number,
                "client_sequence_number": obj.client_sequence_number,
                "reference_sequence_number": obj.reference_sequence_number,
                "type": int(obj.type), "contents": to_wire(obj.contents),
                "metadata": to_wire(obj.metadata),
                "server_metadata": to_wire(obj.server_metadata),
                "traces": [to_wire(t) for t in obj.traces],
                "timestamp": obj.timestamp, "data": to_wire(obj.data)}
    if isinstance(obj, DocumentMessage):
        return {"_t": "doc",
                "client_sequence_number": obj.client_sequence_number,
                "reference_sequence_number": obj.reference_sequence_number,
                "type": int(obj.type), "contents": to_wire(obj.contents),
                "metadata": to_wire(obj.metadata),
                "server_metadata": to_wire(obj.server_metadata),
                "traces": [to_wire(t) for t in obj.traces]}
    if isinstance(obj, NackMessage):
        return {"_t": "nack", "operation": to_wire(obj.operation),
                "sequence_number": obj.sequence_number, "code": obj.code,
                "error_type": int(obj.error_type), "message": obj.message,
                "retry_after_s": obj.retry_after_s}
    if isinstance(obj, Trace):
        return {"_t": "trace", "service": obj.service, "action": obj.action,
                "timestamp": obj.timestamp}
    if isinstance(obj, ClientDetail):
        return {"_t": "cd", "client_id": obj.client_id, "mode": obj.mode,
                "scopes": list(obj.scopes), "user": obj.user}
    ext = _EXT_BY_TYPE.get(type(obj))
    if ext is not None:
        tag, to_fn = ext
        return {"_t": tag, **to_wire(to_fn(obj))}
    if isinstance(obj, dict):
        return {k: to_wire(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_wire(v) for v in obj]
    return obj


def from_wire(obj: Any) -> Any:
    if isinstance(obj, dict):
        tag = obj.get("_t")
        if tag == "seq":
            return SequencedDocumentMessage(
                client_id=obj["client_id"],
                sequence_number=obj["sequence_number"],
                minimum_sequence_number=obj["minimum_sequence_number"],
                client_sequence_number=obj["client_sequence_number"],
                reference_sequence_number=obj["reference_sequence_number"],
                type=MessageType(obj["type"]),
                contents=from_wire(obj["contents"]),
                metadata=from_wire(obj["metadata"]),
                server_metadata=from_wire(obj["server_metadata"]),
                traces=tuple(from_wire(t) for t in obj["traces"]),
                timestamp=obj["timestamp"], data=from_wire(obj["data"]))
        if tag == "doc":
            return DocumentMessage(
                client_sequence_number=obj["client_sequence_number"],
                reference_sequence_number=obj["reference_sequence_number"],
                type=MessageType(obj["type"]),
                contents=from_wire(obj["contents"]),
                metadata=from_wire(obj["metadata"]),
                server_metadata=from_wire(obj["server_metadata"]),
                traces=tuple(from_wire(t) for t in obj["traces"]))
        if tag == "nack":
            return NackMessage(
                operation=from_wire(obj["operation"]),
                sequence_number=obj["sequence_number"], code=obj["code"],
                error_type=NackErrorType(obj["error_type"]),
                message=obj["message"],
                retry_after_s=obj["retry_after_s"])
        if tag == "trace":
            return Trace(service=obj["service"], action=obj["action"],
                         timestamp=obj["timestamp"])
        if tag == "cd":
            return ClientDetail(client_id=obj["client_id"], mode=obj["mode"],
                                scopes=tuple(obj["scopes"]), user=obj["user"])
        if tag in _EXT_BY_TAG:
            body = {k: from_wire(v) for k, v in obj.items() if k != "_t"}
            return _EXT_BY_TAG[tag](body)
        return {k: from_wire(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [from_wire(v) for v in obj]
    return obj


# -- binary op-storm frames ---------------------------------------------------
#
# The columnar fast path (server/storm.py) ships op BATCHES as packed
# arrays instead of per-op JSON: a frame body starting with NUL (JSON can
# never start with one) is a storm frame:
#
#   [0]   magic 0x00
#   [1]   version 0x01
#   [2:6] u32 LE header length H
#   [6:6+H]  JSON header {"op": "storm", "rid", "docs": [[doc_id,
#            client_id, first_client_seq, ref_seq, count], ...]}
#   [6+H:]   concatenated per-doc op words, u32 LE (4 bytes/op — the
#            map kernel's kind|slot<<2|value<<12 wire format)
#
# The same framing carries server→client pushes: a header with
# ``op: "storm_ack"`` and an i32[n, 4] payload of per-doc
# (n_seq, first_seq, last_seq, msn) rows is the columnar ack
# (see :class:`StormAck` / :func:`decode_storm_push`).
#
# This is the rdkafka-batching analog of SURVEY §2.9: the hot path never
# touches per-op Python objects between the socket and the device.

STORM_MAGIC = 0x00
_STORM_HDR = struct.Struct("<I")
STORM_ACK_OP = "storm_ack"
#: Viewer-plane broadcast frame: one binary body per (doc, tick) carrying
#: the tick's sequenced window (first/last/msn/n) plus the raw op words —
#: serialized ONCE per doc per tick by server/broadcaster.py and fanned
#: out to every viewer of the doc's room as the same bytes.
VIEWER_TICK_OP = "storm_tick"

#: Trace-context header field: 1-in-N sampled storm frames carry an
#: opaque trace id under this key; the serving stack timestamps the
#: frame at every hop and the traced ack carries the joined marks back
#: ("tc" + "hops" in the ack header). Version tolerance is BY
#: CONSTRUCTION: the storm header is JSON, so a decoder that predates
#: the field carries it through untouched and a consumer that predates
#: it ignores it — no frame-format version bump (the binary layout is
#: unchanged; see tests/test_storm_codec.py trace-context suite).
TRACE_KEY = "tc"


def stamp_trace(header: dict, trace_id) -> dict:
    """Stamp a trace context onto a storm frame header (client side of
    the sampled per-op tracing plane); returns the header for chaining."""
    header[TRACE_KEY] = trace_id
    return header


def trace_context(header: dict):
    """The frame's sampled trace id, or None when untraced."""
    return header.get(TRACE_KEY)


def is_storm_body(body) -> bool:
    return len(body) > 6 and body[0] == STORM_MAGIC


def _storm_parts(header: dict, payload) -> tuple[bytes, bytes, int]:
    head = json.dumps(header, separators=(",", ":")).encode()
    size = 6 + len(head) + len(payload)
    assert size <= MAX_FRAME, f"storm frame too large: {size}"
    return head, bytes((STORM_MAGIC, 1)) + _STORM_HDR.pack(len(head)), size


def encode_storm_body(header: dict, payload) -> bytes:
    head, prefix, _size = _storm_parts(header, payload)
    return b"".join((prefix, head, payload))


def encode_storm_frame(header: dict, payload) -> bytes:
    # One join builds the whole frame: no intermediate body copy.
    head, prefix, size = _storm_parts(header, payload)
    return b"".join((_LEN.pack(size), prefix, head, payload))


def pack_map_words(kinds, slots, values):
    """Pack parallel arrays into the storm op-word layout
    (kind(2) | slot(10) | value(20)) — THE one definition of the wire
    bit layout; decoders in map_kernel/storm materialization mirror it."""
    import numpy as np

    return (np.asarray(kinds, np.uint32)
            | (np.asarray(slots, np.uint32) << 2)
            | (np.asarray(values, np.uint32) << 12))


def decode_storm_body(body) -> tuple[dict, memoryview]:
    """(header decoded once, payload view) — the payload memoryview
    ALIASES ``body`` (zero-copy through to ``np.frombuffer`` on the
    ingress path); only the small JSON header is materialized."""
    view = body if isinstance(body, memoryview) else memoryview(body)
    if len(view) > MAX_FRAME:
        raise ValueError(f"oversized storm frame: {len(view)}")
    if len(view) < 6 or view[0] != STORM_MAGIC or view[1] != 1:
        raise ValueError("not a v1 storm frame")
    hlen = _STORM_HDR.unpack_from(view, 2)[0]
    if 6 + hlen > len(view):
        raise ValueError(
            f"truncated storm frame: header claims {hlen} bytes, "
            f"{len(view) - 6} available")
    header = json.loads(bytes(view[6:6 + hlen]).decode())
    return header, view[6 + hlen:]


# -- server→client push payloads ----------------------------------------------


class RawBody(bytes):
    """A pre-encoded frame body: session push paths write it verbatim
    (length-prefixed by the transport) instead of JSON-encoding a dict."""

    __slots__ = ()


class StormAck(dict):
    """One tick's ack for one storm frame, held COLUMNAR: ``rows`` is an
    i32[n, 4] array of per-doc (n_seq, first_seq, last_seq, msn). Session
    push paths encode it as ONE binary storm_ack frame without ever
    materializing per-doc Python lists; in-process consumers index it
    like the legacy dict payload — the ``"acks"`` lists materialize
    lazily on first access."""

    __slots__ = ("rows",)

    def __init__(self, rid: Any, rows) -> None:
        super().__init__(rid=rid, storm=True)
        self.rows = rows

    def _materialize(self):
        if not dict.__contains__(self, "acks"):
            dict.__setitem__(self, "acks", self.rows.tolist())

    def __missing__(self, key):
        if key == "acks":
            self._materialize()
            return dict.__getitem__(self, "acks")
        raise KeyError(key)

    # The lazy key must be invisible ONLY to the wire fast path
    # (encode_push reads .rows directly); every dict-protocol read an
    # in-process consumer might use materializes it first. NOTE
    # json.dumps on a dict subclass bypasses these overrides — push
    # payloads go to the wire via encode_push, never raw json.dumps.
    def get(self, key, default=None):
        if key == "acks":
            self._materialize()
        return dict.get(self, key, default)

    def __contains__(self, key):
        if key == "acks":
            return True
        return dict.__contains__(self, key)

    def keys(self):
        self._materialize()
        return dict.keys(self)

    def values(self):
        self._materialize()
        return dict.values(self)

    def items(self):
        self._materialize()
        return dict.items(self)

    def __iter__(self):
        self._materialize()
        return dict.__iter__(self)

    def __len__(self):
        self._materialize()
        return dict.__len__(self)

    def copy(self):
        self._materialize()
        return dict(dict.items(self))


def encode_storm_ack_body(ack: StormAck) -> bytes:
    header = {"op": STORM_ACK_OP}
    # dict.items bypasses StormAck's materializing override — the wire
    # path must never build the per-doc lists.
    header.update((k, v) for k, v in dict.items(ack) if k != "acks")
    import numpy as np

    rows = np.ascontiguousarray(ack.rows, np.dtype("<i4"))
    return encode_storm_body(header, rows.tobytes())


def encode_viewer_tick_body(doc_id: str, n_seq: int, first: int,
                            last: int, msn: int, count: int,
                            words) -> "RawBody":
    """One viewer broadcast frame for one (doc, tick): the sequenced
    window plus the tick's raw op words (``count`` u32 LE — the same
    wire layout storm frames carry in). Encoded ONCE per doc per tick;
    the returned :class:`RawBody` goes down every viewer transport
    verbatim (the serialize-once invariant)."""
    header = {"op": VIEWER_TICK_OP, "doc": doc_id, "n": n_seq,
              "first": first, "last": last, "msn": msn, "count": count}
    return RawBody(encode_storm_body(header, words))


def decode_storm_push(body) -> dict:
    """Decode a server→client binary storm push into the legacy dict
    shape ({"rid", "storm", "acks", "dw", ...}); viewer tick frames
    decode to {"event": "storm_tick", "doc", "n", ..., "words"}; other
    storm headers pass through as-is."""
    header, payload = decode_storm_body(body)
    import numpy as np

    if header.get("op") == VIEWER_TICK_OP:
        out = {k: v for k, v in header.items() if k != "op"}
        out["event"] = VIEWER_TICK_OP
        out["words"] = np.frombuffer(payload, "<u4", out.get("count", 0))
        return out
    if header.get("op") != STORM_ACK_OP:
        return header
    if len(payload) % 16:
        raise ValueError(f"storm ack payload not i32[n, 4]: "
                         f"{len(payload)} bytes")
    out = {k: v for k, v in header.items() if k != "op"}
    out["event"] = STORM_ACK_OP
    out["storm"] = True
    out["acks"] = np.frombuffer(payload, "<i4").reshape(-1, 4).tolist()
    return out


class BroadcastBatch(list):
    """A sequenced-op batch shared by EVERY subscriber of a document:
    the first session push encodes the ops event once and caches the
    bytes here, so fanning one tick out to N connections costs one
    encode + N writes instead of N encode+writes."""

    __slots__ = ("_ops_body",)


#: Encodes actually performed by encode_ops_event (the delivered-bytes /
#: encode-count invariant pins on the delta of this counter).
_ops_event_encodes = 0


def ops_event_encode_count() -> int:
    return _ops_event_encodes


def encode_ops_event(messages) -> RawBody:
    """Wire body of one {"event": "ops"} push — encoded at most once per
    :class:`BroadcastBatch` however many subscribers it fans out to."""
    global _ops_event_encodes
    if isinstance(messages, BroadcastBatch):
        body = getattr(messages, "_ops_body", None)
        if body is None:
            _ops_event_encodes += 1
            body = RawBody(encode_body({"event": "ops",
                                        "messages": messages}))
            messages._ops_body = body
        return body
    _ops_event_encodes += 1
    return RawBody(encode_body({"event": "ops", "messages": messages}))


def encode_push(payload) -> bytes:
    """Body bytes for one server→client push of any payload kind."""
    if isinstance(payload, RawBody):
        return payload
    if isinstance(payload, StormAck):
        return encode_storm_ack_body(payload)
    return encode_body(payload)


def encode_body(payload: Any) -> bytes:
    """Frame body alone — transports that own framing (the native bridge)
    prepend their own length word."""
    body = json.dumps(to_wire(payload), separators=(",", ":")).encode()
    assert len(body) <= MAX_FRAME, f"frame too large: {len(body)}"
    return body


def encode_frame(payload: Any) -> bytes:
    body = encode_body(payload)
    return _LEN.pack(len(body)) + body


def frame_body(body: bytes) -> bytes:
    """Length-prefix an already-encoded body (the push fast paths)."""
    return _LEN.pack(len(body)) + body


def decode_body(body) -> Any:
    if isinstance(body, memoryview):
        body = bytes(body)  # JSON control frames are small; copying is fine
    return from_wire(json.loads(body.decode()))
