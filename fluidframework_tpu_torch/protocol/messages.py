"""Wire-protocol message types (layer 0).

Reference parity: server/routerlicious/packages/protocol-definitions/src/
protocol.ts:6-180 (``MessageType``, ``IDocumentMessage``,
``ISequencedDocumentMessage``, ``INack``, ``ITrace``) and clients.ts
(client details/scopes).

These are plain frozen dataclasses — the *scalar* protocol surface used by the
client runtime and the CPU front-door. The batched device-side encoding of the
same messages lives in :mod:`fluidframework_tpu.ops.opcodes` (fixed-width int
arrays), with converters in :mod:`fluidframework_tpu.ops.encode`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from enum import IntEnum
from typing import Any


class MessageType(IntEnum):
    """Operation types carried by document messages.

    Integer-valued (not strings as in the reference) so the same enum is the
    device-side opcode. Values are stable wire constants — never reorder.
    """

    NOOP = 0          # empty op; carries an updated reference sequence number
    CLIENT_JOIN = 1   # system: a client joined collaboration
    CLIENT_LEAVE = 2  # system: a client left
    PROPOSE = 3       # propose a consensus (quorum) value
    REJECT = 4        # reject a pending proposal
    SUMMARIZE = 5     # client-generated summary offer
    SUMMARY_ACK = 6   # service accepted + durably wrote a summary
    SUMMARY_NACK = 7  # service rejected a summary
    OPERATION = 8     # channel (DDS) operation — the hot path
    SAVE = 9          # forced snapshot request
    REMOTE_HELP = 10  # request a remote agent
    NO_CLIENT = 11    # service: no active clients remain
    ROUND_TRIP = 12   # latency probe
    CONTROL = 13      # service-internal control; never sequenced
    ATTACH = 14       # a data store created post-attach (carries snapshot)
    CHUNKED_OP = 15   # one piece of an oversized op (containerRuntime.ts:1652)


class ScopeType:
    """JWT-style connection scopes (reference: protocol-definitions clients)."""

    READ = "doc:read"
    WRITE = "doc:write"
    SUMMARY_WRITE = "summary:write"
    AGENT = "agent:run"  # claim/complete foreman help assignments

    ALL = (READ, WRITE, SUMMARY_WRITE)


class NackErrorType(IntEnum):
    THROTTLING = 0
    INVALID_SCOPE = 1
    BAD_REQUEST = 2
    LIMIT_EXCEEDED = 3


@dataclass(frozen=True, slots=True)
class Trace:
    """Latency trace breadcrumb attached to ops (protocol.ts:53)."""

    service: str
    action: str
    timestamp: float = field(default_factory=lambda: time.monotonic() * 1000.0)


@dataclass(frozen=True, slots=True)
class ClientDetail:
    """Join-time client description."""

    client_id: str
    mode: str = "write"  # "write" | "read"
    scopes: tuple[str, ...] = ScopeType.ALL
    user: str = ""


@dataclass(frozen=True, slots=True)
class DocumentMessage:
    """Client → service message (protocol.ts:78 ``IDocumentMessage``)."""

    client_sequence_number: int
    reference_sequence_number: int
    type: MessageType
    contents: Any = None
    metadata: Any = None
    server_metadata: Any = None
    traces: tuple[Trace, ...] = ()

    def with_traces(self, *traces: Trace) -> "DocumentMessage":
        return replace(self, traces=self.traces + traces)


@dataclass(frozen=True, slots=True)
class SequencedDocumentMessage:
    """Service → client totally-ordered message
    (protocol.ts:126 ``ISequencedDocumentMessage``).

    ``sequence_number`` is the document-wide total order;
    ``minimum_sequence_number`` (MSN) is the floor of every connected client's
    reference sequence number — state below the MSN is safe to compact.
    """

    client_id: str | None
    sequence_number: int
    minimum_sequence_number: int
    client_sequence_number: int
    reference_sequence_number: int
    type: MessageType
    contents: Any = None
    metadata: Any = None
    server_metadata: Any = None
    traces: tuple[Trace, ...] = ()
    timestamp: float = 0.0
    # System-message payload (join/leave details), reference's
    # ISequencedDocumentSystemMessage.data.
    data: Any = None


@dataclass(frozen=True, slots=True)
class NackMessage:
    """Service rejection of a client op (protocol.ts ``INack``)."""

    operation: DocumentMessage | None
    sequence_number: int  # catch up to this seq before retrying
    code: int
    error_type: NackErrorType
    message: str
    retry_after_s: float | None = None


@dataclass(frozen=True, slots=True)
class SignalMessage:
    """Transient, unsequenced client-to-clients message (protocol.ts:177)."""

    client_id: str | None
    content: Any
