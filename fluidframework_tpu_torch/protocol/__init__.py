"""Layer 0/1: wire messages and the storm codec.

Reference parity: server/routerlicious/packages/protocol-definitions/src/
protocol.ts (wire messages).
"""

from .messages import (
    ClientDetail,
    DocumentMessage,
    MessageType,
    NackErrorType,
    NackMessage,
    ScopeType,
    SequencedDocumentMessage,
    SignalMessage,
    Trace,
)

__all__ = [
    "ClientDetail",
    "DocumentMessage",
    "MessageType",
    "NackErrorType",
    "NackMessage",
    "ScopeType",
    "SequencedDocumentMessage",
    "SignalMessage",
    "Trace",
]
