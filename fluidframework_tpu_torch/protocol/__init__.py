"""Layer 0/1: protocol definitions, the storm codec and the deterministic
quorum state machine.

Reference parity: server/routerlicious/packages/protocol-definitions/src/
protocol.ts (wire messages) and protocol-base/src/{quorum.ts,protocol.ts}
(quorum + protocol op handler).
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
from .quorum import CommittedProposal, PendingProposal, Quorum, QuorumClient
from .handler import ProtocolOpHandler

__all__ = [
    "ClientDetail",
    "CommittedProposal",
    "DocumentMessage",
    "MessageType",
    "NackErrorType",
    "NackMessage",
    "PendingProposal",
    "ProtocolOpHandler",
    "Quorum",
    "QuorumClient",
    "ScopeType",
    "SequencedDocumentMessage",
    "SignalMessage",
    "Trace",
]
