"""Protocol op handler — the per-document protocol state machine.

Reference parity: server/routerlicious/packages/protocol-base/src/protocol.ts:47
(``ProtocolOpHandler``): consumes the sequenced stream's *system* messages
(join/leave/propose/reject/noop MSN carriers) and drives the Quorum. Run by
every client's Container and by the scribe lambda, identically.
"""

from __future__ import annotations

from .messages import ClientDetail, MessageType, SequencedDocumentMessage
from .quorum import Quorum, QuorumClient


class ProtocolOpHandler:
    def __init__(
        self,
        minimum_sequence_number: int = 0,
        sequence_number: int = 0,
        quorum: Quorum | None = None,
    ) -> None:
        self.minimum_sequence_number = minimum_sequence_number
        self.sequence_number = sequence_number
        self.quorum = quorum if quorum is not None else Quorum()

    def process_message(self, message: SequencedDocumentMessage, local: bool) -> dict:
        """Apply one sequenced message. Returns {"immediate_noop": bool}."""
        assert message.sequence_number == self.sequence_number + 1, (
            f"protocol gap: got seq {message.sequence_number}, "
            f"expected {self.sequence_number + 1}"
        )
        self.sequence_number = message.sequence_number

        mtype = message.type
        if mtype == MessageType.CLIENT_JOIN:
            detail: ClientDetail = message.data
            self.quorum.add_member(
                detail.client_id,
                QuorumClient(detail=detail, sequence_number=message.sequence_number),
            )
        elif mtype == MessageType.CLIENT_LEAVE:
            self.quorum.remove_member(message.data)
        elif mtype == MessageType.PROPOSE:
            key, value = message.contents["key"], message.contents["value"]
            self.quorum.add_proposal(key, value, message.sequence_number, local)
        elif mtype == MessageType.REJECT:
            assert message.client_id is not None
            self.quorum.reject_proposal(message.client_id, message.contents)

        immediate_noop = self.quorum.update_minimum_sequence_number(message)
        self.minimum_sequence_number = message.minimum_sequence_number
        return {"immediate_noop": immediate_noop}

    # -- summary ------------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "sequence_number": self.sequence_number,
            "minimum_sequence_number": self.minimum_sequence_number,
            "quorum": self.quorum.snapshot(),
        }

    @classmethod
    def load(cls, snapshot: dict) -> "ProtocolOpHandler":
        return cls(
            minimum_sequence_number=snapshot["minimum_sequence_number"],
            sequence_number=snapshot["sequence_number"],
            quorum=Quorum.load(snapshot["quorum"]),
        )
