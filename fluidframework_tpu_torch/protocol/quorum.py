"""Deterministic quorum state machine (layer 1).

Reference parity: server/routerlicious/packages/protocol-base/src/quorum.ts
(``Quorum``: members, proposals, values; accept at MSN, quorum.ts:262-333) —
run *identically* by every client and by the scribe lambda, so replicas agree
on membership and consensus values by construction.

Lifecycle of a proposal (quorum.ts:266 ``updateMinimumSequenceNumber``):

  propose(key, value)  -> sequenced PROPOSE op at seq P
  any client may send REJECT referencing P while P > MSN
  MSN advances past P   -> if no rejections: *accepted*  (value visible)
                           else:            *rejected*
  MSN advances past the approval seq -> *committed*

Determinism requirement: all hooks fire in sequence-number order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from .messages import ClientDetail, SequencedDocumentMessage


@dataclass(frozen=True, slots=True)
class QuorumClient:
    """A member of the collaboration (reference ``ISequencedClient``)."""

    detail: ClientDetail
    sequence_number: int  # seq of the join message


@dataclass(slots=True)
class PendingProposal:
    key: str
    value: Any
    sequence_number: int
    local: bool = False
    rejections: set[str] = field(default_factory=set)


@dataclass(frozen=True, slots=True)
class CommittedProposal:
    key: str
    value: Any
    sequence_number: int
    approval_sequence_number: int
    commit_sequence_number: int = -1


class Quorum:
    """Members + proposals + committed values, driven by sequenced messages."""

    def __init__(self) -> None:
        self._members: dict[str, QuorumClient] = {}
        self._proposals: dict[int, PendingProposal] = {}
        self._values: dict[str, CommittedProposal] = {}
        self._pending_commit: dict[str, CommittedProposal] = {}
        self._msn: int | None = None
        # Event hooks: (name, *args). Deterministic order.
        self.on_add_member: list[Callable[[str, QuorumClient], None]] = []
        self.on_remove_member: list[Callable[[str], None]] = []
        self.on_approve_proposal: list[Callable[[int, str, Any, int], None]] = []
        self.on_reject_proposal: list[Callable[[int, str, Any, list[str]], None]] = []

    # -- membership ---------------------------------------------------------

    def add_member(self, client_id: str, client: QuorumClient) -> None:
        self._members[client_id] = client
        for cb in self.on_add_member:
            cb(client_id, client)

    def remove_member(self, client_id: str) -> None:
        if client_id in self._members:
            del self._members[client_id]
            for cb in self.on_remove_member:
                cb(client_id)

    def get_members(self) -> dict[str, QuorumClient]:
        return dict(self._members)

    def get_member(self, client_id: str) -> QuorumClient | None:
        return self._members.get(client_id)

    # -- proposals ----------------------------------------------------------

    def add_proposal(
        self, key: str, value: Any, sequence_number: int, local: bool
    ) -> None:
        assert sequence_number not in self._proposals, "duplicate proposal seq"
        self._proposals[sequence_number] = PendingProposal(
            key=key, value=value, sequence_number=sequence_number, local=local
        )

    def reject_proposal(self, client_id: str, proposal_seq: int) -> bool:
        """Record a rejection. True iff the proposal is still pending."""
        proposal = self._proposals.get(proposal_seq)
        if proposal is None:
            return False
        proposal.rejections.add(client_id)
        return True

    def update_minimum_sequence_number(
        self, message: SequencedDocumentMessage
    ) -> bool:
        """Advance the MSN; settle proposals. Returns True if an immediate
        no-op should be sent (to expedite commit — quorum.ts:326)."""
        value = message.minimum_sequence_number
        if self._msn is not None and value <= self._msn:
            return False
        self._msn = value

        immediate_noop = False
        completed = sorted(
            (p for s, p in self._proposals.items() if s <= value),
            key=lambda p: p.sequence_number,
        )
        for proposal in completed:
            del self._proposals[proposal.sequence_number]
            if not proposal.rejections:
                committed = CommittedProposal(
                    key=proposal.key,
                    value=proposal.value,
                    sequence_number=proposal.sequence_number,
                    approval_sequence_number=message.sequence_number,
                )
                self._values[committed.key] = committed
                self._pending_commit[committed.key] = committed
                immediate_noop = True
                for cb in self.on_approve_proposal:
                    cb(
                        committed.sequence_number,
                        committed.key,
                        committed.value,
                        committed.approval_sequence_number,
                    )
            else:
                for cb in self.on_reject_proposal:
                    cb(
                        proposal.sequence_number,
                        proposal.key,
                        proposal.value,
                        sorted(proposal.rejections),
                    )

        # Commit phase: everyone has seen the approval.
        for key in [
            k
            for k, c in self._pending_commit.items()
            if c.approval_sequence_number <= value
        ]:
            committed = self._pending_commit.pop(key)
            self._values[key] = CommittedProposal(
                key=committed.key,
                value=committed.value,
                sequence_number=committed.sequence_number,
                approval_sequence_number=committed.approval_sequence_number,
                commit_sequence_number=message.sequence_number,
            )
        return immediate_noop

    # -- values -------------------------------------------------------------

    def set_local_value(self, key: str, value: Any) -> None:
        """Seed a committed value on a DETACHED document (the reference
        commits the initial \"code\" proposal into the attach-time quorum
        snapshot, container.ts detached create). Never valid once live —
        live changes go through propose→approve→commit."""
        self._values[key] = CommittedProposal(
            key=key, value=value, sequence_number=0,
            approval_sequence_number=0, commit_sequence_number=0)

    def get(self, key: str) -> Any:
        committed = self._values.get(key)
        return None if committed is None else committed.value

    def has(self, key: str) -> bool:
        return key in self._values

    def get_committed(self, key: str) -> CommittedProposal | None:
        return self._values.get(key)

    # -- snapshot for summaries --------------------------------------------

    def snapshot(self) -> dict:
        """JSON-serializable state (summary parity: protocol-base snapshot)."""
        return {
            "msn": self._msn,
            "members": [
                [cid, {"seq": m.sequence_number, "detail": {
                    "client_id": m.detail.client_id,
                    "mode": m.detail.mode,
                    "scopes": list(m.detail.scopes),
                    "user": m.detail.user,
                }}]
                for cid, m in sorted(self._members.items())
            ],
            "proposals": [
                [s, {"key": p.key, "value": p.value,
                     "rejections": sorted(p.rejections)}]
                for s, p in sorted(self._proposals.items())
            ],
            "values": [
                [k, {"key": c.key, "value": c.value,
                     "seq": c.sequence_number,
                     "approval_seq": c.approval_sequence_number,
                     "commit_seq": c.commit_sequence_number}]
                for k, c in sorted(self._values.items())
            ],
        }

    @classmethod
    def load(cls, snapshot: dict) -> "Quorum":
        quorum = cls()
        for cid, m in snapshot.get("members", []):
            detail = ClientDetail(
                client_id=m["detail"]["client_id"],
                mode=m["detail"]["mode"],
                scopes=tuple(m["detail"]["scopes"]),
                user=m["detail"]["user"],
            )
            quorum._members[cid] = QuorumClient(detail=detail, sequence_number=m["seq"])
        for s, p in snapshot.get("proposals", []):
            quorum._proposals[s] = PendingProposal(
                key=p["key"], value=p["value"], sequence_number=s,
                rejections=set(p["rejections"]),
            )
        for k, c in snapshot.get("values", []):
            committed = CommittedProposal(
                key=c["key"], value=c["value"], sequence_number=c["seq"],
                approval_sequence_number=c["approval_seq"],
                commit_sequence_number=c["commit_seq"],
            )
            quorum._values[k] = committed
            # Approved-but-not-committed values still await their commit seq;
            # without this a restored replica diverges from a live one.
            if committed.commit_sequence_number == -1:
                quorum._pending_commit[k] = committed
        quorum._msn = snapshot.get("msn")
        return quorum
