"""Scalar per-document sequencer — the host-side oracle and control path.

Reference parity: the deli lambda's ticket state machine
(server/routerlicious/packages/lambdas/src/deli/lambda.ts:236-470) and
``ClientSequenceNumberManager`` (deli/clientSeqManager.ts). This is the exact
sequential semantics the batched kernel in
:mod:`fluidframework_tpu.ops.sequencer` must reproduce; differential tests
drive both with identical op streams.

Rules, in check order (mirroring ticket()):
  1. nack-future control state → NACK everything.
  2. clientSeqNum dup/gap per client: == expected → ok, > → NACK gap,
     < → silent drop.
  3. system join/leave: membership upsert/remove; duplicate → silent drop.
  4. client checks: unknown/nacked client → NACK; refSeq below MSN → NACK
     (and mark the client nacked at refSeq=MSN); summarize without scope
     → NACK.
  5. sequence-number rev: client ops rev unless NOOP; system ops rev unless
     NOOP/NO_CLIENT/CONTROL. refSeq==-1 (direct REST op) is revved to the
     assigned seq.
  6. MSN = min over active clients' refSeq; if no clients, MSN jumps to seq.
  7. no-op consolidation heuristics decide SEND_IMMEDIATE/LATER/NEVER and may
     rev a no-op after all to carry a fresh MSN.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ..ops import opcodes as oc
from ..protocol.messages import MessageType

# Types only the service itself may inject into a document's stream.
_SERVICE_ONLY_TYPES = frozenset({
    MessageType.CLIENT_JOIN,
    MessageType.CLIENT_LEAVE,
    MessageType.NO_CLIENT,
    MessageType.CONTROL,
    MessageType.SUMMARY_ACK,
    MessageType.SUMMARY_NACK,
})


@dataclass(slots=True)
class ClientEntry:
    """Per-client sequencing state (reference IClientSequenceNumber)."""

    client_id: str
    client_seq: int
    ref_seq: int
    last_update: int
    can_evict: bool = True
    can_summarize: bool = True
    nack: bool = False


@dataclass(frozen=True, slots=True)
class RawOperation:
    """A raw (unsequenced) op as it arrives at the sequencer."""

    client_id: str | None  # None = system message (join/leave/control)
    type: MessageType
    client_seq: int = 0
    ref_seq: int = 0
    timestamp: int = 0
    contents: Any = None
    data: Any = None  # join: ClientEntry-like detail; leave: client_id
    # join-time flags (carried in data for the scalar path):
    can_summarize: bool = True
    can_evict: bool = True
    # Latency breadcrumbs riding the op (protocol.ts:53 ITrace); alfred
    # stamps submit, deli appends start/end (deli/lambda.ts:160).
    traces: tuple = ()


@dataclass(frozen=True, slots=True)
class Ticket:
    """Outcome of sequencing one raw op."""

    kind: int  # oc.OUT_*
    seq: int = -1
    msn: int = -1
    send: int = oc.SEND_IMMEDIATE
    nack_code: int = oc.NACK_NONE
    op: RawOperation | None = None


@dataclass(slots=True)
class SequencerCheckpoint:
    """Durable restart state (reference deli checkpointContext {seq,msn,clients})."""

    sequence_number: int
    minimum_sequence_number: int
    last_sent_msn: int
    no_active_clients: bool
    clients: list[dict]
    nack_future: bool = False
    client_timeout_ms: int = 5 * 60 * 1000
    log_offset: int = -1


class DocumentSequencer:
    """Scalar total-order sequencer for one document."""

    def __init__(
        self,
        sequence_number: int = 0,
        minimum_sequence_number: int = 0,
        client_timeout_ms: int = 5 * 60 * 1000,
    ) -> None:
        self.sequence_number = sequence_number
        self.minimum_sequence_number = minimum_sequence_number
        self.last_sent_msn = minimum_sequence_number
        self.no_active_clients = True
        self.nack_future = False
        self.client_timeout_ms = client_timeout_ms
        self.clients: dict[str, ClientEntry] = {}

    # -- membership helpers --------------------------------------------------

    def _upsert(
        self,
        client_id: str,
        client_seq: int,
        ref_seq: int,
        timestamp: int,
        can_summarize: bool = True,
        can_evict: bool = True,
        nack: bool = False,
    ) -> bool:
        """Returns True iff this is a new client (clientSeqManager.upsertClient)."""
        entry = self.clients.get(client_id)
        if entry is not None:
            entry.client_seq = client_seq
            entry.ref_seq = ref_seq
            entry.last_update = timestamp
            entry.nack = nack
            return False
        self.clients[client_id] = ClientEntry(
            client_id=client_id,
            client_seq=client_seq,
            ref_seq=ref_seq,
            last_update=timestamp,
            can_evict=can_evict,
            can_summarize=can_summarize,
            nack=nack,
        )
        return True

    def _min_ref_seq(self) -> int:
        if not self.clients:
            return -1
        return min(entry.ref_seq for entry in self.clients.values())

    def get_idle_client(self, now: int,
                        timeout_ms: int | None = None) -> str | None:
        """Oldest client idle past the timeout, if any (deli getIdleClient)."""
        timeout = (self.client_timeout_ms if timeout_ms is None
                   else timeout_ms)
        idle = [
            e for e in self.clients.values()
            if e.can_evict and now - e.last_update > timeout
        ]
        if not idle:
            return None
        return min(idle, key=lambda e: (e.last_update, e.client_id)).client_id

    # -- the ticket state machine -------------------------------------------

    def ticket(self, op: RawOperation) -> Ticket:
        if self.nack_future:
            return Ticket(
                kind=oc.OUT_NACK,
                seq=self.sequence_number,
                msn=self.minimum_sequence_number,
                nack_code=oc.NACK_FUTURE,
                op=op,
            )

        # Dup/gap detection on the per-client sequence number.
        if op.client_id is not None:
            entry = self.clients.get(op.client_id)
            if entry is not None:
                expected = entry.client_seq + 1
                if op.client_seq > expected:
                    return Ticket(
                        kind=oc.OUT_NACK,
                        seq=self.sequence_number,
                        msn=self.minimum_sequence_number,
                        nack_code=oc.NACK_GAP,
                        op=op,
                    )
                if op.client_seq < expected:
                    return Ticket(kind=oc.OUT_IGNORED, op=op)

        if op.client_id is None:
            if op.type == MessageType.CLIENT_LEAVE:
                if op.data not in self.clients:
                    return Ticket(kind=oc.OUT_IGNORED, op=op)
                del self.clients[op.data]
            elif op.type == MessageType.CLIENT_JOIN:
                # data carries the join detail (ClientDetail) or a bare id
                # (reference IClientJoin {clientId, detail}).
                join_id = getattr(op.data, "client_id", op.data)
                is_new = self._upsert(
                    join_id,
                    0,
                    self.minimum_sequence_number,
                    op.timestamp,
                    can_summarize=op.can_summarize,
                    can_evict=op.can_evict,
                )
                if not is_new:
                    return Ticket(kind=oc.OUT_IGNORED, op=op)
        else:
            # Service-only types are rejected from clients: CONTROL could set
            # nack_future (DoS), NO_CLIENT/JOIN/LEAVE forge membership, and
            # SUMMARY_ACK/NACK forge the summary protocol.
            if op.type in _SERVICE_ONLY_TYPES:
                return Ticket(
                    kind=oc.OUT_NACK,
                    seq=self.sequence_number,
                    msn=self.minimum_sequence_number,
                    nack_code=oc.NACK_INVALID_TYPE,
                    op=op,
                )
            entry = self.clients.get(op.client_id)
            if entry is None or entry.nack:
                return Ticket(
                    kind=oc.OUT_NACK,
                    seq=self.sequence_number,
                    msn=self.minimum_sequence_number,
                    nack_code=oc.NACK_NONEXISTENT_CLIENT,
                    op=op,
                )
            if op.ref_seq != -1 and op.ref_seq < self.minimum_sequence_number:
                self._upsert(
                    op.client_id,
                    op.client_seq,
                    self.minimum_sequence_number,
                    op.timestamp,
                    nack=True,
                )
                return Ticket(
                    kind=oc.OUT_NACK,
                    seq=self.sequence_number,
                    msn=self.minimum_sequence_number,
                    nack_code=oc.NACK_REFSEQ_BELOW_MSN,
                    op=op,
                )
            if op.type == MessageType.SUMMARIZE and not entry.can_summarize:
                return Ticket(
                    kind=oc.OUT_NACK,
                    seq=self.sequence_number,
                    msn=self.minimum_sequence_number,
                    nack_code=oc.NACK_NO_SUMMARY_SCOPE,
                    op=op,
                )

        # Sequence-number rev.
        sequence_number = self.sequence_number
        ref_seq = op.ref_seq
        if op.client_id is not None:
            if op.type != MessageType.NOOP:
                sequence_number = self._rev()
            if ref_seq == -1:
                ref_seq = sequence_number
            self._upsert(op.client_id, op.client_seq, ref_seq, op.timestamp)
        else:
            if op.type not in (
                MessageType.NOOP,
                MessageType.NO_CLIENT,
                MessageType.CONTROL,
            ):
                sequence_number = self._rev()

        # MSN update.
        msn = self._min_ref_seq()
        if msn == -1:
            self.minimum_sequence_number = sequence_number
            self.no_active_clients = True
        else:
            self.minimum_sequence_number = msn
            self.no_active_clients = False

        # Send heuristics (no-op consolidation, deli lambda.ts:375-447).
        send = oc.SEND_IMMEDIATE
        if op.type == MessageType.NOOP:
            if op.client_id is not None:
                if op.contents is None:
                    send = oc.SEND_LATER
                elif self.minimum_sequence_number <= self.last_sent_msn:
                    send = oc.SEND_LATER
                else:
                    sequence_number = self._rev()
            else:
                if self.minimum_sequence_number <= self.last_sent_msn:
                    send = oc.SEND_NEVER
                else:
                    sequence_number = self._rev()
        elif op.type == MessageType.NO_CLIENT:
            if self.no_active_clients:
                sequence_number = self._rev()
                self.minimum_sequence_number = sequence_number
            else:
                send = oc.SEND_NEVER
        elif op.type == MessageType.CONTROL:
            send = oc.SEND_NEVER
            if isinstance(op.contents, dict) and op.contents.get("type") == "nackFuture":
                self.nack_future = True

        if send == oc.SEND_IMMEDIATE:
            self.last_sent_msn = self.minimum_sequence_number

        return Ticket(
            kind=oc.OUT_SEQUENCED,
            seq=sequence_number,
            msn=self.minimum_sequence_number,
            send=send,
            op=op,
        )

    def _rev(self) -> int:
        self.sequence_number += 1
        return self.sequence_number

    # -- checkpoint/restore (deli checkpointContext.ts) ----------------------

    def checkpoint(self, log_offset: int = -1) -> SequencerCheckpoint:
        return SequencerCheckpoint(
            sequence_number=self.sequence_number,
            minimum_sequence_number=self.minimum_sequence_number,
            last_sent_msn=self.last_sent_msn,
            no_active_clients=self.no_active_clients,
            nack_future=self.nack_future,
            client_timeout_ms=self.client_timeout_ms,
            clients=[
                {
                    "client_id": e.client_id,
                    "client_seq": e.client_seq,
                    "ref_seq": e.ref_seq,
                    "last_update": e.last_update,
                    "can_evict": e.can_evict,
                    "can_summarize": e.can_summarize,
                    "nack": e.nack,
                }
                for e in sorted(self.clients.values(), key=lambda e: e.client_id)
            ],
            log_offset=log_offset,
        )

    @classmethod
    def restore(cls, cp: SequencerCheckpoint) -> "DocumentSequencer":
        seq = cls(
            sequence_number=cp.sequence_number,
            minimum_sequence_number=cp.minimum_sequence_number,
            client_timeout_ms=cp.client_timeout_ms,
        )
        seq.last_sent_msn = cp.last_sent_msn
        seq.no_active_clients = cp.no_active_clients
        seq.nack_future = cp.nack_future
        for c in cp.clients:
            seq.clients[c["client_id"]] = ClientEntry(
                client_id=c["client_id"],
                client_seq=c["client_seq"],
                ref_seq=c["ref_seq"],
                last_update=c["last_update"],
                can_evict=c["can_evict"],
                can_summarize=c["can_summarize"],
                nack=c["nack"],
            )
        return seq
