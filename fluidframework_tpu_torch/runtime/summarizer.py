"""Summary subsystem — elected client checkpoints the document.

Reference parity: packages/runtime/container-runtime/src/summarizer.ts +
summaryManager.ts (§3.5 of SURVEY.md): the oldest eligible quorum member is
elected to summarize; heuristics (ops-since-last-ack, injectable clock for
idle/max-time) decide when; generation = build full summary at the current
sequence number → upload to storage → submit a sequenced SUMMARIZE op
carrying the storage handle → service scribe validates, makes it
load-visible and sequences SUMMARY_ACK / SUMMARY_NACK.

Simplification vs the reference: the elected container summarizes over its
own connection instead of spawning a hidden "/_summarizer" client — the
in-proc client is synchronous, so the summary is generated at a quiesced
point (inside op processing) exactly as the reference's paused-inbound
summarizer does. The election + heuristics + ack protocol are the same.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable

from ..protocol.messages import (
    MessageType,
    ScopeType,
    SequencedDocumentMessage,
)

if TYPE_CHECKING:
    from .container import Container


@dataclass
class SummaryConfig:
    """When to summarize (reference ISummaryConfiguration heuristics)."""

    max_ops: int = 100           # ops since last ack before summarizing
    max_time_ms: float | None = None  # wall-time trigger (needs clock)
    min_ops_for_last_summary: int = 1  # don't summarize empty diffs
    # Give up waiting for an ack after this many further sequenced ops and
    # allow a fresh attempt (reference maxAckWaitTime, op-counted here).
    max_ack_wait_ops: int = 200


@dataclass
class SummarizerEvent:
    kind: str  # "generated" | "acked" | "nacked"
    sequence_number: int
    handle: str | None = None
    reason: str | None = None


class SummaryManager:
    """Per-container election + heuristics driver.

    Every client runs one; only the elected client acts. Election is the
    oldest eligible quorum member (lowest join sequence number) holding the
    summary-write scope — deterministic on the identical quorum state every
    replica maintains (summaryManager.ts oldest-client heuristic).
    """

    def __init__(self, container: "Container",
                 config: SummaryConfig | None = None,
                 clock: Callable[[], float] | None = None) -> None:
        self.container = container
        self.config = config or SummaryConfig()
        self.clock = clock
        self.ops_since_ack = 0
        self.last_ack_seq = 0
        self.last_summary_time = clock() if clock else 0.0
        self.pending_handle: str | None = None
        self.pending_since_seq = 0
        # Incremental-summary parent: the last ACKED summary's handle and
        # its GENERATION seq (the state it captured). Channels unchanged
        # since then serialize as handle stubs into it (summary.ts:53);
        # None gen seq = next summary is full (e.g. a peer's summary was
        # acked — we don't know what state it captured).
        self.last_acked_handle: str | None = None
        self.last_acked_gen_seq: int | None = None
        self.pending_gen_seq: int | None = None
        self.events: list[SummarizerEvent] = []
        self.enabled = True
        container.on_op_processed.append(self._on_op)
        container.on_nack.append(self._on_transport_nack)

    # -- election --------------------------------------------------------------

    def elected_client_id(self) -> str | None:
        """The quorum's oldest member with summary scope, or None."""
        members = self.container.protocol.quorum.get_members()
        best_id, best_seq = None, None
        for client_id, member in members.items():
            scopes = getattr(member.detail, "scopes", ())
            if ScopeType.SUMMARY_WRITE not in scopes:
                continue
            if best_seq is None or member.sequence_number < best_seq:
                best_id, best_seq = client_id, member.sequence_number
        return best_id

    @property
    def is_elected(self) -> bool:
        client_id = self.container.client_id
        return client_id is not None and client_id == self.elected_client_id()

    # -- heuristics ------------------------------------------------------------

    def _on_op(self, message: SequencedDocumentMessage) -> None:
        if message.type == MessageType.SUMMARY_ACK:
            self._on_ack(message)
            return
        if message.type == MessageType.SUMMARY_NACK:
            self._on_nack(message)
            return
        if message.type == MessageType.OPERATION:
            self.ops_since_ack += 1
        if self.pending_handle is not None and (
                message.sequence_number - self.pending_since_seq
                > self.config.max_ack_wait_ops):
            # The offer (or its ack) was lost in transit; stop waiting.
            self.pending_handle = None
        if not self.enabled or self.pending_handle is not None:
            return
        if not self.is_elected:
            return
        if self.container.runtime.pending.has_pending:
            # Local ops are optimistically applied but not yet sequenced: a
            # summary now would bake their effects in below their eventual
            # seq and double-apply them on load. Retry once acks drain.
            return
        if self.ops_since_ack < self.config.min_ops_for_last_summary:
            return
        due = self.ops_since_ack >= self.config.max_ops
        if not due and self.config.max_time_ms is not None and self.clock:
            due = (self.clock() - self.last_summary_time
                   ) * 1000.0 >= self.config.max_time_ms
        if due:
            self.summarize_now(reason="heuristics")

    def _on_ack(self, message: SequencedDocumentMessage) -> None:
        self.ops_since_ack = 0
        self.last_ack_seq = message.contents["summary_proposal"][
            "summary_sequence_number"]
        if self.clock:
            self.last_summary_time = self.clock()
        handle = message.contents.get("handle")
        if self.pending_handle is not None and handle == self.pending_handle:
            self.pending_handle = None
            self.last_acked_gen_seq = self.pending_gen_seq
        else:
            # A peer's summary: we can't know which seq it captured, so
            # the next summary we generate is full.
            self.last_acked_gen_seq = None
        self.last_acked_handle = handle
        self.events.append(SummarizerEvent(
            "acked", message.sequence_number, handle=handle))

    def _on_nack(self, message: SequencedDocumentMessage) -> None:
        # Clear in-flight only when the rejection is for OUR offer — a
        # peer's bogus offer being nacked must not cancel ours.
        handle = (message.contents or {}).get("handle")
        if self.pending_handle is not None and handle == self.pending_handle:
            self.pending_handle = None
        self.events.append(SummarizerEvent(
            "nacked", message.sequence_number, handle=handle,
            reason=(message.contents or {}).get("message")))

    def _on_transport_nack(self, nack) -> None:
        # The sequencer itself can reject the SUMMARIZE op (drain mode,
        # refSeq below MSN after a gap): that arrives as a transport NACK,
        # never as a sequenced SUMMARY_NACK — clear in-flight so summaries
        # don't stall forever.
        operation = getattr(nack, "operation", None)
        if operation is None or operation.type != MessageType.SUMMARIZE:
            return
        if (operation.contents or {}).get("handle") == self.pending_handle:
            self.pending_handle = None

    # -- generation ------------------------------------------------------------

    def summarize_now(self, reason: str = "manual") -> str | None:
        """Generate + upload + offer a summary. Returns the handle, or None
        when not connected/attached."""
        container = self.container
        if not container.connected or not container.attached:
            return None
        if container.runtime.pending.has_pending:
            return None  # unacked optimistic state; see _on_op
        incremental = (self.last_acked_handle is not None
                       and self.last_acked_gen_seq is not None)
        summary = container.summarize(
            unchanged_before=self.last_acked_gen_seq if incremental
            else None)
        try:
            handle = container._service.storage.upload_snapshot(
                summary,
                parent=self.last_acked_handle if incremental else None)
        except Exception as err:
            # Upload/resolution failure (e.g. the parent summary was
            # pruned): record it, fall back to a FULL summary next time,
            # and never let the error escape into op processing.
            self.last_acked_gen_seq = None
            self.events.append(SummarizerEvent(
                "nacked", container.last_processed_seq,
                reason=f"upload failed: {err!r}"))
            return None
        self.pending_handle = handle
        self.pending_gen_seq = summary["sequence_number"]
        self.pending_since_seq = container.last_processed_seq
        # Record BEFORE submitting: the in-proc server delivers the ack
        # re-entrantly inside the submit call.
        self.events.append(SummarizerEvent(
            "generated", summary["sequence_number"], handle=handle,
            reason=reason))
        container.submit_message(MessageType.SUMMARIZE, {
            "handle": handle,
            "head": self.last_ack_seq,
            "message": reason,
        })
        return handle
