"""Batched total-order sequencer ("deli-kernel") in PyTorch.

Port of ``fluidframework_tpu/ops/sequencer.py``. The reference sequencer
is a single-threaded per-document ticket loop
(server/routerlicious/packages/lambdas/src/deli/lambda.ts:236-470) scaled
by Kafka partitioning across documents. Here the same state machine is a
branch-free function over int32/bool tensors: :func:`process_batch` walks
the K ops of one tick in order (sequencing is sequential *within* a
document) and each step is vectorised over the document axis.

:func:`process_batch` is the plain version of the CUDA deli kernel
(``csrc/sequencer_tick.cu`` via :mod:`.sequencer_cuda`): the CPU path and
the kernel's judge. :func:`storm_tickets` is the closed-form storm ticket,
plain tensor math with no kernel of its own.

Client identity is a host-assigned *slot index* (< ``num_slots``); the
host owns the string-id ↔ slot mapping (see server.kernel_host).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..protocol.messages import MessageType
from . import opcodes as oc

I32 = torch.int32


class SequencerState(NamedTuple):
    """Per-document sequencer state. Leading axis = documents (B)."""

    seq: torch.Tensor            # i32[B] current sequence number
    msn: torch.Tensor            # i32[B] minimum sequence number
    last_sent_msn: torch.Tensor  # i32[B] msn of last immediately-sent message
    nack_future: torch.Tensor    # bool[B] control-driven reject-all state
    active: torch.Tensor         # bool[B, C] slot occupied
    cseq: torch.Tensor           # i32[B, C] last clientSequenceNumber per client
    cref: torch.Tensor           # i32[B, C] referenceSequenceNumber per client
    clu: torch.Tensor            # i32[B, C] last-update timestamp (ms)
    csum: torch.Tensor           # bool[B, C] summarize scope
    cnack: torch.Tensor          # bool[B, C] client marked nacked
    cevict: torch.Tensor         # bool[B, C] client may be idle-evicted


class OpBatch(NamedTuple):
    """One tick of raw ops, padded to K per document. Axes [B, K]."""

    valid: torch.Tensor         # bool — padding mask
    kind: torch.Tensor          # i32 MessageType opcode
    slot: torch.Tensor          # i32 submitting client slot; -1 = system message
    target: torch.Tensor        # i32 join/leave subject slot (else ignored)
    client_seq: torch.Tensor    # i32
    ref_seq: torch.Tensor       # i32 (-1 = direct/REST op)
    timestamp: torch.Tensor     # i32 ms
    has_contents: torch.Tensor  # bool (no-op consolidation heuristic)
    can_summarize: torch.Tensor  # bool (join detail)
    can_evict: torch.Tensor     # bool (join detail; False pins e.g. summarizers)
    is_nack_future: torch.Tensor  # bool (control payload)


class TicketBatch(NamedTuple):
    """Sequencing outcome per op. Axes [B, K]."""

    kind: torch.Tensor       # i32 oc.OUT_*
    seq: torch.Tensor        # i32 assigned seq (sequenced) / current seq (nack) / -1
    msn: torch.Tensor        # i32
    send: torch.Tensor       # i32 oc.SEND_*
    nack_code: torch.Tensor  # i32 oc.NACK_*


def init_state(num_docs: int, num_slots: int = 16,
               device: str | torch.device | None = None) -> SequencerState:
    dev = resolve_device(device)
    b, c = num_docs, num_slots
    return SequencerState(
        seq=torch.zeros((b,), dtype=I32, device=dev),
        msn=torch.zeros((b,), dtype=I32, device=dev),
        last_sent_msn=torch.zeros((b,), dtype=I32, device=dev),
        nack_future=torch.zeros((b,), dtype=torch.bool, device=dev),
        active=torch.zeros((b, c), dtype=torch.bool, device=dev),
        cseq=torch.zeros((b, c), dtype=I32, device=dev),
        cref=torch.zeros((b, c), dtype=I32, device=dev),
        clu=torch.zeros((b, c), dtype=I32, device=dev),
        csum=torch.zeros((b, c), dtype=torch.bool, device=dev),
        cnack=torch.zeros((b, c), dtype=torch.bool, device=dev),
        cevict=torch.ones((b, c), dtype=torch.bool, device=dev),
    )


def _at(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """plane[d, idx[d]] per doc."""
    return plane.gather(1, idx[:, None].long())[:, 0]


def _ticket_step(s: SequencerState, op: OpBatch):
    """One op per document through the state machine. State fields [B] /
    [B, C]; op fields [B]."""
    num_slots = s.active.shape[1]
    i32 = lambda v: torch.tensor(v, dtype=I32, device=s.seq.device)  # noqa: E731
    is_client = op.slot >= 0
    slot = op.slot.clamp(0, num_slots - 1)
    target = op.target.clamp(0, num_slots - 1)

    at_slot_active = _at(s.active, slot)
    at_target_active = _at(s.active, target)
    exists = is_client & at_slot_active
    expected = _at(s.cseq, slot) + 1
    gap = exists & (op.client_seq > expected)
    dup = exists & (op.client_seq < expected)

    is_join = op.kind == int(MessageType.CLIENT_JOIN)
    is_leave = op.kind == int(MessageType.CLIENT_LEAVE)
    join_dup = ~is_client & is_join & at_target_active
    leave_dup = ~is_client & is_leave & ~at_target_active

    # Service-only types from a client are invalid (scalar _SERVICE_ONLY_TYPES).
    service_only = (
        (op.kind == int(MessageType.CLIENT_JOIN))
        | (op.kind == int(MessageType.CLIENT_LEAVE))
        | (op.kind == int(MessageType.NO_CLIENT))
        | (op.kind == int(MessageType.CONTROL))
        | (op.kind == int(MessageType.SUMMARY_ACK))
        | (op.kind == int(MessageType.SUMMARY_NACK))
    )
    invalid_type = is_client & ~gap & ~dup & service_only
    nonexistent = (is_client & ~gap & ~dup & ~invalid_type
                   & (~at_slot_active | _at(s.cnack, slot)))
    refseq_nack = (is_client & ~gap & ~dup & ~invalid_type & ~nonexistent
                   & (op.ref_seq != -1) & (op.ref_seq < s.msn))
    summarize_nack = (
        is_client & ~gap & ~dup & ~invalid_type & ~nonexistent & ~refseq_nack
        & (op.kind == int(MessageType.SUMMARIZE)) & ~_at(s.csum, slot))

    nack_future = s.nack_future
    nacked = op.valid & (nack_future | gap | invalid_type | nonexistent
                         | refseq_nack | summarize_nack)
    ignored = op.valid & ~nack_future & (dup | join_dup | leave_dup)
    sequenced = op.valid & ~nacked & ~ignored

    nack_code = torch.full_like(op.kind, oc.NACK_NONE)
    for cond, code in ((summarize_nack, oc.NACK_NO_SUMMARY_SCOPE),
                       (refseq_nack, oc.NACK_REFSEQ_BELOW_MSN),
                       (nonexistent, oc.NACK_NONEXISTENT_CLIENT),
                       (invalid_type, oc.NACK_INVALID_TYPE),
                       (gap, oc.NACK_GAP),
                       (nack_future, oc.NACK_FUTURE)):
        nack_code = torch.where(cond, i32(code), nack_code)

    # Side effect of a refseq NACK: client is marked nacked at refSeq=MSN
    # (deli lambda.ts:305-312 upsert with nack=true).
    do_refseq_mark = op.valid & ~nack_future & refseq_nack
    lanes = torch.arange(num_slots, device=s.seq.device)[None, :]
    onehot_slot = (lanes == slot[:, None]) & is_client[:, None]
    mark = onehot_slot & do_refseq_mark[:, None]
    cseq = torch.where(mark, op.client_seq[:, None], s.cseq)
    cref = torch.where(mark, s.msn[:, None], s.cref)
    clu = torch.where(mark, op.timestamp[:, None], s.clu)
    cnack = s.cnack | mark

    # Membership changes. A duplicate join is dropped from the stream but
    # STILL upserts the client entry (clientSeq=0, refSeq=msn) — the
    # reference's upsertClient mutates before deli's early return
    # (clientSeqManager.ts:79-88, deli lambda.ts:277-287). A duplicate
    # leave has no side effect.
    onehot_target = lanes == target[:, None]
    do_join = op.valid & ~nack_future & is_join & ~is_client
    do_leave = sequenced & is_leave & ~is_client
    join_mask = onehot_target & do_join[:, None]
    active = (s.active & ~(onehot_target & do_leave[:, None])) | join_mask
    cseq = torch.where(join_mask, i32(0), cseq)
    cref = torch.where(join_mask, s.msn[:, None], cref)
    clu = torch.where(join_mask, op.timestamp[:, None], clu)
    # Scopes are set only at first join; a dup-join upsert leaves them.
    fresh_join_mask = join_mask & ~at_target_active[:, None]
    csum = torch.where(fresh_join_mask, op.can_summarize[:, None], s.csum)
    cevict = torch.where(fresh_join_mask, op.can_evict[:, None], s.cevict)
    cnack = cnack & ~join_mask

    # Sequence-number rev (step 5).
    is_noop = op.kind == int(MessageType.NOOP)
    is_noclient = op.kind == int(MessageType.NO_CLIENT)
    is_control = op.kind == int(MessageType.CONTROL)
    rev1 = sequenced & torch.where(is_client, ~is_noop,
                                   ~(is_noop | is_noclient | is_control))
    seq1 = s.seq + rev1.to(I32)

    # Client upsert on the sequenced path.
    ref_eff = torch.where(is_client & (op.ref_seq == -1), seq1, op.ref_seq)
    up = onehot_slot & (sequenced & is_client)[:, None]
    cseq = torch.where(up, op.client_seq[:, None], cseq)
    cref = torch.where(up, ref_eff[:, None], cref)
    clu = torch.where(up, op.timestamp[:, None], clu)
    cnack = cnack & ~up

    # MSN (step 6).
    min_ref = torch.where(active, cref, i32(int(oc.INT32_MAX))).amin(dim=1)
    no_clients = ~active.any(dim=1)
    msn1 = torch.where(no_clients, seq1, min_ref)

    # No-op consolidation heuristics (step 7).
    stale = msn1 <= s.last_sent_msn
    client_noop = sequenced & is_noop & is_client
    server_noop = sequenced & is_noop & ~is_client
    noclient = sequenced & is_noclient & ~is_client
    control = sequenced & is_control & ~is_client

    send = torch.full_like(op.kind, oc.SEND_IMMEDIATE)
    send = torch.where(client_noop & (~op.has_contents | stale),
                       i32(oc.SEND_LATER), send)
    send = torch.where(server_noop & stale, i32(oc.SEND_NEVER), send)
    send = torch.where(noclient & ~no_clients, i32(oc.SEND_NEVER), send)
    send = torch.where(control, i32(oc.SEND_NEVER), send)

    rev2 = ((client_noop & op.has_contents & ~stale)
            | (server_noop & ~stale)
            | (noclient & no_clients))
    seq2 = seq1 + rev2.to(I32)
    msn2 = torch.where(noclient & no_clients, seq2, msn1)
    nack_future_next = s.nack_future | (control & op.is_nack_future)

    applied = sequenced
    touched = (applied | do_refseq_mark | do_join)[:, None]
    state = SequencerState(
        seq=torch.where(applied, seq2, s.seq),
        msn=torch.where(applied, msn2, s.msn),
        last_sent_msn=torch.where(
            applied & (send == oc.SEND_IMMEDIATE), msn2, s.last_sent_msn),
        nack_future=torch.where(op.valid, nack_future_next, s.nack_future),
        active=torch.where(touched, active, s.active),
        cseq=torch.where(touched, cseq, s.cseq),
        cref=torch.where(touched, cref, s.cref),
        clu=torch.where(touched, clu, s.clu),
        csum=torch.where(touched, csum, s.csum),
        cnack=torch.where(touched, cnack, s.cnack),
        cevict=torch.where(touched, cevict, s.cevict),
    )

    out = TicketBatch(
        kind=torch.where(
            nacked, i32(oc.OUT_NACK),
            torch.where(sequenced, i32(oc.OUT_SEQUENCED),
                        i32(oc.OUT_IGNORED))),
        seq=torch.where(nacked, s.seq, torch.where(sequenced, seq2, i32(-1))),
        msn=torch.where(nacked, s.msn, torch.where(sequenced, msn2, i32(-1))),
        send=torch.where(sequenced, send, i32(oc.SEND_IMMEDIATE)),
        nack_code=torch.where(nacked, nack_code, i32(oc.NACK_NONE)),
    )
    return state, out


def process_batch(state: SequencerState, ops: OpBatch):
    """Sequence one tick of ops for every document (the plain version of
    the CUDA deli kernel).

    state: fields [B, ...]; ops: fields [B, K] → (state', TicketBatch[B, K]).
    """
    k = ops.kind.shape[1]
    tickets = []
    for i in range(k):
        state, out = _ticket_step(state, OpBatch(*(f[:, i] for f in ops)))
        tickets.append(out)
    if not tickets:
        empty = ops.kind.new_empty(ops.kind.shape)
        return state, TicketBatch(*(empty.clone() for _ in TicketBatch._fields))
    return state, TicketBatch(*(torch.stack(planes, dim=1)
                                for planes in zip(*tickets)))


def storm_tickets(state: SequencerState, slot, cseq0, ref, ts, counts):
    """Closed-form deli ticket for the storm frame shape — NO per-op scan.

    A storm batch is: one client per document, ``counts`` consecutive
    OPERATION ops (client_seq = cseq0..cseq0+n-1), one shared ref_seq and
    timestamp. On that shape the K-step ticket loop collapses to O(1)
    per-doc algebra (deli/lambda.ts:236-341 specialized):

      * dup resends are a PREFIX (clientSequenceNumber dedup, lambda.ts:257):
        dups = clip(cseq[slot]+1 - cseq0, 0, n);
      * a gap (cseq0 > expected) rejects the whole batch;
      * nack_future / inactive slot / nacked client reject the whole
        batch with no state change;
      * refSeq < MSN NACKs the first accepted op AND marks the client
        (cseq=that op's clientSeq, cref=msn, nacked — lambda.ts:305-312);
      * otherwise the m = n - dups survivors take seq+1..seq+m, the
        client upserts once (cseq=cseq0+n-1, cref=ref or seq+m for
        ref=-1), and MSN/last_sent_msn settle once at the end.

    Pinned to :func:`process_batch` on this shape by differential test.

    Returns (state', dups, n_seq, msn) — per-op planes derive as:
    sequenced[i] = dups <= i < dups + n_seq; seq[i] = seq0 + 1 + i - dups.
    """
    c = state.active.shape[1]
    lanes = torch.arange(c, device=state.seq.device)[None, :]
    onehot = lanes == slot.clamp(0, c - 1)[:, None]

    def at(plane):
        return torch.where(onehot, plane.to(I32), 0).sum(dim=1, dtype=I32)

    n = counts.clamp(min=0)
    ok = ((n > 0) & (slot >= 0) & (at(state.active) != 0)
          & (at(state.cnack) == 0) & ~state.nack_future)
    expected = at(state.cseq) + 1
    no_gap = ok & (cseq0 <= expected)
    dups = torch.minimum(torch.clamp(expected - cseq0, min=0), n)
    m = torch.where(no_gap, n - dups, 0)
    refnack = no_gap & (m > 0) & (ref != -1) & (ref < state.msn)
    n_seq = torch.where(refnack, 0, m)
    do_seq = n_seq > 0

    seq2 = state.seq + n_seq
    ref_eff = torch.where(ref == -1, seq2, ref)
    up = onehot & do_seq[:, None]
    mark = onehot & refnack[:, None]
    cseq_new = torch.where(
        up, (cseq0 + n - 1)[:, None],
        torch.where(mark, (cseq0 + dups)[:, None], state.cseq))
    cref_new = torch.where(
        up, ref_eff[:, None],
        torch.where(mark, state.msn[:, None], state.cref))
    clu_new = torch.where(up | mark, ts[:, None], state.clu)
    cnack_new = (state.cnack & ~up) | mark
    min_ref = torch.where(state.active, cref_new,
                          int(oc.INT32_MAX)).amin(dim=1)
    msn2 = torch.where(do_seq, min_ref, state.msn)
    new_state = state._replace(
        seq=seq2, msn=msn2,
        last_sent_msn=torch.where(do_seq, msn2, state.last_sent_msn),
        cseq=cseq_new, cref=cref_new, clu=clu_new, cnack=cnack_new)
    return new_state, dups, n_seq, msn2


def find_idle(state: SequencerState, now: int, timeout_ms: int) -> torch.Tensor:
    """bool[B, C] mask of evictable idle clients. ``now`` uses the same
    clock as op timestamps: int32 milliseconds since service start."""
    assert 0 <= now < 2**31, "timestamps are i32 ms since service start"
    return state.active & state.cevict & ((now - state.clu) > timeout_ms)


# -- host-side encode helpers -------------------------------------------------


def make_op_batch(ops_per_doc: list[list[dict]], num_docs: int, k: int,
                  device: str | torch.device | None = None) -> OpBatch:
    """Encode python op dicts (see fields of OpBatch) into padded tensors."""
    dev = resolve_device(device)

    def zeros(dtype):
        return np.zeros((num_docs, k), dtype)

    out = dict(
        valid=zeros(np.bool_), kind=zeros(np.int32), slot=zeros(np.int32),
        target=zeros(np.int32), client_seq=zeros(np.int32),
        ref_seq=zeros(np.int32), timestamp=zeros(np.int32),
        has_contents=zeros(np.bool_), can_summarize=zeros(np.bool_),
        can_evict=zeros(np.bool_), is_nack_future=zeros(np.bool_),
    )
    out["slot"][:] = -1
    for d, doc_ops in enumerate(ops_per_doc):
        assert len(doc_ops) <= k, f"tick overflow: {len(doc_ops)} > {k}"
        for i, op in enumerate(doc_ops):
            ts = op.get("timestamp", 0)
            # Timestamps are milliseconds SINCE SERVICE START, not epoch ms:
            # they live in int32 on device (epoch ms overflows).
            assert 0 <= ts < 2**31, (
                f"timestamp {ts} out of i32 range — rebase to service start")
            out["valid"][d, i] = True
            out["kind"][d, i] = int(op["kind"])
            out["slot"][d, i] = op.get("slot", -1)
            out["target"][d, i] = op.get("target", 0)
            out["client_seq"][d, i] = op.get("client_seq", 0)
            out["ref_seq"][d, i] = op.get("ref_seq", 0)
            out["timestamp"][d, i] = ts
            out["has_contents"][d, i] = op.get("has_contents", False)
            out["can_summarize"][d, i] = op.get("can_summarize", True)
            out["can_evict"][d, i] = op.get("can_evict", True)
            out["is_nack_future"][d, i] = op.get("is_nack_future", False)
    return OpBatch(**{name: torch.from_numpy(v).to(dev)
                      for name, v in out.items()})
