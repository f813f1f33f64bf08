"""KernelSequencerHost — the batched device sequencer behind the service.

Port of ``fluidframework_tpu/server/kernel_host.py``. Reference parity:
this replaces the per-partition deli lambda fleet
(server/routerlicious/packages/lambdas/src/deli/lambda.ts + the
lambdas-driver partition manager) with ONE device-resident state batch:
every document is a row of :class:`fluidframework_tpu_torch.ops.sequencer.
SequencerState`, and a service tick sequences the pending ops of all
documents in a single deli-kernel launch (``ops/sequencer_cuda.py``).

The host owns everything the kernel cannot: the ``doc_id`` → state-row and
``client_id`` → slot mappings, checkpoint encode/decode, and idle-client
ejection (deli checkIdleClients). Every ticket outcome — including NACKs
for clients the kernel has never seen — is decided BY the kernel: the host
allocates a slot for any referenced client id so the op can be expressed
on device, then prunes allocations that did not result in an active
client.

Two call paths:

- :meth:`sequence` — synchronous per-op path (one-op batch through the
  plain :func:`~fluidframework_tpu_torch.ops.sequencer.process_batch`).
- :meth:`submit` + :meth:`flush` — the throughput path: queue raw ops per
  document, then sequence every document's tick in one kernel launch.

Device rows are updated in place where a single row changes (the sync
path, restore, release): the host owns its state tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops import opcodes as oc
from ..ops import sequencer as seqk
from ..ops import sequencer_cuda as seqc
from ..protocol.messages import MessageType
from .sequencer import (
    DocumentSequencer,
    RawOperation,
    SequencerCheckpoint,
    Ticket,
)


def _step_one(state: seqk.SequencerState, row: int, ops: seqk.OpBatch):
    """Sequence a [1, K] op batch against state row ``row`` in place."""
    sliced = seqk.SequencerState(*(f[row:row + 1] for f in state))
    new_row, out = seqk.process_batch(sliced, ops)
    for f, r in zip(state, new_row):
        f[row:row + 1] = r
    return state, out


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _tick_k(max_pending: int) -> int:
    """Op-batch width for a flush tick: pow2-bucketed with a floor of 32."""
    return max(32, _next_pow2(max_pending))


def _to_numpy(planes):
    """A NamedTuple of tensors as the same NamedTuple of numpy arrays (one
    device→host copy per plane)."""
    return type(planes)(*(t.cpu().numpy() for t in planes))


class KernelSequencerHost:
    """Device-batched total-order sequencer for many documents.

    The device state carries ``num_slots`` allocatable client lanes plus one
    reserved GHOST lane (the last index) that is never joined: ops that
    reference a client id the host cannot map are encoded against the ghost
    lane, which is permanently inactive, so the kernel itself produces the
    NACK_NONEXISTENT_CLIENT / dup-leave-IGNORED outcome with exact mid-tick
    ordering. Joins that find no free lane grow the slot axis (doubling).
    """

    DEFAULT_TIMEOUT_MS = 5 * 60 * 1000

    def __init__(self, num_slots: int = 16, initial_capacity: int = 8,
                 device: str | torch.device | None = None) -> None:
        self.device = resolve_device(device)
        self._alloc_slots = max(1, num_slots)  # lanes handed to real clients
        self._capacity = max(1, initial_capacity)
        self._state = seqk.init_state(self._capacity, self._alloc_slots + 1,
                                      self.device)
        self._rows: dict[str, int] = {}
        # Row recycling (the doc-residency seam): released rows return to
        # this free list and are reissued before the high-water counter
        # advances.
        self._free_rows: list[int] = []
        self._row_count = 0  # high-water mark of allocated rows
        self._slots: list[dict[str, int]] = [{} for _ in range(self._capacity)]
        # Bumped on every client->slot membership change; callers caching
        # resolved (row, slot) cohorts key on it (server/storm.py).
        self.membership_gen = 0
        self._pending: list[list[RawOperation]] = [
            [] for _ in range(self._capacity)]
        self._timeout_ms: list[int] = [
            self.DEFAULT_TIMEOUT_MS] * self._capacity
        self._doc_counter = 0
        # Tickets produced by an internal flush buffer here until the next
        # flush() caller collects them — nothing is sequenced-and-dropped.
        self._ready: dict[str, list[Ticket]] = {}
        # Host mirror of the device state, fetched in ONE transfer and
        # reused until the next device write.
        self._host_state = None

    @property
    def _ghost(self) -> int:
        return self._alloc_slots

    # -- document / slot management -------------------------------------------

    def _row(self, doc_id: str) -> int:
        row = self._rows.get(doc_id)
        if row is None:
            if self._free_rows:
                row = self._free_rows.pop()
            else:
                row = self._row_count
                if row >= self._capacity:
                    self._grow_rows()
                self._row_count += 1
            self._rows[doc_id] = row
        return row

    def release_doc(self, doc_id: str) -> int:
        """Free a document's device row: blank the row back to init
        defaults and recycle its index. Returns the freed row index."""
        row = self._rows.pop(doc_id)
        assert not self._pending[row], (
            f"release_doc({doc_id!r}) with pending ops — flush first")
        self._ready.pop(doc_id, None)
        self._slots[row] = {}
        self._timeout_ms[row] = self.DEFAULT_TIMEOUT_MS
        self.membership_gen += 1
        blank = seqk.init_state(1, self._alloc_slots + 1, self.device)
        for f, b in zip(self._state, blank):
            f[row] = b[0]
        self._host_state = None
        self._free_rows.append(row)
        return row

    @property
    def resident_docs(self) -> int:
        return len(self._rows)

    def _grow_rows(self) -> None:
        old = self._capacity
        self._capacity = old * 2
        # Padded rows match init defaults (cevict inits True).
        pad = seqk.init_state(old, self._alloc_slots + 1, self.device)
        self._state = seqk.SequencerState(*(
            torch.cat((a, p)) for a, p in zip(self._state, pad)))
        self._host_state = None
        self._slots += [{} for _ in range(old)]
        self._pending += [[] for _ in range(old)]
        self._timeout_ms += [self.DEFAULT_TIMEOUT_MS] * old

    def _grow_slots(self, need: int) -> None:
        """Double the allocatable slot axis until ``need`` lanes fit. The old
        ghost lane is recycled as allocatable (the kernel never writes an
        inactive un-joined lane, so its state is pristine zeros)."""
        new_alloc = self._alloc_slots
        while new_alloc < need:
            new_alloc *= 2
        extra = (new_alloc + 1) - (self._alloc_slots + 1)
        b = self._capacity
        pad = seqk.init_state(b, extra, self.device)
        self._state = seqk.SequencerState(*(
            torch.cat((a, p), dim=1) if a.dim() == 2 else a
            for a, p in zip(self._state, pad)))
        self._host_state = None
        self._alloc_slots = new_alloc

    def _slot_for(self, row: int, client_id: str, fresh: set[str],
                  allow_ghost: bool) -> int:
        slots = self._slots[row]
        if client_id in slots:
            return slots[client_id]
        used = set(slots.values())
        for s in range(self._alloc_slots):
            if s not in used:
                slots[client_id] = s
                fresh.add(client_id)
                return s
        if allow_ghost:
            # Unknown client, no lane free: the permanently-inactive ghost
            # lane yields the kernel's nonexistent-client outcome.
            return self._ghost
        self._grow_slots(len(used) + 1)
        for s in range(self._alloc_slots):
            if s not in used:
                slots[client_id] = s
                fresh.add(client_id)
                return s
        raise AssertionError("slot growth failed to free a lane")

    @staticmethod
    def _referenced_client(raw: RawOperation) -> str | None:
        if raw.client_id is not None:
            return raw.client_id
        if raw.type == MessageType.CLIENT_JOIN:
            return getattr(raw.data, "client_id", raw.data)
        if raw.type == MessageType.CLIENT_LEAVE:
            return raw.data
        return None

    # -- encode / decode --------------------------------------------------------

    def _encode(self, row: int, raw: RawOperation, fresh: set[str]) -> dict:
        if raw.client_id is None:
            if raw.type in (MessageType.CLIENT_JOIN, MessageType.CLIENT_LEAVE):
                target = self._slot_for(
                    row, self._referenced_client(raw), fresh,
                    allow_ghost=raw.type == MessageType.CLIENT_LEAVE)
                return dict(kind=int(raw.type), slot=-1, target=target,
                            timestamp=raw.timestamp,
                            can_summarize=raw.can_summarize,
                            can_evict=raw.can_evict)
            is_nack_future = (isinstance(raw.contents, dict)
                              and raw.contents.get("type") == "nackFuture")
            return dict(kind=int(raw.type), slot=-1,
                        timestamp=raw.timestamp,
                        has_contents=raw.contents is not None,
                        is_nack_future=is_nack_future)
        return dict(kind=int(raw.type),
                    slot=self._slot_for(row, raw.client_id, fresh,
                                        allow_ghost=True),
                    client_seq=raw.client_seq, ref_seq=raw.ref_seq,
                    timestamp=raw.timestamp,
                    has_contents=raw.contents is not None)

    def _decode_doc(self, row: int, raws: list[RawOperation],
                    encs: list[dict], out, d: int,
                    fresh: set[str]) -> list[Ticket]:
        """Decode one document's tickets and settle its slot mappings."""
        tickets = []
        joined_ok: set[str] = set()
        for i, (raw, enc) in enumerate(zip(raws, encs)):
            kind = int(out.kind[d, i])
            tickets.append(Ticket(
                kind=kind,
                seq=int(out.seq[d, i]),
                msn=int(out.msn[d, i]),
                send=int(out.send[d, i]) if kind == oc.OUT_SEQUENCED
                else oc.SEND_IMMEDIATE,
                nack_code=int(out.nack_code[d, i]),
                op=raw,
            ))
            if raw.client_id is None and raw.type == MessageType.CLIENT_LEAVE:
                if kind == oc.OUT_SEQUENCED:
                    self._slots[row].pop(raw.data, None)
                    self.membership_gen += 1
                    joined_ok.discard(raw.data)
            elif raw.client_id is None and raw.type == MessageType.CLIENT_JOIN:
                # A sequenced join activates the lane; a dup-join (IGNORED)
                # still upserts the client on device, so the lane is live
                # either way.
                if kind in (oc.OUT_SEQUENCED, oc.OUT_IGNORED):
                    client_id = getattr(raw.data, "client_id", raw.data)
                    self._slots[row][client_id] = enc["target"]
                    self.membership_gen += 1
                    joined_ok.add(client_id)
        # Prune allocations that never became an active client.
        for client_id in fresh:
            if client_id not in joined_ok:
                self._slots[row].pop(client_id, None)
                self.membership_gen += 1
        return tickets

    @staticmethod
    def _check_timestamp(raw: RawOperation) -> None:
        """Reject out-of-range timestamps BEFORE any host state mutates
        (timestamps are i32 ms since service start)."""
        if not 0 <= raw.timestamp < 2**31:
            raise ValueError(
                f"timestamp {raw.timestamp} out of i32 range — timestamps "
                "are milliseconds since service start, not epoch ms")

    # -- synchronous per-op path ----------------------------------------------

    def sequence(self, doc_id: str, raw: RawOperation) -> Ticket:
        self._check_timestamp(raw)
        row = self._row(doc_id)
        if self._pending[row]:
            # Ops queued for the batched path must sequence first.
            self._flush_pending()
        fresh: set[str] = set()
        enc = self._encode(row, raw, fresh)
        ops = seqk.make_op_batch([[enc]], 1, 1, self.device)
        self._state, out = _step_one(self._state, row, ops)
        self._host_state = None
        out = _to_numpy(out)
        return self._decode_doc(row, [raw], [enc], out, 0, fresh)[0]

    # -- batched tick path ------------------------------------------------------

    def submit(self, doc_id: str, raw: RawOperation) -> None:
        self._check_timestamp(raw)
        self._pending[self._row(doc_id)].append(raw)

    def flush(self) -> dict[str, list[Ticket]]:
        """Sequence every document's pending ops in one kernel launch and
        return them, together with any tickets buffered by an internal
        flush since the last call."""
        self._flush_pending()
        out, self._ready = self._ready, {}
        return out

    def _flush_pending(self) -> None:
        doc_ids = [d for d in self._rows if self._pending[self._rows[d]]]
        if not doc_ids:
            return
        per_doc_ops = [[] for _ in range(self._capacity)]
        fresh_by_doc: dict[str, set[str]] = {}
        max_k = 1
        for doc_id in doc_ids:
            row = self._rows[doc_id]
            fresh: set[str] = set()
            per_doc_ops[row] = [self._encode(row, raw, fresh)
                                for raw in self._pending[row]]
            fresh_by_doc[doc_id] = fresh
            max_k = max(max_k, len(per_doc_ops[row]))
        ops = seqk.make_op_batch(per_doc_ops, self._capacity,
                                 _next_pow2(max_k), self.device)
        self._state, out = seqc.process_batch_best(self._state, ops)
        self._host_state = None
        # One transfer for the whole tick: the per-op decode below indexes
        # HOST arrays.
        out = _to_numpy(out)
        for doc_id in doc_ids:
            row = self._rows[doc_id]
            self._ready.setdefault(doc_id, []).extend(self._decode_doc(
                row, self._pending[row], per_doc_ops[row], out, row,
                fresh_by_doc[doc_id]))
            self._pending[row] = []

    # -- idle ejection (deli checkIdleClients) ---------------------------------

    def idle_clients(self, now: int,
                     timeout_ms: int | None = None
                     ) -> list[tuple[str, str]]:
        """(doc_id, client_id) pairs idle past the timeout; the service
        injects CLIENT_LEAVE for each. Without an override, each
        document's own timeout applies."""
        out = []
        masks: dict[int, np.ndarray] = {}
        for doc_id, row in self._rows.items():
            t = timeout_ms if timeout_ms is not None else self._timeout_ms[row]
            if t not in masks:
                masks[t] = seqk.find_idle(self._state, now, t).cpu().numpy()
            for client_id, slot in self._slots[row].items():
                if masks[t][row, slot]:
                    out.append((doc_id, client_id))
        return out

    # -- checkpoint / restore ---------------------------------------------------

    def _host_view(self):
        """Full host copy of the device state (one transfer, cached until
        the next device write)."""
        if self._host_state is None:
            self._host_state = _to_numpy(self._state)
        return self._host_state

    def checkpoint(self, doc_id: str,
                   log_offset: int = -1) -> SequencerCheckpoint:
        """Read one document's row from the cached host mirror into the
        durable checkpoint format shared with the scalar sequencer."""
        row = self._rows[doc_id]
        s = seqk.SequencerState(*(a[row] for a in self._host_view()))
        clients = []
        for client_id, slot in sorted(self._slots[row].items()):
            if not bool(s.active[slot]):
                continue
            clients.append({
                "client_id": client_id,
                "client_seq": int(s.cseq[slot]),
                "ref_seq": int(s.cref[slot]),
                "last_update": int(s.clu[slot]),
                "can_evict": bool(s.cevict[slot]),
                "can_summarize": bool(s.csum[slot]),
                "nack": bool(s.cnack[slot]),
            })
        return SequencerCheckpoint(
            sequence_number=int(s.seq),
            minimum_sequence_number=int(s.msn),
            last_sent_msn=int(s.last_sent_msn),
            no_active_clients=not any(np.asarray(s.active)),
            clients=clients,
            nack_future=bool(s.nack_future),
            client_timeout_ms=self._timeout_ms[row],
            log_offset=log_offset,
        )

    def checkpoint_all(self) -> dict[str, SequencerCheckpoint]:
        """Checkpoints for EVERY tracked document off the cached host
        mirror — one device transfer however many documents."""
        self._host_view()
        return {doc_id: self.checkpoint(doc_id) for doc_id in self._rows}

    def restore(self, doc_id: str, cp: SequencerCheckpoint) -> None:
        """Load a checkpoint into a document row, OVERWRITING any live row
        for the document. Writes only the target row on device."""
        if len(cp.clients) > self._alloc_slots:
            self._grow_slots(len(cp.clients))
        row = self._row(doc_id)
        self._slots[row] = {}
        self.membership_gen += 1
        self._pending[row] = []
        self._ready.pop(doc_id, None)
        self._timeout_ms[row] = cp.client_timeout_ms
        lanes = self._alloc_slots + 1
        vals = dict(
            seq=np.int32(cp.sequence_number),
            msn=np.int32(cp.minimum_sequence_number),
            last_sent_msn=np.int32(cp.last_sent_msn),
            nack_future=np.bool_(cp.nack_future),
            active=np.zeros(lanes, np.bool_),
            cseq=np.zeros(lanes, np.int32),
            cref=np.zeros(lanes, np.int32),
            clu=np.zeros(lanes, np.int32),
            csum=np.zeros(lanes, np.bool_),
            cnack=np.zeros(lanes, np.bool_),
            cevict=np.ones(lanes, np.bool_),
        )
        for slot, c in enumerate(cp.clients):
            self._slots[row][c["client_id"]] = slot
            vals["active"][slot] = True
            vals["cseq"][slot] = c["client_seq"]
            vals["cref"][slot] = c["ref_seq"]
            vals["clu"][slot] = c["last_update"]
            vals["csum"][slot] = c["can_summarize"]
            vals["cnack"][slot] = c["nack"]
            vals["cevict"][slot] = c["can_evict"]
        for f, name in zip(self._state, seqk.SequencerState._fields):
            f[row] = torch.as_tensor(vals[name]).to(self.device)
        self._host_state = None

    # -- LocalCollabServer integration -----------------------------------------

    def document_factory(self):
        """A ``sequencer_factory``: each new document gets an adapter
        routing tickets through this host's device batch."""
        def factory() -> "KernelDocumentSequencer":
            doc_id = f"kernel-doc-{self._doc_counter}"
            self._doc_counter += 1
            return KernelDocumentSequencer(self, doc_id)
        return factory


class KernelDocumentSequencer:
    """Per-document adapter with the DocumentSequencer.ticket interface."""

    def __init__(self, host: KernelSequencerHost, doc_id: str) -> None:
        self._host = host
        self._doc_id = doc_id

    def ticket(self, raw: RawOperation) -> Ticket:
        return self._host.sequence(self._doc_id, raw)

    def checkpoint(self, log_offset: int = -1) -> SequencerCheckpoint:
        return self._host.checkpoint(self._doc_id, log_offset)


__all__ = [
    "KernelSequencerHost",
    "KernelDocumentSequencer",
    "DocumentSequencer",
]
