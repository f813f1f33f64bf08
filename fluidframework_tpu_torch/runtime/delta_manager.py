"""DeltaManager — the loader-layer transport engine for one container.

Reference parity: packages/loader/container-loader/src/deltaManager.ts:147
(inbound/outbound/inboundSignal DeltaQueues :197-199, sequence-gap detection
+ fetchMissingDeltas :1298-1360, connect/disconnect lifecycle :566-692,
readonly mode) — reshaped for a synchronous in-proc client: queues drain
eagerly on the pushing thread; pausing is the deterministic-interleaving
primitive tests use (test-utils OpProcessingController).

Gap handling: the live stream may skip sequence numbers (dropped socket
messages, reconnect races). Out-of-order arrivals park in ``_parked`` and a
catch-up read from delta storage fills the hole; duplicates (seq already
queued) drop silently. ``DataCorruptionError`` fires when the same seq
arrives twice with different payloads (deltaManager.ts:1336-1346).
"""

from __future__ import annotations

from typing import Any, Callable

from ..drivers.base import DocumentService
from ..protocol.messages import (
    DocumentMessage,
    MessageType,
    SequencedDocumentMessage,
)
from .delta_queue import DeltaQueue, DeltaScheduler


class DataCorruptionError(Exception):
    """Same sequence number delivered twice with different payloads."""


class FlushMode:
    """Outbound batching mode (containerRuntime.ts FlushMode)."""

    IMMEDIATE = "immediate"  # every submit flushes (reference Automatic)
    MANUAL = "manual"        # accumulate until flush() (orderSequentially)


class DeltaManager:
    """Inbound/outbound op pump between a driver connection and a handler."""

    #: Own echoed-but-not-proven-durable ops retained for reconnect
    #: resubmission. Bounded: the crash race lives at the stream tip (the
    #: per-op path journals before broadcasting; the storm path fsyncs
    #: before acking), so ops far behind the tip are durable in every
    #: non-pathological run — the oldest entry drops when the window
    #: overflows rather than growing with session length.
    RESUBMIT_WINDOW = 1024

    def __init__(
        self,
        service: DocumentService,
        process_message: Callable[[SequencedDocumentMessage], None],
        process_signal: Callable[[Any], None] | None = None,
        on_nack: Callable[[Any], None] | None = None,
        on_lost_ops: Callable[[list[SequencedDocumentMessage]], None]
        | None = None,
    ) -> None:
        self._service = service
        self._connection: Any = None
        self.client_id: str | None = None
        self.client_seq = 0
        self.last_processed_seq = 0   # seq of last message run through handler
        self.last_queued_seq = 0      # seq of last message accepted inbound
        # Acknowledged-durability watermark: the highest SEQUENCE NUMBER
        # the service has proven durable. Everything read back from delta
        # storage is durable by definition (it came from the journal).
        # NOTE the storm ack's "dw" field is a TICK-count watermark, not
        # a seq — a storm-aware host must feed note_durable with the
        # ack's per-doc last_seq once "dw" covers the tick, never "dw"
        # itself. A live broadcast above the watermark may still be lost
        # to a server crash — which is why own echoed ops stay in
        # _undurable until the watermark passes them.
        self.last_durable_seq = 0
        # Own ops echoed back (acked) but not yet known durable, oldest
        # first: the resubmit-on-reconnect candidates after a server
        # crash loses acked-but-unfsynced ops.
        self._undurable_own: list[SequencedDocumentMessage] = []
        self._on_lost_ops = on_lost_ops
        self.flush_mode = FlushMode.IMMEDIATE
        self._parked: dict[int, SequencedDocumentMessage] = {}
        self._fetching = False
        self._read_mode = False

        # Long inbound catch-ups yield through the scheduler
        # (deltaScheduler.ts:25): hosts register on_yield callbacks.
        self.scheduler = DeltaScheduler()
        self.inbound: DeltaQueue[SequencedDocumentMessage] = DeltaQueue(
            self._process_inbound, scheduler=self.scheduler)
        self.outbound: DeltaQueue[list[DocumentMessage]] = DeltaQueue(
            self._send_batch)
        self.inbound_signal: DeltaQueue[Any] = DeltaQueue(
            process_signal if process_signal is not None else lambda _s: None)
        self._process_message = process_message
        self._on_nack_cb = on_nack
        self._batch: list[DocumentMessage] = []

    # -- connection lifecycle --------------------------------------------------

    @property
    def connected(self) -> bool:
        return self._connection is not None

    @property
    def readonly(self) -> bool:
        """True in read mode AND while the connection is down — readonly
        degradation is the offline contract (deltaManager.ts readonly):
        a disconnected container reads its local state but cannot claim
        client seqs until the transport is back."""
        return self._read_mode or self._connection is None

    def handle_connection_lost(self) -> None:
        """Transport-level disconnect (dead socket, server kill): degrade
        to disconnected/readonly WITHOUT the disconnect RPC — there is no
        live socket to send it on. Pending local ops stay stashed for the
        post-reconnect replay; own echoed-but-unproven ops stay in the
        resubmit ring (the durability-watermark probe on the next
        connect() decides what the crashed server lost)."""
        if self._connection is None:
            return
        self._connection.open = False  # poison further submits locally
        self._teardown_session()

    def catch_up_to(self, to_seq: int) -> None:
        """Process stored deltas up to ``to_seq`` while still offline —
        the staging step of offline-resume: stashed ops re-apply at their
        original reference point, between this and connect()."""
        assert self._connection is None, "already connected"
        for message in self._service.delta_storage.get_deltas(
                self.last_queued_seq, to_seq):
            self.note_durable(message.sequence_number)
            self._accept(message)
        self.inbound.resume()  # drain exactly what was accepted
        self.inbound.pause()

    def note_durable(self, seq: int) -> None:
        """Advance the acknowledged-durability watermark (storage reads
        and service "dw" acks both feed this) and retire own echoed ops
        the service has now proven durable."""
        if seq <= self.last_durable_seq:
            return
        self.last_durable_seq = seq
        while (self._undurable_own
               and self._undurable_own[0].sequence_number <= seq):
            self._undurable_own.pop(0)

    def _check_lost_ops(self) -> None:
        """Resubmit-on-reconnect against the durability watermark: own
        ops that were ECHOED (acked) but never proven durable may have
        died with the server. Probe storage for them; any op the
        recovered journal does not hold is lost — hand it to the
        ``on_lost_ops`` hook (the runtime resubmits through its own
        channels, regenerating refs/clientSeqs) rather than silently
        converging without it."""
        if not self._undurable_own:
            return
        lo = self._undurable_own[0].sequence_number - 1
        hi = self._undurable_own[-1].sequence_number
        fetched = self._service.delta_storage.get_deltas(lo, hi)
        # Identity match, NOT bare sequence number: a recovered server
        # resumes numbering from its durable tip, so a seq our lost op
        # once held may now belong to ANOTHER client's post-crash
        # submission — which must not mask the loss.
        held = {(m.client_id, m.client_sequence_number) for m in fetched}
        lost = [m for m in self._undurable_own
                if (m.client_id, m.client_sequence_number) not in held]
        self._undurable_own = []
        if fetched:
            # The journal is seq-contiguous: holding N proves 1..N.
            self.last_durable_seq = max(self.last_durable_seq,
                                        fetched[-1].sequence_number)
        if lost and self._on_lost_ops is not None:
            self._on_lost_ops(lost)

    def connect(self, mode: str = "write") -> str:
        """Catch up from delta storage, then go live. Returns the client id.

        Catch-up ops and the live stream both land in the (paused) inbound
        queue in seq order; overlap dedupes by sequence number.
        """
        assert self._connection is None, "already connected"
        self._read_mode = mode == "read"
        self._check_lost_ops()
        for message in self._service.delta_storage.get_deltas(
                self.last_queued_seq):
            self.note_durable(message.sequence_number)
            self._accept(message)
        connection = self._service.connect(
            self._enqueue_messages,
            on_nack=self._handle_nack,
            on_signal=self.inbound_signal.push,
            mode=mode,
        )
        self._connection = connection
        self.client_id = connection.client_id
        self.client_seq = 0
        self.inbound.resume()
        self.outbound.resume()
        self.inbound_signal.resume()
        return connection.client_id

    def disconnect(self) -> None:
        if self._connection is None:
            return
        self._connection.close()
        self._teardown_session()

    def _teardown_session(self) -> None:
        """Shared tail of disconnect()/handle_connection_lost(): forget
        the connection and park the queues (the two paths differ only in
        whether the transport could carry a goodbye)."""
        self._connection = None
        self.client_id = None
        self._batch = []
        self.outbound.clear()  # stale clientSeqs; pending ops resubmit fresh
        self.inbound.pause()
        self.outbound.pause()
        self.inbound_signal.pause()

    # -- inbound: dedupe, order, gap-fetch -------------------------------------

    def _enqueue_messages(self,
                          messages: list[SequencedDocumentMessage]) -> None:
        for message in messages:
            self._accept(message)
        if self._parked and not self._fetching:
            self._fetch_missing()

    def _accept(self, message: SequencedDocumentMessage) -> None:
        seq = message.sequence_number
        if seq <= self.last_queued_seq:
            return  # duplicate from catch-up overlap / rebroadcast
        if seq == self.last_queued_seq + 1:
            self.last_queued_seq = seq
            self.inbound.push(message)
            # Unpark any directly-following messages.
            while self.last_queued_seq + 1 in self._parked:
                nxt = self._parked.pop(self.last_queued_seq + 1)
                self.last_queued_seq = nxt.sequence_number
                self.inbound.push(nxt)
            return
        # Gap: park and (re)fetch the hole from durable storage.
        parked = self._parked.get(seq)
        if parked is not None and parked != message:
            raise DataCorruptionError(
                f"two different messages for seq {seq}")
        self._parked[seq] = message

    def _fetch_missing(self) -> None:
        """Read the hole [last_queued+1, first_parked) from delta storage
        (deltaManager.ts fetchMissingDeltas → enqueueMessages)."""
        self._fetching = True
        try:
            while self._parked:
                first_parked = min(self._parked)
                if first_parked <= self.last_queued_seq + 1:
                    # Hole already closed by unparking.
                    while self.last_queued_seq + 1 in self._parked:
                        nxt = self._parked.pop(self.last_queued_seq + 1)
                        self.last_queued_seq = nxt.sequence_number
                        self.inbound.push(nxt)
                    # Drop any parked duplicates below the watermark.
                    for seq in [s for s in self._parked
                                if s <= self.last_queued_seq]:
                        del self._parked[seq]
                    continue
                fetched = self._service.delta_storage.get_deltas(
                    self.last_queued_seq, first_parked - 1)
                progressed = False
                for message in fetched:
                    before = self.last_queued_seq
                    self._accept(message)
                    progressed |= self.last_queued_seq > before
                if not progressed:
                    # Storage doesn't have the hole yet (broadcast raced the
                    # durable write); leave messages parked — the next
                    # delivery retries the fetch.
                    return
        finally:
            self._fetching = False

    def _process_inbound(self, message: SequencedDocumentMessage) -> None:
        if message.sequence_number <= self.last_processed_seq:
            return
        assert message.sequence_number == self.last_processed_seq + 1, (
            f"inbound queue disorder: got {message.sequence_number}, "
            f"expected {self.last_processed_seq + 1}")
        self.last_processed_seq = message.sequence_number
        if (message.client_id is not None
                and message.client_id == self.client_id
                and message.type == MessageType.OPERATION
                and message.sequence_number > self.last_durable_seq):
            # Own op echoed from a LIVE broadcast: acked, but the service
            # has not yet proven it durable — keep it resubmittable until
            # the watermark passes it (see _check_lost_ops).
            if len(self._undurable_own) >= self.RESUBMIT_WINDOW:
                self._undurable_own.pop(0)
            self._undurable_own.append(message)
        self._process_message(message)

    def _handle_nack(self, nack: Any) -> None:
        if self._on_nack_cb is not None:
            self._on_nack_cb(nack)

    # -- outbound --------------------------------------------------------------

    def allocate_client_seq(self) -> int | None:
        """Claim the next clientSequenceNumber, or None when disconnected.
        Callers record pending state against it BEFORE submit — the ack may
        arrive re-entrantly during the send (in-proc server)."""
        if self._connection is None or self._read_mode:
            return None
        self.client_seq += 1
        return self.client_seq

    def submit(self, mtype: MessageType, contents: Any,
               client_seq: int) -> None:
        assert not self._read_mode, "submit on a read-only connection"
        message = DocumentMessage(
            client_sequence_number=client_seq,
            reference_sequence_number=self.last_processed_seq,
            type=mtype,
            contents=contents,
        )
        self._batch.append(message)
        if self.flush_mode == FlushMode.IMMEDIATE:
            self.flush()

    def flush(self) -> None:
        if not self._batch:
            return
        batch, self._batch = self._batch, []
        self.outbound.push(batch)

    def _send_batch(self, batch: list[DocumentMessage]) -> None:
        assert self._connection is not None, "outbound drain while disconnected"
        self._connection.submit(batch)

    def submit_signal(self, content: Any) -> None:
        assert self._connection is not None, "signal while disconnected"
        self._connection.signal(content)


class AutoReconnector:
    """Automatic reconnect with exponential backoff + jitter for a
    DeltaManager over a re-dialable transport (drivers exposing
    ``reconnect()``, e.g. NetworkDocumentService).

    On the service's "disconnect" event the DeltaManager degrades to
    disconnected/readonly immediately (handle_connection_lost), then the
    retry loop re-dials on a
    :class:`~fluidframework_tpu_torch.drivers.utils.ReconnectPolicy` schedule —
    honoring server ``retry_after_s`` hints from busy-nacks, so a
    reconnect storm self-spreads under the admission limit instead of
    hammering the front door. A successful connect() runs the usual
    catch-up + durability-watermark probe, then ``on_reconnected`` (the
    container replays pending ops there).

    ``spawn_thread=False`` leaves the loop to the caller (deterministic
    tests / simulations drive :meth:`run` with a fake sleep).
    """

    def __init__(self, delta_manager: DeltaManager, service,
                 policy=None, mode: str = "write",
                 max_attempts: int = 64,
                 sleep=None,
                 on_reconnected: Callable[[str], None] | None = None,
                 on_gave_up: Callable[[], None] | None = None,
                 spawn_thread: bool = True) -> None:
        import time

        from ..drivers.utils import ReconnectPolicy
        self.delta_manager = delta_manager
        self.service = service
        self.policy = policy if policy is not None else ReconnectPolicy()
        self.mode = mode
        self.max_attempts = max_attempts
        self.on_reconnected = on_reconnected
        # Fired (once per exhausted loop) when max_attempts runs out —
        # in spawned-thread mode the ConnectionError below dies with the
        # daemon thread, so this hook (plus the `gave_up` flag) is the
        # application's only signal that redialing was abandoned.
        self.on_gave_up = on_gave_up
        self.gave_up = False
        self._sleep = sleep if sleep is not None else time.sleep
        self._spawn_thread = spawn_thread
        # One redial loop at a time: a disconnect fired DURING a redial
        # (the fresh socket dying mid-connect) must not start a second
        # loop racing the first through the driver's reconnect().
        import threading
        self._run_guard = threading.Lock()
        # Set by every disconnect, cleared when a redial loop takes over:
        # a disconnect landing in the tail of a finishing run() (after
        # its connect succeeded, before the guard released) must not be
        # dropped — the finishing loop re-spawns if this is still set.
        self._redial_needed = False
        self.disconnects = 0
        self.attempts = 0  # attempts spent on the LAST successful redial
        service.events.on("disconnect", self._on_disconnect)

    def _on_disconnect(self) -> None:
        # Runs on the driver's dispatcher thread (holding dispatch_lock):
        # degrade NOW, retry elsewhere — the redial loop does RPCs that
        # need this thread free.
        self.delta_manager.handle_connection_lost()
        self.disconnects += 1
        self._redial_needed = True
        self._maybe_spawn()

    def _maybe_spawn(self) -> None:
        if self._spawn_thread and not self._run_guard.locked():
            import threading
            threading.Thread(target=self.run, daemon=True).start()

    def run(self) -> str | None:
        """The redial loop; returns the new client id, None when another
        loop already holds the redial (it will finish the job) or the
        connection is already back, or raises after ``max_attempts``.
        Connection refusals retry; throttling nacks retry after honoring
        the server's hint; non-retriable driver errors (auth)
        propagate."""
        from ..drivers.utils import DriverError
        if not self._run_guard.acquire(blocking=False):
            return None  # a concurrent loop is already redialing
        try:
            self._redial_needed = False
            if self.delta_manager.connected:
                return self.delta_manager.client_id  # nothing to redial
            retry_hint: float | None = None
            for attempt in range(self.max_attempts):
                self._sleep(self.policy.next_delay(attempt, retry_hint))
                retry_hint = None
                try:
                    # Re-dial only a DEAD transport: a connect refused by
                    # admission (throttled) arrives over a healthy fresh
                    # socket — tearing it down per retry would multiply
                    # front-door handshake churn by the attempt count,
                    # the very load the admission ladder bounds.
                    if getattr(self.service, "closed", True):
                        self.service.reconnect()
                    client_id = self.delta_manager.connect(self.mode)
                except DriverError as err:
                    if not err.can_retry:
                        # Auth-class failure: redialing cannot help. In
                        # spawned-thread mode the raise dies with the
                        # daemon thread, so signal abandonment first.
                        self.gave_up = True
                        if self.on_gave_up is not None:
                            self.on_gave_up()
                        raise
                    retry_hint = err.retry_after_s
                    continue
                except (ConnectionError, OSError):
                    continue  # server still down; back off further
                self.attempts = attempt + 1
                self.gave_up = False
                if self.on_reconnected is not None:
                    self.on_reconnected(client_id)
                return client_id
            self.gave_up = True
            if self.on_gave_up is not None:
                self.on_gave_up()
            raise ConnectionError(
                f"reconnect gave up after {self.max_attempts} attempts")
        finally:
            self._run_guard.release()
            if self._redial_needed:
                # A disconnect raced the tail of this loop: pick it up.
                self._maybe_spawn()
