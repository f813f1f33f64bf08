"""PendingStateManager — tracks unacked local ops for ack matching + replay.

Reference parity: packages/runtime/container-runtime/src/
pendingStateManager.ts:56 — local ops are enqueued at submit with their
localOpMetadata; when the server echoes our op back (same clientId), the
front of the queue must match by clientSequenceNumber and yields the metadata
for the local apply; on reconnect the whole queue is replayed through
``ContainerRuntime.reSubmit`` (containerRuntime.ts:989-1027).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True, slots=True)
class PendingMessage:
    client_seq: int
    contents: Any
    local_op_metadata: Any


class PendingStateManager:
    def __init__(self) -> None:
        self._pending: deque[PendingMessage] = deque()

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def has_pending(self) -> bool:
        return bool(self._pending)

    def on_submit(self, client_seq: int, contents: Any,
                  local_op_metadata: Any) -> None:
        self._pending.append(
            PendingMessage(client_seq, contents, local_op_metadata))

    def process_own_message(self, client_seq: int) -> Any:
        """Pop the matching pending entry; returns its localOpMetadata."""
        assert self._pending, "ack for an op we never submitted"
        front = self._pending.popleft()
        assert front.client_seq == client_seq, (
            f"unordered ack: expected clientSeq {front.client_seq}, "
            f"got {client_seq}"
        )
        return front.local_op_metadata

    def _void_matching(self, guard, target) -> set[int]:
        """If any pending entry satisfies ``guard``, remove every entry
        satisfying ``target`` and return their client seqs (else void
        nothing). The voided ops' echoes are applied as remote ops by the
        runtime — see ContainerRuntime._voided."""
        if not any(guard(item.contents) for item in self._pending):
            return set()
        voided: set[int] = set()
        kept: deque[PendingMessage] = deque()
        for item in self._pending:
            if target(item.contents):
                voided.add(item.client_seq)
            else:
                kept.append(item)
        self._pending = kept
        return voided

    @staticmethod
    def _is_datastore_attach(contents: Any, datastore_id: str) -> bool:
        return (contents.get("type") == "attach"
                and contents.get("id") == datastore_id)

    @staticmethod
    def _targets_channel(contents: Any, datastore_id: str,
                         channel_id: str) -> bool:
        if contents.get("type") == "attach":
            return False
        if contents.get("address") != datastore_id:
            return False
        inner = contents.get("contents")
        return isinstance(inner, dict) and inner.get("address") == channel_id

    @staticmethod
    def _is_channel_attach(contents: Any, datastore_id: str,
                           channel_id: str) -> bool:
        return (PendingStateManager._targets_channel(
                    contents, datastore_id, channel_id)
                and contents["contents"].get("type") == "attach_channel")

    def void_datastore(self, datastore_id: str) -> set[int]:
        """If our CREATE (attach) of this data store is still pending, a
        concurrent remote create won the sequencing race: remove the pending
        attach plus every pending op addressed to the store and return their
        client seqs. The runtime replaces the local state with the winner's
        snapshot and, when the voided ops echo back, applies them as remote
        ops (every replica applies them to the winner's state the same way).
        No pending attach → not a race loss (our earlier attach already won)
        → nothing is voided."""
        return self._void_matching(
            lambda c: self._is_datastore_attach(c, datastore_id),
            lambda c: self._is_datastore_attach(c, datastore_id)
            or (c.get("type") != "attach"
                and c.get("address") == datastore_id))

    def void_channel(self, datastore_id: str, channel_id: str) -> set[int]:
        """Channel-level analog of void_datastore: if our CREATE
        (attach_channel) of this channel is still pending, a concurrent
        remote create of the same channel id won the race — void our
        pending attach_channel plus every pending op addressed to the
        channel and return their client seqs."""
        return self._void_matching(
            lambda c: self._is_channel_attach(c, datastore_id, channel_id),
            lambda c: self._targets_channel(c, datastore_id, channel_id))

    def void_channel_ops(self, datastore_id: str, channel_id: str) -> set[int]:
        """Unconditionally void every pending op addressed to the channel
        (no pending-attach guard): used when a channel's state is reloaded
        by an adopting attach_channel — ops recorded against the pre-adopt
        state must echo as remote ops, not local acks."""
        return self._void_matching(
            lambda _c: True,
            lambda c: self._targets_channel(c, datastore_id, channel_id))

    def drain_for_replay(self) -> list[PendingMessage]:
        """Take everything pending (reconnect replay). Queue is emptied; the
        replay re-submits and re-enqueues with fresh client seq numbers."""
        items = list(self._pending)
        self._pending.clear()
        return items
