"""Scalar SharedMap merge engine — per-replica apply with pending-local ops.

Reference parity: packages/dds/map/src/mapKernel.ts (``MapKernel``):
last-writer-wins per key under the total order, with *pending local op
shadowing* for replica-local consistency — a remote op on a key is ignored
while an unacked local op on that key exists, because the local op will
(once sequenced, necessarily later) overwrite it (mapKernel.ts:607-700,
``needProcessKeyOperation``). A pending local clear shadows everything; a
remote clear preserves keys with pending local edits
(``clearExceptPendingKeys``).

Once every replica's local ops are acked, all replicas equal the pure LWW
fold of the sequenced stream — which is exactly what the batched device
kernel :mod:`fluidframework_tpu_torch.ops.map_kernel` computes; the
differential fuzz in tests/test_map.py asserts that equivalence.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


class MapData:
    """The map kernel: data + pending tracking. One per replica per map DDS."""

    def __init__(self) -> None:
        self._data: dict[str, Any] = {}
        # key -> pendingMessageId of the LATEST unacked local op on that key.
        self._pending_keys: dict[str, int] = {}
        self._pending_clear_id: int = -1
        self._next_message_id: int = 0
        # (key, local, previous_value, key_existed) change hooks, fired on
        # every applied op; key_existed disambiguates a stored None.
        self.on_value_changed: list[Callable[[str, bool, Any, bool],
                                             None]] = []
        # (local, previous_items) — previous enables clear-undo.
        self.on_clear: list[Callable[[bool, dict], None]] = []

    # -- reads ---------------------------------------------------------------

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def has(self, key: str) -> bool:
        return key in self._data

    def keys(self) -> Iterator[str]:
        return iter(self._data)

    def items(self) -> Iterator[tuple[str, Any]]:
        return iter(self._data.items())

    def __len__(self) -> int:
        return len(self._data)

    # -- local edits (apply eagerly, return (op, metadata) to submit) --------

    def local_set(self, key: str, value: Any) -> tuple[dict, int]:
        self._set_core(key, value, local=True)
        return {"type": "set", "key": key, "value": value}, self._pend_key(key)

    def local_delete(self, key: str) -> tuple[dict, int]:
        self._delete_core(key, local=True)
        return {"type": "delete", "key": key}, self._pend_key(key)

    def local_clear(self) -> tuple[dict, int]:
        self._clear_core(local=True)
        self._pending_clear_id = self._next_id()
        return {"type": "clear"}, self._pending_clear_id

    def _pend_key(self, key: str) -> int:
        message_id = self._next_id()
        self._pending_keys[key] = message_id
        return message_id

    def _next_id(self) -> int:
        self._next_message_id += 1
        return self._next_message_id

    # -- resubmit on reconnect (sequence.ts reSubmitCore analog) -------------

    def resubmit(self, op: dict, _old_metadata: int) -> tuple[dict, int]:
        """Re-stamp a pending op with a fresh pending id (fresh metadata)."""
        if op["type"] == "clear":
            self._pending_clear_id = self._next_id()
            return op, self._pending_clear_id
        return op, self._pend_key(op["key"])

    # -- sequenced apply ------------------------------------------------------

    def process(self, op: dict, local: bool, local_op_metadata: int | None) -> None:
        kind = op["type"]
        if kind == "clear":
            if local:
                assert local_op_metadata is not None
                if self._pending_clear_id == local_op_metadata:
                    self._pending_clear_id = -1
                return
            if self._pending_keys:
                self._clear_except_pending()
                return
            self._clear_core(local=False)
            return

        if not self._need_process_key_op(op, local, local_op_metadata):
            return
        if kind == "set":
            self._set_core(op["key"], op["value"], local=False)
        elif kind == "delete":
            self._delete_core(op["key"], local=False)
        else:
            raise ValueError(f"unknown map op {kind!r}")

    def _need_process_key_op(
        self, op: dict, local: bool, local_op_metadata: int | None
    ) -> bool:
        if self._pending_clear_id != -1:
            if local:
                assert (
                    local_op_metadata is not None
                    and local_op_metadata < self._pending_clear_id
                ), "out-of-order op under an unacked clear"
                # DELIBERATE FIX vs reference (mapKernel.ts:617-624): the
                # reference drops a local key-op ack under a pending clear
                # WITHOUT removing its pendingKeys entry, so the stale entry
                # shadows remote ops on that key forever and replicas diverge
                # (found by the convergence fuzz). Acked means no longer
                # pending: remove the entry when the ids match.
                key = op["key"]
                if self._pending_keys.get(key) == local_op_metadata:
                    del self._pending_keys[key]
            return False
        key = op["key"]
        if key in self._pending_keys:
            if local:
                assert local_op_metadata is not None
                if self._pending_keys[key] == local_op_metadata:
                    del self._pending_keys[key]
            return False
        return not local

    # -- core mutators --------------------------------------------------------

    def _set_core(self, key: str, value: Any, local: bool) -> None:
        existed = key in self._data
        previous = self._data.get(key)
        self._data[key] = value
        for cb in self.on_value_changed:
            cb(key, local, previous, existed)

    def _delete_core(self, key: str, local: bool) -> bool:
        if key not in self._data:
            return False
        previous = self._data.pop(key)
        for cb in self.on_value_changed:
            cb(key, local, previous, True)
        return True

    def _clear_core(self, local: bool) -> None:
        previous = dict(self._data)
        self._data.clear()
        for cb in self.on_clear:
            cb(local, previous)

    def _clear_except_pending(self) -> None:
        kept = {
            key: self._data[key]
            for key in self._pending_keys
            if key in self._data
        }
        self._data = kept

    def normalize_detached(self) -> None:
        """Detached → attached: detached edits were never submitted, so their
        pending entries will never ack; without this they'd shadow remote ops
        forever. The data itself ships via the attach snapshot."""
        self._pending_keys.clear()
        self._pending_clear_id = -1

    # -- summary --------------------------------------------------------------

    def snapshot(self) -> dict:
        """Converged-content snapshot (pending local state is never summarized)."""
        return {"data": dict(sorted(self._data.items()))}

    @classmethod
    def load(cls, snapshot: dict) -> "MapData":
        data = cls()
        data._data = dict(snapshot["data"])
        return data
