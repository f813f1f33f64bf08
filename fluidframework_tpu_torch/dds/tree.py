"""SharedTree DDS — whole-document tree CRDT with rebase-by-reapplication.

Reference parity: experimental/dds/tree/src/SharedTree.ts:446 (processCore:
append sequenced edit, rebase local edits), Checkout.ts:172 (rebase),
CachingLogViewer (snapshot per revision — here: cached sequenced snapshot +
recomputed local view), and undo via inverse edits.

Edit-log chunking (EditLog.ts:84 editChunks parity, SURVEY §5.7): the full
edit history beyond a tail window seals into fixed-size chunks; sealed
chunk bodies offload to attachment blobs (handles ride the summary) and
are fetched LAZILY — history browsing pays for what it reads, and resident
memory stays bounded no matter how long the document lives.
"""

from __future__ import annotations

import itertools
import json
from typing import Any, Iterator

from ..protocol.messages import SequencedDocumentMessage
from .shared_object import ChannelFactory, SharedObject
from .tree_core import (
    EditLog,
    INVALID,
    ROOT_ID,
    Transaction,
    TreeSnapshot,
    VALID,
    invert_edit,
)


EDITS_PER_CHUNK = 64   # sealed chunk size (EditLog.ts editsPerChunk)
EDIT_TAIL_WINDOW = 64  # unsealed edits kept inline / in summaries


class SharedTree(SharedObject):
    channel_type = "https://graph.microsoft.com/types/tree"

    def __init__(self, channel_id: str, runtime=None, attributes=None) -> None:
        super().__init__(channel_id, runtime, attributes)
        self.log = EditLog()
        self._sequenced_snapshot = TreeSnapshot()
        self._view: TreeSnapshot | None = self._sequenced_snapshot
        self._edit_counter = itertools.count(1)
        # seq -> snapshot BEFORE that sequenced edit (undo support, bounded).
        self._history: dict[str, TreeSnapshot] = {}
        # Edit ids from the summary we loaded (EditLog.getEditLogSummary
        # parity): keeps the summarized id window identical whether a
        # replica replayed the full log or resumed from a snapshot. Empty
        # when the summary carried chunks (they cover the same ids).
        self._prior_edit_ids: list[str] = []
        # Sealed history chunks: {"ids": [...], "edits": [...]} inline or
        # {"ids": [...], "blob": <blob id>} offloaded (fetched lazily).
        self._sealed_chunks: list[dict] = []
        # Unsealed full records loaded from the summary's edit_tail.
        self._loaded_tail: list[dict] = []

    # -- views ----------------------------------------------------------------

    @property
    def current_view(self) -> TreeSnapshot:
        """Sequenced state + local pending edits reapplied (rebase)."""
        if self._view is None:
            view = self._sequenced_snapshot
            for edit in self.log.local:
                txn = Transaction(view)
                if txn.apply_edit(edit) == VALID:
                    view = txn.snapshot
            self._view = view
        return self._view

    # -- edit builders (typed convenience API) ---------------------------------

    def _next_edit_id(self) -> str:
        container = (self.runtime.parent.container
                     if self.runtime is not None else None)
        owner = (container.client_id or "detached") if container else "detached"
        return f"{owner}-e{next(self._edit_counter)}"

    def apply_edit(self, changes: list[dict]) -> str:
        """Submit an edit (a list of changes applied atomically)."""
        edit = {"id": self._next_edit_id(), "changes": changes}
        self.log.add_local(edit)
        self._view = None
        self.submit_local_message({"type": "edit", "edit": edit})
        return edit["id"]

    def insert_node(self, spec: dict, destination: dict) -> str:
        build_id = f"b-{spec['id']}"
        return self.apply_edit([
            {"type": "build", "source": [spec], "destination": build_id},
            {"type": "insert", "source": build_id,
             "destination": destination},
        ])

    def move_range(self, source_range: dict, destination: dict) -> str:
        detach_id = f"m-{next(self._edit_counter)}"
        return self.apply_edit([
            {"type": "detach", "source": source_range,
             "destination": detach_id},
            {"type": "insert", "source": detach_id,
             "destination": destination},
        ])

    def delete_range(self, source_range: dict) -> str:
        return self.apply_edit([
            {"type": "detach", "source": source_range}])

    def set_payload(self, node_id: str, payload: Any) -> str:
        return self.apply_edit([
            {"type": "set_value", "node": node_id, "payload": payload}])

    def undo(self, edit_id: str) -> str | None:
        """Submit the inverse of a previously *sequenced* edit."""
        before = self._history.get(edit_id)
        found = self._find_edit(edit_id)
        if before is None or found is None or found[1] != VALID:
            return None
        inverse = invert_edit(found[0], before)
        if inverse is None:
            return None
        self.log.add_local(inverse)
        self._view = None
        self.submit_local_message({"type": "edit", "edit": inverse})
        return inverse["id"]

    # -- SharedObject contract ------------------------------------------------

    def process_core(self, message: SequencedDocumentMessage, local: bool,
                     local_op_metadata: Any) -> None:
        edit = message.contents["edit"]
        if local:
            front = self.log.ack_front_local()
            assert front["id"] == edit["id"], "out-of-order tree ack"
        self._history[edit["id"]] = self._sequenced_snapshot
        txn = Transaction(self._sequenced_snapshot)
        validity = txn.apply_edit(edit)
        if validity == VALID:
            self._sequenced_snapshot = txn.snapshot
        self.log.add_sequenced(edit, message.sequence_number, validity)
        self._view = None  # local edits rebase onto the new sequenced state
        # Bound history to the collab window (minSeq advance ~ zamboni).
        if len(self._history) > 256:
            for edit_id in list(self._history)[:64]:
                del self._history[edit_id]
        self._maybe_seal()

    # -- edit-log chunking (EditLog.ts:84) -------------------------------------

    def _find_edit(self, edit_id: str) -> tuple[dict, str] | None:
        """(edit, validity) for a known sequenced edit — live entries
        first, then the loaded tail, then sealed chunks (only the chunk
        whose id list matches is fetched)."""
        for entry in self.log.sequenced:
            if entry.edit["id"] == edit_id:
                return entry.edit, entry.validity
        candidates = itertools.chain(
            self._loaded_tail,
            *(self._chunk_records(c) for c in self._sealed_chunks
              if edit_id in c["ids"]))
        for record in candidates:
            if record["id"] == edit_id:
                return ({"id": record["id"], "changes": record["changes"]},
                        record.get("validity", VALID))
        return None

    def _chunk_records(self, chunk: dict) -> list[dict]:
        if "edits" in chunk:
            return chunk["edits"]
        data = self._blob_manager().read(chunk["blob"])
        return json.loads(data.decode())

    def _unsealed_records(self) -> list[dict]:
        return self._loaded_tail + [
            {"id": e.edit["id"], "changes": e.edit["changes"],
             "validity": e.validity}
            for e in self.log.sequenced]

    def _maybe_seal(self) -> None:
        """Seal full chunks off the front of the unsealed window; offload
        their bodies to a blob when a blob manager is reachable."""
        while (len(self._loaded_tail) + len(self.log.sequenced)
               >= EDITS_PER_CHUNK + EDIT_TAIL_WINDOW):
            records = []
            while len(records) < EDITS_PER_CHUNK and self._loaded_tail:
                records.append(self._loaded_tail.pop(0))
            while len(records) < EDITS_PER_CHUNK:
                entry = self.log.sequenced.pop(0)
                records.append({"id": entry.edit["id"],
                                "changes": entry.edit["changes"],
                                "validity": entry.validity})
            chunk: dict = {"ids": [r["id"] for r in records]}
            blob_id = self._offload(records)
            if blob_id is not None:
                chunk["blob"] = blob_id
            else:
                chunk["edits"] = records
            self._sealed_chunks.append(chunk)

    def _blob_manager(self):
        datastore = self.runtime
        container_runtime = getattr(datastore, "parent", None)
        return getattr(container_runtime, "blobs", None)

    def _offload(self, records: list[dict]) -> str | None:
        blobs = self._blob_manager()
        if blobs is None:
            return None
        try:
            handle = blobs.upload_blob(
                json.dumps(records, sort_keys=True).encode())
        except Exception:
            return None  # storage unreachable: keep the chunk inline
        return handle.blob_id

    def edit_history(self) -> Iterator[dict]:
        """Full edit records, oldest first — sealed chunks fetch their blob
        on demand (the lazy editChunks read path)."""
        for chunk in self._sealed_chunks:
            yield from self._chunk_records(chunk)
        yield from self._unsealed_records()

    def history_ids(self) -> list[str]:
        """Every known edit id WITHOUT fetching any chunk bodies."""
        ids = list(self._prior_edit_ids)
        for chunk in self._sealed_chunks:
            ids.extend(chunk["ids"])
        ids.extend(r["id"] for r in self._unsealed_records())
        return ids

    def resubmit_core(self, contents: Any, metadata: Any) -> None:
        # Stable ids anchor the edit; it is resubmitted unchanged and
        # re-validated at its new sequence point.
        self.submit_local_message(contents, metadata)

    def on_attach(self) -> None:
        # Detached edits fold into the baseline snapshot.
        view = self.current_view
        self._sequenced_snapshot = view
        self.log = EditLog()
        self._view = view
        self._prior_edit_ids = []
        self._sealed_chunks = []
        self._loaded_tail = []

    def summarize_core(self) -> dict:
        self._maybe_seal()
        out: dict = {
            "tree": self._sequenced_snapshot.serialize(),
            "edit_ids": self.history_ids()[-64:],
        }
        if self._sealed_chunks:
            # Chunked form only once history outgrew the tail window —
            # short-lived documents keep the original compact summary.
            out["edit_chunks"] = [dict(c) for c in self._sealed_chunks]
            out["edit_tail"] = self._unsealed_records()
        return out

    def load_core(self, content: dict) -> None:
        self._sequenced_snapshot = TreeSnapshot.load(content["tree"])
        self._view = self._sequenced_snapshot
        self.log = EditLog()
        self._sealed_chunks = [dict(c) for c in
                               content.get("edit_chunks", ())]
        self._loaded_tail = list(content.get("edit_tail", ()))
        # A chunked summary's ids are covered by its chunks + tail; only an
        # unchunked one contributes bare prior ids.
        self._prior_edit_ids = (
            [] if self._sealed_chunks or self._loaded_tail
            else list(content.get("edit_ids", ())))

    def apply_stashed_op(self, contents: Any) -> Any:
        self.log.add_local(contents["edit"])
        self._view = None
        return None


class SharedTreeFactory(ChannelFactory):
    channel_type = SharedTree.channel_type
    shared_object_cls = SharedTree
