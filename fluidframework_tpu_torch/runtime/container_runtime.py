"""ContainerRuntime — container-level op router, batching, pending replay.

Reference parity: packages/runtime/container-runtime/src/containerRuntime.ts
(``ContainerRuntime``: process:1042 routing {address: dataStoreId} envelopes,
submit:1589, reSubmit:1722, replayPendingStates:989-1027) and
dataStores.ts:274.
"""

from __future__ import annotations

import json
from dataclasses import replace
from typing import TYPE_CHECKING, Any

from ..dds.shared_object import ChannelRegistry, default_registry
from ..protocol.messages import MessageType, SequencedDocumentMessage
from .blob_manager import BlobManager
from .datastore import DataStoreRuntime
from .pending_state import PendingStateManager

if TYPE_CHECKING:  # pragma: no cover
    from .container import Container

# Ops above this serialized size split into CHUNKED_OP pieces — the
# reference's 16KB alfred cap (config.json:38, containerRuntime.ts:1652).
MAX_OP_BYTES = 16 * 1024


class ContainerRuntime:
    def __init__(self, container: "Container",
                 registry: ChannelRegistry | None = None) -> None:
        self.container = container
        self.registry = registry if registry is not None else default_registry()
        self.datastores: dict[str, DataStoreRuntime] = {}
        # Root (aliased) data stores: GC-reachable from "/" even with no
        # stored handle to them (containerRuntime.ts createRootDataStore).
        self.root_datastores: set[str] = set()
        self.pending = PendingStateManager()
        self.blobs = BlobManager(self)
        self.max_op_bytes = MAX_OP_BYTES
        # In-flight chunked-op reassembly, keyed by sender client id
        # (one chunked op in flight per client, containerRuntime.ts rule).
        self._chunks: dict[str, list[str]] = {}
        # Client seqs of ops voided by a lost concurrent-create race: their
        # echoes apply as REMOTE ops (the local state they referenced was
        # replaced by the winner's snapshot) — see process_attach.
        self._voided: set[int] = set()

    # -- data store lifecycle -------------------------------------------------

    def create_datastore(self, datastore_id: str, root: bool = True,
                         attributes: dict | None = None) -> DataStoreRuntime:
        if datastore_id in self.datastores:
            raise ValueError(f"datastore {datastore_id!r} already exists")
        datastore = DataStoreRuntime(datastore_id, self, self.registry,
                                     attributes)
        self.datastores[datastore_id] = datastore
        if root:
            self.root_datastores.add(datastore_id)
        if self.container.attached:
            # Announce to peers (containerRuntime.ts attach message): the
            # snapshot ships the store's channels as of submit time; later
            # channel/DDS ops are sequenced after this and replay on top.
            self._submit_attach(datastore)
        return datastore

    def get_datastore(self, datastore_id: str) -> DataStoreRuntime:
        return self.datastores[datastore_id]

    def resolve_path(self, absolute_path: str):
        """Resolve a handle path: ``/ds`` → DataStoreRuntime,
        ``/ds/channel`` → SharedObject."""
        parts = absolute_path.strip("/").split("/")
        datastore = self.datastores[parts[0]]
        return datastore if len(parts) == 1 else \
            datastore.get_channel(parts[1])

    # -- garbage collection ---------------------------------------------------

    def run_gc(self, datastore_summaries: dict | None = None):
        """Mark-phase GC over stored handle routes (garbageCollector.ts):
        roots = every root data store. Pass already-serialized datastore
        summaries to avoid re-serializing channel state for the graph."""
        from .garbage_collector import run_garbage_collection
        graph: dict[str, list[str]] = {}
        for ds_id, datastore in self.datastores.items():
            summary = None if datastore_summaries is None else \
                datastore_summaries[ds_id]
            graph.update(datastore.get_gc_data(summary))
        roots = [f"/{ds_id}" for ds_id in sorted(self.root_datastores)]
        return run_garbage_collection(graph, roots)

    # -- outbound -------------------------------------------------------------

    def submit_datastore_op(self, datastore_id: str, contents: dict,
                            local_op_metadata: Any) -> None:
        if not self.container.attached:
            return  # detached edits ship via the attach-time snapshot
        envelope = {"address": datastore_id, "contents": contents}
        serialized = json.dumps(envelope, default=list)
        if len(serialized) > self.max_op_bytes:
            self._submit_chunked(envelope, serialized, local_op_metadata)
            return
        # Pending is recorded BEFORE the send: the in-proc server acks
        # re-entrantly. client_seq None = disconnected: the op stays pending
        # (never sent) and is replayed on reconnect (pendingStateManager.ts:56).
        client_seq = self.container.allocate_client_seq()
        self.pending.on_submit(client_seq, envelope, local_op_metadata)
        if client_seq is not None:
            self.container.send_message(
                MessageType.OPERATION, envelope, client_seq)

    def _submit_chunked(self, envelope: dict, serialized: str,
                        local_op_metadata: Any) -> None:
        """Split an oversized op into CHUNKED_OP pieces
        (containerRuntime.ts submitChunkedMessage :1652). Only the FINAL
        chunk carries the pending entry: its ack is the op's ack, and a
        reconnect replays the op whole (re-chunking on the way out)."""
        pieces = [serialized[i:i + self.max_op_bytes]
                  for i in range(0, len(serialized), self.max_op_bytes)]
        total = len(pieces)
        for index, piece in enumerate(pieces):
            final = index == total - 1
            client_seq = self.container.allocate_client_seq()
            if final:
                self.pending.on_submit(client_seq, envelope,
                                       local_op_metadata)
            if client_seq is not None:
                self.container.send_message(
                    MessageType.CHUNKED_OP,
                    {"index": index, "total": total, "data": piece},
                    client_seq)

    def process_chunk(self, message: SequencedDocumentMessage,
                      local: bool) -> None:
        """Reassemble CHUNKED_OP pieces; the final piece processes as a
        normal OPERATION at the final chunk's sequence number."""
        contents = message.contents
        assert message.client_id is not None
        buffer = self._chunks.setdefault(message.client_id, [])
        assert contents["index"] == len(buffer), "chunk disorder"
        buffer.append(contents["data"])
        if len(buffer) < contents["total"]:
            return
        envelope = json.loads("".join(self._chunks.pop(message.client_id)))
        self.process(replace(message, type=MessageType.OPERATION,
                             contents=envelope), local)

    def _submit_attach(self, datastore: DataStoreRuntime,
                       snapshot: dict | None = None) -> None:
        # The snapshot is captured at CREATE time (not resend time): any
        # state added later travels as its own pending ops, which must not
        # also be baked into a replayed attach (or remotes apply it twice).
        contents = {
            "id": datastore.id,
            "root": datastore.id in self.root_datastores,
            "snapshot": datastore.summarize() if snapshot is None
            else snapshot,
        }
        client_seq = self.container.allocate_client_seq()
        # Tracked pending like any op so a disconnected create replays on
        # reconnect; the replay marker is the "attach" type key.
        self.pending.on_submit(
            client_seq, {"type": "attach", **contents}, None)
        if client_seq is not None:
            self.container.send_message(
                MessageType.ATTACH, contents, client_seq)

    def process_attach(self, message: SequencedDocumentMessage,
                       local: bool) -> None:
        if local:
            if message.client_sequence_number in self._voided:
                # Echo of OUR losing create in a concurrent-create race:
                # the winner's snapshot was already adopted; drop it (every
                # remote replica ignores this second attach too).
                self._voided.discard(message.client_sequence_number)
            else:
                self.pending.process_own_message(
                    message.client_sequence_number)
            return
        contents = message.contents
        if contents["id"] in self.datastores:
            # Concurrent create: first sequenced attach wins the state, but
            # the root flag is the OR of all creates (commutative, so every
            # replica converges regardless of arrival order).
            if contents["root"]:
                self.root_datastores.add(contents["id"])
            # If OUR create of this id is still pending, the remote attach
            # is the first-sequenced winner: adopt its snapshot, void our
            # pending attach + ops (their echoes re-apply as remote ops so
            # all replicas process the loser's ops identically). Matches the
            # reference's alias resolution for well-known ids
            # (containerRuntime.ts createRootDataStore / alias ops).
            voided = self.pending.void_datastore(contents["id"])
            if voided:
                self._voided |= voided
                # Adopt in place: held DataStoreRuntime AND channel object
                # references stay valid, with their state reloaded from the
                # winner's snapshot (see DataStoreRuntime.adopt).
                self.datastores[contents["id"]].adopt(contents["snapshot"])
            return
        datastore = DataStoreRuntime(contents["id"], self, self.registry)
        self.datastores[contents["id"]] = datastore
        datastore.load(contents["snapshot"])
        if contents["root"]:
            self.root_datastores.add(contents["id"])

    def void_channel(self, datastore_id: str, channel_id: str) -> bool:
        """Void our pending create of a channel that lost a same-id race
        (see PendingStateManager.void_channel); True if anything voided."""
        voided = self.pending.void_channel(datastore_id, channel_id)
        self._voided |= voided
        return bool(voided)

    def void_channel_ops(self, datastore_id: str, channel_id: str) -> None:
        """Unconditionally void pending ops against a channel whose state is
        being replaced by an adopting attach_channel."""
        self._voided |= self.pending.void_channel_ops(
            datastore_id, channel_id)

    # -- inbound --------------------------------------------------------------

    def process(self, message: SequencedDocumentMessage, local: bool) -> None:
        assert message.type == MessageType.OPERATION
        local_op_metadata = None
        if local:
            if message.client_sequence_number in self._voided:
                # Own op voided by a lost create race: the channel state it
                # was submitted against is gone (replaced by the winner's
                # snapshot) — apply it as a remote op, exactly as every other
                # replica does. The sentinel tells merge engines to exclude
                # local unacked state from visibility despite the author id
                # being our own.
                from ..dds.shared_object import VOIDED_LOCAL_ECHO
                self._voided.discard(message.client_sequence_number)
                local = False
                local_op_metadata = VOIDED_LOCAL_ECHO
            else:
                local_op_metadata = self.pending.process_own_message(
                    message.client_sequence_number)
        envelope = message.contents
        datastore = self.datastores[envelope["address"]]
        datastore.process(
            replace(message, contents=envelope["contents"]),
            local,
            local_op_metadata,
        )

    # -- reconnect ------------------------------------------------------------

    def replay_pending(self) -> None:
        """Resubmit every unacked op through the owning channel so it can
        regenerate/restamp (containerRuntime.ts replayPendingStates)."""
        # Ops pending against still-unadopted channels must not replay (the
        # state they target is provisional — if their adopting
        # attach_channel was sequenced, catch-up delivers it and the old
        # ops as remote ops from our previous identity).
        for datastore in self.datastores.values():
            datastore.void_adoption_pending_ops()
        # Voided ops from a lost create race never echo across a reconnect
        # under the OLD client seqs (client seqs restart with the new
        # connection) — clear so stale entries can't void fresh ops.
        self._voided.clear()
        for item in self.pending.drain_for_replay():
            envelope = item.contents
            if envelope.get("type") == "attach":
                # Re-announce with the ORIGINAL create-time snapshot; the
                # state added since rides the pending ops replayed after us.
                self._submit_attach(self.datastores[envelope["id"]],
                                    snapshot=envelope["snapshot"])
                continue
            datastore = self.datastores[envelope["address"]]
            datastore.resubmit(envelope["contents"], item.local_op_metadata)

    def on_attach(self) -> None:
        for datastore in self.datastores.values():
            for channel in datastore.channels.values():
                channel.on_attach()
        self.blobs.on_attach()

    # -- summary --------------------------------------------------------------

    def summarize(self, unchanged_before: int | None = None) -> dict:
        datastores = {
            datastore_id: datastore.summarize(unchanged_before)
            for datastore_id, datastore in sorted(self.datastores.items())
        }
        gc = self.run_gc(datastores)
        return {
            "datastores": datastores,
            "roots": sorted(self.root_datastores),
            "blobs": self.blobs.summarize(),
            # GC state rides the summary (containerRuntime.ts:1383-1430);
            # unreferenced nodes are reported, not yet swept.
            "gc": {"unreferenced": gc.deleted},
        }

    def load(self, snapshot: dict) -> None:
        for datastore_id, datastore_snapshot in snapshot["datastores"].items():
            datastore = DataStoreRuntime(datastore_id, self, self.registry)
            self.datastores[datastore_id] = datastore
            datastore.load(datastore_snapshot)
        self.root_datastores = set(
            snapshot.get("roots", snapshot["datastores"].keys()))
        self.blobs.load(snapshot.get("blobs"))
