"""DataStoreRuntime — hosts named channels (DDS instances).

Reference parity: packages/runtime/datastore/src/dataStoreRuntime.ts:98
(``FluidDataStoreRuntime``: createChannel:370, process:499 routing the
envelope {address: channelId, contents} to the channel, channel summaries)
and channelDeltaConnection.ts:39.
"""

from __future__ import annotations

from dataclasses import replace
from typing import TYPE_CHECKING, Any

from ..dds.shared_object import ChannelRegistry, SharedObject
from ..protocol.messages import SequencedDocumentMessage

if TYPE_CHECKING:  # pragma: no cover
    from .container_runtime import ContainerRuntime


class ChannelDeltaConnection:
    """The submit/process pipe between one channel and its data store."""

    def __init__(self, datastore: "DataStoreRuntime", channel_id: str) -> None:
        self._datastore = datastore
        self._channel_id = channel_id

    def submit(self, contents: Any, local_op_metadata: Any) -> None:
        self._datastore.submit_channel_op(
            self._channel_id, contents, local_op_metadata)


class DataStoreRuntime:
    def __init__(self, datastore_id: str, parent: "ContainerRuntime",
                 registry: ChannelRegistry,
                 attributes: dict | None = None) -> None:
        self.id = datastore_id
        self.parent = parent
        self.registry = registry
        self.channels: dict[str, SharedObject] = {}
        # Snapshot-loaded channels realize LAZILY on first access
        # (remoteChannelContext.ts:203's lazy realization): until then the
        # stored snapshot (possibly a virtualized blob stub —
        # drivers/virtualized_driver.py) IS the channel's state. Keyed by
        # channel id; values are channel snapshots or virtual stubs.
        self._unrealized: dict[str, dict] = {}

        # Persisted metadata, e.g. {"type": <data-object type>} — what the
        # reference stores as the data store's package path so the right
        # DataObject class re-instantiates on load (dataStoreContext.ts).
        self.attributes: dict = attributes or {}
        # Channel ids created by ops voided in a lost concurrent-create
        # race: the first-sequenced attach_channel to arrive (the winner's,
        # or our own voided echo) reloads its snapshot into the existing
        # object in place. See adopt()/process().
        self._adoption_pending: set[str] = set()

    @property
    def handle(self):
        """A serializable FluidHandle to this data store."""
        from .handles import FluidHandle
        return FluidHandle(f"/{self.id}", self.resolve_path)

    def resolve_path(self, absolute_path: str):
        """Resolve ``/ds`` or ``/ds/channel`` via the container runtime."""
        return self.parent.resolve_path(absolute_path)

    def get_gc_data(self, summary: dict | None = None) -> dict[str, list[str]]:
        """GC graph fragment: this store's node (implicit edges to its
        channels) + each channel's node (its stored handle routes). Pass an
        already-built ``summarize()`` result to scan it instead of
        re-serializing channel state."""
        from .handles import collect_handle_routes
        from ..protocol.summary import is_handle
        live = [cid for cid in (set(self.channels) | set(self._unrealized))
                if cid not in self._adoption_pending]
        graph = {f"/{self.id}": [f"/{self.id}/{cid}"
                                 for cid in sorted(live)]}
        for channel_id in sorted(live):
            if channel_id in self._unrealized:
                # Routes come from the stored snapshot content — no
                # realization needed (a virtual stub resolves once, then
                # memoizes; GC runs on the summarizer, where the first
                # fetch is warranted).
                snap = self._stored_snapshot(channel_id)
                graph[f"/{self.id}/{channel_id}"] = collect_handle_routes(
                    snap["content"])
                continue
            channel = self.channels[channel_id]
            node = None if summary is None else \
                summary["channels"][channel_id]
            from ..drivers.virtualized_driver import is_virtual_stub
            if node is not None and not is_handle(node) \
                    and not is_virtual_stub(node):
                routes = collect_handle_routes(node["content"])
                # Seed the dirty-bit cache from the inline content so the
                # NEXT (incremental) summary's GC pass costs nothing for
                # this channel if it stays unchanged.
                channel._gc_cache = (channel.last_changed_seq, routes)
            else:
                # Handle stub (unchanged channel): routes come from the
                # channel's dirty-bit cache, not a re-serialization.
                routes = channel.gc_routes()
            graph[f"/{self.id}/{channel_id}"] = routes
        return graph

    # -- channel lifecycle ----------------------------------------------------

    def create_channel(self, channel_id: str, channel_type: str) -> SharedObject:
        if channel_id in self.channels or channel_id in self._unrealized:
            raise ValueError(f"channel {channel_id!r} already exists")
        channel = self.registry.get(channel_type).create(self, channel_id)
        self._bind(channel)
        if self.parent.container.attached:
            # Announce the new channel to peers (dataStoreRuntime.ts:405
            # bindChannel → attach op carrying the channel snapshot).
            self.parent.submit_datastore_op(
                self.id,
                {"type": "attach_channel", "address": channel_id,
                 "snapshot": channel.summarize()},
                None,
            )
        return channel

    def get_channel(self, channel_id: str) -> SharedObject:
        if channel_id in self._unrealized:
            self._realize(channel_id)
        return self.channels[channel_id]

    def channel_ids(self) -> list[str]:
        """Every channel id, realized or lazy (access via get_channel)."""
        return sorted(set(self.channels) | set(self._unrealized))

    def _unrealized_type(self, channel_id: str) -> str:
        """A lazy channel's DDS type WITHOUT realizing (stubs carry it)."""
        from ..drivers.virtualized_driver import VIRTUAL_KEY, is_virtual_stub
        snap = self._unrealized[channel_id]
        if is_virtual_stub(snap):
            return snap[VIRTUAL_KEY].get("type", "")
        return snap["attributes"]["type"]

    def channel_type(self, channel_id: str) -> str:
        """A channel's DDS type string without forcing realization — the
        public filter surface for agents/tools walking documents."""
        if channel_id in self._unrealized:
            return self._unrealized_type(channel_id)
        return self.channels[channel_id].attributes.get("type", "")

    def realize_membership_sensitive(self) -> None:
        """Realize lazy channels whose type reacts to quorum membership
        (e.g. consensus collections releasing a departed client's leases)
        — they must observe client-leave events even if the app never
        touched them."""
        for channel_id in list(self._unrealized):
            try:
                cls = self.registry.get(
                    self._unrealized_type(channel_id)).shared_object_cls
            except KeyError:
                continue
            if hasattr(cls, "on_client_leave"):
                self._realize(channel_id)

    def _stored_snapshot(self, channel_id: str) -> dict:
        """A lazy channel's full snapshot; a virtualized stub resolves
        ONCE and the resolution is memoized back into the store (the
        content cannot change while unrealized), so repeated GC/summary
        passes cost no further blob fetches."""
        from ..drivers.virtualized_driver import is_virtual_stub
        snapshot = self._unrealized[channel_id]
        if is_virtual_stub(snapshot):
            resolver = getattr(self.parent.container, "snapshot_resolver",
                               None)
            if resolver is None:
                raise KeyError(
                    "virtualized channel snapshot with no blob resolver")
            snapshot = resolver(snapshot)
            self._unrealized[channel_id] = snapshot
        return snapshot

    def _realize(self, channel_id: str) -> None:
        """First access to a snapshot-loaded channel: resolve its (maybe
        virtualized) snapshot and construct the live object. The lazy
        entry is removed only after construction SUCCEEDS — a failed
        load (unknown type, bad snapshot) must keep the channel visible
        to channel_ids()/summarize(), exactly as the eager path failed
        loudly without losing data."""
        snapshot = self._stored_snapshot(channel_id)
        channel_type = snapshot["attributes"]["type"]
        channel = self.registry.get(channel_type).load(
            self, channel_id, snapshot)
        self._bind(channel)
        self._unrealized.pop(channel_id)
        # last_changed_seq stays at the construction default, exactly as
        # the eager load path leaves it — summaries must not depend on
        # WHEN a replica realized a channel.

    def _bind(self, channel: SharedObject) -> None:
        self.channels[channel.id] = channel
        channel.bind_connection(ChannelDeltaConnection(self, channel.id))

    # -- op plumbing ---------------------------------------------------------

    def submit_channel_op(self, channel_id: str, contents: Any,
                          local_op_metadata: Any) -> None:
        self.parent.submit_datastore_op(
            self.id,
            {"address": channel_id, "contents": contents},
            local_op_metadata,
        )

    def process(self, message: SequencedDocumentMessage, local: bool,
                local_op_metadata: Any) -> None:
        envelope = message.contents
        if envelope.get("type") == "attach_channel":
            changed = self._process_attach(envelope, local)
            # Stamp the dirty bit ONLY when the attach changed channel
            # state (creation/adoption — such a channel must summarize
            # inline; a handle stub would dangle, protocol/summary.py).
            # An IGNORED attach (the existing channel won the race) must
            # not stamp: whether the loser arrived is unrelated to the
            # channel's content, and stamping here would make summaries
            # depend on whether a replica had realized a lazy channel.
            if changed or local:
                created = self.channels.get(envelope["address"])
                if created is not None:
                    created.last_changed_seq = message.sequence_number
            return
        channel = self.get_channel(envelope["address"])
        channel.process(
            replace(message, contents=envelope["contents"]),
            local,
            local_op_metadata,
        )

    def _process_attach(self, envelope: dict, local: bool) -> bool:
        """Returns True when the attach CHANGED state (created/adopted a
        channel) — the caller stamps the dirty bit only then, so the
        outcome is identical on every replica regardless of lazy
        realization."""
        if local:
            return False
        address = envelope["address"]
        if address in self._unrealized:
            # A lazy snapshot-loaded channel was never locally pending,
            # so the remote attach can only lose to it (our channel
            # already exists on every replica's snapshot) — drop the
            # stale attach WITHOUT realizing (no blob fetch on the
            # op-processing path).
            return False
        if address not in self.channels:
            self._adopt_channel(address, envelope["snapshot"])
            return True
        if address in self._adoption_pending:
            # Datastore-race leftover: the FIRST sequenced
            # attach_channel for this id (winner's, or our own voided
            # echo) defines its state on every replica.
            self._adopt_channel(address, envelope["snapshot"])
            return True
        # Same-id channel create race on a shared datastore: if OUR
        # create of this channel is still pending, the remote
        # attach_channel sequenced first — adopt its snapshot and void
        # our pending create + ops (their echoes re-apply as remote
        # ops, like every replica). Otherwise our create already won:
        # ignore the later one (all replicas do).
        if self.parent.void_channel(self.id, address):
            self._adopt_channel(address, envelope["snapshot"])
            return True
        return False

    def resubmit(self, envelope: dict, local_op_metadata: Any) -> None:
        if envelope.get("type") == "attach_channel":
            # Re-announce with the ORIGINAL create-time snapshot — edits made
            # since are their own pending ops and replay right after this
            # (re-snapshotting here would double-apply them on remotes).
            self.parent.submit_datastore_op(self.id, envelope, None)
            return
        channel = self.get_channel(envelope["address"])
        channel.resubmit(envelope["contents"], local_op_metadata)

    def adopt(self, snapshot: dict) -> None:
        """Replace this store's state with a concurrent-create winner's
        snapshot IN PLACE: channels sharing id+type reload their state into
        the existing objects, so references held by app code stay live (and
        keep submitting/processing against the adopted state). Channels
        absent from the winner's snapshot were announced by our now-voided
        attach_channel ops — they stay, marked adoption-pending, and the
        first-sequenced attach_channel to arrive for that id (the winner's
        or our own voided echo) reloads its snapshot into them, which is
        exactly the state every remote replica builds."""
        self.attributes = snapshot.get("attributes", {})
        winner_channels = snapshot["channels"]
        for channel_id in list(self._unrealized):
            # Lazy channels participate in adoption like realized ones.
            self._realize(channel_id)
        for channel_id in self.channels:
            if channel_id not in winner_channels:
                self._adoption_pending.add(channel_id)
        for channel_id, channel_snapshot in winner_channels.items():
            self._adopt_channel(channel_id, channel_snapshot)

    def _adopt_channel(self, channel_id: str, snapshot: dict) -> None:
        """Reload a channel snapshot into the existing object (keeping its
        identity) when the types agree, else rebind a fresh instance. Any
        local ops still pending against the pre-adopt state are voided —
        their echoes apply as remote ops, exactly as every replica applies
        them to the adopted state."""
        self._adoption_pending.discard(channel_id)
        self._unrealized.pop(channel_id, None)  # superseded before access
        self.parent.void_channel_ops(self.id, channel_id)
        channel_type = snapshot["attributes"]["type"]
        existing = self.channels.get(channel_id)
        if (existing is not None
                and existing.attributes.get("type") == channel_type):
            existing.load(snapshot)
        else:
            self._bind(self.registry.get(channel_type).load(
                self, channel_id, snapshot))

    def void_adoption_pending_ops(self) -> None:
        """Reconnect while channel adoptions are still unresolved: pending
        ops against those channels must not replay (the state they were
        recorded against is provisional; if the adopting attach_channel was
        sequenced it arrives in catch-up and its ops with it). The channels
        themselves stay, still marked — catch-up may yet adopt them, and
        until then summarize()/GC exclude them."""
        for channel_id in self._adoption_pending:
            self.parent.void_channel_ops(self.id, channel_id)

    # -- summary --------------------------------------------------------------

    def summarize(self, unchanged_before: int | None = None) -> dict:
        # Adoption-pending channels are provisional local state: on every
        # other replica they either do not exist yet or will be defined by
        # the first-sequenced attach_channel — excluding them keeps
        # summaries byte-identical across replicas during the race window.
        #
        # Incremental mode (summary.ts:53 handle reuse): channels whose
        # last change is at or below ``unchanged_before`` (the last ACKED
        # summary's seq) serialize as handle stubs into that summary
        # instead of full content — O(changed) summaries.
        from ..protocol.summary import make_handle

        channels: dict[str, dict] = {}
        ids = sorted(set(self.channels) | set(self._unrealized))
        for channel_id in ids:
            if channel_id in self._adoption_pending:
                continue
            if channel_id in self._unrealized:
                # Never accessed since load: unchanged by definition. In
                # incremental mode it stubs like any unchanged channel;
                # a full summary re-inlines the (resolved) snapshot.
                if unchanged_before is not None:
                    channels[channel_id] = make_handle(
                        f"runtime/datastores/{self.id}/channels/"
                        f"{channel_id}")
                else:
                    channels[channel_id] = self._stored_snapshot(
                        channel_id)
                continue
            channel = self.channels[channel_id]
            if (unchanged_before is not None
                    and channel.last_changed_seq <= unchanged_before):
                channels[channel_id] = make_handle(
                    f"runtime/datastores/{self.id}/channels/{channel_id}")
            else:
                channels[channel_id] = channel.summarize()
        return {
            "attributes": dict(sorted(self.attributes.items())),
            "channels": channels,
        }

    def load(self, snapshot: dict) -> None:
        """Defer channel construction: the stored snapshots realize on
        first access (lazy realization, remoteChannelContext.ts:203) —
        with a virtualizing driver a stubbed channel's content is not
        even FETCHED until then."""
        self.attributes = snapshot.get("attributes", {})
        self._unrealized.update(snapshot["channels"])
