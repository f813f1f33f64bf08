"""SharedObject — the abstract base every DDS extends.

Reference parity: packages/dds/shared-object-base/src/sharedObject.ts
(``SharedObject``: process→processCore:471→320, summarize:209, attach
lifecycle) and the IChannel/IChannelFactory contract
(packages/runtime/datastore-definitions/src/channel.ts) — the plugin seam
named in BASELINE.json.

A DDS instance is a *channel* inside a data store. Local edits call
``submit_local_message``; sequenced messages arrive via ``process`` which
dispatches to the subclass ``process_core``. Subclasses implement:

  process_core(message, local, local_op_metadata)
  summarize_core() -> dict                (JSON-serializable summary blob)
  load_core(snapshot: dict)
  resubmit_core(contents, metadata)       (reconnect replay)
  apply_stashed_op(contents) -> metadata  (offline rehydration)
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Callable

from ..protocol.messages import MessageType, SequencedDocumentMessage

if TYPE_CHECKING:  # pragma: no cover
    from ..runtime.datastore import DataStoreRuntime


# Metadata sentinel: this sequenced message is OUR OWN op, voided by a lost
# concurrent-create race and applied as a remote op. Merge engines must then
# exclude local unacked state from visibility (no other replica has it) even
# though the op's author id equals the local client id.
VOIDED_LOCAL_ECHO = object()


class SharedObject:
    """Base DDS channel."""

    # Subclasses set this to their channel factory type string.
    channel_type: str = ""

    def __init__(self, channel_id: str, runtime: "DataStoreRuntime | None",
                 attributes: dict | None = None) -> None:
        self.id = channel_id
        self.runtime = runtime
        self.attributes = attributes or {"type": self.channel_type}
        self._connection: Any = None  # ChannelDeltaConnection once bound
        self.on_op: list[Callable[[SequencedDocumentMessage, bool], None]] = []
        # Seq of the last sequenced message that touched this channel —
        # the summarizerNode dirty bit: a channel unchanged since the last
        # ACKED summary serializes as a handle, not content (summary.ts:53).
        self.last_changed_seq = 0
        self._gc_cache: tuple[int, list[str]] | None = None

    # -- attach/bind lifecycle ----------------------------------------------

    @property
    def is_attached(self) -> bool:
        return self._connection is not None

    @property
    def handle(self):
        """A serializable FluidHandle to this channel (handle.ts)."""
        from ..runtime.handles import FluidHandle
        assert self.runtime is not None, "detached channel has no handle"
        return FluidHandle(f"/{self.runtime.id}/{self.id}",
                           self.runtime.resolve_path)

    def _handle_resolver(self):
        """Path resolver for decoding stored handles (None when hosted
        outside a data store, e.g. direct unit tests)."""
        return None if self.runtime is None else self.runtime.resolve_path

    def get_gc_data(self) -> list[str]:
        """Outbound GC routes = handles stored in this channel's state
        (runtime-utils scans serialized summary content the same way)."""
        from ..runtime.handles import collect_handle_routes
        return collect_handle_routes(self.summarize_core())

    def gc_routes(self) -> list[str]:
        """get_gc_data with a dirty-bit cache: unchanged channels (whose
        summary is a handle stub) must not re-serialize just for GC."""
        if (self._gc_cache is not None
                and self._gc_cache[0] == self.last_changed_seq):
            return self._gc_cache[1]
        routes = self.get_gc_data()
        self._gc_cache = (self.last_changed_seq, routes)
        return routes

    def bind_connection(self, connection: Any) -> None:
        """Called by the data store when the channel becomes live."""
        self._connection = connection

    def on_attach(self) -> None:
        """Container went detached → attached: normalize local-only state
        into baseline state (it ships via the attach snapshot)."""

    # -- op plumbing ---------------------------------------------------------

    def submit_local_message(self, contents: Any, metadata: Any = None) -> None:
        """Send a channel op; a detached channel applies ops locally only."""
        if self._connection is not None:
            self._connection.submit(contents, metadata)

    def process(self, message: SequencedDocumentMessage, local: bool,
                local_op_metadata: Any) -> None:
        assert message.type == MessageType.OPERATION
        self.last_changed_seq = message.sequence_number
        self.process_core(message, local, local_op_metadata)
        for cb in self.on_op:
            cb(message, local)

    def resubmit(self, contents: Any, metadata: Any) -> None:
        self.resubmit_core(contents, metadata)

    # -- summaries ------------------------------------------------------------

    def summarize(self) -> dict:
        return {"attributes": self.attributes, "content": self.summarize_core()}

    def load(self, snapshot: dict) -> None:
        self.load_core(snapshot["content"])

    # -- subclass contract ----------------------------------------------------

    def process_core(self, message: SequencedDocumentMessage, local: bool,
                     local_op_metadata: Any) -> None:
        raise NotImplementedError

    def summarize_core(self) -> dict:
        raise NotImplementedError

    def load_core(self, content: dict) -> None:
        raise NotImplementedError

    def resubmit_core(self, contents: Any, metadata: Any) -> None:
        # Default: resubmit unchanged (correct for commutative/LWW ops).
        self.submit_local_message(contents, metadata)

    def apply_stashed_op(self, contents: Any) -> Any:
        raise NotImplementedError


class ChannelFactory:
    """IChannelFactory equivalent: creates/loads channels of one type."""

    channel_type: str = ""
    shared_object_cls: type[SharedObject] = SharedObject

    def create(self, runtime: "DataStoreRuntime", channel_id: str) -> SharedObject:
        return self.shared_object_cls(channel_id, runtime)

    def load(self, runtime: "DataStoreRuntime", channel_id: str,
             snapshot: dict) -> SharedObject:
        channel = self.shared_object_cls(channel_id, runtime)
        channel.load(snapshot)
        return channel


class ChannelRegistry:
    """Maps channel type strings to factories (the DDS plugin seam)."""

    def __init__(self, factories: list[ChannelFactory] | None = None) -> None:
        self._factories: dict[str, ChannelFactory] = {}
        for factory in factories or []:
            self.register(factory)

    def register(self, factory: ChannelFactory) -> None:
        self._factories[factory.channel_type] = factory

    def get(self, channel_type: str) -> ChannelFactory:
        if channel_type not in self._factories:
            raise KeyError(f"no channel factory for type {channel_type!r}")
        return self._factories[channel_type]


def default_registry() -> ChannelRegistry:
    """Registry with every built-in DDS type registered."""
    from . import (cell, counter, directory, ink, map, matrix,
                   ordered_collection, register_collection, sequence,
                   summary_block)
    factories: list[ChannelFactory] = [
        map.SharedMapFactory(),
        directory.SharedDirectoryFactory(),
        counter.SharedCounterFactory(),
        cell.SharedCellFactory(),
        sequence.SharedStringFactory(),
        matrix.SharedMatrixFactory(),
        ordered_collection.ConsensusQueueFactory(),
        register_collection.ConsensusRegisterCollectionFactory(),
        ink.InkFactory(),
        summary_block.SharedSummaryBlockFactory(),
    ]
    try:  # registered as they land
        from . import tree
        factories.append(tree.SharedTreeFactory())
    except ImportError:  # pragma: no cover
        pass
    return ChannelRegistry(factories)
