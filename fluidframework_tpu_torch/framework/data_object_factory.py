"""DataObjectFactory — creates/loads DataObjects over data stores.

Reference parity: packages/framework/aqueduct/src/data-object-factories/
dataObjectFactory.ts:32 — binds an object type string to a DataObject class,
creates the backing data store (plus the root directory for ``DataObject``
subclasses), and runs the initialize lifecycle.
"""

from __future__ import annotations

import uuid
from typing import Any

from ..dds.directory import SharedDirectory
from ..runtime.container_runtime import ContainerRuntime
from ..runtime.datastore import DataStoreRuntime
from .data_object import DataObject, PureDataObject


class DataObjectFactory:
    def __init__(self, object_type: str,
                 data_object_cls: type[PureDataObject] = DataObject) -> None:
        self.type = object_type
        self.data_object_cls = data_object_cls

    # -- create ---------------------------------------------------------------

    def create(self, container_runtime: ContainerRuntime,
               datastore_id: str | None = None, root: bool = False,
               props: Any = None) -> PureDataObject:
        """Create a new instance: data store + root channel + first-time
        init (dataObjectFactory.ts createInstance flow)."""
        if datastore_id is None:
            # Globally unique (uuid, as in the reference): two clients
            # auto-creating objects must never collide on a store id —
            # process_attach would silently merge them.
            datastore_id = f"{self.type}-{uuid.uuid4().hex}"
        datastore = container_runtime.create_datastore(
            datastore_id, root=root, attributes={"type": self.type})
        obj = self.data_object_cls(datastore)
        if issubclass(self.data_object_cls, DataObject):
            datastore.create_channel(DataObject.ROOT_ID,
                                     SharedDirectory.channel_type)
        obj.initializing_first_time(props)
        obj.has_initialized()
        datastore._data_object = obj  # later get()s return the creator's
        return obj

    # -- load -----------------------------------------------------------------

    def get(self, datastore: DataStoreRuntime) -> PureDataObject:
        """Wrap an existing (loaded) data store of this factory's type.
        Cached per data store: repeated gets (every routed request) must
        not re-run the initialize lifecycle — hooks that subscribe
        listeners would stack one copy per call."""
        assert datastore.attributes.get("type") == self.type, (
            f"data store {datastore.id!r} is "
            f"{datastore.attributes.get('type')!r}, not {self.type!r}")
        cached = getattr(datastore, "_data_object", None)
        if isinstance(cached, self.data_object_cls):
            return cached
        obj = self.data_object_cls(datastore)
        obj.initializing_from_existing()
        obj.has_initialized()
        datastore._data_object = obj
        return obj
