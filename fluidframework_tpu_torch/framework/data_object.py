"""PureDataObject / DataObject — the app programming model.

Reference parity: packages/framework/aqueduct/src/data-objects/
pureDataObject.ts:46 and dataObject.ts:31 — a data object wraps one data
store; ``DataObject`` adds a ``root`` SharedDirectory created on first
initialization and re-bound on load.
"""

from __future__ import annotations

from typing import Any

from ..dds.directory import SharedDirectory
from ..runtime.datastore import DataStoreRuntime


class PureDataObject:
    """A typed wrapper over one data store (pureDataObject.ts:46).

    Lifecycle (mirroring the reference's initialize flow):
      - ``initializing_first_time(props)`` — runs once, on the creating
        client only, before anyone else can see the object.
      - ``initializing_from_existing()`` — runs when loading an object
        someone else created.
      - ``has_initialized()`` — runs on every client after either path.
    """

    def __init__(self, runtime: DataStoreRuntime) -> None:
        self.runtime = runtime

    # -- identity --------------------------------------------------------------

    @property
    def id(self) -> str:
        return self.runtime.id

    @property
    def handle(self):
        return self.runtime.handle

    # -- lifecycle hooks (override in subclasses) -----------------------------

    def initializing_first_time(self, props: Any = None) -> None:
        pass

    def initializing_from_existing(self) -> None:
        pass

    def has_initialized(self) -> None:
        pass


class DataObject(PureDataObject):
    """PureDataObject with a ``root`` SharedDirectory (dataObject.ts:31)."""

    ROOT_ID = "root"

    @property
    def root(self) -> SharedDirectory:
        return self.runtime.get_channel(self.ROOT_ID)
