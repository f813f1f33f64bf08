"""Legacy client-api — the one-call "document" facade.

Reference parity: packages/runtime/client-api/src/api/document.ts:58
(``Document`` bundling loader + runtime + a root map behind
``load()``/``createMap()``/``createString()``/``getRoot()``) — the
deprecated-but-shipped convenience layer predating aqueduct/fluid-static.
Kept for surface parity: a user porting old client-api code finds the
same verbs here, implemented over the modern Loader/Container stack.
"""

from __future__ import annotations

import uuid
from typing import Callable

from .dds.cell import SharedCell
from .dds.directory import SharedDirectory
from .dds.ink import Ink
from .dds.map import SharedMap
from .dds.matrix import SharedMatrix
from .dds.sequence import SharedString
from .drivers.base import DocumentService
from .runtime.container import Container

_ROOT_STORE = "root"
_ROOT_MAP = "root"


class Document:
    """Loader + runtime + root map in one object (document.ts:58)."""

    def __init__(self, container: Container, existing: bool) -> None:
        self.container = container
        self._existing = existing
        datastore = container.runtime.get_datastore(_ROOT_STORE)
        self._datastore = datastore

    # -- accessors (document.ts getRoot/existing) -----------------------------

    def get_root(self) -> SharedMap:
        return self._datastore.get_channel(_ROOT_MAP)

    @property
    def existing(self) -> bool:
        """True when the document pre-existed this session (loaded, not
        created here) — the reference client-api's existing flag."""
        return self._existing

    # -- creators (document.ts createMap/createString/...) --------------------

    def _create(self, channel_type: str):
        # Channel ids must be globally unique — a per-session counter
        # collides across sessions/clients (document.ts uses uuid()).
        name = f"channel-{uuid.uuid4().hex}"
        return self._datastore.create_channel(name, channel_type)

    def create_map(self) -> SharedMap:
        return self._create(SharedMap.channel_type)

    def create_directory(self) -> SharedDirectory:
        return self._create(SharedDirectory.channel_type)

    def create_string(self) -> SharedString:
        return self._create(SharedString.channel_type)

    def create_cell(self) -> SharedCell:
        return self._create(SharedCell.channel_type)

    def create_matrix(self) -> SharedMatrix:
        return self._create(SharedMatrix.channel_type)

    def create_ink(self) -> Ink:
        return self._create(Ink.channel_type)

    def close(self) -> None:
        self.container.close()


def create(service: DocumentService) -> Document:
    """Create a new document with a root map and attach it."""
    container = Container.create_detached(service)
    datastore = container.runtime.create_datastore(_ROOT_STORE)
    datastore.create_channel(_ROOT_MAP, SharedMap.channel_type)
    container.attach()
    return Document(container, existing=False)


def load(service_factory: Callable[[str], DocumentService],
         doc_id: str) -> Document:
    """Open an existing document (client-api load(): resolve + request)."""
    container = Container.load(service_factory(doc_id))
    return Document(container, existing=True)
