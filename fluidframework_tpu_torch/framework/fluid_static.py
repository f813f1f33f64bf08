"""FluidStatic — the simplified one-call client.

Reference parity: experimental/framework/fluid-static (+ get-container) —
``FluidContainer`` exposes named *initial objects* (DDS instances declared
up front) without the app touching data stores or channels.
"""

from __future__ import annotations

from ..dds.shared_object import SharedObject
from ..drivers.base import DocumentService
from ..runtime.container import Container

_INITIAL_DS = "initial-objects"


class FluidContainer:
    """A container exposing initial objects by name (fluid-static's
    FluidContainer.initialObjects)."""

    def __init__(self, container: Container) -> None:
        self.container = container

    @property
    def initial_objects(self) -> dict[str, SharedObject]:
        datastore = self.container.runtime.get_datastore(_INITIAL_DS)
        return {channel_id: datastore.get_channel(channel_id)
                for channel_id in datastore.channel_ids()}

    @property
    def connected(self) -> bool:
        return self.container.connected

    def disconnect(self) -> None:
        self.container.disconnect()

    def close(self) -> None:
        self.container.close()


def create_container(service: DocumentService,
                     initial_objects: dict[str, type[SharedObject]]
                     ) -> FluidContainer:
    """Create + attach a document with the given initial objects, e.g.
    ``create_container(svc, {"map": SharedMap, "text": SharedString})``."""
    container = Container.create_detached(service)
    datastore = container.runtime.create_datastore(_INITIAL_DS)
    for name, dds_cls in initial_objects.items():
        datastore.create_channel(name, dds_cls.channel_type)
    container.attach()
    return FluidContainer(container)


def get_container(service: DocumentService) -> FluidContainer:
    """Open an existing document created by :func:`create_container`."""
    return FluidContainer(Container.load(service))
