"""ContainerRuntimeFactoryWithDefaultDataStore.

Reference parity: packages/framework/aqueduct/src/container-runtime-
factories/containerRuntimeFactoryWithDefaultDataStore.ts:25 — assembles a
container whose "/" resolves to a default data object, with a registry of
data-object factories for any further objects created at runtime.
"""

from __future__ import annotations

from typing import Any

from ..drivers.base import DocumentService
from ..runtime.container import Container
from .data_object_factory import DataObjectFactory
from .data_object import PureDataObject


class ContainerRuntimeFactoryWithDefaultDataStore:
    DEFAULT_ID = "default"

    def __init__(self, default_factory: DataObjectFactory,
                 registry_entries: list[DataObjectFactory] | None = None
                 ) -> None:
        self.default_factory = default_factory
        self.registry: dict[str, DataObjectFactory] = {
            f.type: f for f in (registry_entries or [])}
        self.registry.setdefault(default_factory.type, default_factory)
        self._router = None  # built lazily, reused across requests

    # -- document lifecycle ---------------------------------------------------

    def create_document(self, service: DocumentService,
                        props: Any = None) -> tuple[Container, PureDataObject]:
        """New detached document with the default object at "/default";
        caller attaches when ready (container.ts detached lifecycle)."""
        container = Container.create_detached(service)
        obj = self.default_factory.create(
            container.runtime, self.DEFAULT_ID, root=True, props=props)
        return container, obj

    def load_document(self, service: DocumentService
                      ) -> tuple[Container, PureDataObject]:
        container = Container.load(service)
        return container, self.get_default_object(container)

    # -- request routing ("/" → default object) -------------------------------

    def get_default_object(self, container: Container) -> PureDataObject:
        return self.get_object(container, self.DEFAULT_ID)

    def get_object(self, container: Container,
                   datastore_id: str) -> PureDataObject:
        """Resolve a data store id to its typed DataObject. Type→factory
        resolution lives in data_object_request_handler (one code path);
        this adds the raising contract."""
        from .request_handler import (
            RequestParser, data_object_request_handler)
        response = data_object_request_handler(self.registry)(
            RequestParser(f"/{datastore_id}"), container.runtime)
        if response is None:
            datastore = container.runtime.get_datastore(datastore_id)
            raise KeyError("no data object factory registered for "
                           f"{datastore.attributes.get('type')!r}")
        return response.value

    def create_object(self, container: Container, factory_type: str,
                      props: Any = None) -> PureDataObject:
        """Create a further (non-root) data object at runtime; store its
        handle somewhere reachable or GC will report it unreferenced."""
        return self.registry[factory_type].create(
            container.runtime, props=props)

    # -- request routing (request-handler chain) ------------------------------

    def make_router(self):
        """The assembled handler chain this factory serves: "/" rewrites to
        the default store, then "/<id>" → typed object with "/<id>" and
        "/<id>/<channel>" raw fallbacks (buildRuntimeRequestHandler
        composition). Built once per factory — the chain is immutable."""
        from .request_handler import (
            RequestParser,
            RuntimeRequestRouter,
            data_object_request_handler,
            datastore_request_handler,
        )
        typed = data_object_request_handler(self.registry)

        def root_handler(parser, runtime):
            # "/" IS "/<default>": rewrite (headers preserved) and reuse
            # the exact same handlers so there is one code path per route.
            if parser.path_parts:
                return None
            rewritten = RequestParser(f"/{self.DEFAULT_ID}", parser.headers)
            return (typed(rewritten, runtime)
                    or datastore_request_handler(rewritten, runtime))

        return RuntimeRequestRouter(
            [root_handler, typed, datastore_request_handler])

    def request(self, container: Container, url: str):
        if self._router is None:
            self._router = self.make_router()
        return self._router.request(container.runtime, url)
