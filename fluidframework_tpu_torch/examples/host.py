"""Host — loads example apps through the code-proposal boundary.

Reference parity: packages/hosts/base-host + examples' webpack-fluid-loader
— a host owns the CodeLoader (which app packages exist), resolves document
URLs through the Loader, and hands the app its typed default object. The
document's quorum ``code`` value — not the host's command line — names the
package, so any host with the registry can open any example document.

Endpoints: in-process ordering service by default; ``--port`` targets a
running alfred front door over TCP (the tinylicious analog).
"""

from __future__ import annotations

import contextlib
import time
import uuid

from ..framework.runtime_factory import (
    ContainerRuntimeFactoryWithDefaultDataStore,
)
from ..runtime.loader import CODE_KEY, CodeLoader, Loader
from ..runtime.container import Container


def _example_factories():
    from .clicker import clicker_factory
    from .collab_text import collab_text_factory
    from .dice_roller import dice_roller_factory
    from .rich_text_editor import rich_text_editor_factory
    from .table_document import table_document_factory
    from .task_board import task_board_factory
    from .whiteboard import whiteboard_factory
    return {f.type: f for f in (clicker_factory, collab_text_factory,
                                rich_text_editor_factory,
                                task_board_factory, dice_roller_factory,
                                whiteboard_factory,
                                table_document_factory)}


class ExampleRuntimeFactory:
    """IRuntimeFactory for one example package: the channel registry plus
    the typed default-object bootstrap."""

    def __init__(self, data_object_factory) -> None:
        self.runtime_factory = ContainerRuntimeFactoryWithDefaultDataStore(
            data_object_factory)

    def instantiate(self, container: Container) -> None:
        pass  # the default registry already covers every built-in DDS

    def create_default(self, container: Container, props=None):
        return self.runtime_factory.default_factory.create(
            container.runtime,
            ContainerRuntimeFactoryWithDefaultDataStore.DEFAULT_ID,
            root=True, props=props)

    def default_object(self, container: Container):
        return self.runtime_factory.get_default_object(container)


def build_code_loader() -> CodeLoader:
    """The host's package registry (web-code-loader analog)."""
    code_loader = CodeLoader()
    for name, factory in _example_factories().items():
        code_loader.register(f"@examples/{name}",
                             ExampleRuntimeFactory(factory))
    return code_loader


def create_document(loader: Loader, package: str, url: str, props=None):
    """New document running ``package``; returns (container, data object)."""
    container = loader.create_detached({"package": package}, url)
    factory: ExampleRuntimeFactory = loader.code_loader.load(
        {"package": package})
    obj = factory.create_default(container, props)
    container.attach()
    return container, obj


def open_existing(loader: Loader, url: str):
    """Open by URL; the quorum's code value picks the app package."""
    container = loader.resolve(url)
    code = container.protocol.quorum.get(CODE_KEY)
    factory: ExampleRuntimeFactory = loader.code_loader.load(code)
    return container, factory.default_object(container)


# -- example-main plumbing -----------------------------------------------------


def parse_endpoint_args(parser) -> None:
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=None,
                        help="alfred front door port; omitted = in-process")
    parser.add_argument("--doc", default=None, help="document id")


class Session:
    """What :func:`open_document` yields: two clients on one document.

    ``created`` is False when ``--doc`` named a document that already
    existed — the session then joined it instead of clobbering it, and
    example asserts about exact fresh-document values don't hold.
    """

    def __init__(self, creator, joiner, settle, created: bool) -> None:
        self.creator = creator
        self.joiner = joiner
        self.settle = settle
        self.created = created

    def __iter__(self):
        return iter((self.creator, self.joiner, self.settle))


@contextlib.contextmanager
def open_document(example: str, args, props=None):
    """Open (creating if absent) a document for ``example``, join it with a
    second client, and yield a :class:`Session`. settle() drains until both
    replicas have seen every op. Single-threaded by construction: in
    network mode the drivers run with auto_dispatch off and settle() pumps
    inbound events on this thread — no locking needed."""
    doc_id = args.doc or f"{example}-{uuid.uuid4().hex[:8]}"
    package = f"@examples/{example}"
    containers: list[Container] = []
    services = []

    if args.port is None:
        from ..drivers.local_driver import LocalDocumentService
        from ..server.routerlicious import RouterliciousService
        service = RouterliciousService()

        def service_factory(doc):
            svc = LocalDocumentService(service, doc)
            services.append(svc)
            return svc

        def settle(timeout: float = 15.0):
            service.pump()
    else:
        from ..drivers.network_driver import NetworkDocumentService

        def service_factory(doc):
            svc = NetworkDocumentService(args.host, args.port, doc,
                                         auto_dispatch=False)
            services.append(svc)
            return svc

        def settle(timeout: float = 15.0):
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                for svc in services:
                    svc.pump_events()
                pending = any(c.runtime.pending.has_pending
                              for c in containers)
                seqs = {c.last_processed_seq for c in containers}
                if not pending and len(seqs) == 1:
                    return
                time.sleep(0.02)
            raise TimeoutError("replicas failed to settle")

    loader = Loader(service_factory, build_code_loader())
    url = f"fluid://{args.host}/{doc_id}"
    # --doc may name a live document: join it, don't clobber it (a second
    # attach snapshot over replayed deltas corrupts state).
    exists = (args.doc is not None
              and service_factory(doc_id).storage.get_latest_snapshot()
              is not None)
    if exists:
        creator_container, creator = open_existing(loader, url)
        created = False
    else:
        creator_container, creator = create_document(loader, package, url,
                                                     props)
        created = True
    containers.append(creator_container)
    settle()
    joiner_container, joiner = open_existing(loader, url)
    containers.append(joiner_container)
    settle()
    try:
        yield Session(creator, joiner, settle, created)
    finally:
        for svc in services:
            close = getattr(svc, "close", None)
            if close is not None:
                close()


def main(argv: list[str] | None = None) -> None:
    """Run every example end-to-end (host smoke)."""
    from . import clicker, collab_text, task_board
    for module in (clicker, collab_text, task_board):
        module.main(argv)


if __name__ == "__main__":
    main()
