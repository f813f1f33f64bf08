"""Loader + code loader — quorum-"code"-driven runtime instantiation.

Reference parity: packages/loader/container-loader/src/loader.ts:103
(``Loader.resolve``: URL → driver → Container) and the code-loading
boundary the reference machine-enforces: the loader knows NOTHING about
app code; the quorum's committed ``"code"`` value names the runtime
factory, fetched through an ``ICodeLoader``
(container.ts:1700-1835, web-code-loader/src/webLoader.ts). Here the
"app code" a factory supplies is the channel registry (which DDS types
exist) plus any bootstrap — the IRuntimeFactory.instantiateRuntime
surface collapsed to :meth:`RuntimeFactory.instantiate`.

Create flow: ``create_detached`` seeds the committed ``code`` value into
the detached quorum (shipped via the attach snapshot) so every later
``resolve`` can pick the right factory before any channel instantiates.
"""

from __future__ import annotations

from typing import Callable, Protocol
from urllib.parse import urlparse

from ..dds.shared_object import ChannelRegistry
from ..drivers.base import DocumentService
from .container import Container

CODE_KEY = "code"


class RuntimeFactory(Protocol):
    """instantiateRuntime seam (container-definitions IRuntimeFactory)."""

    def instantiate(self, container: Container) -> None: ...


class StaticRuntimeFactory:
    """A runtime factory that is just a channel registry (the minimum
    viable 'app code')."""

    def __init__(self, registry: ChannelRegistry) -> None:
        self.registry = registry

    def instantiate(self, container: Container) -> None:
        container.runtime.registry = self.registry


class CodeLoader:
    """web-code-loader analog: resolves code details → runtime factory.

    The reference fetches a UMD bundle named by
    ``{package, version}``; here packages register in-process."""

    def __init__(self) -> None:
        self._packages: dict[tuple[str, str], RuntimeFactory] = {}

    def register(self, package: str, factory: RuntimeFactory,
                 version: str = "1.0.0") -> None:
        self._packages[(package, version)] = factory

    def load(self, code_details: dict | None) -> RuntimeFactory:
        if not isinstance(code_details, dict) or "package" not in code_details:
            raise ValueError(f"malformed code details: {code_details!r}")
        key = (code_details["package"], code_details.get("version", "1.0.0"))
        if key not in self._packages:
            raise KeyError(f"no code registered for {key}")
        return self._packages[key]


class Loader:
    """Resolve document URLs to running containers (loader.ts:307).

    URLs look like ``fluid://<host>/<doc_id>``; the service factory maps a
    doc id to a DocumentService (the driver seam), mirroring the
    reference's UrlResolver + IDocumentServiceFactory pair."""

    def __init__(self, service_factory: Callable[[str], DocumentService],
                 code_loader: CodeLoader) -> None:
        self._service_factory = service_factory
        self.code_loader = code_loader

    @staticmethod
    def _doc_id(url: str) -> str:
        if "://" not in url:
            return url
        parsed = urlparse(url)
        doc_id = parsed.path.lstrip("/")
        if not doc_id:
            raise ValueError(f"no document id in {url!r}")
        return doc_id

    def resolve(self, url: str, mode: str = "write",
                pending_state: dict | None = None) -> Container:
        """Open an existing document; the quorum's committed ``code``
        value picks the runtime factory before any channel loads."""
        service = self._service_factory(self._doc_id(url))
        return Container.load(service, mode=mode,
                              pending_state=pending_state,
                              code_loader=self.code_loader)

    def create_detached(self, code_details: dict,
                        url: str) -> Container:
        """New detached document running the given code; the committed
        code value ships in the attach snapshot."""
        factory = self.code_loader.load(code_details)
        service = self._service_factory(self._doc_id(url))
        container = Container.create_detached(service)
        container.protocol.quorum.set_local_value(CODE_KEY, code_details)
        factory.instantiate(container)
        return container
