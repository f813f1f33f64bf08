"""Runtime request routing — URL paths → objects inside a container.

Reference parity: packages/framework/request-handler (RuntimeRequestHandler
chain, ``buildRuntimeRequestHandler``) + the core-interfaces IResponse
shape {status, mimeType, value}. A router holds an ordered handler list;
the first handler returning a response wins; no match = 404 — exactly the
reference's composition model (e.g. defaultRouteRequestHandler +
dataStore-by-id fallback).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass(slots=True)
class RequestParser:
    """Split a request URL into path segments + headers (requestParser.ts)."""

    url: str
    headers: dict = field(default_factory=dict)

    @property
    def path_parts(self) -> list[str]:
        return [p for p in self.url.split("?")[0].split("/") if p]


@dataclass(slots=True)
class Response:
    status: int
    value: Any = None
    mime_type: str = "fluid/object"

    @property
    def ok(self) -> bool:
        return self.status == 200


def ok(value: Any, mime_type: str = "fluid/object") -> Response:
    return Response(200, value, mime_type)


def not_found(url: str) -> Response:
    return Response(404, f"no route for {url!r}", "text/plain")


# A handler: (RequestParser, container_runtime) -> Response | None.
RequestHandler = Callable[[RequestParser, Any], "Response | None"]


class RuntimeRequestRouter:
    """Ordered handler chain (buildRuntimeRequestHandler)."""

    def __init__(self, handlers: list[RequestHandler] | None = None) -> None:
        self._handlers = list(handlers or [])

    def add(self, handler: RequestHandler) -> "RuntimeRequestRouter":
        self._handlers.append(handler)
        return self

    def request(self, runtime, url: str,
                headers: dict | None = None) -> Response:
        parser = RequestParser(url, headers or {})
        for handler in self._handlers:
            response = handler(parser, runtime)
            if response is not None:
                return response
        return not_found(url)


# -- built-in handlers ---------------------------------------------------------


def default_route_handler(default_id: str) -> RequestHandler:
    """"/" → the default data store (defaultRouteRequestHandler)."""

    def handler(parser: RequestParser, runtime) -> Response | None:
        if parser.path_parts:
            return None
        try:
            return ok(runtime.get_datastore(default_id))
        except KeyError:
            return None
    return handler


def datastore_request_handler(parser: RequestParser, runtime
                              ) -> Response | None:
    """"/<datastore>[/<channel>]" → data store or channel inside it."""
    parts = parser.path_parts
    if not parts:
        return None
    try:
        datastore = runtime.get_datastore(parts[0])
    except KeyError:
        return None
    if len(parts) == 1:
        return ok(datastore)
    if len(parts) == 2:
        try:
            return ok(datastore.get_channel(parts[1]))
        except KeyError:
            return None
    return None


def data_object_request_handler(registry: dict) -> RequestHandler:
    """"/<datastore>" → the TYPED data object via its factory registry
    (the aqueduct get_object path as a chain handler)."""

    def handler(parser: RequestParser, runtime) -> Response | None:
        parts = parser.path_parts
        if len(parts) != 1:
            return None
        try:
            datastore = runtime.get_datastore(parts[0])
        except KeyError:
            return None
        factory = registry.get(datastore.attributes.get("type"))
        if factory is None:
            return None
        return ok(factory.get(datastore))
    return handler
