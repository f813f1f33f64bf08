"""Gateway — a web host that loads documents server-side.

Reference parity: server/gateway (the routerlicious web host: login/token
minting, loader bootstrap, server-side container loading for browsers).
Collapsed to its framework-relevant core as an HTTP service in front of an
alfred front door:

  GET /token?doc=<id>          mint a tenant-signed access token
                               (gateway's api token minting; requires a
                               tenant secret — riddler integration)
  GET /doc/<id>                load the container server-side (read-only
                               network driver session) and return its
                               summary JSON — the "server-side render"
  GET /doc/<id>/view           minimal HTML page embedding that state
                               (the loader-bootstrap page analog)
  GET /healthz                 liveness

Run standalone::

    python -m fluidframework_tpu_torch.server.gateway --alfred-port 7070 --port 8080
"""

from __future__ import annotations

import argparse
import html
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..drivers.tinylicious_driver import TinyliciousDocumentServiceFactory
from ..protocol.messages import ScopeType
from ..runtime.container import Container
from .riddler import sign_token


class Gateway:
    """Loads documents through the network driver on request."""

    def __init__(self, alfred_host: str, alfred_port: int,
                 tenant_id: str | None = None,
                 tenant_secret: str | None = None) -> None:
        self.factory = TinyliciousDocumentServiceFactory(
            host=alfred_host, port=alfred_port)
        self.tenant_id = tenant_id
        self.tenant_secret = tenant_secret

    def mint_token(self, doc_id: str) -> str:
        if self.tenant_secret is None or self.tenant_id is None:
            raise PermissionError("gateway has no tenant secret configured")
        return sign_token(self.tenant_id, self.tenant_secret, doc_id,
                          scopes=[ScopeType.READ, ScopeType.WRITE])

    def render(self, doc_id: str) -> dict:
        """Server-side load: full client stack over the wire, read mode."""
        service = self.factory(doc_id)
        try:
            container = Container.load(service, mode="read")
            return container.summarize()
        finally:
            service.close()


class _Handler(BaseHTTPRequestHandler):
    gateway: Gateway  # set by serve()

    def log_message(self, *args) -> None:  # quiet by default
        pass

    def do_GET(self) -> None:  # noqa: N802 (http.server contract)
        parsed = urlparse(self.path)
        parts = [p for p in parsed.path.split("/") if p]
        try:
            if parsed.path == "/healthz":
                return self._json(200, {"ok": True})
            if parsed.path == "/token":
                doc = parse_qs(parsed.query).get("doc", [None])[0]
                if not doc:
                    return self._json(400, {"error": "missing ?doc="})
                return self._json(200,
                                  {"token": self.gateway.mint_token(doc)})
            is_doc = (len(parts) == 2 and parts[0] == "doc")
            is_view = (len(parts) == 3 and parts[0] == "doc"
                       and parts[2] == "view")
            if is_doc or is_view:
                doc_id = parts[1]
                state = self.gateway.render(doc_id)
                if is_view:
                    body = ("<!doctype html><title>%s</title><h1>%s</h1>"
                            "<pre id=\"fluid-state\">%s</pre>" % (
                                html.escape(doc_id), html.escape(doc_id),
                                html.escape(json.dumps(state, indent=1,
                                                       default=list))))
                    return self._raw(200, body.encode(),
                                     "text/html; charset=utf-8")
                return self._json(200, state)
            return self._json(404, {"error": f"no route {parsed.path!r}"})
        except PermissionError as err:
            return self._json(403, {"error": str(err)})
        except Exception as err:  # surface load failures as 502
            return self._json(502, {"error": repr(err)})

    def _json(self, status: int, payload: dict) -> None:
        self._raw(status, json.dumps(payload, default=list).encode(),
                  "application/json")

    def _raw(self, status: int, body: bytes, ctype: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def serve(gateway: Gateway, host: str = "127.0.0.1", port: int = 0
          ) -> tuple[ThreadingHTTPServer, threading.Thread]:
    """Start the gateway HTTP server on a daemon thread; returns it."""
    handler = type("BoundHandler", (_Handler,), {"gateway": gateway})
    server = ThreadingHTTPServer((host, port), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--alfred-host", default="127.0.0.1")
    parser.add_argument("--alfred-port", type=int, required=True)
    parser.add_argument("--tenant-id", default=None)
    parser.add_argument("--tenant-secret", default=None)
    args = parser.parse_args(argv)
    gateway = Gateway(args.alfred_host, args.alfred_port,
                      args.tenant_id, args.tenant_secret)
    server, thread = serve(gateway, args.host, args.port)
    print(f"READY {server.server_address[1]}", flush=True)
    thread.join()


if __name__ == "__main__":
    main(sys.argv[1:])
