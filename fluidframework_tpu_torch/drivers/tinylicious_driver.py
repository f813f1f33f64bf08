"""Tinylicious driver — the dev-service preset of the network driver.

Reference parity: packages/drivers/tinylicious-driver — a thin
configuration of the routerlicious driver pointed at the local dev
ordering service's well-known endpoint. Here that service is the
standalone alfred (``python -m fluidframework_tpu_torch.server.alfred``),
and this factory is the IDocumentServiceFactory preset for it.
"""

from __future__ import annotations

from .network_driver import NetworkDocumentService

DEFAULT_PORT = 7070


class TinyliciousDocumentServiceFactory:
    """IDocumentServiceFactory preconfigured for the local dev service."""

    def __init__(self, host: str = "127.0.0.1",
                 port: int = DEFAULT_PORT) -> None:
        self.host = host
        self.port = port

    def create_document_service(self, doc_id: str,
                                **kwargs) -> NetworkDocumentService:
        return NetworkDocumentService(self.host, self.port, doc_id,
                                      **kwargs)

    def __call__(self, doc_id: str) -> NetworkDocumentService:
        """Usable directly as a Loader service factory."""
        return self.create_document_service(doc_id)
