"""Historical document service — the client half of the history plane.

Reference parity: loading a container at a historical version (the
reference's ``IDocumentService`` against a summary handle + op range).
Here :class:`HistoricalDocumentService` pins one document at one
sequence number and serves its state/deltas READ-ONLY from the server's
history plane (``read_at`` — summaries + cold records; the server never
hydrates a device row for it), plus the branch verbs: ``fork`` a named
branch at the pinned seq and ``merge_back`` a branch's delta ops through
the ordinary sequencer.

Works over either transport, duck-typed:

* an in-process service (``RouterliciousService`` — anything exposing
  ``read_at``/``fork_doc``/``merge_back``/``get_deltas``), or
* a :class:`~.network_driver.NetworkDocumentService` (anything exposing
  ``_request`` — the alfred ``read_at``/``fork``/``merge_back`` ops).
"""

from __future__ import annotations

from typing import Any


class HistoricalDocumentService:
    """One document pinned at one historical sequence number."""

    def __init__(self, service: Any, doc_id: str,
                 seq: int | None = None) -> None:
        self._service = service
        self.doc_id = doc_id
        # None pins at the CURRENT head (resolved lazily per read so a
        # fresh instance tracks the live head until explicitly pinned).
        self.seq = seq

    # -- transport dispatch ----------------------------------------------------

    def _net_request(self, req: dict) -> dict:
        """One front-door RPC with bounded read-tier redial: a
        ``moved`` answer (the replica/placement directory naming the
        serving host) redials the labeled address from the service's
        address book and re-asks THERE — how a historical read lands on
        its assigned read replica, and how a replica-shed stale read
        falls back to the leader. Unknown labels surface to the caller
        (who owns service discovery)."""
        service = self._service
        for _hop in range(4):
            try:
                return service._request(req)
            except Exception as err:
                moved = getattr(err, "moved_to", None)
                addr = getattr(service, "hosts", {}).get(moved)
                if moved is None or addr is None:
                    raise
                service._addr = tuple(addr)
                service.reconnect()
        raise ConnectionError(
            "historical read redirect chain did not converge")

    def _read_at(self, doc_id: str, seq: int) -> dict:
        request = getattr(self._service, "_request", None)
        if request is not None:  # network front door
            resp = self._net_request({"op": "read_at", "doc_id": doc_id,
                                      "seq": seq})
            return {k: v for k, v in resp.items() if k != "rid"}
        return self._service.read_at(doc_id, seq)

    def _pinned_seq(self) -> int:
        if self.seq is not None:
            return self.seq
        return int(self._read_at(self.doc_id, 0)["head_seq"])

    # -- reads -----------------------------------------------------------------

    def read_at(self, seq: int | None = None) -> dict:
        """The materialized state record at ``seq`` (default: the
        pinned seq): ``{doc, seq, head_seq, entries}``."""
        return self._read_at(self.doc_id,
                             self._pinned_seq() if seq is None
                             else int(seq))

    def entries(self, seq: int | None = None) -> dict[str, int]:
        """Converged map entries at the pinned (or given) seq."""
        return self.read_at(seq)["entries"]

    def head_seq(self) -> int:
        return int(self._read_at(self.doc_id, 0)["head_seq"])

    def get_deltas(self, from_seq: int = 0,
                   to_seq: int | None = None) -> list:
        """Sequenced deltas CLAMPED to the pin — a historical view must
        never leak ops from its future."""
        pin = self._pinned_seq()
        to_seq = pin if to_seq is None else min(int(to_seq), pin)
        request = getattr(self._service, "_request", None)
        if request is not None:
            return self._net_request(
                {"op": "get_deltas", "doc_id": self.doc_id,
                 "from_seq": from_seq, "to_seq": to_seq})["messages"]
        return self._service.get_deltas(self.doc_id, from_seq, to_seq)

    # -- branch verbs ----------------------------------------------------------

    def fork(self, name: str | None = None,
             seq: int | None = None) -> "HistoricalDocumentService":
        """Fork the doc at the pinned (or given) seq into a named
        branch; returns a service pinned at the branch's fork seq."""
        at = self._pinned_seq() if seq is None else int(seq)
        request = getattr(self._service, "_request", None)
        if request is not None:
            # Branch verbs are writes: a replica front door answers
            # "moved" naming the leader, and the same redial converges
            # there.
            branch = self._net_request(
                {"op": "fork", "doc_id": self.doc_id,
                 "seq": at, "name": name})["branch"]
        else:
            branch = self._service.fork_doc(self.doc_id, at, name)
        return HistoricalDocumentService(self._service, branch, at)

    def merge_back(self) -> dict:
        """Re-submit THIS doc's (a branch's) delta ops into its parent
        through the ordinary sequencer."""
        request = getattr(self._service, "_request", None)
        if request is not None:
            resp = self._net_request({"op": "merge_back",
                                      "branch": self.doc_id})
            return {k: v for k, v in resp.items() if k != "rid"}
        return self._service.merge_back(self.doc_id)

    # -- read-only contract ----------------------------------------------------

    def connect(self, *_args, **_kwargs):
        raise TypeError(
            "HistoricalDocumentService is read-only: a historical view "
            "cannot take a live write connection — fork() a branch and "
            "connect to THAT doc instead")


__all__ = ["HistoricalDocumentService"]
