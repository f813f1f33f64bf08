"""Audience announcements — the service side of the container's audience
roster (container.ts:1700 region): every connection, including read-only
ones that never reach the quorum, is announced via system signals
(``client_id`` None on the wire; clients reject the shape from peers).

Shared by both service assemblies (RouterliciousService and
LocalCollabServer); connection objects are duck-typed
(client_id / mode / on_signal).

Scale note (the viewer-plane round): presence is INTEREST-SAMPLED past
``max_roster`` members — the snapshot a newcomer receives carries a
bounded member sample plus the exact ``total``, and join announcements
to peers stop once the roster is past the bound (peers track the count,
not 100k individual joins). Read-only viewers never enter these
connection maps at all (server/broadcaster.py keeps its own sampled
presence plane); the bound here protects the writer/reader roster from
pathological fan-in on one hot doc.
"""

from __future__ import annotations

AUDIENCE_SIGNAL = "__audience__"

#: Default roster-sample bound for interest-sampled presence: snapshots
#: list at most this many members (plus the exact total); per-join
#: announcements to peers stop past it.
MAX_ROSTER = 256


def _signal(content: dict) -> dict:
    return {"client_id": None, "content": {"type": AUDIENCE_SIGNAL,
                                           **content}}


def roster_sample(connections, limit: int | None = None
                  ) -> tuple[list[dict], int]:
    """(bounded member sample, exact total) over a connection map —
    the interest-sampled presence shape shared with the viewer plane."""
    members = [{"client_id": c.client_id, "mode": c.mode}
               for c in connections.values()]
    total = len(members)
    if limit is not None and total > limit:
        members = members[:limit]
    return members, total


def announce_connect(connections, connection,
                     max_roster: int | None = None) -> None:
    """Send the newcomer the (bounded) roster; announce it to everyone
    else while the roster is within ``max_roster`` — past the bound the
    snapshot's ``total`` is the presence signal (peers see a count grow,
    not one join event per member)."""
    members, total = roster_sample(connections, max_roster)
    if connection.on_signal is not None:
        connection.on_signal(_signal({
            "event": "snapshot", "members": members, "total": total}))
    if max_roster is not None and total > max_roster:
        # Interest-sampled: no per-join member storm past the bound —
        # but the COUNT must still move, or peers' totals drift (the
        # leave path decrements; an unannounced join never increments).
        # Coalesced statelessly: only bucket crossings broadcast, so a
        # join storm costs O(N log N) callbacks total, not O(N^2);
        # between crossings peers' totals are stale by < 1/16 and
        # self-correct at the next crossing (count events are exact).
        if _count_moved(total - 1, total):
            _broadcast_count(connections, connection.client_id, total)
        return
    member = {"client_id": connection.client_id, "mode": connection.mode}
    for other in connections.values():
        if (other.client_id != connection.client_id
                and other.on_signal is not None):
            other.on_signal(_signal({"event": "join", "member": member}))


def _count_moved(before: int, after: int) -> bool:
    """Stateless coalescing rule for count broadcasts (these functions
    hold no per-doc state): announce only when the population crossed a
    ~1/16 bucket boundary. Small rosters (< 32) always announce."""
    def bucket(n: int) -> int:
        return n if n < 32 else n >> (n.bit_length() - 5)
    return bucket(before) != bucket(after)


def _broadcast_count(connections, skip_client_id: str | None,
                     total: int, left: str | None = None) -> None:
    payload = {"event": "count", "total": total}
    if left is not None:
        payload["left"] = left
    for other in connections.values():
        if (other.client_id != skip_client_id
                and other.on_signal is not None):
            other.on_signal(_signal(payload))


def announce_leave(connections, client_id: str,
                   max_roster: int | None = None) -> None:
    """Announce one departure. Past the roster bound the per-member
    leave becomes a coalesced count update carrying the leaver's id (so
    a peer whose SAMPLE held it still drops it at the crossing) —
    totals stay bounded-exact in both directions under sampled
    presence, and a leave storm costs O(N log N) like the join side."""
    total = len(connections)
    if max_roster is not None and total > max_roster:
        if _count_moved(total + 1, total):
            _broadcast_count(connections, None, total, left=client_id)
        return
    for other in connections.values():
        if other.on_signal is not None:
            other.on_signal(_signal({"event": "leave",
                                     "client_id": client_id}))
