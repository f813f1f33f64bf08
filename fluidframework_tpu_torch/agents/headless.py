"""Headless agent runner — claims foreman help assignments and runs agents.

Reference parity: server/headless-agent/src — a headless client process
that, told a document needs agent work, loads the document with a normal
client stack, runs the agent, and writes results back INTO the document
(the insights map convention), so every collaborator sees the analysis as
ordinary converged state. Assignment flow: clients submit REMOTE_HELP ops
→ the foreman lambda records durable assignments → this runner polls,
claims, runs, completes (at-least-once; completion is recorded durably via
the service control surface).
"""

from __future__ import annotations

from ..dds.map import SharedMap
from ..runtime.container import Container

INSIGHTS_CHANNEL = "insights"


class HeadlessAgentRunner:
    """Polls help assignments and runs matching agents against documents.

    ``control`` — the service control surface: ``help_tasks(doc_id=None)``
    returning assignment dicts with stable ``key``s, and
    ``complete_help(key)``; RouterliciousService implements it in-proc
    and alfred exposes it over the wire (get_help / complete_help ops).
    ``service_factory`` — doc_id → DocumentService, the same driver seam
    every client uses.
    """

    def __init__(self, control, service_factory, agents,
                 agent_name: str | None = None) -> None:
        self._control = control
        self._service_factory = service_factory
        self._agents = {agent.name: agent for agent in agents}
        self._agent_name = agent_name  # claim only tasks assigned to us

    def run_once(self, doc_id: str | None = None) -> int:
        """Process every claimable pending assignment; returns how many.
        Tasks are grouped per document so each document loads once."""
        by_doc: dict[str, list] = {}
        for task in self._control.help_tasks(doc_id):
            agent = self._agents.get(task["task"])
            if agent is None:
                continue
            if (self._agent_name is not None
                    and task.get("agent") != self._agent_name):
                continue
            by_doc.setdefault(task["doc_id"], []).append((task, agent))
        processed = 0
        for doc, doc_tasks in by_doc.items():
            processed += self._run_doc_tasks(doc, doc_tasks)
        return processed

    def _run_doc_tasks(self, doc_id: str, doc_tasks: list) -> int:
        service = self._service_factory(doc_id)
        container = Container.load(service)
        completed = []
        try:
            for task, agent in doc_tasks:
                result = agent.run(container)
                self._insights(container).set(agent.name, result)
                completed.append(task["key"])
        finally:
            container.close()
            close = getattr(service, "close", None)
            if close is not None:
                close()  # a network service holds a socket + threads
        # Complete AFTER the insights writes are submitted: a crash in
        # between re-runs tasks (at-least-once), never loses them.
        for key in completed:
            self._control.complete_help(key)
        return len(completed)

    @staticmethod
    def _insights(container) -> SharedMap:
        """The document's insights map, created on first agent visit."""
        runtime = container.runtime
        for datastore in runtime.datastores.values():
            if INSIGHTS_CHANNEL in datastore.channel_ids():
                return datastore.get_channel(INSIGHTS_CHANNEL)
        if not runtime.datastores:
            raise RuntimeError("document has no data stores to annotate")
        datastore = runtime.datastores[sorted(runtime.datastores)[0]]
        return datastore.create_channel(INSIGHTS_CHANNEL,
                                        SharedMap.channel_type)
