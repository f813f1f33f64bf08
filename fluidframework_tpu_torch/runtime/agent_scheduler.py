"""AgentScheduler — distributed task leasing + leader election.

Reference parity: packages/runtime/agent-scheduler/src/scheduler.ts — tasks
are claimed by writing the claimant's clientId into a
ConsensusRegisterCollection register (linearizable at sequencing, so the
first sequenced claim wins); when the claimant leaves the quorum, interested
clients volunteer again. Leader election = picking the well-known "leader"
task (scheduler.ts leadership helper).
"""

from __future__ import annotations

from typing import Callable

from ..dds.register_collection import ConsensusRegisterCollection
from .container import Container

UNCLAIMED = None
LEADER_TASK = "leader"


class AgentScheduler:
    DATASTORE_ID = "_agent_scheduler"
    CHANNEL_ID = "tasks"

    def __init__(self, container: Container,
                 channel: ConsensusRegisterCollection) -> None:
        self.container = container
        self._tasks = channel
        # task id → callback to run when (re)claimed by this client.
        self._interested: dict[str, Callable[[], None] | None] = {}
        self._held: set[str] = set()
        self._in_flight: set[str] = set()  # volunteer writes not yet decided
        self._tasks.on_op.append(lambda _msg, _local: self._evaluate())
        container.protocol.quorum.on_remove_member.append(
            self._on_member_removed)
        # A pick() made while disconnected volunteers on (re)connect.
        container.on_connected.append(lambda _cid: self._evaluate())

    # -- wiring ---------------------------------------------------------------

    @classmethod
    def get(cls, container: Container) -> "AgentScheduler":
        """Create-or-open the scheduler's hidden data store (the reference
        mounts it at the well-known "_scheduler" route). Idempotent: one
        scheduler instance per container (cached), or double-subscribed
        hooks would disagree about held tasks."""
        existing = getattr(container, "_agent_scheduler", None)
        if existing is not None:
            return existing
        try:
            datastore = container.runtime.get_datastore(cls.DATASTORE_ID)
        except KeyError:
            datastore = container.runtime.create_datastore(cls.DATASTORE_ID)
            datastore.create_channel(
                cls.CHANNEL_ID, ConsensusRegisterCollection.channel_type)
        scheduler = cls(container, datastore.get_channel(cls.CHANNEL_ID))
        container._agent_scheduler = scheduler
        return scheduler

    # -- task API (scheduler.ts pick/release/pickedTasks) ---------------------

    def pick(self, task_id: str,
             callback: Callable[[], None] | None = None) -> None:
        """Register interest: claim the task if unclaimed, and re-volunteer
        whenever the current claimant leaves."""
        self._interested[task_id] = callback
        if self.claimant(task_id) is UNCLAIMED:
            self._volunteer(task_id)
        else:
            self._evaluate()

    def release(self, task_id: str) -> None:
        """Give the task up (only valid while holding it)."""
        assert task_id in self._held, f"not holding {task_id!r}"
        self._interested.pop(task_id, None)
        self._held.discard(task_id)
        self._tasks.write(task_id, UNCLAIMED)

    def claimant(self, task_id: str) -> str | None:
        """Current valid holder: the consensus register value (atomic read =
        first sequenced claim), but only while that client is a quorum
        member — a claim stamped with a departed/stale id (e.g. a volunteer
        write replayed across a reconnect under the old identity) is void,
        exactly as the reference validates picks against the quorum
        (scheduler.ts pickCore)."""
        raw = self._tasks.read(task_id, ConsensusRegisterCollection.ATOMIC)
        if raw is UNCLAIMED:
            return UNCLAIMED
        if raw not in self.container.protocol.quorum.get_members():
            return UNCLAIMED
        return raw

    def picked_tasks(self) -> list[str]:
        return sorted(self._held)

    # -- leadership ------------------------------------------------------------

    def volunteer_for_leadership(
            self, on_elected: Callable[[], None] | None = None) -> None:
        self.pick(LEADER_TASK, on_elected)

    @property
    def leader(self) -> str | None:
        return self.claimant(LEADER_TASK)

    @property
    def is_leader(self) -> bool:
        client_id = self.container.client_id
        return client_id is not None and self.leader == client_id

    # -- claim machinery -------------------------------------------------------

    def _volunteer(self, task_id: str) -> None:
        if self.container.client_id is None or task_id in self._in_flight:
            return
        self._in_flight.add(task_id)
        self._tasks.write(task_id, self.container.client_id)

    def _evaluate(self) -> None:
        """After any sequenced write: fire callbacks for newly-won tasks and
        re-volunteer for interested tasks that became unclaimed (voluntary
        release by the previous holder)."""
        # Snapshot: a callback may pick() more tasks mid-iteration.
        client_id = self.container.client_id
        for task_id, callback in list(self._interested.items()):
            claimant = self.claimant(task_id)
            if claimant is not UNCLAIMED:
                self._in_flight.discard(task_id)  # the race was decided
            held = client_id is not None and claimant == client_id
            if held and task_id not in self._held:
                self._held.add(task_id)
                if callback is not None:
                    callback()
            elif not held:
                self._held.discard(task_id)
                if claimant is UNCLAIMED:
                    self._volunteer(task_id)

    def _on_member_removed(self, _client_id: str) -> None:
        # The quorum has already dropped the member by the time this callback
        # fires, so claimant() for any task they held now reads UNCLAIMED —
        # re-run the claim loop, which re-volunteers for every interested
        # unclaimed task (scheduler.ts pick-on-leave).
        self._evaluate()
