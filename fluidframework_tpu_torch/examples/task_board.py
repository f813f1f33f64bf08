"""TaskBoard — shared task list with exactly-once work claiming.

Reference parity: examples/data-objects/task-selection (+ the
ordered-collection DDS's acquire/complete contract): tasks live in a
SharedDirectory (one subdirectory per task, LWW fields); a ConsensusQueue
distributes "do this task" work items so exactly one client claims each,
no matter how many race (consensusOrderedCollection.ts:98 semantics).

Run:  python -m fluidframework_tpu_torch.examples.task_board
"""

from __future__ import annotations

from ..dds.directory import SharedDirectory
from ..dds.ordered_collection import ConsensusQueue
from ..framework.data_object import DataObject
from ..framework.data_object_factory import DataObjectFactory

TASKS_ID = "tasks"
WORK_ID = "work"


class TaskBoard(DataObject):
    def initializing_first_time(self, props=None) -> None:
        tasks = self.runtime.create_channel(
            TASKS_ID, SharedDirectory.channel_type)
        work = self.runtime.create_channel(WORK_ID, ConsensusQueue.channel_type)
        self.root.set(TASKS_ID, tasks.handle)
        self.root.set(WORK_ID, work.handle)

    @property
    def tasks(self) -> SharedDirectory:
        return self.root.get(TASKS_ID).get()

    @property
    def work(self) -> ConsensusQueue:
        return self.root.get(WORK_ID).get()

    # -- board operations ------------------------------------------------------

    def add_task(self, task_id: str, title: str) -> None:
        sub = self.tasks.create_sub_directory(task_id)
        sub.set("title", title)
        sub.set("done", False)
        self.work.add(task_id)

    def claim_next(self) -> None:
        """Race to acquire the next work item; the sequencer arbitrates."""
        self.work.acquire()

    def claimed(self) -> dict[str, str]:
        """Work items this client currently holds: {item_id: task_id}."""
        return dict(self.work.acquired_items())

    def complete(self, item_id: str, task_id: str) -> None:
        self.tasks.get_sub_directory(task_id).set("done", True)
        self.work.complete(item_id)

    def board(self) -> dict[str, dict]:
        tasks = self.tasks
        return {name: {
            "title": tasks.get_sub_directory(name).get("title"),
            "done": tasks.get_sub_directory(name).get("done"),
        } for name in sorted(tasks.root.subdirectories())}


task_board_factory = DataObjectFactory("task-board", TaskBoard)


def main(argv: list[str] | None = None) -> None:
    import argparse

    from .host import open_document, parse_endpoint_args

    parser = argparse.ArgumentParser(description=__doc__)
    parse_endpoint_args(parser)
    args = parser.parse_args(argv)

    with open_document("task-board", args) as session:
        creator, joiner, settle = session
        creator.add_task("t1", "write docs")
        creator.add_task("t2", "fix bug")
        settle()
        # Both clients race for work; consensus hands each item to exactly
        # one of them.
        creator.claim_next()
        joiner.claim_next()
        settle()
        claims = {**{k: ("creator", v) for k, v in creator.claimed().items()},
                  **{k: ("joiner", v) for k, v in joiner.claimed().items()}}
        assert len(claims) == 2, claims
        for item_id, (who, task_id) in claims.items():
            owner = creator if who == "creator" else joiner
            owner.complete(item_id, task_id)
        settle()
        print(f"task_board: {creator.board()}")
        assert all(t["done"] for t in creator.board().values())
        assert creator.board() == joiner.board()


if __name__ == "__main__":
    main()
