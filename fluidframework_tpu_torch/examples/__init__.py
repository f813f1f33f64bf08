"""Example applications built on the framework API (SURVEY layer 6).

Reference parity: examples/data-objects/* — 30 sample apps demonstrating
the app programming model; the three here cover the archetypes:

  * :mod:`.clicker` — the counter app (examples/data-objects/clicker,
    BASELINE config 1's smoke workload);
  * :mod:`.collab_text` — a collaborative text editor on SharedString
    with annotations and undo (examples/data-objects/shared-text);
  * :mod:`.task_board` — a task board using a SharedDirectory of tasks
    plus a ConsensusQueue for exactly-once work claiming
    (examples/data-objects/task-selection shape).

:mod:`.host` is the base-host analog: a code-loader registry mapping
package names to these apps, loaded through the quorum code proposal.
Each example module is runnable:  python -m fluidframework_tpu_torch.examples.clicker

Exports resolve lazily so ``python -m`` can execute a submodule as
__main__ without the package import creating a second copy of it.
"""

_EXPORTS = {
    "Clicker": "clicker", "clicker_factory": "clicker",
    "CollabText": "collab_text", "collab_text_factory": "collab_text",
    "RichTextEditor": "rich_text_editor",
    "rich_text_editor_factory": "rich_text_editor",
    "TaskBoard": "task_board", "task_board_factory": "task_board",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        module = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
