"""The port stands alone: ``fluidframework_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor the reference package ``fluidframework_tpu``.

Checked two ways: every module of the port is imported in a fresh
interpreter and ``sys.modules`` is inspected afterwards, and every source
file is parsed for import statements (which also catches lazy imports
inside functions that a plain import never runs). A child process is
another way in: no string constant of the port or ``chip_smoke.py`` is a
dotted module name of the reference package (a ``-m`` target), and every
child command line the port builds runs a module of the port.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "fluidframework_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == "fluidframework_tpu"


_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import fluidframework_tpu_torch as pkg
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
print(json.dumps(sorted(sys.modules)))
"""


def test_importing_every_port_module_loads_no_jax_or_reference():
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    modules = json.loads(out.strip().splitlines()[-1])
    for name in ("server.storm", "server.merge_host", "dds.mergetree",
                 "ops.mergetree_cuda", "ops.mergetree_blocks_cuda",
                 "dds.matrix", "ops.matrix_kernel", "ops.matrix_cuda",
                 "parallel.mesh", "parallel.multihost", "parallel.serving",
                 "ops.mergetree_sharded", "server.history",
                 "protocol.summary", "drivers.history_driver",
                 "server.broadcaster", "server.read_replica",
                 "server.alfred", "server.native_bus", "native.fanout",
                 "native.shuttle", "native.bridge", "server.bridge_host",
                 "server.transport", "tools.launch_cluster",
                 "tools.monitor", "runtime.container",
                 "runtime.container_runtime", "runtime.datastore",
                 "runtime.delta_manager", "runtime.summarizer",
                 "dds.shared_object", "dds.sequence", "dds.intervals",
                 "dds.tree", "protocol.quorum", "protocol.handler",
                 "drivers.network_driver", "drivers.virtualized_driver",
                 "server.local_server", "tools.load_test",
                 "framework.data_object", "framework.undo_redo",
                 "runtime.agent_scheduler", "agents.headless",
                 "agents.intelligence", "examples.host",
                 "examples.rich_text_editor", "examples.table_document",
                 "drivers.replay_driver", "drivers.debug_driver",
                 "tools.replay", "tools.debug_tool",
                 "tools.record_goldens", "server.gateway",
                 "ops.mergetree_runs"):
        assert f"fluidframework_tpu_torch.{name}" in modules
    assert [m for m in modules if _forbidden(m)] == []


def _imports(path: pathlib.Path) -> list[str]:
    """Absolute module names imported anywhere in ``path``."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_has_no_jax_or_reference_import(path):
    assert [m for m in _imports(path) if _forbidden(m)] == []


#: A whole string that names a module of the reference package, as a
#: ``python -m`` target does. Prose that mentions one is not matched.
_REFERENCE_MODULE = re.compile(r"fluidframework_tpu(\.[A-Za-z_]\w*)+")


def _reference_module_strings(path: pathlib.Path) -> list[str]:
    return [node.value
            for node in ast.walk(ast.parse(path.read_text(), str(path)))
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and _REFERENCE_MODULE.fullmatch(node.value)]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_names_no_reference_module(path):
    assert _reference_module_strings(path) == []


def test_reference_module_names_are_caught(tmp_path):
    """The scan sees a spawn string and leaves prose alone."""
    src = tmp_path / "spawn.py"
    src.write_text('"""Ports fluidframework_tpu.server.alfred."""\n'
                   'CMD = ["python", "-m", "fluidframework_tpu.tools.chaos"]\n'
                   'OK = "fluidframework_tpu_torch.tools.chaos"\n')
    assert _reference_module_strings(src) == ["fluidframework_tpu.tools.chaos"]


def test_child_command_lines_name_the_port(monkeypatch, tmp_path):
    """Every child command line the port builds (the launcher's follower
    and replica children, the chaos harness's serving lives) runs a
    module of ``fluidframework_tpu_torch``, and so does every ``python
    -m`` line that the load harness, the examples, the gateway and the
    replay tools document."""
    from fluidframework_tpu_torch.tools import chaos, launch_cluster

    seen: list = []

    class _Spawned(Exception):
        pass

    def record(cmd, *args, **kw):
        seen.append(cmd)
        raise _Spawned

    monkeypatch.setattr(launch_cluster, "_spawn", record)
    monkeypatch.setattr(chaos.subprocess, "Popen", record)
    monkeypatch.setattr(chaos.subprocess, "run", record)
    for spawn in (
            lambda: launch_cluster.launch_follower(str(tmp_path / "f0")),
            lambda: launch_cluster.launch_replica(
                str(tmp_path / "r0"), str(tmp_path / "git"), "r0"),
            lambda: chaos._spawn_net_life(
                str(tmp_path / "n"), [], [], [], None, 0, 2, 8, 4, 2, 10.0,
                0.5, device="cpu"),
            lambda: chaos._spawn_life(str(tmp_path / "l"), 0, 2, 8, 4, 2,
                                      None, None, 10.0, "cpu")):
        with pytest.raises(_Spawned):
            spawn()
    documented = ["tools.load_test", "server.gateway", "tools.debug_tool",
                  "tools.record_goldens"] + [
        f"examples.{name}" for name in (
            "__init__", "clicker", "collab_text", "dice_roller",
            "task_board", "whiteboard", "table_document",
            "rich_text_editor")]
    run_lines = []
    for name in documented:
        module = importlib.import_module(
            "fluidframework_tpu_torch." + name.removesuffix(".__init__"))
        run_lines += re.findall(r"python -m (\S+) ?(.*)", module.__doc__)
    assert len(run_lines) >= 12
    for module, args in run_lines:
        seen.append(["python", "-m", module, *args.split()])
    assert len(seen) == 4 + len(run_lines)
    for cmd in seen:
        module = cmd[cmd.index("-m") + 1]
        assert module.startswith("fluidframework_tpu_torch."), cmd
        assert importlib.util.find_spec(module) is not None, cmd


def test_chip_smoke_refuses_without_the_repository(tmp_path):
    """Alone in a directory (and with no card here) chip_smoke.py exits
    non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env={**os.environ, "PYTHONPATH": ""},
                          capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
