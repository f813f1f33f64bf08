"""The port stands alone: ``fluidframework_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor the reference package ``fluidframework_tpu``.

Checked two ways: every module of the port is imported in a fresh
interpreter and ``sys.modules`` is inspected afterwards, and every source
file is parsed for import statements (which also catches lazy imports
inside functions that a plain import never runs).
"""

from __future__ import annotations

import ast
import json
import os
import pathlib
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
                 "native.shuttle"):
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
