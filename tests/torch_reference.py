"""Run a reference test file against the port.

``port_reference("test_e2e_local", globals())`` compiles
``tests/test_e2e_local.py`` with every ``fluidframework_tpu`` import
pointed at ``fluidframework_tpu_torch`` and executes it in the calling
``tests/test_torch_*.py`` module's namespace, so pytest collects each of
the reference's cases there as a case of its own, held by the reference's
own assertions to the port.

``adapt`` lists exact ``(old, new)`` source edits, each of which must
match: the only edits made are the ones the port's device defaults need
(``device="cpu"`` where the reference builds a device host, which the
port builds on the card unless asked). A ``from tests.<file> import`` of
another reference test file's helpers loads that file against the port
too; a ``from <file> import`` (a file that needs JAX as a whole) takes
only the named functions of that file, with its imports of the reference
package, against the port.
"""

from __future__ import annotations

import ast
import re
import sys
import textwrap
import types
from pathlib import Path

TESTS = Path(__file__).resolve().parent

#: The reference package's name as an import, not the port's.
_REFERENCE = re.compile(r"\bfluidframework_tpu\b(?!_torch)")
_HELPER_IMPORT = re.compile(r"from tests\.(\w+) import")
_FUNCTION_IMPORT = re.compile(r"^from (test_\w+) import ([\w, ]+)$", re.M)


def ported_source(name: str, adapt=()) -> str:
    """``tests/<name>.py`` with its imports pointed at the port."""
    src = (TESTS / f"{name}.py").read_text()
    for old, new in adapt:
        assert src.count(old) >= 1, f"{name}: no {old!r} to adapt"
        src = src.replace(old, new)
    src = _REFERENCE.sub("fluidframework_tpu_torch", src)
    for helper in sorted(set(_HELPER_IMPORT.findall(src))):
        module = ported_module(helper)
        src = src.replace(f"from tests.{helper} import",
                          f"from {module.__name__} import")
    for helper, names in _FUNCTION_IMPORT.findall(src):
        module = ported_functions(helper, [n.strip() for n in
                                           names.split(",")])
        src = src.replace(f"from {helper} import {names}",
                          f"from {module.__name__} import {names}")
    return src


def ported_functions(name: str, functions: list[str]) -> types.ModuleType:
    """The named functions of ``tests/<name>.py`` and its imports of
    the reference package, run against the port. ``Class.method`` names
    a method, which the module holds as a function of its own name."""
    src = (TESTS / f"{name}.py").read_text()
    tree = ast.parse(src)
    parts = [ast.get_source_segment(src, node) for node in tree.body
             if isinstance(node, ast.ImportFrom) and node.module
             and _REFERENCE.match(node.module)]
    scopes = {"": tree.body} | {node.name: node.body for node in tree.body
                                if isinstance(node, ast.ClassDef)}
    for qualname in functions:
        scope, _, function = qualname.rpartition(".")
        parts += [textwrap.dedent(" " * node.col_offset
                                  + ast.get_source_segment(src, node))
                  for node in scopes[scope]
                  if isinstance(node, ast.FunctionDef)
                  and node.name == function]
    key = f"_torch_reference_{name}_" + "_".join(sorted(functions))
    module = types.ModuleType(key)
    exec(compile(_REFERENCE.sub("fluidframework_tpu_torch",
                                "\n\n".join(parts)),
                 f"{TESTS / name}.py: {', '.join(functions)}", "exec",
                 dont_inherit=True), module.__dict__)
    assert all(hasattr(module, f.rpartition(".")[2])
               for f in functions), (name, functions)
    sys.modules[key] = module
    return module


def ported_module(name: str) -> types.ModuleType:
    """``tests/<name>.py`` run against the port as a module of its own
    (for its helpers; its cases are collected where it is run)."""
    key = f"_torch_reference_{name}"
    if key not in sys.modules:
        module = types.ModuleType(key)
        module.__file__ = str(TESTS / f"{name}.py")
        sys.modules[key] = module
        port_reference(name, module.__dict__)
    return sys.modules[key]


def port_reference(name: str, namespace: dict, adapt=()) -> None:
    """Execute ``tests/<name>.py`` against the port into ``namespace``."""
    doc = namespace.get("__doc__")
    code = compile(ported_source(name, adapt), str(TESTS / f"{name}.py"),
                   "exec", dont_inherit=True)
    exec(code, namespace)
    namespace["__doc__"] = doc
