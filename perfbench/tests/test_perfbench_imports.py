"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the plain reference loads nothing of the port."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

RUN_SMALL = """
import json, sys, time
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
import perfbench.run
from perfbench.harness import bench, cell
from perfbench.tests.small import shrink
real = cell.load_cell
bench.load_cell = lambda n: shrink(*real(n))
for name in ("text_8k.scattered", "map_storm_10k.served"):
    bench.run_cell(name, 5, 1.0, False, torch.device("cpu"),
                   time.perf_counter(), {{"setup_s": "s"}})
for kind in ("traffic", "reference", "readout"):
    for f in ("deli", "map", "map_device", "text", "matrix", "tree"):
        try:
            cell.module(kind, f)
        except ModuleNotFoundError:
            pass
empty = {{"legs": {{}}, "kernels": {{}}, "work": {{}}, "kstats": [],
         "host_tick_s": [], "families": []}}
for p in sorted((cell.HERE / "metrics").glob("*.py")):
    if not p.name.startswith("_"):
        assert bench.read_metric(p.stem, empty) is None, p.stem
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
import perfbench.reference.deli, perfbench.reference.map
import perfbench.reference.text, perfbench.reference.matrix
import perfbench.reference.tree
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(script: str) -> set:
    got = subprocess.run([sys.executable, "-c", script.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         check=True, cwd=ROOT)
    return set(json.loads(got.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    names = top_level(RUN_SMALL)
    assert "fluidframework_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "fluidframework_tpu"}


def test_reference_loads_nothing_of_the_port():
    names = top_level(REFERENCE_ONLY)
    assert not names & {"jax", "jaxlib", "flax", "fluidframework_tpu",
                        "fluidframework_tpu_torch", "torch"}
