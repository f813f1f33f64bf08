"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, the program
(``fluidframework_tpu_torch``) and this folder, on a machine with the
CUDA devices the cell asks for. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; then ``checks``, each compared
number beside its limit, which also close standard error. Exits non-zero
with no result line when CUDA or the cell's devices are missing, and when
JAX or the JAX package was loaded.

``--control 1`` runs the cell as usual but hands the check the control's
outputs in the program's place (``perfbench/control.py``): its line has
to read ``correct`` false. The benchmark's own runs leave it at 0."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

# One process with few threads: the host work of a tick is one thread's
# launches, and idle worker pools only contend with it for the cores.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: Top-level modules that may not be loaded in a run (compared whole).
BANNED = ("jax", "jaxlib", "flax", "fluidframework_tpu")


def parse(argv: list) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def pin_one_core() -> None:
    """Keep this process, and the threads the CUDA runtime starts in it
    later, on one core: the tick's host work is one thread's launches,
    whose pace should not follow the scheduler's placement of it."""
    if hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})


def cell_metrics(bench: dict, name: str, trace: bool) -> dict:
    """{metric: unit} the cell reports: its end-to-end metrics, or traced
    its per-layer metrics."""
    group = bench["per_layer" if trace else "end_to_end"]
    return {m["name"]: m["unit"] for m in group
            if name in m.get("workloads", [name])}


def power_limit_w() -> str | None:
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return got.stdout.strip() or None


def loaded_banned() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def main(argv: list) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell named {args.workload!r}", file=sys.stderr)
        return 2
    entry = cells[args.workload]
    pin_one_core()
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        print(f"cell {args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from perfbench.harness.bench import run_cell
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T_START,
                   cell_metrics(bench, args.workload, bool(args.trace)),
                   control=bool(args.control))
    found = loaded_banned()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": entry["chips"],
              "memory_peak_bytes": out.pop("memory_peak_bytes"),
              "power_limit_w": power_limit_w()}
    if args.trace:
        device["busy_s"] = out.pop("busy_s")
        device["window_s"] = out.pop("window_s")
    checks = out.pop("checks")
    result = {"correct": out.pop("correct"), "attempted": out.pop("attempted"),
              "failed": out.pop("failed"), "metrics": out.pop("metrics"),
              "device": device}
    breakdown = out.pop("breakdown", None)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["run"] = out
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
