"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the metrics."""

from __future__ import annotations

import gc
import importlib.util
import statistics

from . import check
from .cell import HERE, Staged, generate_sets, load_cell, now
from .trace import TICK, WINDOW, Marks, reduce
from .window import Ticker, run_epochs


def build_kernels() -> None:
    """Every kernel source of the program, built once into the program's
    own build directory inside the checkout (later runs load them)."""
    from fluidframework_tpu_torch.ops import _build
    _build.build_all(sorted(p.stem for p in _build.CSRC.glob("*.cu")))


def read_metric(name: str, run: dict):
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def p95(values: list) -> float:
    """The 95th percentile (``statistics.quantiles``, exclusive method)."""
    return statistics.quantiles(values, n=20)[18]


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, metrics: dict, control: bool = False) -> dict:
    """``metrics``: {name: unit} of the metrics to report. Returns the
    result's fields: ``correct``, ``attempted``, ``failed``, ``metrics``,
    ``memory_peak_bytes``, ``checks`` and, traced, ``busy_s``,
    ``window_s`` and ``breakdown``. With ``control`` the check judges the
    control's outputs (``perfbench/control.py``) in the program's place."""
    import torch
    work, config = load_cell(name)
    if "driver" in work:
        # A cell served through another entry of the program: the driver
        # its workload names (``drivers/<driver>.py``) runs all of it.
        driver = importlib.import_module(
            f"perfbench.drivers.{work['driver']}")
        return driver.run(work, config, seed, seconds, trace, device,
                          t_start, metrics, control=control)
    cuda = device.type == "cuda"
    if cuda:
        build_kernels()
    sets = generate_sets(config, work, seed)
    staged = Staged(config, sets, device)
    # Warm-up: one epoch of every input set, untimed.
    run_epochs(Ticker(staged), len(sets))
    marks = Marks() if trace else None
    ticker = Ticker(staged, mark=marks)
    prof_out = None
    traced_keys: dict = {"marked": [], "profiled": []}
    # What set-up built stays: the collector need not walk it again.
    gc.collect()
    gc.freeze()
    ticker.anchor()
    setup_s = now() - t_start
    start = now()
    while now() - start < seconds:
        if (trace and prof_out is None and ticker.tick == 0
                and now() - start >= seconds / 3):
            prof_out = traced_epochs(ticker, work["trace_epochs"], marks,
                                     traced_keys, cuda)
            continue
        ticker.dispatch()
    ticker.drain()
    window_s = now() - start
    ticker.anchor()
    latency_s, clock_scale = ticker.ready_latency_s()
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    repeat = int(ticker.repeat_diffs) + ticker.harvest_repeat_diffs
    firsts = {i: t.cpu().numpy() for i, t in ticker.first_capture.items()}
    legs = marks.legs() if marks else {}
    ticker.states = None
    del staged.ticks
    if cuda:
        torch.cuda.empty_cache()

    # The check: after the window, with the program's state freed.
    tickets = check.expected_tickets(config, sets)
    harvests = ticker.first_harvest
    states_of = check.program_states(
        staged.sample_rows,
        lambda i: staged.split(firsts[i], i) if i in firsts else None)
    if control:
        from perfbench import control as ctl
        harvests = ctl.harvests(config, tickets, harvests)
        states_of = ctl.states(config, sets, tickets)
        repeat = 0
    values = {
        "harvest_diffs": check.harvest_diffs(config, sets, tickets, harvests),
        "repeat_diffs": repeat,
        "sets_unchecked": 0 if control else len(sets) - len(firsts)}
    values["state_diffs"], compared = check.state_diffs(
        config, sets, tickets, states_of)
    verdict = check.summary(values)

    out = {"correct": verdict["correct"], "attempted": ticker.attempted,
           "failed": ticker.attempted - ticker.ops,
           "memory_peak_bytes": int(peak), "compared_docs": compared,
           "ticks": ticker.ticks_run, "epochs": ticker.epochs_done,
           "ops_per_s": ticker.ops / window_s,
           "ops_per_s_by_quarter": quarter_rates(ticker, start, window_s),
           "tick_p95_read_ms": 1e3 * p95(ticker.latency_s),
           "clock_scale": clock_scale, "control": control}
    if not trace:
        values = {"merged_ops_per_s": ticker.ops / window_s,
                  "tick_p95_ms": 1e3 * p95(latency_s),
                  "setup_s": setup_s}
    else:
        run = {"legs": legs, "host_tick_s": ticker.host_tick_s,
               "kstats": ticker.kstats, "families": staged.families,
               "work": work_counts(staged, sets, traced_keys),
               **(prof_out or {"kernels": {}})}
        values = {m: read_metric(m, run) for m in metrics}
        out.update(busy_s=run.get("busy_s"), window_s=run.get("window_s"),
                   breakdown=run.get("breakdown"))
    out["metrics"] = {m: {"value": float(v), "unit": metrics[m]}
                      for m, v in values.items()
                      if m in metrics and v is not None}
    out["checks"] = verdict["checks"]
    return out


def quarter_rates(ticker: Ticker, start: float, window_s: float) -> list:
    """Ops/s harvested in each quarter of the window (a steadiness
    reading; the end-to-end rate is over the whole window)."""
    ops = [0, 0, 0, 0]
    for t, k in zip(ticker.harvested_at, ticker.kstats):
        ops[min(3, int(4 * (t - start) / window_s))] += int(k[0])
    return [4 * o / window_s for o in ops]


def traced_epochs(ticker: Ticker, epochs: int, marks: Marks, keys: dict,
                  cuda: bool) -> dict:
    """``epochs`` whole epochs with the tick's leg marks on, then
    ``epochs`` more under ``torch.profiler`` (whose host cost would swell
    the marks' host-paced legs), each span from an epoch boundary with
    nothing in flight. ``keys`` gets the (input set, tick) of the marked
    and of the profiled ticks; the profiled ticks' host spans are dropped
    from the ticker's."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    ticks = epochs * ticker.staged.config["epoch_ticks"]
    ticker.drain()
    marks.on = True
    for _ in range(ticks):
        keys["marked"].append((ticker.set_index, ticker.tick))
        ticker.dispatch()
    ticker.drain()
    marks.on = False
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    spans = len(ticker.host_tick_s)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            for _ in range(ticks):
                keys["profiled"].append((ticker.set_index, ticker.tick))
                with record_function(TICK):
                    ticker.dispatch()
            ticker.drain()
    if cuda:
        torch.cuda.synchronize()
    del ticker.host_tick_s[spans:]
    return reduce(prof)


def work_counts(staged: Staged, sets: list, keys: dict) -> dict:
    """Least bytes of the text work of the profiled ticks (what kernel
    3's traced time did) and of the tree work of the marked ticks (what
    the tree leg's marks timed), counted from their inputs and the
    tables' shapes."""
    from perfbench.metrics import _work
    _seq, _map, text, _matrix, tree = staged.snapshot
    out = {}
    if text is not None:
        _b, nb, bk = text.length.shape
        props, words = text.prop_val.shape[3], text.rem_overlap.shape[3]
        out["k3_bytes"] = sum(_work.k3_bytes(
            sets[i]["inputs"]["text"][t], nb, bk, props, words)
            for i, t in keys["profiled"])
    if tree is not None:
        out["tree_bytes"] = sum(_work.tree_bytes(sets[i]["inputs"]["tree"][t])
                                for i, t in keys["marked"])
    return out
