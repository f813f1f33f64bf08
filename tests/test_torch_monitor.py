"""The port's service monitor (``tools/monitor.py``) against the JAX
package's, on the CPU.

The reference's own monitor cases — the monitor half of
``tests/test_debugger_monitor.py``, ``tests/test_history.py``'s
``test_render_history_line`` and ``tests/test_qos.py``'s
``test_render_tenants_line`` — run twice: once against the reference
with every ``render_*`` function (and ``stage_shares``) recorded, after
which the port's function must return the same string on each recorded
call's arguments; and once against the port, its module standing in for
the reference's, so the port meets the reference test's own assertions.
Then ``scrape`` and ``python -m fluidframework_tpu_torch.tools.monitor
--once`` read the port's ``AlfredServer`` and ``BridgeFrontDoor``.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import fluidframework_tpu.tools as j_tools
from fluidframework_tpu.tools import monitor as j_monitor
from fluidframework_tpu_torch.server import alfred as t_alfred
from fluidframework_tpu_torch.server import bridge_host as t_bh
from fluidframework_tpu_torch.tools import monitor as t_monitor

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent


def _reference_tests(name: str):
    """A reference test module, loaded by path under a name of its own."""
    spec = importlib.util.spec_from_file_location(f"_reference_{name}",
                                                  TESTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_DM = _reference_tests("test_debugger_monitor")
_HIST = _reference_tests("test_history")
_QOS = _reference_tests("test_qos")

#: The reference's monitor cases that need no process, by name.
CASES = {
    "watch_json_mode_emits_lines_with_deltas":
        lambda mp: _DM.TestServiceMonitor()
        .test_watch_json_mode_emits_lines_with_deltas(mp),
    "watch_reconnects_after_restart":
        lambda mp: _DM.TestServiceMonitor()
        .test_watch_reconnects_after_restart(mp),
    "stage_bar_renders_attribution":
        lambda mp: _DM.TestServiceMonitor()
        .test_stage_bar_renders_attribution(),
    "rebalance_line": lambda mp: _DM.test_rebalance_line_renders_fire_rate(),
    "pipeline_line":
        lambda mp: _DM.test_pipeline_line_renders_depth_and_overlap(),
    "viewer_line": lambda mp: _DM.test_viewer_line_renders_broadcast_plane(),
    "residency_line":
        lambda mp: _DM.test_residency_line_renders_tiering_state(),
    "megadoc_line":
        lambda mp: _DM.test_megadoc_line_renders_write_scaleout_plane(),
    "cluster_line":
        lambda mp: _DM.test_cluster_line_renders_placement_plane(),
    "replication_line":
        lambda mp: _DM.test_replication_line_renders_plane_state(),
    "transport_line":
        lambda mp: _DM.test_transport_line_renders_wire_state(),
    "replicas_line":
        lambda mp: _DM.test_replicas_line_renders_read_tier_state(),
    "history_line": lambda mp: _HIST.test_render_history_line(),
    "tenants_line": lambda mp: _QOS.test_render_tenants_line(),
}

RECORDED = sorted([n for n in vars(j_monitor) if n.startswith("render_")]
                  + ["stage_shares"])


def test_port_monitor_has_the_references_functions():
    assert sorted(n for n in vars(t_monitor) if n.startswith("render_")) \
        == [n for n in RECORDED if n.startswith("render_")]
    assert t_monitor.STORM_STAGES == j_monitor.STORM_STAGES


#: The JSON watch mode renders nothing: it prints the raw scrape.
RENDERING = [c for c in CASES
             if c != "watch_json_mode_emits_lines_with_deltas"]


@pytest.mark.parametrize("case", RENDERING)
def test_render_outputs_equal_the_references(case, monkeypatch):
    """Every render call the reference case makes returns the same value
    from the port's function on the same arguments."""
    calls = []

    def wrap(name, inner):
        def recorded(*args, **kw):
            saved = copy.deepcopy((args, kw))
            out = inner(*args, **kw)
            calls.append((name, saved, out))
            return out
        return recorded

    for name in RECORDED:
        monkeypatch.setattr(j_monitor, name, wrap(name, getattr(j_monitor,
                                                                name)))
    CASES[case](monkeypatch)
    assert calls, f"{case} rendered nothing"
    for name, (args, kw), want in calls:
        assert getattr(t_monitor, name)(*args, **kw) == want, (name, args)


@pytest.mark.parametrize("case", list(CASES))
def test_reference_case_passes_against_the_port(case, monkeypatch):
    """The reference case's own assertions, the port's module in place of
    the reference's."""
    monkeypatch.setitem(sys.modules, "fluidframework_tpu.tools.monitor",
                        t_monitor)
    monkeypatch.setattr(j_tools, "monitor", t_monitor)
    CASES[case](monkeypatch)


# -- scrapes of the port's front doors ----------------------------------------


def _drive_one_op(port: int) -> None:
    """One client round trip through the reference's JAX-free client."""
    import time

    from fluidframework_tpu.dds.map import SharedMap
    from fluidframework_tpu.drivers.tinylicious_driver import (
        TinyliciousDocumentServiceFactory,
    )
    from fluidframework_tpu.runtime.container import Container
    svc = TinyliciousDocumentServiceFactory(port=port)("doc")
    container = Container.create_detached(svc)
    ds = container.runtime.create_datastore("default")
    ds.create_channel("root", SharedMap.channel_type)
    with svc.dispatch_lock:
        container.attach()
        ds.get_channel("root").set("k", 1)
    deadline = time.monotonic() + 30
    while container.runtime.pending.has_pending \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not container.runtime.pending.has_pending
    svc.close()


def _monitor_once(port: int) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    out = subprocess.run(
        [sys.executable, "-m", "fluidframework_tpu_torch.tools.monitor",
         "--port", str(port), "--once"],
        capture_output=True, text=True, timeout=60, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


def test_scrape_the_ports_bridge_door():
    service = t_alfred.build_default_service(merge_host=False, device="cpu")
    front = t_bh.BridgeFrontDoor(service, 0)
    try:
        assert isinstance(t_monitor.scrape("127.0.0.1", front.port), dict)
        _drive_one_op(front.port)
        after = t_monitor.scrape("127.0.0.1", front.port)
        assert after.get("alfred.connects", 0) >= 1
        assert after.get("deli.sequenced_ops", 0) >= 1
        once = _monitor_once(front.port)
        assert once.get("deli.sequenced_ops", 0) >= 1
    finally:
        front.close()


def test_scrape_the_ports_alfred_server():
    """``tests/test_debugger_monitor.py``'s live scrape and ``--once`` CLI
    against the port's standalone alfred."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    proc = subprocess.Popen(
        [sys.executable, "-m", "fluidframework_tpu_torch.server.alfred",
         "--port", "0", "--no-merge-host", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    try:
        line = proc.stdout.readline()
        assert line.startswith("READY "), (line, proc.stderr.read())
        port = int(line.split()[1])
        assert isinstance(t_monitor.scrape("127.0.0.1", port), dict)
        _drive_one_op(port)
        after = t_monitor.scrape("127.0.0.1", port)
        assert after.get("alfred.connects", 0) >= 1
        assert after.get("deli.sequenced_ops", 0) >= 1
        assert isinstance(_monitor_once(port), dict)
        assert t_monitor.render_human(after, {}, interval=1.0) \
            == j_monitor.render_human(after, {}, interval=1.0)
    finally:
        proc.terminate()
        proc.wait(timeout=10)
