"""Incremental summary handles of the port (``protocol/summary.py``) and
the service routes that use them, against the JAX package's.

``resolve_handles`` and ``count_handles`` run on seeded summary trees in
both packages and must give equal results (or equal refusals); an
incremental ``upload_snapshot(..., parent=...)`` through each package's
service must store the same content-addressed tree (equal handles).
"""

from __future__ import annotations

import random

import pytest

from fluidframework_tpu.protocol import summary as j_sum
from fluidframework_tpu.server import durable_store as j_ds
from fluidframework_tpu.server import routerlicious as j_rl
from fluidframework_tpu_torch.protocol import summary as t_sum
from fluidframework_tpu_torch.server import durable_store as t_ds
from fluidframework_tpu_torch.server import routerlicious as t_rl


def summary_tree(seed: int, handles: int) -> tuple[dict, dict]:
    """A parent summary and a child that replaces ``handles`` of its
    channels with handle stubs (one stub may name a missing path)."""
    rng = random.Random(seed)
    parent: dict = {"protocol": {"seq": rng.randrange(100)},
                    "runtime": {"datastores": {}}}
    for d in range(3):
        channels = {}
        for c in range(4):
            channels[f"ch{c}"] = {
                "type": rng.choice(["map", "string", "matrix"]),
                "content": {f"k{i}": rng.randrange(1 << 20)
                            for i in range(rng.randrange(1, 5))},
                # User content shaped like a handle node is never touched.
                "value": {"_handle": f"user-{rng.randrange(9)}"}}
        parent["runtime"]["datastores"][f"ds{d}"] = {"channels": channels}
    child = {"protocol": {"seq": parent["protocol"]["seq"] + 1},
             "runtime": {"datastores": {}}}
    stubs = set(rng.sample([(d, c) for d in range(3) for c in range(4)],
                           handles))
    for d in range(3):
        channels = {}
        for c in range(4):
            if (d, c) in stubs:
                path = f"runtime/datastores/ds{d}/channels/ch{c}"
                if seed % 5 == 4 and (d, c) == min(stubs):
                    path += "/missing"
                channels[f"ch{c}"] = {"_handle": path}
            else:
                channels[f"ch{c}"] = {"type": "map",
                                      "content": {"new": seed}}
        child["runtime"]["datastores"][f"ds{d}"] = {"channels": channels}
    return parent, child


def resolved(mod, parent, child):
    try:
        return mod.resolve_handles(child, parent)
    except KeyError as err:
        return ("KeyError", str(err))


@pytest.mark.parametrize("seed", range(10))
def test_resolve_and_count_handles_equal_jax(seed):
    parent, child = summary_tree(seed, handles=1 + seed % 7)
    got = resolved(t_sum, parent, child)
    assert got == resolved(j_sum, parent, child)
    assert t_sum.count_handles(child) == j_sum.count_handles(child) \
        == 1 + seed % 7
    # Handle-shaped user values are counted but never resolved.
    assert t_sum.count_handles(parent) == j_sum.count_handles(parent) == 12
    if not isinstance(got, tuple):
        # Each resolved stub brings back its parent channel's user value.
        assert t_sum.count_handles(got) == 1 + seed % 7


def test_handle_helpers_equal_jax():
    for node in (t_sum.make_handle("a/b"), {"_handle": 1, "x": 2}, [],
                 {"_handle": "p"}, "s", None):
        assert t_sum.is_handle(node) == j_sum.is_handle(node)
    assert t_sum.make_handle("a/b") == j_sum.make_handle("a/b")
    assert t_sum.SUMMARY_HANDLE_KEY == j_sum.SUMMARY_HANDLE_KEY
    # Trees without the runtime/datastores shape pass through as-is.
    for tree in ({}, {"runtime": 3}, {"runtime": {"datastores": []}}):
        assert t_sum.resolve_handles(tree, {}) == \
            j_sum.resolve_handles(tree, {})


def service(rl, ds, root):
    return rl.RouterliciousService(
        store=ds.FileStateStore(str(root / "state")),
        snapshots=ds.GitSnapshotStore(str(root / "git")),
        auto_pump=False, idle_check_interval=10**9)


@pytest.mark.parametrize("seed", [0, 3, 4])
def test_incremental_upload_snapshot_equals_jax(tmp_path, seed):
    parent, child = summary_tree(seed, handles=5)
    out = {}
    for name, rl, ds in (("jax", j_rl, j_ds), ("torch", t_rl, t_ds)):
        svc = service(rl, ds, tmp_path / name)
        first = svc.upload_snapshot("doc", parent)
        try:
            second = svc.upload_snapshot("doc", child, parent=first)
            stored = svc.snapshots.get("doc", second)
        except KeyError as err:
            second, stored = "KeyError", str(err)
        with pytest.raises(KeyError):
            svc.upload_snapshot("doc", child, parent="no-such-handle")
        out[name] = (first, second, stored,
                     svc.snapshots.head("doc"),
                     svc.get_latest_snapshot("doc"))
    assert out["torch"] == out["jax"]
    first, second, stored, head, latest = out["torch"]
    assert head == first and latest == parent
    assert (second == "KeyError") == (seed % 5 == 4)
    if second != "KeyError":
        assert stored == t_sum.resolve_handles(child, parent)

