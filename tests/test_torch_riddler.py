"""The port's ``server/riddler.py`` against the JAX package's.

The module holds no JAX, so the port keeps a verbatim copy (tenants,
tokens, the fixed-window throttler, the token bucket and the admission
controller). The residency plane takes its ``TokenBucket`` as the
hydration gate. Each test drives both copies with the same seeded
sequence under a fake clock and compares every answer exactly.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest

from fluidframework_tpu.server import riddler as jr
from fluidframework_tpu_torch.server import riddler as tr

MODS = (jr, tr)


class FakeClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def test_copy_is_verbatim():
    root = pathlib.Path(__file__).resolve().parents[1]
    a = (root / "fluidframework_tpu/server/riddler.py").read_bytes()
    b = (root / "fluidframework_tpu_torch/server/riddler.py").read_bytes()
    assert a == b


def _bucket_trace(mod, seed: int) -> list:
    """Random grant / refund / reserve / clock-advance steps over three
    keys; every return value recorded."""
    rng = np.random.default_rng(seed)
    clk = FakeClock()
    bucket = mod.TokenBucket(float(rng.choice([0.5, 2.0, 10.0])),
                             float(rng.choice([1.0, 3.0])), clock=clk)
    out = []
    for _ in range(200):
        key = f"k{int(rng.integers(3))}"
        op = rng.choice(["consume", "refund", "reserve", "tick"],
                        p=[0.4, 0.15, 0.3, 0.15])
        weight = float(rng.choice([1.0, 1.0, 2.0]))
        if op == "consume":
            out.append(("c", bucket.try_consume(key, weight)))
        elif op == "refund":
            bucket.refund(key, weight)
            out.append(("r", None))
        elif op == "reserve":
            out.append(("v", bucket.reserve(key, weight)))
        else:
            clk.t += float(rng.uniform(0.0, 1.5))
            out.append(("t", clk.t))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_token_bucket_ladder_matches_jax(seed):
    traces = [_bucket_trace(mod, seed) for mod in MODS]
    assert traces[0] == traces[1]
    # The trace exercised refusals, reservations and grants alike.
    kinds = {(k, v is None) for k, v in traces[0] if k in "cv"}
    assert ("c", True) in kinds and ("c", False) in kinds


def test_reservation_horizon_refuses_alike():
    out = []
    for mod in MODS:
        clk = FakeClock()
        bucket = mod.TokenBucket(1.0, 1.0, clock=clk)
        out.append([bucket.reserve("k") for _ in range(
            int(mod.TokenBucket.RESERVE_HORIZON_S) + 4)])
    assert out[0] == out[1]
    assert out[0][-1][1] is False  # past the horizon: no debit


@pytest.mark.parametrize("seed", range(2))
def test_throttler_windows_match_jax(seed):
    traces = []
    for mod in MODS:
        rng = np.random.default_rng(seed)
        clk = FakeClock()
        th = mod.Throttler(rate_per_interval=5, interval_s=1.0, clock=clk)
        trace = []
        for _ in range(120):
            if rng.random() < 0.2:
                clk.t += float(rng.uniform(0.0, 0.8))
            trace.append(th.try_consume(f"c{int(rng.integers(2))}",
                                        float(rng.integers(1, 3))))
        traces.append(trace)
    assert traces[0] == traces[1]


@pytest.mark.parametrize("seed", range(2))
def test_admission_controller_matches_jax(seed):
    traces, stats = [], []
    for mod in MODS:
        rng = np.random.default_rng(seed)
        clk = FakeClock()
        pressure = [0.0]
        ac = mod.AdmissionController(
            connect_rate_per_s=2.0, connect_burst=2.0,
            write_rate_per_s=50.0, write_burst=20.0,
            client_write_rate_per_s=10.0, client_write_burst=8.0,
            clock=clk)
        ac.add_pressure_probe(lambda: pressure[0])
        trace = []
        for _ in range(240):
            r = rng.random()
            if r < 0.1:
                clk.t += float(rng.uniform(0.0, 1.0))
            elif r < 0.15:
                pressure[0] = float(rng.choice([0.0, 0.6, 0.8, 1.0]))
            tenant = f"t{int(rng.integers(2))}"
            client = [None, "a", "b", "c"][int(rng.integers(4))]
            op = int(rng.integers(4))
            if op == 0:
                trace.append(ac.admit_connect(tenant, client))
            elif op == 1:
                trace.append(ac.admit_write(tenant, client,
                                            float(rng.integers(1, 6))))
            elif op == 2:
                trace.append(ac.admit_read(tenant))
            else:
                trace.append(ac.admit_signal(tenant))
        traces.append(trace)
        stats.append(dict(ac.stats))
    assert traces[0] == traces[1]
    assert stats[0] == stats[1]
    assert stats[0]["shed_connects"] and stats[0]["shed_writes"]


class DictStore:
    def __init__(self) -> None:
        self.d = {}

    def get(self, key):
        return self.d.get(key)

    def put(self, key, value):
        self.d[key] = value


def test_tokens_and_tenants_match_jax():
    out = []
    for mod in MODS:
        store = DictStore()
        tm = mod.TenantManager(store)
        tm.create_tenant("acme", secret="s3cret", tier="pro")
        tm.create_tenant("free-co", secret="x", tier="free")
        tok = mod.sign_token("acme", "s3cret", "doc-1", ["doc:read"],
                             user="u", lifetime_s=60.0, now=1000.0)
        rec = {"token": tok,
               "claims": tm.validate_token(tok, "doc-1", now=1030.0),
               "weights": tm.tenant_weights(),
               "store": store.d}
        errors = []
        for args in ((tok, "doc-2", 1030.0), (tok, "doc-1", 2000.0),
                     (tok[:-2] + "AA", "doc-1", 1030.0),
                     ("garbage", None, 1030.0)):
            with pytest.raises(mod.AuthError) as err:
                tm.validate_token(args[0], args[1], now=args[2])
            errors.append(str(err.value))
        rec["errors"] = errors
        tm.set_tier("free-co", "premium")
        rec["reloaded"] = mod.TenantManager(store).tenant_weights()
        out.append(rec)
    assert out[0] == out[1]
    assert out[0]["reloaded"]["free-co"] == 4.0
