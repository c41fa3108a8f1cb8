"""The port's SLO observatory (``dllama_tpu_torch/runtime/slo.py``) held
against the JAX package's ``runtime/slo.py`` in one process: the objective
grammar accepts and refuses the same specs with the same messages, the
streaming log-bucket histogram gives the same quantiles on a seeded stream,
and ``SloEngine.evaluate`` gives equal dicts — global and per-tenant
compliance, burn rates over both windows, the published gauges — for one
seeded observation stream under an injected clock. Host only."""

from __future__ import annotations

import json

import numpy as np
import pytest

from dllama_tpu.runtime import slo as jslo
from dllama_tpu.runtime import telemetry as jtm
from dllama_tpu_torch.runtime import slo as tslo
from dllama_tpu_torch.runtime import telemetry as ttm


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("err", str(e))


@pytest.mark.parametrize("spec", [
    "ttft_p95_ms=500, itl_p50_ms=40,shed_rate=0.01",
    "itl_p50_ms=12.5",
    "shed_rate=0.2,ttft_p95_ms=1e3",
    "ttft_p95_ms",
    "latency_p95=5",
    "ttft_p95_ms=500,ttft_p95_ms=600",
    "ttft_p95_ms=banana",
    "ttft_p95_ms=0",
    "ttft_p95_ms=-3",
    "ttft_p95_ms=inf",
    "ttft_p95_ms=nan",
    "",
    " , ,",
    "ttft_p99_ms=5",
])
def test_parse_slo_same_verdicts(spec):
    assert _outcome(tslo.parse_slo, spec) == _outcome(jslo.parse_slo, spec)


def test_load_slo_file_and_inline_same(tmp_path):
    good = tmp_path / "slo.json"
    good.write_text(json.dumps({"ttft_p95_ms": 500, "shed_rate": 0.01}))
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 2]")
    for arg in (str(good), str(bad), "itl_p50_ms=40", "nope=1"):
        assert _outcome(tslo.load_slo, arg) == _outcome(jslo.load_slo, arg), arg
    assert tslo.OBJECTIVES == jslo.OBJECTIVES and tslo.WINDOWS == jslo.WINDOWS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_log_histogram_quantiles_equal(seed):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.lognormal(3.0, 1.5, 400), np.zeros(7),
                           -rng.random(3), rng.uniform(1e-3, 1e4, 90)])
    rng.shuffle(vals)
    hj, ht = jslo.LogHistogram(), tslo.LogHistogram()
    assert ht.quantile(0.5) == hj.quantile(0.5) == 0.0
    for v in vals.tolist():
        hj.record(v)
        ht.record(v)
    assert (ht.n, ht.sum) == (hj.n, hj.sum)
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert ht.quantile(q) == hj.quantile(q), q
    assert ht.rel_error_bound() == hj.rel_error_bound()


class _Clock:
    def __init__(self):
        self.t = 5000.0

    def __call__(self):
        return self.t


def _gauges(reg, tm) -> dict:
    out = {}
    for name in (tm.SLO_COMPLIANCE, tm.SLO_BURN_RATE):
        g = reg.gauge(name)
        out[name] = sorted(g.items())
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_slo_engine_evaluate_equal(seed):
    """One seeded stream of TTFT/ITL observations and admission outcomes
    over five tenants (the clock advancing across both burn windows):
    every ``evaluate`` along the way, and the gauges it publishes, are equal."""
    objectives = {"ttft_p95_ms": 120.0, "itl_p50_ms": 15.0, "shed_rate": 0.05}
    cj, ct = _Clock(), _Clock()
    rj, rt = jtm.Registry(), ttm.Registry()
    ej = jslo.SloEngine(objectives, clock=cj, registry=rj)
    et = tslo.SloEngine(objectives, clock=ct, registry=rt)
    assert et.objective_names == ej.objective_names
    rng = np.random.default_rng(seed)
    tenants = [None, "anon", "flood", "light", "metered"]
    for step in range(600):
        dt = float(rng.exponential(4.0))
        cj.t += dt
        ct.t += dt
        tenant = tenants[int(rng.integers(len(tenants)))]
        kind = int(rng.integers(3))
        if kind == 0:
            ms = float(rng.lognormal(4.2, 0.6))
            ej.observe_ttft(ms, tenant=tenant)
            et.observe_ttft(ms, tenant=tenant)
        elif kind == 1:
            ms = float(rng.lognormal(2.5, 0.5))
            ej.observe_itl(ms, tenant=tenant)
            et.observe_itl(ms, tenant=tenant)
        else:
            shed = bool(rng.random() < 0.07)
            ej.observe_outcome(shed=shed, tenant=tenant)
            et.observe_outcome(shed=shed, tenant=tenant)
        if step % 97 == 0:
            assert et.evaluate() == ej.evaluate(), step
    assert et.evaluate() == ej.evaluate()
    assert _gauges(rt, ttm) == _gauges(rj, jtm)


def test_slo_engine_tenant_cap_folds_into_other():
    """Past 64 tenants both engines fold new labels into ``other``."""
    objectives = {"shed_rate": 0.5}
    ej = jslo.SloEngine(objectives, clock=_Clock(), registry=jtm.Registry())
    et = tslo.SloEngine(objectives, clock=_Clock(), registry=ttm.Registry())
    for i in range(80):
        for e in (ej, et):
            e.observe_outcome(shed=i % 3 == 0, tenant=f"t{i}")
    got, want = et.evaluate(), ej.evaluate()
    assert got == want
    assert "other" in got["objectives"]["shed_rate"]["tenants"]
