"""SLO observatory (the port of the JAX package's ``runtime/slo.py``):
declarative serving objectives over streaming log-bucket histograms with
sliding-window error-budget burn rates.

The fleet router (``serve/router.py``) is the only place that sees the
whole fleet's latency story, so objectives are evaluated there, from
router-measured observations (TTFT = admission to the first relayed body
byte, ITL = inter-chunk gaps on the SSE relay, shed = admission-gate
rejections). Stdlib plus the port's ``telemetry`` only: host-side, no
device, no torch.

Objective grammar (``--slo`` flag or a JSON file mapping name→number):

    ttft_p95_ms=500,itl_p50_ms=40,shed_rate=0.01

``<metric>_p<NN>_ms=T`` declares "the p<NN> of <metric> stays ≤ T ms";
its error budget is the quantile's complement (p95 → 5% of requests may
exceed T). ``shed_rate=B`` declares "at most fraction B of requests may
be shed"; the budget is B itself. A request that exceeds its latency
threshold (or is shed) is a *bad event*; the burn rate of a window is
``bad_fraction / budget`` — 1.0 burns exactly the budget, >1 exhausts
it early. Compliance is evaluated on the full streaming histogram:
``quantile(p) <= threshold`` flips exactly at the configured threshold.
The gauges are the ``dllama_slo_*`` names of
:mod:`~dllama_tpu_torch.runtime.telemetry`.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import time

from . import telemetry

# the closed-world objective vocabulary: cli grammar, /debug/slo,
# gauges, bench output, and PERF.md all spell these names exactly
OBJECTIVES = ("ttft_p95_ms", "itl_p50_ms", "shed_rate")

# burn-rate windows (label, seconds) — the classic short/long pair: the
# short window catches a fast burn, the long one a slow leak
WINDOWS = (("5m", 300.0), ("1h", 3600.0))

_LATENCY_RE = re.compile(r"^(ttft|itl)_p(\d{2})_ms$")


def parse_slo(spec: str) -> dict[str, float]:
    """``"ttft_p95_ms=500,itl_p50_ms=40"`` → ``{name: threshold}``.
    Raises ``ValueError`` on unknown objective names, non-positive or
    unparseable thresholds, and duplicates — a typo'd SLO must fail at
    startup, not silently never alarm."""
    out: dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"SLO objective {part!r} is not name=value")
        name, _, raw = part.partition("=")
        name = name.strip()
        if name not in OBJECTIVES:
            raise ValueError(
                f"unknown SLO objective {name!r} (known: "
                f"{', '.join(OBJECTIVES)})")
        if name in out:
            raise ValueError(f"duplicate SLO objective {name!r}")
        try:
            val = float(raw)
        except ValueError:
            raise ValueError(
                f"SLO objective {name}: threshold {raw!r} is not a number")
        if not math.isfinite(val) or val <= 0:
            raise ValueError(
                f"SLO objective {name}: threshold must be a positive "
                f"finite number, got {raw!r}")
        out[name] = val
    if not out:
        raise ValueError("empty SLO spec")
    return out


def load_slo(arg: str) -> dict[str, float]:
    """The ``--slo`` flag value: a ``name=value,...`` string, or the
    path of a JSON file mapping objective names to thresholds."""
    if os.path.isfile(arg):
        with open(arg, encoding="utf-8") as f:
            data = json.load(f)
        if not isinstance(data, dict):
            raise ValueError(f"{arg}: SLO file must be a JSON object")
        return parse_slo(",".join(f"{k}={v}" for k, v in data.items()))
    return parse_slo(arg)


class LogHistogram:
    """Streaming log-bucket histogram: geometric buckets with growth
    ``GROWTH``, so any quantile estimate (the geometric midpoint of its
    bucket) carries a bounded relative error of ``sqrt(GROWTH) - 1``
    (~3.9%) regardless of the distribution's shape or range — the
    property the SLO compliance check needs and the fixed-bucket
    telemetry.Histogram explicitly disclaims. Memory is bounded by the
    dynamic range, not the sample count (~240 buckets spanning 1e-4 to
    1e4). Values ≤ 0 collapse into a single underflow bucket reported
    as 0.0. Not thread-safe on its own; SloEngine serializes access."""

    GROWTH = 1.08
    _LOG_G = math.log(GROWTH)

    def __init__(self):
        self._counts: dict[int, int] = {}
        self._n_zero = 0
        self.n = 0
        self.sum = 0.0

    def record(self, value: float) -> None:
        self.n += 1
        self.sum += value
        if value <= 0.0:
            self._n_zero += 1
            return
        i = int(math.floor(math.log(value) / self._LOG_G))
        self._counts[i] = self._counts.get(i, 0) + 1

    def quantile(self, q: float) -> float:
        """Geometric-midpoint estimate of the q-quantile (0..1); 0.0
        when empty. Rank convention matches a sorted-array index
        ``ceil(q*n)`` so a point mass lands exactly on its bucket."""
        if self.n == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.n))
        seen = self._n_zero
        if rank <= seen:
            return 0.0
        for i in sorted(self._counts):
            seen += self._counts[i]
            if seen >= rank:
                return math.exp((i + 0.5) * self._LOG_G)
        return 0.0  # unreachable: counts sum to n

    def rel_error_bound(self) -> float:
        """The worst-case relative error of any quantile estimate."""
        return math.sqrt(self.GROWTH) - 1.0


class _BurnWindow:
    """Sliding good/bad event counts over ``span_s`` seconds, kept in
    coarse time buckets (``_N_BUCKETS`` per span) so the hot path is
    one dict update — no per-event deque, no wall-clock reads (the
    clock is whatever monotonic callable the engine injected)."""

    _N_BUCKETS = 60

    def __init__(self, span_s: float):
        self.span_s = span_s
        self._width = span_s / self._N_BUCKETS
        self._buckets: dict[int, list[int]] = {}  # idx -> [good, bad]

    def note(self, now: float, bad: bool) -> None:
        idx = int(now / self._width)
        b = self._buckets.get(idx)
        if b is None:
            # lazily expire everything outside the window; at most
            # _N_BUCKETS live entries survive
            floor = idx - self._N_BUCKETS
            for k in [k for k in self._buckets if k <= floor]:
                del self._buckets[k]
            b = self._buckets[idx] = [0, 0]
        b[1 if bad else 0] += 1

    def fractions(self, now: float) -> tuple[int, float]:
        """``(n_events, bad_fraction)`` over the trailing window."""
        floor = int(now / self._width) - self._N_BUCKETS
        good = bad = 0
        for k, (g, b) in self._buckets.items():
            if k > floor:
                good += g
                bad += b
        n = good + bad
        return n, (bad / n if n else 0.0)


class _Objective:
    """One parsed objective: its kind, threshold, error budget, and the
    per-window burn trackers."""

    def __init__(self, name: str, threshold: float):
        self.name = name
        self.threshold = threshold
        m = _LATENCY_RE.match(name)
        if m:
            self.kind = "latency"
            self.metric = m.group(1)          # "ttft" | "itl"
            self.quantile = int(m.group(2)) / 100.0
            self.budget = max(1e-9, 1.0 - self.quantile)
        else:  # shed_rate — the only non-latency member of OBJECTIVES
            self.kind = "rate"
            self.metric = "shed"
            self.quantile = None
            self.budget = threshold
        self.windows = {label: _BurnWindow(span)
                        for label, span in WINDOWS}
        self.n_bad = 0
        self.n_events = 0

    def note(self, now: float, bad: bool) -> None:
        self.n_events += 1
        if bad:
            self.n_bad += 1
        for w in self.windows.values():
            w.note(now, bad)


class SloEngine:
    """The router's SLO evaluator: feed it router-measured observations
    (``observe_ttft`` / ``observe_itl`` in ms, ``observe_outcome`` per
    admission decision), read back :meth:`evaluate` — which also
    publishes the ``dllama_slo_compliance`` / ``dllama_slo_burn_rate``
    gauges. The clock is injectable (tests advance it by hand); the
    default is ``time.monotonic`` — never wall time, so a clock step
    can't fabricate or destroy a burn window."""

    def __init__(self, objectives: dict[str, float], *,
                 clock=time.monotonic, registry=None):
        self._clock = clock
        self._reg = registry if registry is not None else (
            telemetry.registry())
        self._lock = threading.Lock()
        self._objectives = {name: _Objective(name, thr)
                            for name, thr in objectives.items()}
        self._hists = {"ttft": LogHistogram(), "itl": LogHistogram()}
        # per-tenant twin state (runtime/tenancy's observatory): lifetime
        # histograms + shed counts keyed by canonical tenant label — the
        # caller resolves labels through TenantRegistry.resolve(), so
        # cardinality is already bounded there; the local cap below is a
        # second fence (tenancy can't be imported here: it uses this
        # module's LogHistogram). Burn windows stay GLOBAL only — per
        # tenant×objective×window gauge series is exactly the cardinality
        # blow-up the observatory is built to prevent.
        self._tenants: dict[str, dict] = {}

    _TENANT_CAP = 64  # mirrors tenancy.TENANT_CAP; overflow → "other"

    def _tenant_state(self, tenant: str) -> dict:
        st = self._tenants.get(tenant)
        if st is None:
            if tenant != "other" and len(self._tenants) >= self._TENANT_CAP:
                return self._tenant_state("other")
            st = self._tenants[tenant] = {
                "hists": {"ttft": LogHistogram(), "itl": LogHistogram()},
                "shed": [0, 0]}  # [bad, events]
        return st

    @property
    def objective_names(self) -> tuple[str, ...]:
        return tuple(self._objectives)

    def _observe_latency(self, metric: str, ms: float,
                         tenant: str | None = None) -> None:
        now = self._clock()
        with self._lock:
            self._hists[metric].record(ms)
            if tenant is not None:
                self._tenant_state(tenant)["hists"][metric].record(ms)
            for obj in self._objectives.values():
                if obj.kind == "latency" and obj.metric == metric:
                    obj.note(now, ms > obj.threshold)

    def observe_ttft(self, ms: float, tenant: str | None = None) -> None:
        self._observe_latency("ttft", ms, tenant)

    def observe_itl(self, ms: float, tenant: str | None = None) -> None:
        self._observe_latency("itl", ms, tenant)

    def observe_outcome(self, *, shed: bool,
                        tenant: str | None = None) -> None:
        """One admission decision: admitted (good) or shed (bad)."""
        now = self._clock()
        with self._lock:
            if tenant is not None:
                st = self._tenant_state(tenant)["shed"]
                st[0] += 1 if shed else 0
                st[1] += 1
            for obj in self._objectives.values():
                if obj.kind == "rate":
                    obj.note(now, shed)

    def evaluate(self) -> dict:
        """Per-objective compliance + burn, as the ``/debug/slo`` body;
        publishes the gauges as a side effect. Compliance: latency
        objectives compare the streaming histogram's quantile estimate
        to the threshold (≤ passes — flips exactly at the threshold);
        shed_rate compares the lifetime shed fraction to the budget."""
        now = self._clock()
        out: dict = {"objectives": {},
                     "windows": [label for label, _ in WINDOWS]}
        with self._lock:
            for name, obj in self._objectives.items():
                rec: dict = {"threshold": obj.threshold,
                             "kind": obj.kind, "budget": obj.budget,
                             "n": obj.n_events}
                if obj.kind == "latency":
                    h = self._hists[obj.metric]
                    rec["quantile"] = obj.quantile
                    rec["estimate"] = h.quantile(obj.quantile)
                    rec["rel_error_bound"] = h.rel_error_bound()
                    compliant = rec["estimate"] <= obj.threshold
                else:
                    frac = (obj.n_bad / obj.n_events
                            if obj.n_events else 0.0)
                    rec["estimate"] = frac
                    compliant = frac <= obj.threshold
                rec["compliant"] = bool(compliant)
                burns: dict[str, float] = {}
                for label, w in obj.windows.items():
                    n, bad_frac = w.fractions(now)
                    burns[label] = (bad_frac / obj.budget) if n else 0.0
                rec["burn"] = burns
                # per-tenant compliance (the tenant observatory): the
                # same objective evaluated over each tenant's own
                # lifetime observations — a fleet meeting its p95
                # globally can still be failing ONE tenant, and that
                # must be visible as dllama_slo_compliance{tenant=...}
                tenants: dict[str, dict] = {}
                for t, st in self._tenants.items():
                    if obj.kind == "latency":
                        h = st["hists"][obj.metric]
                        if not h.n:
                            continue
                        est = h.quantile(obj.quantile)
                        ok = est <= obj.threshold
                    else:
                        bad, n = st["shed"]
                        if not n:
                            continue
                        est = bad / n
                        ok = est <= obj.threshold
                    tenants[t] = {"estimate": est, "compliant": bool(ok)}
                if tenants:
                    rec["tenants"] = tenants
                out["objectives"][name] = rec
        comp_g = self._reg.gauge(telemetry.SLO_COMPLIANCE)
        burn_g = self._reg.gauge(telemetry.SLO_BURN_RATE)
        for name, rec in out["objectives"].items():
            comp_g.set(1.0 if rec["compliant"] else 0.0, objective=name)
            for t, trec in rec.get("tenants", {}).items():
                comp_g.set(1.0 if trec["compliant"] else 0.0,
                           objective=name, tenant=t)
            for label, burn in rec["burn"].items():
                burn_g.set(burn, objective=name, window=label)
        return out
