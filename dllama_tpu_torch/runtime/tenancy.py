"""Tenant observatory (the port of the JAX package's
``runtime/tenancy.py``): per-tenant accounting, fair-share queueing and the
usage ledger behind the ``X-Dllama-Tenant`` identity. Stdlib plus the
port's ``telemetry`` and ``slo`` only: host-side, nothing on the hot path
beyond dict updates, no device read.

* **Identity** — :func:`sanitize_tenant` applies the same
  ``[A-Za-z0-9._-]{1,64}`` contract as the fleet request id
  (``serve/api.py`` ``FLEET_RID_RE``); anything absent or malformed is
  ``anon``, never an error.
* **Accounting registry** — :class:`TenantRegistry` keeps per-tenant
  token/shed/timeout/KV-residency/speculation totals plus log-bucket
  latency histograms (queue wait, TTFT, ITL — :class:`slo.LogHistogram`),
  published as the ``dllama_tenant_*`` metric family. Cardinality is
  bounded: at most :data:`TENANT_CAP` distinct tenant labels, LRU-ordered;
  overflow tenants collapse into ``other`` and count
  ``dllama_tenant_overflow_total``.
* **Fair-share queueing** — :class:`FairQueue` (per-tenant FIFOs drained
  by stride-scheduled weighted round-robin) and :class:`TenantLimits`
  (``--tenant-limits``: weight, max concurrent slots, token-rate budget).
  The BatchScheduler owns admission policy; this module owns the
  mechanism.
* **Usage ledger** — :class:`UsageLedger` appends periodic JSONL snapshots
  of the cumulative per-tenant totals (``--usage-ledger``) — monotonic by
  construction, so a consumer may diff any two lines.

Fairness is measured, not assumed: :meth:`TenantRegistry.note_tick` folds
every scheduler tick's slot occupancy into a sliding window and publishes
Jain's index over the tenants' weight-normalized dominant-resource shares
plus the max/min share.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import time
from collections import deque

from . import telemetry
from .slo import LogHistogram

# the identity contract — byte-identical to serve/api.py FLEET_RID_RE;
# re-spelled here so serve/router.py can sanitize without importing the
# api module (the router process never loads the engine)
TENANT_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

# the default tenant: absent or malformed X-Dllama-Tenant headers, and
# every pre-tenancy caller
ANON = "anon"

# overflow label: tenants beyond the registry's cardinality cap
OTHER = "other"

# label-cardinality bound: at most this many distinct real tenant labels
# (ANON included, OTHER excluded) before new ids collapse into OTHER
TENANT_CAP = 64

# The closed-world admission decision-reason vocabulary: every
# flight-ring defer/shed/requeue/preempt decision in runtime/serving.py
# and serve/router.py names one of exactly these reasons (the JAX
# package's, letter for letter, so one postmortem query reads both).
#
# * ``queue_full`` — the shared ``--max-queue`` bound shed the submit
#   (429 + backpressure headers).
# * ``tenant_rate_budget`` — the tenant's own ``--tenant-limits`` token
#   bucket ran dry (per-tenant 429; other tenants unaffected).
# * ``tenant_slot_cap`` — the tenant sits at its max concurrent slots;
#   its queue head is skipped this round, other tenants keep admitting.
# * ``blocks_unaffordable`` — the paged pool cannot price the head
#   request's blocks yet (pre-existing; now tenant-attributed).
# * ``kv_block_exhaustion`` — begin_admit found no free/evictable block
#   and the request requeued at its tenant's head (pre-existing).
# * ``prefill_budget`` — the tick's prefill-token budget was spent and
#   the admission waits a tick (pre-existing preemption).
# * ``router_queue_full`` — the fleet router's admission gate shed the
#   request before any replica saw it (serve/router.py).
ADMIT_REASONS = ("queue_full", "tenant_rate_budget", "tenant_slot_cap",
                 "blocks_unaffordable", "kv_block_exhaustion",
                 "prefill_budget", "router_queue_full")

# fairness window: scheduler-tick occupancy and emitted tokens are
# folded into coarse time buckets spanning this many trailing seconds
FAIR_WINDOW_S = 60.0
_FAIR_BUCKETS = 30

# token-rate buckets hold this many seconds of burst above the
# sustained --tenant-limits rate
BURST_S = 2.0

# the latency quantiles published per tenant (gauge label q=...)
_QUANTILES = (("p50", 0.50), ("p95", 0.95))


def sanitize_tenant(raw) -> str:
    """The one tenant-identity parse: a well-formed id passes through,
    everything else — ``None``, empty, over-long, bad charset — is
    :data:`ANON`. Never raises: identity is best-effort attribution,
    not authentication."""
    if raw is None:
        return ANON
    s = str(raw).strip()
    return s if TENANT_RE.match(s) else ANON


class TenantLimits:
    """One tenant's ``--tenant-limits`` entry: WRR ``weight`` (>0),
    ``max_slots`` concurrent slots (0 = uncapped), and ``tokens_per_s``
    sustained token rate (0 = unlimited; the bucket holds
    :data:`BURST_S` seconds of burst)."""

    __slots__ = ("weight", "max_slots", "tokens_per_s")

    def __init__(self, weight: float = 1.0, max_slots: int = 0,
                 tokens_per_s: float = 0.0):
        self.weight = float(weight)
        self.max_slots = int(max_slots)
        self.tokens_per_s = float(tokens_per_s)

    def as_dict(self) -> dict:
        return {"weight": self.weight, "max_slots": self.max_slots,
                "tokens_per_s": self.tokens_per_s}


DEFAULT_LIMITS = TenantLimits()

_LIMIT_KEYS = ("weight", "max_slots", "tokens_per_s")


def parse_limits(doc: dict) -> dict[str, TenantLimits]:
    """A ``--tenant-limits`` JSON object → ``{tenant: TenantLimits}``.
    Keys are tenant ids (the ``*`` entry is the default for tenants not
    listed); values are objects with any of ``weight`` (>0),
    ``max_slots`` (>=0), ``tokens_per_s`` (>=0). A typo'd tenant id,
    unknown field, or out-of-range value fails at startup — a limits
    file that silently never applies is how a flooder wins."""
    if not isinstance(doc, dict):
        raise ValueError("tenant limits must be a JSON object "
                         "{tenant: {weight, max_slots, tokens_per_s}}")
    out: dict[str, TenantLimits] = {}
    for tenant, spec in doc.items():
        if tenant != "*" and not TENANT_RE.match(str(tenant)):
            raise ValueError(
                f"tenant limits: id {tenant!r} violates the "
                f"[A-Za-z0-9._-]{{1,64}} contract")
        if not isinstance(spec, dict):
            raise ValueError(f"tenant limits: {tenant!r} entry must be "
                             f"an object, got {type(spec).__name__}")
        for k in spec:
            if k not in _LIMIT_KEYS:
                raise ValueError(
                    f"tenant limits: {tenant!r} has unknown field {k!r} "
                    f"(known: {', '.join(_LIMIT_KEYS)})")
        lim = TenantLimits(
            weight=float(spec.get("weight", 1.0)),
            max_slots=int(spec.get("max_slots", 0)),
            tokens_per_s=float(spec.get("tokens_per_s", 0.0)))
        if not math.isfinite(lim.weight) or lim.weight <= 0:
            raise ValueError(f"tenant limits: {tenant!r} weight must be "
                             f"a positive finite number")
        if lim.max_slots < 0 or lim.tokens_per_s < 0 \
                or not math.isfinite(lim.tokens_per_s):
            raise ValueError(f"tenant limits: {tenant!r} max_slots and "
                             f"tokens_per_s must be >= 0")
        out[str(tenant)] = lim
    return out


def load_limits(arg: str) -> dict[str, TenantLimits]:
    """The ``--tenant-limits`` flag value: an inline JSON object, or the
    path of a JSON file holding one (the ``--slo`` loading convention)."""
    if os.path.isfile(arg):
        with open(arg, encoding="utf-8") as f:
            return parse_limits(json.load(f))
    try:
        doc = json.loads(arg)
    except json.JSONDecodeError as e:
        raise ValueError(f"--tenant-limits is neither a file nor valid "
                         f"JSON: {e}")
    return parse_limits(doc)


class _TokenBucket:
    """One tenant's token-rate budget: sustained ``rate`` tokens/s with
    ``rate * BURST_S`` of burst capacity. Lazily refilled on charge."""

    __slots__ = ("rate", "capacity", "level", "t_last")

    def __init__(self, rate: float, now: float):
        self.rate = rate
        self.capacity = rate * BURST_S
        self.level = self.capacity
        self.t_last = now

    def try_charge(self, cost: float, now: float) -> bool:
        self.level = min(self.capacity,
                         self.level + (now - self.t_last) * self.rate)
        self.t_last = now
        if self.level < cost:
            return False
        self.level -= cost
        return True


class _TenantStats:
    """One tenant's cumulative accounting (the registry's value type)."""

    __slots__ = ("prefill_tokens", "decode_tokens", "admissions", "sheds",
                 "timeouts", "kv_device_block_s", "kv_host_block_s",
                 "spec_drafted", "spec_accepted", "queue_wait", "ttft",
                 "itl")

    def __init__(self):
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.admissions = 0
        self.sheds: dict[str, int] = {}
        self.timeouts = 0
        self.kv_device_block_s = 0.0
        self.kv_host_block_s = 0.0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.queue_wait = LogHistogram()
        self.ttft = LogHistogram()
        self.itl = LogHistogram()

    def as_dict(self) -> dict:
        d = {"prefill_tokens": self.prefill_tokens,
             "decode_tokens": self.decode_tokens,
             "admissions": self.admissions,
             "sheds": dict(self.sheds),
             "timeouts": self.timeouts,
             "kv_device_block_s": self.kv_device_block_s,
             "kv_host_block_s": self.kv_host_block_s,
             "spec_drafted": self.spec_drafted,
             "spec_accepted": self.spec_accepted}
        for name, h in (("queue_wait_ms", self.queue_wait),
                        ("ttft_ms", self.ttft), ("itl_ms", self.itl)):
            d[name] = {"n": h.n, "sum": h.sum,
                       "p50": h.quantile(0.5), "p95": h.quantile(0.95)}
        return d


class _FairWindow:
    """Sliding per-tenant resource accumulation (slot-seconds + emitted
    tokens) over :data:`FAIR_WINDOW_S`, in coarse time buckets — the
    same shape as slo._BurnWindow, so the hot path is one dict update."""

    def __init__(self, span_s: float = FAIR_WINDOW_S):
        self.span_s = span_s
        self._width = span_s / _FAIR_BUCKETS
        # idx -> {tenant: [slot_s, tokens]}
        self._buckets: dict[int, dict[str, list[float]]] = {}

    def add(self, now: float, tenant: str, slot_s: float = 0.0,
            tokens: float = 0.0) -> None:
        idx = int(now / self._width)
        b = self._buckets.get(idx)
        if b is None:
            floor = idx - _FAIR_BUCKETS
            for k in [k for k in self._buckets if k <= floor]:
                del self._buckets[k]
            b = self._buckets[idx] = {}
        cell = b.get(tenant)
        if cell is None:
            cell = b[tenant] = [0.0, 0.0]
        cell[0] += slot_s
        cell[1] += tokens

    def totals(self, now: float) -> dict[str, tuple[float, float]]:
        """``{tenant: (slot_s, tokens)}`` over the trailing window."""
        floor = int(now / self._width) - _FAIR_BUCKETS
        out: dict[str, list[float]] = {}
        for k, cells in self._buckets.items():
            if k <= floor:
                continue
            for tenant, (s, t) in cells.items():
                cell = out.setdefault(tenant, [0.0, 0.0])
                cell[0] += s
                cell[1] += t
        return {t: (v[0], v[1]) for t, v in out.items()}


def jain_index(values) -> float:
    """Jain's fairness index ``(Σx)² / (n·Σx²)`` over non-negative
    shares: 1.0 = perfectly even, 1/n = one value holds everything.
    Empty or all-zero input reads as perfectly fair (1.0) — no traffic
    is not unfairness."""
    xs = [float(v) for v in values if v > 0]
    if not xs:
        return 1.0
    sq = sum(x * x for x in xs)
    return (sum(xs) ** 2) / (len(xs) * sq) if sq else 1.0


class TenantRegistry:
    """Bounded-cardinality per-tenant accounting. Every ``note_*`` both
    updates the in-process stats (the ``/debug/tenants`` and ledger
    source of truth) and increments the matching ``dllama_tenant_*``
    series — same value, same call, so per-tenant sums reconcile with
    the global counters bit-exactly (the conservation tests pin it).

    Thread-safe: handler threads shed/submit, the scheduler loop ticks,
    and scrapes snapshot concurrently. The clock is injectable
    (``time.monotonic``) so fairness-window tests advance it by hand."""

    def __init__(self, *, registry=None, clock=time.monotonic,
                 cap: int = TENANT_CAP):
        self._reg = registry if registry is not None else (
            telemetry.registry())
        self._clock = clock
        self._cap = cap
        self._lock = threading.Lock()
        # LRU order: accesses move the tenant to the end; entries are
        # never evicted (a counter's label can't un-exist) — the cap
        # instead collapses NEW tenants into OTHER
        self._tenants: dict[str, _TenantStats] = {}
        self._buckets: dict[str, _TokenBucket] = {}
        self._limits: dict[str, TenantLimits] = {}
        self._window = _FairWindow()
        self._t0_wall = time.time()

    # -- identity + limits ---------------------------------------------------

    def resolve(self, tenant) -> str:
        """Sanitize + bound: the canonical label all accounting uses.
        Unknown tenants past the cap collapse into :data:`OTHER` and
        count ``dllama_tenant_overflow_total``."""
        t = sanitize_tenant(tenant)
        with self._lock:
            st = self._tenants.get(t)
            if st is not None:
                self._tenants[t] = self._tenants.pop(t)  # LRU refresh
                return t
            if t != OTHER and len(self._tenants) < self._cap:
                self._tenants[t] = _TenantStats()
                return t
        self._reg.counter(telemetry.TENANT_OVERFLOW).inc()
        with self._lock:
            if OTHER not in self._tenants:
                self._tenants[OTHER] = _TenantStats()
        return OTHER

    def set_limits(self, limits: dict[str, TenantLimits] | None) -> None:
        with self._lock:
            self._limits = dict(limits or {})
            self._buckets.clear()

    def limit_for(self, tenant: str) -> TenantLimits:
        with self._lock:
            return (self._limits.get(tenant)
                    or self._limits.get("*") or DEFAULT_LIMITS)

    def try_charge_tokens(self, tenant: str, cost: float) -> bool:
        """Charge ``cost`` projected tokens against the tenant's rate
        budget; False = over budget (the caller sheds 429-shaped). A
        tenant with no ``tokens_per_s`` limit always passes."""
        lim = self.limit_for(tenant)
        if lim.tokens_per_s <= 0:
            return True
        now = self._clock()
        with self._lock:
            b = self._buckets.get(tenant)
            if b is None or b.rate != lim.tokens_per_s:
                b = self._buckets[tenant] = _TokenBucket(
                    lim.tokens_per_s, now)
            return b.try_charge(cost, now)

    # -- accounting notes ----------------------------------------------------

    def _stats(self, tenant: str) -> _TenantStats:
        # internal: tenant is already a canonical label from resolve()
        st = self._tenants.get(tenant)
        if st is None:
            st = self._tenants[tenant] = _TenantStats()
        return st

    def note_prefill_tokens(self, tenant: str, n: int) -> None:
        with self._lock:
            self._stats(tenant).prefill_tokens += n
        self._reg.counter(telemetry.TENANT_PREFILL_TOKENS).inc(
            n, tenant=tenant)

    def note_decode_tokens(self, tenant: str, n: int) -> None:
        with self._lock:
            self._stats(tenant).decode_tokens += n
            self._window.add(self._clock(), tenant, tokens=n)
        self._reg.counter(telemetry.TENANT_DECODE_TOKENS).inc(
            n, tenant=tenant)

    def note_admission(self, tenant: str,
                       queue_wait_ms: float | None = None) -> None:
        # queue_wait_ms is None for direct-generator use (no submit
        # stamp) — the admission still counts, the histogram doesn't
        with self._lock:
            st = self._stats(tenant)
            st.admissions += 1
            if queue_wait_ms is not None:
                st.queue_wait.record(queue_wait_ms)
                self._publish_quantiles(telemetry.TENANT_QUEUE_WAIT_MS,
                                        tenant, st.queue_wait)
        self._reg.counter(telemetry.TENANT_ADMISSIONS).inc(tenant=tenant)

    def note_ttft(self, tenant: str, ms: float) -> None:
        with self._lock:
            st = self._stats(tenant)
            st.ttft.record(ms)
            self._publish_quantiles(telemetry.TENANT_TTFT_MS, tenant,
                                    st.ttft)

    def note_itl(self, tenant: str, ms: float, n: int = 1) -> None:
        with self._lock:
            st = self._stats(tenant)
            for _ in range(max(1, n)):
                st.itl.record(ms)
            self._publish_quantiles(telemetry.TENANT_ITL_MS, tenant,
                                    st.itl)

    def note_shed(self, tenant: str, reason: str) -> None:
        with self._lock:
            st = self._stats(tenant)
            st.sheds[reason] = st.sheds.get(reason, 0) + 1
        self._reg.counter(telemetry.TENANT_SHED).inc(
            tenant=tenant, reason=reason)

    def note_timeout(self, tenant: str) -> None:
        with self._lock:
            self._stats(tenant).timeouts += 1
        self._reg.counter(telemetry.TENANT_TIMEOUTS).inc(tenant=tenant)

    def note_spec(self, tenant: str, drafted: int, accepted: int) -> None:
        if not drafted and not accepted:
            return
        with self._lock:
            st = self._stats(tenant)
            st.spec_drafted += drafted
            st.spec_accepted += accepted
        if drafted:
            self._reg.counter(telemetry.TENANT_SPEC_DRAFT_TOKENS).inc(
                drafted, tenant=tenant)
        if accepted:
            self._reg.counter(telemetry.TENANT_SPEC_ACCEPTED_TOKENS).inc(
                accepted, tenant=tenant)

    def note_tick(self, dt_s: float, device_blocks: dict[str, float],
                  host_blocks: dict[str, float] | None = None) -> None:
        """One scheduler tick's KV residency + occupancy: ``dt_s``
        seconds during which each tenant held ``device_blocks[t]`` live
        KV blocks (dense pool: one synthetic block per slot column) and
        ``host_blocks[t]`` spilled blocks awaiting its page-ins.
        Charges block-seconds, feeds the fairness window, and publishes
        the fairness gauges."""
        if dt_s <= 0:
            return
        now = self._clock()
        with self._lock:
            for tenant, n in device_blocks.items():
                if n <= 0:
                    continue
                self._stats(tenant).kv_device_block_s += n * dt_s
                self._window.add(now, tenant, slot_s=dt_s)
            for tenant, n in (host_blocks or {}).items():
                if n > 0:
                    self._stats(tenant).kv_host_block_s += n * dt_s
        for tenant, n in device_blocks.items():
            if n > 0:
                self._reg.counter(telemetry.TENANT_KV_BLOCK_SECONDS).inc(
                    n * dt_s, tenant=tenant, tier="device")
        for tenant, n in (host_blocks or {}).items():
            if n > 0:
                self._reg.counter(telemetry.TENANT_KV_BLOCK_SECONDS).inc(
                    n * dt_s, tenant=tenant, tier="host")
        self.publish_fairness()

    # -- fairness ------------------------------------------------------------

    def _shares(self, now: float) -> dict[str, float]:
        """Weight-normalized dominant-resource shares over the trailing
        window: a tenant's share is the larger of its slot-time and
        token fractions, divided by its WRR weight — so a weight-2
        tenant legitimately holding 2/3 of the machine scores even with
        a weight-1 tenant holding 1/3."""
        totals = self._window.totals(now)
        sum_slots = sum(s for s, _ in totals.values())
        sum_tokens = sum(t for _, t in totals.values())
        shares: dict[str, float] = {}
        for tenant, (s, t) in totals.items():
            dom = max(s / sum_slots if sum_slots else 0.0,
                      t / sum_tokens if sum_tokens else 0.0)
            lim = (self._limits.get(tenant) or self._limits.get("*")
                   or DEFAULT_LIMITS)
            shares[tenant] = dom / lim.weight
        return shares

    def fairness(self) -> dict:
        now = self._clock()
        with self._lock:
            shares = self._shares(now)
        vals = [v for v in shares.values() if v > 0]
        return {"window_s": FAIR_WINDOW_S,
                "jain_index": jain_index(vals),
                "share_max": max(vals, default=0.0),
                "share_min": min(vals, default=0.0),
                "active_tenants": len(vals),
                "shares": shares}

    def publish_fairness(self) -> dict:
        f = self.fairness()
        self._reg.gauge(telemetry.TENANT_FAIRNESS_JAIN).set(
            f["jain_index"])
        self._reg.gauge(telemetry.TENANT_SHARE_MAX).set(f["share_max"])
        self._reg.gauge(telemetry.TENANT_SHARE_MIN).set(f["share_min"])
        self._reg.gauge(telemetry.TENANT_ACTIVE).set(f["active_tenants"])
        return f

    # -- views ---------------------------------------------------------------

    def _publish_quantiles(self, name: str, tenant: str,
                           hist: LogHistogram) -> None:
        # caller holds the lock; gauge sets take the metric's own lock
        g = self._reg.gauge(name)
        for label, q in _QUANTILES:
            g.set(hist.quantile(q), tenant=tenant, q=label)

    def snapshot(self) -> dict:
        """The ``GET /debug/tenants`` body: cumulative per-tenant
        totals (LRU order, most recent last) + the fairness view."""
        with self._lock:
            tenants = {t: st.as_dict() for t, st in self._tenants.items()}
        return {"cap": self._cap,
                "n_tenants": len(tenants),
                "overflow_total": int(self._reg.counter(
                    telemetry.TENANT_OVERFLOW).total()),
                "limits": {t: lim.as_dict()
                           for t, lim in self._limits.items()},
                "tenants": tenants,
                "fairness": self.fairness()}

    def usage_record(self, seq: int) -> dict:
        """One usage-ledger line: wall timestamp + the monotonic
        cumulative totals per tenant (no windows, no quantile state —
        billing diffs two lines, it never needs distribution shape)."""
        with self._lock:
            tenants = {}
            for t, st in self._tenants.items():
                tenants[t] = {
                    "prefill_tokens": st.prefill_tokens,
                    "decode_tokens": st.decode_tokens,
                    "admissions": st.admissions,
                    "sheds": sum(st.sheds.values()),
                    "timeouts": st.timeouts,
                    "kv_device_block_s": round(st.kv_device_block_s, 6),
                    "kv_host_block_s": round(st.kv_host_block_s, 6),
                    "spec_drafted": st.spec_drafted,
                    "spec_accepted": st.spec_accepted}
        return {"seq": seq, "t_wall": time.time(),
                "uptime_s": round(time.time() - self._t0_wall, 3),
                "tenants": tenants}


class UsageLedger:
    """Append-only JSONL usage snapshots (``--usage-ledger FILE``): one
    :meth:`TenantRegistry.usage_record` line every ``interval_s``
    seconds, written from the scheduler tick (host-side file append —
    ledger-quiet by construction) and force-flushed at drain. Totals
    are cumulative and monotonic, so a consumer may diff ANY two lines,
    tolerate lost lines, and dedupe by ``seq``."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._path: str | None = None
        self._interval = 10.0
        self._t_last = 0.0
        self._seq = 0

    def configure(self, path: str | None,
                  interval_s: float = 10.0) -> None:
        with self._lock:
            self._path = path or None
            self._interval = max(0.1, float(interval_s))
            self._t_last = 0.0

    @property
    def enabled(self) -> bool:
        return self._path is not None

    def maybe_write(self, reg: TenantRegistry, *,
                    force: bool = False) -> bool:
        """Append a snapshot line if the interval elapsed (or forced).
        Write failures WARN once per interval and never raise into the
        scheduler loop."""
        now = self._clock()
        with self._lock:
            path = self._path
            if path is None:
                return False
            if not force and now - self._t_last < self._interval:
                return False
            self._t_last = now
            self._seq += 1
            seq = self._seq
        rec = reg.usage_record(seq)
        try:
            with open(path, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError as e:
            print(f"🛑 usage ledger: append to {path} failed ({e})",
                  flush=True)
            return False
        return True


class FairQueue:
    """Per-tenant FIFOs drained by stride-scheduled weighted
    round-robin: each pop charges the tenant's virtual pass by
    ``1/weight``, and :meth:`peek` always proposes the eligible tenant
    with the smallest pass — a weight-4 tenant drains four requests per
    weight-1 request, and an idle tenant re-enters at the current
    virtual time instead of cashing in saved-up credit. FIFO order is
    preserved within a tenant (the continuous-batching invariant the
    requeue-at-head paths rely on).

    Items need ``.tenant`` (a canonical label) — otherwise this is a
    plain container. NOT thread-safe: the BatchScheduler serializes
    every access under its own lock, exactly like the list it replaces."""

    def __init__(self, weight_of=None):
        self._weight_of = weight_of or (lambda tenant: 1.0)
        self._fifos: dict[str, deque] = {}
        self._pass: dict[str, float] = {}
        self._vtime = 0.0

    def __len__(self) -> int:
        return sum(len(q) for q in self._fifos.values())

    def __bool__(self) -> bool:
        return any(self._fifos.values())

    def __iter__(self):
        """Every queued item, grouped by tenant in pass order — the
        deadline sweep and fail-all iterate; admission never does."""
        for t in sorted(self._fifos, key=lambda t: self._pass.get(t, 0.0)):
            yield from self._fifos[t]

    def _fifo(self, tenant: str) -> deque:
        q = self._fifos.get(tenant)
        if q is None:
            q = self._fifos[tenant] = deque()
            self._pass[tenant] = self._vtime
        elif not q:
            # idle tenant re-entering: no banked credit from its idle
            # stretch, but keep any debt from a recent burst
            self._pass[tenant] = max(self._pass[tenant], self._vtime)
        return q

    def push(self, item) -> None:
        self._fifo(item.tenant).append(item)

    def push_front(self, item) -> None:
        """Requeue at the tenant's head (block exhaustion, migration
        fallback) AND refund the pass the pop charged — the retry must
        not count twice against the tenant's share."""
        tenant = item.tenant
        self._fifo(tenant).appendleft(item)
        w = max(1e-9, float(self._weight_of(tenant)))
        self._pass[tenant] = max(0.0, self._pass[tenant] - 1.0 / w)

    def peek(self, blocked=frozenset()):
        """The WRR head: front of the non-empty FIFO with the smallest
        pass among tenants not in ``blocked``; None when nothing is
        eligible. Pure — repeated peeks return the same item until a
        mutation."""
        best_t = None
        best_p = 0.0
        for t, q in self._fifos.items():
            if not q or t in blocked:
                continue
            p = self._pass[t]
            if best_t is None or p < best_p:
                best_t, best_p = t, p
        return self._fifos[best_t][0] if best_t is not None else None

    def pop(self, item):
        """Pop ``item`` from the front of its tenant's FIFO (it must be
        a current :meth:`peek` result) and charge the tenant's pass."""
        tenant = item.tenant
        q = self._fifos[tenant]
        if not q or q[0] is not item:
            raise ValueError("pop target is not its tenant's queue head")
        q.popleft()
        w = max(1e-9, float(self._weight_of(tenant)))
        self._pass[tenant] += 1.0 / w
        self._vtime = max(self._vtime, self._pass[tenant])
        return item

    def remove(self, item) -> None:
        """Remove from anywhere in its tenant's FIFO (deadline sweep);
        raises ValueError when absent, matching list.remove."""
        self._fifos[item.tenant].remove(item)

    def clear(self) -> None:
        for q in self._fifos.values():
            q.clear()

    def tenants_queued(self) -> dict[str, int]:
        return {t: len(q) for t, q in self._fifos.items() if q}


_registry = TenantRegistry()
_ledger = UsageLedger()


def registry() -> TenantRegistry:
    """The process-wide tenant registry (what ``/debug/tenants`` and
    the usage ledger serve)."""
    return _registry


def ledger() -> UsageLedger:
    return _ledger


def reset() -> None:
    """Fresh process-global registry state (tests). Metric series in
    telemetry's registry are reset separately by its own reset()."""
    global _registry
    _registry = TenantRegistry()
    _ledger.configure(None)
