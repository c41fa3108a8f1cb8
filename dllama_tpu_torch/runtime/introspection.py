"""The compile ledger of the port: what its runtime built and captured,
when, at which signature, and what each program moves (the port of the
JAX package's ``runtime/introspection.py``).

The JAX module records XLA's traces and compiles. The port compiles no
programs: its counterparts are

* **kernel builds** — one event per CUDA source that
  ``ops/cuda_build.py::build`` compiled (its ``nvcc`` seconds) or found
  built (``reused``), in the ``kernels`` scope (:meth:`CompileLedger.record_build`);
* **graph captures** — a :class:`~dllama_tpu_torch.runtime.graphs.StepGraph`
  captured on the card (decode, verify, the slot pools' steps), with its
  signature (the static inputs' shapes and dtypes, the mesh), its warm-up
  and capture seconds and its private pool's bytes;
* **first eager runs** — a program run without a graph at a signature it
  has not run at: prefill chunks at each width, the steps of ``tp > 1`` and
  ``sp > 1``, and every step on the CPU.

A :class:`Program` is one (scope, program) of an engine; the scope is the
engine's watchdog name (``engine-N``). Each capture or first run records
the program's analysis: the bytes and operations that the kernel wrappers
K1-K5 count during it (``ops/cost.py``; a replay runs what the capture
recorded), so ``hbm_total_bytes`` and ``flops`` are what one dispatch of
the program moves and computes through K1-K5, and nothing else of the step
(the analysis names its ``source``). ``hbm_bytes["temp"]`` is the graph's
pool (``dllama_program_hbm_bytes{kind="temp"}``); ``peak_bytes`` the
allocator's peak right after the capture or run, which the admission guard
reads through :meth:`CompileLedger.measured_hbm_bytes`.

Retrace sentinel, as in the JAX module: once a scope is marked steady (the
batch scheduler after :data:`~dllama_tpu_torch.runtime.serving.BatchScheduler.STEADY_TICKS`
quiet ticks, the single-sequence server after one quiet completion), a
capture or a new signature in it counts ``dllama_retrace_unexpected_total``
and prints the signature diff. Registering a program re-opens its scope.

A program that is replayed or run again at a signature it has seen costs
one dictionary increment (its ``hits``). ``GET /debug/compiles`` dumps
:meth:`CompileLedger.snapshot`; :func:`hbm_startup_report` prints the
serving startup's device-memory table.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from . import telemetry

# cap the warnings one misbehaving program can print
_MAX_WARNS_PER_PROGRAM = 8
_MAX_DIFF_LINES = 12
BUILD_SCOPE = "kernels"


def _describe_leaf(x) -> str:
    """Short shape/dtype tag of one input: ``float32[1,8]`` for a tensor (a
    cache: its K tensor; a list or a sharded cache: the count and its first
    shard), ``repr`` (bounded) for anything else."""
    if hasattr(x, "shards"):
        return f"{len(x.shards)}x{_describe_leaf(x.shards[0])}"
    if hasattr(x, "k") and hasattr(x, "v"):
        x = x.k
    if isinstance(x, list) and x:
        return f"{len(x)}x{_describe_leaf(x[0])}"
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return f"{str(dtype).removeprefix('torch.')}[{','.join(str(d) for d in shape)}]"
    r = repr(x)
    return r if len(r) <= 80 else r[:77] + "..."


def signature(**inputs) -> dict[str, str]:
    """The diffable identity of one program specialization: each named
    input's shape and dtype (or its value, for a static one)."""
    return {k: _describe_leaf(v) for k, v in inputs.items()}


def plan_desc(plan) -> str:
    """The mesh of a dispatch, e.g. ``tp=2`` (``none`` without a plan)."""
    return "none" if plan is None else f"{plan.axis}={len(plan.devices)}"


def _sig_diff(old: dict[str, str] | None, new: dict[str, str]) -> list[str]:
    if not old:
        return ["(first compile in scope — no prior signature)"]
    lines = []
    for k, v in new.items():
        if k not in old:
            lines.append(f"+ {k} = {v}")
        elif old[k] != v:
            lines.append(f"~ {k}: {old[k]} -> {v}")
    for k in old:
        if k not in new:
            lines.append(f"- {k} = {old[k]}")
    if not lines:
        lines = ["(identical leaf shapes — an input-sharding, weak-type, or "
                 "mesh-plan change keyed a new executable; e.g. a program's "
                 "first dispatch on its own donated output)"]
    return lines[:_MAX_DIFF_LINES]


class CompileLedger:
    """Process-wide record of what the port built and captured, keyed
    (scope, program). Steadiness is per scope, so a second engine warming
    up never trips the first engine's sentinel."""

    def __init__(self, max_events: int = 256):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max_events)
        self._programs: dict[tuple[str, str], dict] = {}
        self._steady: dict[str, bool] = {}
        self._compiles_by_scope: dict[str, int] = {}
        self._seq = 0
        # the JAX ledger's switch for its second AOT compile; the port's
        # analysis is the wrappers' counts, always taken
        self.analyze = True

    def register(self, scope: str, program: str) -> dict:
        """Create/fetch the (scope, program) aggregate. Registering re-opens
        the scope: the program set is no longer closed, so steady state
        flips off until re-marked."""
        with self._lock:
            self._steady[scope] = False
            entry = self._programs.get((scope, program))
            if entry is None:
                entry = {"scope": scope, "program": program, "compiles": 0,
                         "hits": 0, "warns": 0, "last_sig": None,
                         "last_plan": None, "last_compile_s": 0.0,
                         "total_compile_s": 0.0, "analysis": None,
                         "unexpected": 0}
                self._programs[(scope, program)] = entry
            return entry

    def compile_count(self, scope: str) -> int:
        with self._lock:
            return self._compiles_by_scope.get(scope, 0)

    def steady(self, scope: str) -> bool:
        with self._lock:
            return self._steady.get(scope, False)

    def mark_steady(self, scope: str) -> None:
        """Arm the retrace sentinel for ``scope``: from here on, a capture
        or a new signature in the scope is unexpected."""
        with self._lock:
            self._steady[scope] = True

    def measured_hbm_bytes(self, scope: str) -> dict[str, int]:
        """The allocator's peak after each program's capture or first run
        in ``scope`` (the admission guard's evidence; empty on the CPU)."""
        out: dict[str, int] = {}
        with self._lock:
            for (sc, program), entry in self._programs.items():
                peak = (entry["analysis"] or {}).get("peak_bytes", 0)
                if sc == scope and peak:
                    out[program] = int(peak)
        return out

    def record(self, entry: dict, compile_s: float, signature: dict,
               plan: str, analysis: dict | None, *,
               backend_s: float = 0.0, kind: str = "capture") -> None:
        """File one capture (``kind="capture"``: ``compile_s`` is its
        warm-up and capture seconds) or first run (``"first_run"``: the
        run's wall)."""
        scope, program = entry["scope"], entry["program"]
        reg = telemetry.registry()
        with self._lock:
            unexpected = self._steady.get(scope, False)
            diff = _sig_diff(entry["last_sig"], signature) if unexpected \
                else None
            if unexpected and entry["last_plan"] not in (None, plan):
                diff = [f"~ mesh plan: {entry['last_plan']} -> {plan}"] + diff
            entry["compiles"] += 1
            entry["last_sig"] = signature
            entry["last_plan"] = plan
            entry["last_compile_s"] = compile_s
            entry["total_compile_s"] += compile_s
            if analysis:
                entry["analysis"] = analysis
            if unexpected:
                entry["unexpected"] += 1
            self._compiles_by_scope[scope] = \
                self._compiles_by_scope.get(scope, 0) + 1
            self._seq += 1
            self._events.append({
                "seq": self._seq, "time": time.time(), "scope": scope,
                "program": program, "compile_s": round(compile_s, 6),
                "backend_s": round(backend_s, 6),
                "plan": plan, "n_leaves": len(signature),
                "unexpected": unexpected, "diff": diff,
                "analysis": analysis, "kind": kind,
            })
            warn = unexpected and entry["warns"] < _MAX_WARNS_PER_PROGRAM
            if warn:
                entry["warns"] += 1
        reg.counter(telemetry.COMPILE_TOTAL).inc(scope=scope,
                                                 program=program)
        reg.histogram(telemetry.COMPILE_SECONDS).record(compile_s)
        if unexpected:
            reg.counter(telemetry.RETRACE_UNEXPECTED).inc(program=program)
        if warn:
            lines = "\n".join(f"      {d}" for d in (diff or []))
            print(f"⚠️ unexpected {kind.replace('_', ' ')} after steady state: "
                  f"{scope}/{program} took {compile_s * 1e3:.0f} ms "
                  f"(plan {plan})\n{lines}", flush=True)

    def record_build(self, source: str, seconds: float, reused: bool) -> None:
        """File one kernel source: built by ``nvcc`` in ``seconds``, or a
        library of the same hash found built (``reused``). A build counts in
        ``dllama_compile_total{scope="kernels"}``."""
        with self._lock:
            self._seq += 1
            self._events.append({
                "seq": self._seq, "time": time.time(), "scope": BUILD_SCOPE,
                "program": source, "compile_s": round(seconds, 6),
                "backend_s": round(seconds, 6), "plan": "none", "n_leaves": 0,
                "unexpected": False, "diff": None, "analysis": None,
                "kind": "build", "reused": reused,
            })
        if not reused:
            reg = telemetry.registry()
            reg.counter(telemetry.COMPILE_TOTAL).inc(scope=BUILD_SCOPE, program=source)
            reg.histogram(telemetry.COMPILE_SECONDS).record(seconds)

    def snapshot(self) -> dict:
        """JSON-able ledger dump (``GET /debug/compiles``)."""
        with self._lock:
            programs = []
            for entry in self._programs.values():
                e = {k: v for k, v in entry.items() if k != "last_sig"}
                e["hbm_total_bytes"] = (entry["analysis"] or {}).get(
                    "hbm_total_bytes", 0)
                programs.append(e)
            return {
                "steady": dict(self._steady),
                "analyze": self.analyze,
                "programs": sorted(
                    programs, key=lambda e: (e["scope"], e["program"])),
                "events": list(self._events),
            }

    def reset(self) -> None:
        """Forget everything (tests). Registry metrics are NOT zeroed —
        use ``telemetry.registry().reset()`` for that."""
        with self._lock:
            self._events.clear()
            self._programs.clear()
            self._steady.clear()
            self._compiles_by_scope.clear()


_ledger = CompileLedger()


def ledger() -> CompileLedger:
    """The process-wide compile ledger."""
    return _ledger


# -- the kernel wrappers' counts ----------------------------------------------


def wrappers() -> tuple:
    """Every kernel wrapper with ``launches`` / ``moved_bytes`` / ``ops``
    counters."""
    from ..ops import flash_attention as fa
    from ..ops import moe_matmul as mm
    from ..ops import paged_attention as pa
    from ..ops import quant_matmul as qm

    return (qm.q40_matmul, qm.q40_gemv, fa.flash_attention, fa.flash_block_stats,
            pa.paged_attention, mm.moe_matmul)


def counts() -> dict:
    """Each wrapper's ``(launches, moved_bytes, ops)`` now."""
    return {fn: (fn.launches, fn.moved_bytes, fn.ops) for fn in wrappers()}


def delta(before: dict) -> dict:
    """What each wrapper counted since ``before`` (wrappers that counted
    nothing left out)."""
    out = {}
    for fn, (n0, b0, o0) in before.items():
        d = (fn.launches - n0, fn.moved_bytes - b0, fn.ops - o0)
        if any(d):
            out[fn] = d
    return out


def _peak_bytes(device) -> int | None:
    if device is None or getattr(device, "type", "cpu") != "cuda":
        return None
    import torch

    return int(torch.cuda.max_memory_allocated(device))


def analysis_of(counted: dict, *, scope: str, program: str, pool_bytes: int = 0,
                device=None) -> dict:
    """A program's analysis from what the wrappers counted during one
    dispatch of it (:func:`delta`), published as the per-(scope, program)
    gauges."""
    from ..ops.cost import CAPACITY_NOTE

    out = {"hbm_bytes": {"temp": int(pool_bytes)},
           "hbm_total_bytes": int(sum(b for _, b, _ in counted.values())),
           "flops": float(sum(o for _, _, o in counted.values())),
           "kernels": {fn.__name__: {"launches": n, "bytes": int(b), "ops": float(o)}
                       for fn, (n, b, o) in counted.items()},
           "source": CAPACITY_NOTE}
    peak = _peak_bytes(device)
    if peak is not None:
        out["peak_bytes"] = peak
    reg = telemetry.registry()
    reg.gauge(telemetry.PROGRAM_HBM_BYTES).set(pool_bytes, scope=scope, program=program,
                                               kind="temp")
    reg.gauge(telemetry.PROGRAM_FLOPS).set(out["flops"], scope=scope, program=program)
    return out


class Program:
    """One program of an engine scope in the ledger: the signatures it has
    run at, and its captures and first runs."""

    def __init__(self, scope: str, name: str):
        self.scope, self.name = scope, name
        self.entry = _ledger.register(scope, name)
        self._seen: set = set()

    def hit(self) -> None:
        """A replay, or a run at a signature seen before."""
        self.entry["hits"] += 1

    def run(self, key, fn, *, sig, device=None):
        """``fn()``. ``key`` (hashable, cheap) names the specialization; at
        a key this program has not run at, the run is timed and counted and
        filed as a first run with the signature ``sig()``."""
        if key in self._seen:
            self.hit()
            return fn()
        before = counts()
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        self._seen.add(key)
        s = sig()
        _ledger.record(self.entry, wall, s, s.get("mesh", "none"),
                       analysis_of(delta(before), scope=self.scope, program=self.name,
                                   device=device), kind="first_run")
        return out

    def captured(self, sig: dict[str, str], capture_s: float, counted: dict,
                 pool_bytes: int, device) -> None:
        """File a graph capture: ``counted`` is what one replay runs."""
        _ledger.record(self.entry, capture_s, sig, sig.get("mesh", "none"),
                       analysis_of(counted, scope=self.scope, program=self.name,
                                   pool_bytes=pool_bytes, device=device))


# -- the serving startup's device-memory report --------------------------------


def _gb(n: float) -> str:
    return f"{n / 1024 ** 3:.2f} GB" if n >= 1024 ** 2 else f"{n / 1024:.0f} kB"


def hbm_startup_report(engine, emit=print) -> dict:
    """The device-memory table at serving startup: the estimate
    (``runtime/hbm.py``: weights + KV + margin) against what the engine's
    programs captured so far reserve in their graph pools, and what each
    moves per dispatch through K1-K5. Publishes nothing new (the capture
    did); returns the raw dict."""
    from .hbm import device_memory_bytes

    est = dict(engine.hbm_estimate)
    limit = device_memory_bytes(engine.device)
    scope = engine.introspection_scope
    report: dict = {
        "weights_bytes": est["weights_bytes"],
        "kv_bytes": est["kv_bytes"],
        "need_per_device": est["need_per_device"],
        "limit_bytes": limit,
        "n_shards": engine.n_shards,
        "programs": {},
    }
    emit(f"🧮 HBM budget/device: weights {_gb(est['weights_bytes'])} + "
         f"KV {_gb(est['kv_bytes'])} over {report['n_shards']} shard(s) "
         f"+ margin → need {_gb(est['need_per_device'])}"
         + (f" of {_gb(limit)}" if limit else " (device limit unknown)"))
    pools = 0
    for p in _ledger.snapshot()["programs"]:
        info = p["analysis"]
        if p["scope"] != scope or not info:
            continue
        report["programs"][p["program"]] = info
        pool = info["hbm_bytes"]["temp"]
        pools += pool
        emit(f"🧮   program {p['program']}: graph pool {_gb(pool)}, moves "
             f"{_gb(info['hbm_total_bytes'])} and {info['flops']:.3g} ops a dispatch "
             f"through K1-K5")
    if not report["programs"]:
        emit("🧮   no program captured or run yet (graphs capture at first use)")
    report["graph_pool_bytes"] = pools
    actual = (est["weights_bytes"] + est["kv_bytes"]) // max(1, report["n_shards"]) + pools
    report["actual_floor_bytes"] = actual
    if limit and actual > limit:
        emit(f"⚠️ 🧮 measured floor {_gb(actual)} exceeds the device limit "
             f"{_gb(limit)} — the estimate's margin was optimistic")
    elif actual > est["need_per_device"]:
        emit(f"⚠️ 🧮 measured floor {_gb(actual)} exceeds the hbm.py "
             f"estimate {_gb(est['need_per_device'])} — estimate drift, "
             f"check runtime/hbm.py against this model")
    return report
