"""Profiler capture, per-op attribution, the per-token Eval/Sync split and
the tensor-parallel merges' traffic (the port of the JAX package's
``runtime/profiling.py``, with its result schemas).

Reference parity target: dllama.cpp prints, for every generated token,
``Eval ms / Sync ms / Sent kB / Recv kB`` (src/dllama.cpp:59-67). The port
takes them from the two places they exist:

* **time** — a ``torch.profiler`` capture (:func:`capture`, CPU and CUDA
  activities) writes a Chrome-trace JSON. Its device events (categories
  ``kernel``, ``gpu_memcpy``, ``gpu_memset``; one lane per device stream)
  are the device time. "Sync" is the device time of the tensor-parallel
  merges (``ops/linear.py::merge_shards``): during a capture each merge's
  copies and sums run inside a ``tp_merge`` profiler range, and a kernel
  is sync time when the CUDA call that launched it lies inside one
  (:func:`split_from_trace`). At ``tp = 1`` there is no merge: sync is 0
  and no trace runs, as in the JAX engine.
* **bytes** — the JAX package reads its collectives' payloads off the
  compiled HLO. The port has no HLO: every merge counts what it moves
  between rank 0 and the other ranks (``ops/linear.py::MERGES``), and
  :class:`TrafficStats` is that count over one step, per merge and in
  total, whether or not the ranks share a card.

:func:`op_attribution` decomposes a capture's device time by op and by
:data:`OP_CLASSES` (``POST /debug/profile?ops=1``, ``chip_smoke.py``'s
profiles). A trace with no device events (a CPU run) is attributed over
its host threads' ``cpu_op`` events instead, which nest (``aten::linear``
holds ``aten::matmul``): ``sum_over_union`` says by how much.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import re
import tempfile
import threading
import time
from dataclasses import dataclass


class CaptureBusyError(RuntimeError):
    """A profiler capture is already running (one session per process;
    ``POST /debug/profile`` maps this to HTTP 409)."""


# THE profiler entry point: the CLI's --profile, POST /debug/profile and
# measure_eval_sync all come through here, so session-at-a-time
# serialization lives in exactly one place
_capture_lock = threading.Lock()


def capture_active() -> bool:
    """Whether a :func:`capture` session is running in this process."""
    return _capture_lock.locked()


@contextlib.contextmanager
def capture(trace_dir: str, on_loop=None):
    """Run one ``torch.profiler`` session (CPU and, on a machine with a
    card, CUDA activities) and write its Chrome trace as a ``.json`` into
    ``trace_dir``; yields the profiler. Raises :class:`CaptureBusyError`
    when a session is already active. The tp merges are annotated for the
    session's length only. ``on_loop(fn)`` runs the session's start and
    stop on the thread that dispatches the steps (a serving scheduler's
    loop, between ticks: a session stopped from another thread while that
    one launches a graph can deadlock the process); the trace is written on
    the caller's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..ops.linear import annotate_merges

    run = on_loop or (lambda fn: fn())
    if not _capture_lock.acquire(timeout=0.5):
        raise CaptureBusyError("a profiler capture is already in progress")
    try:
        os.makedirs(trace_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        annotate_merges(True)
        try:
            run(prof.start)
            try:
                yield prof
            finally:
                run(prof.stop)
        finally:
            annotate_merges(False)
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
    finally:
        _capture_lock.release()


# -- Chrome-trace parsing -------------------------------------------------------

# Event names that are collective communication (or waiting on it): the JAX
# package's set, kept so its op names classify alike
_SYNC_RE = re.compile(
    r"(all-reduce|all-gather|all-to-all|collective-permute|reduce-scatter"
    r"|collective-broadcast|^psum\b|^psum[._]|^ppermute[._]?|^all_gather"
    r"|^all_to_all|^reduce_scatter|rendezvous|^wait\b|^wait:)",
    re.IGNORECASE)

# -- per-op attribution classes ----------------------------------------------
#
# First match wins, so order matters (the JAX package's order): a
# collective is a collective even when its name mentions a dot; attention
# is named before the generic matmul family; the sampler's sort/scan ops
# before anything else they could match. The port's own kernels are named
# into their classes: K1/K2 (q40_gemv*, q40_matmul*, sum_splits_kernel) and
# K5 (moe_*) in gemv/matmul with cuBLAS's Hopper kernels (nvjet*: the dense
# bf16 head of fast configs), K3/K4 (flash_attention*, paged_attention*,
# combine_splits_kernel) in attention, PyTorch's sort and scan kernels (the
# sampler's top-p sort and cumsum) in sampling.
OP_CLASSES = (
    ("collective", _SYNC_RE),
    ("attention", re.compile(r"(attention|attn|flash|softmax|combine_splits)",
                             re.IGNORECASE)),
    ("sampling", re.compile(r"(top_k|top-k|sort|argmax|arg_max|cumsum|"
                            r"categorical|gumbel|threefry|random|rng_bit|"
                            r"scan_innermost|DeviceScan)",
                            re.IGNORECASE)),
    ("gemv/matmul", re.compile(r"(dot_general|dot\b|dot\.|_dot_|matmul|"
                               r"gemm|gemv|einsum|convolution|sum_splits_kernel|"
                               r"moe_tc_kernel|moe_reduce_kernel|nvjet)",
                               re.IGNORECASE)),
    ("dequant", re.compile(r"(dequant|quantize|convert_element_type|"
                           r"convert\b|bitcast_convert)", re.IGNORECASE)),
)

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def classify_op(name: str) -> str:
    """Op-class label for one device event name (see :data:`OP_CLASSES`;
    ``"other"`` for everything unmatched)."""
    for cls, rx in OP_CLASSES:
        if rx.search(name):
            return cls
    return "other"


def empty_attribution(n_steps: int = 0) -> dict:
    """The op-attribution result shape with nothing in it — THE schema
    both :func:`op_attribution` and the idle-window ``?ops=1`` fallback
    build on, so the empty and populated responses can never diverge."""
    return {"n_steps": n_steps, "n_lanes": 0, "lanes": [],
            "device_busy_ms_per_step": 0.0, "classes": {}, "top_ops": [],
            "total_ms_per_step": 0.0, "sum_over_union": 0.0}


def load_trace(trace_dir: str) -> dict:
    """The newest Chrome-trace ``.json`` under ``trace_dir`` (recursive)."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True)
    if not paths:
        raise RuntimeError(f"no profiler trace (.json) under {trace_dir}")
    path = max(paths, key=os.path.getmtime)
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except ValueError as e:
        raise RuntimeError(f"malformed profiler trace {path}: {e}") from e


def _lanes(trace: dict) -> list[tuple[str, str, list[tuple[str, int, int, bool]]]]:
    """``(plane, line, [(name, start_ns, end_ns, is_sync)])`` per lane: one
    lane per device stream, or, with no device event in the trace, one per
    host thread of ``cpu_op`` events. A device event is sync when the CUDA
    call that launched it lies inside a ``tp_merge`` range on its thread
    (or, on its stream, inside the range's device projection); a host op
    when it lies inside one on its own thread."""
    from ..ops.linear import MERGE_SPAN

    by_cat: dict[str, list[dict]] = {}
    base = None
    for e in trace.get("traceEvents", ()):
        if e.get("ph") == "X" and "ts" in e:
            by_cat.setdefault(e.get("cat"), []).append(e)
            base = e["ts"] if base is None else min(base, e["ts"])

    def ns(t) -> int:
        return round((t - base) * 1000)

    merges: dict = {}  # (pid, tid) -> [(start, end)] of tp_merge ranges
    for cat in ("user_annotation", "gpu_user_annotation"):
        for e in by_cat.get(cat, ()):
            if e.get("name") == MERGE_SPAN:
                merges.setdefault((e.get("pid"), e.get("tid")), []).append(
                    (ns(e["ts"]), ns(e["ts"] + e.get("dur", 0))))

    def in_merge(key, t: int) -> bool:
        return any(a <= t <= b for a, b in merges.get(key, ()))

    launched = set()
    if merges:
        for cat in ("cuda_runtime", "cuda_driver"):
            for e in by_cat.get(cat, ()):
                if in_merge((e.get("pid"), e.get("tid")), ns(e["ts"])):
                    launched.add((e.get("args") or {}).get("correlation"))
    device = [e for cat in _DEVICE_CATS for e in by_cat.get(cat, ())]
    host = not device
    lanes: dict = {}
    for e in device or by_cat.get("cpu_op", ()):
        key = (e.get("pid"), e.get("tid"))
        s = ns(e["ts"])
        end = max(s, ns(e["ts"] + e.get("dur", 0)))
        sync = bool(merges) and (
            in_merge(key, s) or (not host and (e.get("args") or {}).get("correlation")
                                 in launched))
        lanes.setdefault(key, []).append((e.get("name", ""), s, end, sync))
    plane, line = ("/host:CPU", "thread") if host else ("/device:GPU:", "stream")
    return [(plane if host else f"{plane}{pid}", f"{line} {tid}", lane)
            for (pid, tid), lane in sorted(lanes.items(), key=lambda kv: str(kv[0]))]


def op_attribution(trace_dir: str | None = None, *, trace: dict | None = None,
                   n_steps: int = 1, top: int = 25, lanes=None) -> dict:
    """Per-op device-time decomposition of a profiler capture, the JAX
    function's schema: the newest trace under ``trace_dir``, or an
    already-parsed ``trace`` dict.

    Attribution comes from the PRIMARY lane (the lane with the largest
    interval-union busy time): per-op duration sums, the op-class rollup of
    :data:`OP_CLASSES`, and the top ops by time. ``sum_over_union`` is the
    primary lane's per-op sum over that lane's own union (far above 1.0:
    nested or overlapping events double-count).
    ``device_busy_ms_per_step`` is the all-lane union — the whole-device
    busy figure. All times are ms, averaged per step with ``n_steps``.
    ``lanes``: the trace's :func:`_lanes`, when the caller has them."""
    if lanes is None:
        if trace is None:
            if trace_dir is None:
                raise ValueError("op_attribution needs trace_dir or trace")
            trace = load_trace(trace_dir)
        lanes = _lanes(trace)

    rows = []            # per-lane {plane, line, sum_ms, union_ms, n_events}
    all_iv: list[tuple[int, int]] = []
    best = None          # (union_ns, per_op_ns, per_op_count)
    for plane, line, events in lanes:
        iv, s_ns = [], 0
        ops: dict[str, int] = {}
        ops_n: dict[str, int] = {}
        for name, start, end, _ in events:
            dur = end - start
            iv.append((start, end))
            ops[name] = ops.get(name, 0) + dur
            ops_n[name] = ops_n.get(name, 0) + 1
            s_ns += dur
        u = union_span(iv)
        rows.append({"plane": plane, "line": line,
                     "sum_ms": s_ns / 1e6, "union_ms": u / 1e6,
                     "n_events": len(events)})
        all_iv.extend(iv)
        if best is None or u > best[0]:
            best = (u, ops, ops_n)

    steps = max(1, n_steps)
    g_union = union_span(all_iv)
    out = empty_attribution(n_steps)
    out["n_lanes"] = len(rows)
    out["lanes"] = rows
    out["device_busy_ms_per_step"] = g_union / 1e6 / steps
    if best is None:
        return out
    best_u, per_op, per_op_n = best
    total_ns = sum(per_op.values())
    out["total_ms_per_step"] = total_ns / 1e6 / steps
    out["sum_over_union"] = round(total_ns / max(1, best_u), 3)
    classes: dict[str, float] = {}
    for name, t in per_op.items():
        cls = classify_op(name)
        classes[cls] = classes.get(cls, 0.0) + t
    out["classes"] = {
        cls: {"ms_per_step": round(t / 1e6 / steps, 4),
              "frac": round(t / max(1, total_ns), 4)}
        for cls, t in sorted(classes.items(), key=lambda kv: -kv[1])}
    out["top_ops"] = [
        {"name": name, "class": classify_op(name),
         "ms_per_step": round(t / 1e6 / steps, 4),
         "count": per_op_n[name], "frac": round(t / max(1, total_ns), 4)}
        for name, t in sorted(per_op.items(), key=lambda kv: -kv[1])[:top]]
    return out


def union_span(intervals: list[tuple[int, int]]) -> int:
    """Total covered length of possibly-overlapping [start, end] spans, in
    the caller's units — nested events must not double-count. THE one
    interval-union sweep."""
    if not intervals:
        return 0
    intervals.sort()
    total = 0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    total += cur_e - cur_s
    return total


@dataclass
class EvalSyncSplit:
    """Steady-state per-step device-time split, averaged over the profiled
    steps and the lanes that carried events."""

    eval_ms: float        # device time outside the tp merges, per step per lane
    sync_ms: float        # the tp merges' device time, per step per lane
    n_steps: int          # steps profiled
    n_lanes: int          # lanes seen in the trace
    # EXPOSED merge time: sync lane time NOT covered by concurrent compute
    # on the same lane (union(sync ∪ eval) − union(eval)); published as
    # dllama_comm_exposed_ms
    exposed_ms: float = 0.0

    @property
    def sync_frac(self) -> float:
        tot = self.eval_ms + self.sync_ms
        return self.sync_ms / tot if tot > 0 else 0.0


def split_from_trace(trace_dir: str | None, n_steps: int, *,
                     trace: dict | None = None, lanes=None) -> EvalSyncSplit:
    """The Eval/Sync split of the newest trace under ``trace_dir`` (or of
    ``trace``, or of its :func:`_lanes`): per lane, the union of the tp
    merges' events is sync, the rest of the lane's union eval."""
    if lanes is None:
        lanes = _lanes(trace if trace is not None else load_trace(trace_dir))
    sync_ms = eval_ms = exposed_ms = 0.0
    n_lanes = 0
    for _, _, events in lanes:
        if not events:
            continue
        n_lanes += 1
        sync_iv = [(s, e) for _, s, e, sync in events if sync]
        eval_iv = [(s, e) for _, s, e, sync in events if not sync]
        s = union_span(list(sync_iv)) / 1e6
        sync_ms += s
        # time inside a merge counts once, as sync
        both = union_span(eval_iv + sync_iv) / 1e6
        eval_ms += max(0.0, both - s)
        exposed_ms += max(0.0, both - union_span(list(eval_iv)) / 1e6)
    lanes = max(1, n_lanes)
    return EvalSyncSplit(eval_ms=eval_ms / lanes / max(1, n_steps),
                         sync_ms=sync_ms / lanes / max(1, n_steps),
                         n_steps=n_steps, n_lanes=n_lanes,
                         exposed_ms=exposed_ms / lanes / max(1, n_steps))


def measure_eval_sync(step, n_steps: int = 3) -> EvalSyncSplit:
    """Profile ``step()`` (which must end in a synchronisation) for
    ``n_steps`` calls and return the split. A throwaway warm-up session
    runs first: the first session of a process initialises the tracer."""
    with tempfile.TemporaryDirectory(prefix="dllama-prof-") as d:
        with capture(os.path.join(d, "warmup")):
            step()
        with capture(os.path.join(d, "capture")):
            for _ in range(n_steps):
                step()
        return split_from_trace(os.path.join(d, "capture"), n_steps)


@dataclass
class TrafficStats:
    """The tp merges' traffic of one step, per token, from what
    ``merge_shards`` counted (``ops/linear.py::MERGES``): kB rank 0 sent to
    the other ranks and received from them, the number of merges, and the
    received kB per merge kind (``concat`` of a row split, ``sum`` of a
    col split). Counted, not estimated: each merge adds the bytes of the
    tensors it moves."""

    sent_kb: float
    recv_kb: float
    n_collectives: int
    by_kind: dict

    def __bool__(self) -> bool:
        return self.n_collectives > 0

    @classmethod
    def between(cls, before: dict, after: dict, n_tokens: int = 1,
                n_steps: int = 1) -> "TrafficStats":
        """The merges counted from ``before`` to ``after`` (two
        :func:`merge_counts`): kB per token over ``n_tokens``, merges per
        step over ``n_steps``."""
        per = max(1, n_tokens) * 1024.0
        kinds = {k: (v - before["by_kind"].get(k, 0)) / per
                 for k, v in after["by_kind"].items() if v != before["by_kind"].get(k, 0)}
        return cls(sent_kb=(after["sent_bytes"] - before["sent_bytes"]) / per,
                   recv_kb=(after["recv_bytes"] - before["recv_bytes"]) / per,
                   n_collectives=(after["n"] - before["n"]) // max(1, n_steps),
                   by_kind=kinds)


def merge_counts() -> dict:
    """A copy of the process's merge counters."""
    from ..ops.linear import MERGES

    return dict(MERGES, by_kind=dict(MERGES["by_kind"]))


def live_split_summary(engine, duration_s: float, *, include_ops: bool = False,
                       on_loop=None) -> dict:
    """``POST /debug/profile``: hold a profiler window open over whatever
    steps the serving loop dispatches in the next ``duration_s`` seconds,
    then classify the captured device time into the Eval/Sync split, with
    the merges' traffic of the window per emitted token (and, with
    ``include_ops``, the per-op attribution). An idle window gives a zero
    split and the empty attribution, never an error. ``on_loop``: see
    :func:`capture` (the batch scheduler's ``run_on_loop``)."""
    from . import telemetry

    reg = telemetry.registry()

    def _steps() -> int:
        return (reg.histogram(telemetry.BATCH_STEP_MS).count()
                + reg.histogram(telemetry.DECODE_STEP_MS).count())

    def _tokens() -> float:
        return (reg.counter(telemetry.BATCH_TOKENS).total()
                + reg.counter(telemetry.DECODE_TOKENS).total())

    n0, tok0, merges0 = _steps(), _tokens(), merge_counts()
    with tempfile.TemporaryDirectory(prefix="dllama-live-prof-") as d:
        with capture(d, on_loop=on_loop):
            time.sleep(duration_s)
        n = _steps() - n0
        n_tok = int(_tokens() - tok0)
        lanes = _lanes(load_trace(d))
        split = split_from_trace(None, max(1, n), lanes=lanes)
        ops = op_attribution(lanes=lanes, n_steps=max(1, n)) if include_ops else None
    out = {
        "duration_ms": duration_s * 1000.0,
        "n_steps": n,
        "eval_ms": split.eval_ms,
        "sync_ms": split.sync_ms,
        "sync_frac": split.sync_frac,
        "n_lanes": split.n_lanes,
        "collective_traffic": None,
    }
    if ops is not None:
        out["op_attribution"] = ops
    if engine.tp == 1:
        tr = TrafficStats(0.0, 0.0, 0, {})
    else:
        tr = TrafficStats.between(merges0, merge_counts(), n_tok, n)
    if engine.tp == 1 or n_tok:
        out["collective_traffic"] = {
            "sent_kb_per_token": tr.sent_kb, "recv_kb_per_token": tr.recv_kb,
            "n_collectives": tr.n_collectives, "by_kind": tr.by_kind}
    else:
        out["collective_traffic_error"] = "no token emitted in the window"
    return out
