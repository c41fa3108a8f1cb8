"""Serving flight recorder — per-tick scheduler history, black-box dumps,
and Perfetto (Chrome trace-event) timeline export (the port of the JAX
package's ``runtime/flightrec.py``).

The telemetry module's metrics are aggregates and the span ring (telemetry.SpanTracer)
only sees per-request phases; neither records *why* a scheduler tick
admitted, requeued, preempted, or stalled — exactly the information a
prefill/decode token-budget tuning pass (or a postmortem of a wedged
batch) needs. This module is that record:

* **Tick ring** — one structured record per work-carrying scheduler tick
  (batch composition, admit/retire/requeue/preempt/spec_degraded
  decisions with machine-readable reasons, the prefill-vs-decode token
  split, speculative draft/accept counts, dispatch wall time, block-pool
  occupancy, queue depth). Bounded
  (:data:`RING_TICKS`), host-only, always on: recording is one lock +
  dict append per event against multi-ms ticks, and sits in host code
  around the graph replays, never inside a captured step.
* **Event ring** — per-request lifecycle events (submit / admit /
  decode_armed / first_token / requeue / preempt / retire / timeout)
  from any thread, stamped with the tick they happened in.
* **Postmortem dumps** — :meth:`FlightRecorder.dump` writes the last N
  ticks + events + the span ring to a JSON crash file (rate-limited per
  reason). The watchdog stall path, scheduler crash supervision, and
  KV-block exhaustion all call it, so a dead batch always leaves a
  readable black box naming the victim requests and the decisions
  leading in. ``GET /debug/flight`` serves the live rings.
* **Chrome-trace export** — :func:`to_chrome_trace` renders the rings +
  span ring as Perfetto-loadable trace-event JSON (per-slot request
  tracks, a scheduler tick track, queue-depth/occupancy/block counter
  tracks, one flow per request). ``GET /debug/timeline`` serves it live;
  ``python -m dllama_tpu_torch timeline --dump f.json`` converts offline.

Dependency-free (stdlib + runtime.telemetry only). Like the span ring, the recorder is process-global: two schedulers
in one process interleave their ticks (request ids are per-scheduler
counters), so this is a debug view, not an audit log.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque

from . import telemetry

RING_TICKS = 256
RING_EVENTS = 4096
# one postmortem per reason per window: exhaustion under sustained
# pressure must not spray a file per tick
DUMP_MIN_INTERVAL_S = 30.0

# spans with slot == -1 (the single-sequence engine path) render on one
# synthetic "engine" thread in the trace
_NO_SLOT_TID = 999


class FlightRecorder:
    """Bounded tick + event rings for one process's serving loop(s).

    Thread model: ticks are opened/closed by the scheduler loop thread;
    events may arrive from any thread (submit runs on HTTP handlers).
    All state is under one lock; every operation is O(1) appends.

    ``clock`` is injectable (monotonic ns) so the golden-fixture
    generator can record deterministic timelines."""

    def __init__(self, clock=None):
        self._clock = clock or telemetry.now_ns
        self._lock = threading.Lock()
        self._ticks: deque = deque(maxlen=RING_TICKS)
        self._events: deque = deque(maxlen=RING_EVENTS)
        self._cur: dict | None = None
        self._tick_seq = 0
        self._dump_seq = 0
        self._last_dump: dict[str, float] = {}
        self._dumps: deque = deque(maxlen=16)
        reg = telemetry.registry()
        self._m_ticks = reg.counter(telemetry.FLIGHT_TICKS)
        self._m_dumps = reg.counter(telemetry.FLIGHT_DUMPS)

    def reset(self) -> None:
        """Forget everything, including the dump rate limiter (tests)."""
        with self._lock:
            self._ticks.clear()
            self._events.clear()
            self._cur = None
            self._tick_seq = 0
            self._dump_seq = 0
            self._last_dump.clear()
            self._dumps.clear()

    # -- tick lifecycle (scheduler loop thread) -----------------------------

    def begin_tick(self, queue_depth: int = 0, n_admissions: int = 0) -> None:
        with self._lock:
            self._tick_seq += 1
            self._cur = {"tick": self._tick_seq,
                         "t_start_ns": self._clock(),
                         "queue_depth": queue_depth,
                         "n_admissions": n_admissions,
                         "decisions": [], "dispatch_ms": 0.0,
                         "prefill_ms": 0.0, "prefill_tokens": 0,
                         "decode_tokens": 0, "n_active": 0}

    def note(self, event: str, rid: int = -1, reason: str = "",
             **extra) -> None:
        """One lifecycle/decision event: always appended to the event ring
        (stamped with the current tick number), and — when a tick is open
        — to that tick's decision list, so the tick record reads as "what
        the scheduler decided and why"."""
        rec = {"t_ns": self._clock(), "event": event, "rid": rid}
        if reason:
            rec["reason"] = reason
        rec.update(extra)
        with self._lock:
            rec["tick"] = self._tick_seq
            self._events.append(rec)
            if self._cur is not None:
                d = {"event": event, "rid": rid}
                if reason:
                    d["reason"] = reason
                d.update(extra)
                self._cur["decisions"].append(d)

    def note_dispatch(self, ms: float, n_active: int, emitted: int) -> None:
        """One decode dispatch inside the current tick."""
        with self._lock:
            if self._cur is None:
                return
            self._cur["dispatch_ms"] += ms
            self._cur["n_active"] = max(self._cur["n_active"], n_active)
            self._cur["decode_tokens"] += emitted

    def note_prefill(self, rid: int, ms: float, n_tokens: int) -> None:
        """One prefill chunk dispatch inside the current tick (the prefill
        side of the tick's token-budget split)."""
        with self._lock:
            if self._cur is None:
                return
            self._cur["prefill_ms"] += ms
            self._cur["prefill_tokens"] += n_tokens

    def note_spec(self, drafted: int, accepted: int) -> None:
        """One speculative verify dispatch's draft/accept counts inside
        the current tick — the tick record's view of what the verify
        width bought (accept rate per tick, next to the dispatch wall it
        cost). Zero-draft ticks are recorded too: a run of
        ``spec_draft_tokens: 0`` ticks under spec serving is the
        degraded-proposer signature a postmortem should show."""
        with self._lock:
            if self._cur is None:
                return
            self._cur["spec_draft_tokens"] = (
                self._cur.get("spec_draft_tokens", 0) + drafted)
            self._cur["spec_accept_tokens"] = (
                self._cur.get("spec_accept_tokens", 0) + accepted)

    def end_tick(self, blocks: dict | None = None, **extra) -> None:
        """Close the tick. Idle ticks (no decisions, no dispatch, no
        prefill) are dropped — the ring stays signal-dense and tick
        numbering gaps mark idle stretches."""
        with self._lock:
            cur, self._cur = self._cur, None
            if cur is None:
                return
            cur["t_end_ns"] = self._clock()
            if blocks is not None:
                cur["blocks"] = dict(blocks)
            cur.update(extra)
            if not (cur["decisions"] or cur["dispatch_ms"]
                    or cur["prefill_ms"]):
                return
            self._ticks.append(cur)
        self._m_ticks.inc()

    # -- views ---------------------------------------------------------------

    def snapshot(self, n_ticks: int = RING_TICKS,
                 n_events: int = RING_EVENTS) -> dict:
        """The live rings (``GET /debug/flight``), newest last. An OPEN
        tick is included as a partial record marked ``"open": true`` — a
        mid-tick postmortem (exhaustion dump, watchdog stall while the
        loop thread is wedged inside a dispatch) must show the dying
        tick's decisions, not stop at the last completed one."""
        with self._lock:
            ticks = list(self._ticks)[-n_ticks:]
            if self._cur is not None:
                cur = dict(self._cur)
                cur["decisions"] = list(cur["decisions"])
                cur["open"] = True
                ticks.append(cur)
            return {"tick_seq": self._tick_seq,
                    "ticks": ticks,
                    "events": list(self._events)[-n_events:],
                    "dumps": list(self._dumps)}

    def payload(self, reason: str, victims=(), info: dict | None = None, *,
                spans=None, requests=None) -> dict:
        """The dump-file document: rings + span ring + request timelines.
        ``spans``/``requests`` are injectable for the deterministic
        golden-fixture generator; by default they come from the live
        tracer."""
        snap = self.snapshot()
        snap.pop("dumps", None)
        tr = telemetry.tracer()
        return {"reason": reason,
                "victims": [int(v) for v in victims],
                "info": dict(info or {}),
                "t_ns": self._clock(),
                "pid": os.getpid(),
                **snap,
                "spans": tr.raw_spans() if spans is None else spans,
                "requests": (tr.recent_requests() if requests is None
                             else requests)}

    def dump(self, reason: str, victims=(),
             info: dict | None = None) -> str | None:
        """Write the black-box postmortem file; returns its path, or None
        when rate-limited (same reason within
        :data:`DUMP_MIN_INTERVAL_S`) or unwritable. Directory:
        ``DLLAMA_FLIGHT_DIR`` env, else the system temp dir."""
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(reason)
            if last is not None and now - last < DUMP_MIN_INTERVAL_S:
                return None
            self._last_dump[reason] = now
            self._dump_seq += 1
            seq = self._dump_seq
        doc = self.payload(reason, victims, info)
        d = os.environ.get("DLLAMA_FLIGHT_DIR") or tempfile.gettempdir()
        path = os.path.join(
            d, f"dllama-flight-{os.getpid()}-{seq:03d}-{reason}.json")
        try:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1)
        except OSError as e:
            print(f"🛑 flight recorder: postmortem write to {path} failed "
                  f"({e})", flush=True)
            with self._lock:
                # a failed write must not arm the rate limiter: the next
                # incident (disk freed, dir fixed) still gets its postmortem
                if self._last_dump.get(reason) == now:
                    del self._last_dump[reason]
            return None
        self._m_dumps.inc(reason=reason)
        with self._lock:
            self._dumps.append(path)
        print(f"🧾 flight recorder: {reason} postmortem → {path} (victims: "
              f"{', '.join(str(v) for v in victims) or 'none'})", flush=True)
        return path


def ttft_phases(t_submit: int, t_admit: int, t_decode: int,
                t_first_token: int, ms_prefill: float,
                ms_pagein: float = 0.0,
                ms_kvmigrate: float = 0.0) -> dict:
    """THE TTFT phase formula — every surface that decomposes a first
    token (the ``dllama_ttft_attrib_ms`` histograms, the API ``timing``
    block on both serving paths, bench.py's attribution section) derives
    from this one function, so they can never drift apart. Timestamps
    are monotonic ns; ``ms_prefill`` is the request's own prefill chunk
    dispatch wall, ``ms_pagein`` its KV-tier page-in wall (resumed
    sessions restoring spilled blocks; 0 everywhere else), and
    ``ms_kvmigrate`` its peer-KV migration wall (fetch + stage + commit,
    or the failed attempt before a recompute fallback; 0 everywhere
    else). Phases: queue (submit → admission start minus the migration
    wall — migration runs while the request is parked pre-admission, so
    it is carved out of the queue window), kvmigrate (peer-KV fetch +
    scatter, clamped to the queue window), pagein (host→device block
    restore for a resumed session), admission (admission start →
    decode-armed minus own prefill and pagein walls — bookkeeping plus
    interleave gaps while other requests' chunks ran), prefill (own
    chunk dispatch wall; pagein+prefill clamp to the admission window),
    first_decode (decode-armed → first token). The six sum to
    ``ttft_ms`` by construction. Single-sequence serving passes
    ``t_admit == t_submit`` (no scheduler queue → queue = 0)."""
    queue_window = (t_admit - t_submit) / 1e6
    kvmigrate = min(ms_kvmigrate, queue_window)
    window = (t_decode - t_admit) / 1e6
    pagein = min(ms_pagein, window)
    prefill = min(ms_prefill, window - pagein)
    return {"ttft_ms": (t_first_token - t_submit) / 1e6,
            "queue_ms": queue_window - kvmigrate,
            "kvmigrate_ms": kvmigrate,
            "pagein_ms": pagein,
            "admission_ms": window - prefill - pagein,
            "prefill_ms": prefill,
            "first_decode_ms": (t_first_token - t_decode) / 1e6}


def record_ttft(hist, bd: dict) -> None:
    """Publish a :func:`ttft_phases` breakdown into the
    ``dllama_ttft_attrib_ms`` histogram — the one publication site for
    both serving paths, so the phase label set can never diverge."""
    hist.record(bd["queue_ms"], phase="queue")
    hist.record(bd["kvmigrate_ms"], phase="kvmigrate")
    hist.record(bd["pagein_ms"], phase="pagein")
    hist.record(bd["admission_ms"], phase="admission")
    hist.record(bd["prefill_ms"], phase="prefill")
    hist.record(bd["first_decode_ms"], phase="first_decode")


_recorder = FlightRecorder()


def recorder() -> FlightRecorder:
    """The process-wide default recorder (what the scheduler writes and
    ``/debug/flight`` serves)."""
    return _recorder


# -- Chrome trace-event export ------------------------------------------------


def _span_tid(slot: int) -> int:
    return _NO_SLOT_TID if slot < 0 else slot


def to_chrome_trace(data: dict) -> dict:
    """Render a flight snapshot/dump (``ticks`` + ``events`` + raw
    ``spans``) as Chrome trace-event JSON, loadable in Perfetto or
    chrome://tracing.

    Track layout: pid 1 = the scheduler (tid 0: one ``X`` slice per tick
    with its decisions in ``args``, plus queue-depth / active-slot /
    kv-block counter tracks); pid 2 = requests (one thread per slot,
    ``X`` slices per request phase from the span ring, plus one flow —
    ``s``/``t``/``f`` events, id = request id — chaining each request's
    phases across slots). Timestamps are the recorder's monotonic ns
    rendered as µs; spans and ticks share one clock."""
    ticks = data.get("ticks") or []
    spans = data.get("spans") or []
    out: list[dict] = []

    def meta(pid, tid, what, name):
        e = {"ph": "M", "pid": pid, "name": what, "args": {"name": name}}
        if tid is not None:
            e["tid"] = tid
        out.append(e)

    meta(1, None, "process_name", "scheduler")
    meta(1, 0, "thread_name", "ticks")
    meta(2, None, "process_name", "requests")
    for sl in sorted({s["slot"] for s in spans}):
        meta(2, _span_tid(sl), "thread_name",
             "engine" if sl < 0 else f"slot {sl}")

    for t in ticks:
        ts = t["t_start_ns"] / 1e3
        dur = max(0.0, (t.get("t_end_ns", t["t_start_ns"])
                        - t["t_start_ns"]) / 1e3)
        args = {k: t[k] for k in ("queue_depth", "n_admissions", "decisions",
                                  "dispatch_ms", "prefill_ms",
                                  "prefill_tokens", "decode_tokens",
                                  "spec_draft_tokens", "spec_accept_tokens",
                                  "n_active", "slots", "blocks",
                                  "prefill_budget") if k in t}
        out.append({"ph": "X", "pid": 1, "tid": 0, "ts": ts, "dur": dur,
                    "name": f"tick {t['tick']}", "cat": "tick",
                    "args": args})
        out.append({"ph": "C", "pid": 1, "tid": 0, "ts": ts,
                    "name": "queue_depth",
                    "args": {"requests": t.get("queue_depth", 0)}})
        out.append({"ph": "C", "pid": 1, "tid": 0, "ts": ts,
                    "name": "active_slots",
                    "args": {"slots": t.get("n_active", 0)}})
        blocks = t.get("blocks")
        if blocks:
            args = {"used": blocks.get("used", 0),
                    "shared": blocks.get("shared", 0)}
            if "host_used" in blocks:
                # tiered KV memory: the host-resident block count rides
                # the same counter track, so a Perfetto view shows spill
                # pressure next to device occupancy
                args["host_used"] = blocks.get("host_used", 0)
            out.append({"ph": "C", "pid": 1, "tid": 0, "ts": ts,
                        "name": "kv_blocks", "args": args})

    by_rid: dict[int, list[dict]] = {}
    for s in spans:
        by_rid.setdefault(s["request_id"], []).append(s)
    for rid, ss in sorted(by_rid.items()):
        ss.sort(key=lambda s: (s["start_ns"], s["end_ns"]))
        for i, s in enumerate(ss):
            tid = _span_tid(s["slot"])
            ts = s["start_ns"] / 1e3
            dur = max(0.0, (s["end_ns"] - s["start_ns"]) / 1e3)
            args = {"request_id": rid, "phase": s["phase"],
                    "n_tokens": s["n_tokens"]}
            if s.get("tenant"):
                # tenant-bound spans (telemetry.SpanTracer.bind_tenant)
                # keep their attribution in the rendered trace, so a
                # Perfetto query can slice one tenant's requests out of
                # a mixed-tenant timeline
                args["tenant"] = s["tenant"]
            out.append({"ph": "X", "pid": 2, "tid": tid, "ts": ts,
                        "dur": dur, "name": f"r{rid} {s['phase']}",
                        "cat": "request", "args": args})
            if len(ss) == 1:
                # a single-span request still gets a complete flow: start
                # at the slice begin, finish at its end
                out.append({"ph": "s", "pid": 2, "tid": tid, "ts": ts,
                            "id": rid, "name": "request", "cat": "req"})
                out.append({"ph": "f", "pid": 2, "tid": tid,
                            "ts": ts + dur, "id": rid, "bp": "e",
                            "name": "request", "cat": "req"})
                continue
            ph = "s" if i == 0 else ("f" if i == len(ss) - 1 else "t")
            flow = {"ph": ph, "pid": 2, "tid": tid, "ts": ts, "id": rid,
                    "name": "request", "cat": "req"}
            if ph == "f":
                flow["bp"] = "e"
            out.append(flow)

    # global ts sort (metadata first) keeps every track's slices
    # monotonic — the validator and Perfetto's importer both assume it
    out.sort(key=lambda e: e.get("ts", -1.0))
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def validate_chrome_trace(trace: dict, expect_rids=None) -> list[str]:
    """Structural validation of a trace produced by
    :func:`to_chrome_trace` (the golden-fixture test and the offline
    converter's ``--check`` both use it). Returns a list of problems
    (empty = valid): per-track ``X`` timestamps must be monotonic with
    non-negative durations, every flow must run start→finish, and — when
    ``expect_rids`` is given — every one of those requests must be
    present as a complete flow with at least one phase slice."""
    problems: list[str] = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is missing or not a list"]
    last_ts: dict[tuple, float] = {}
    flows: dict[int, list[str]] = {}
    slice_rids: set[int] = set()
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)):
            problems.append(f"event {i} ({ph}): non-numeric ts {ts!r}")
            continue
        if ph == "X":
            key = (e.get("pid"), e.get("tid"))
            if ts < last_ts.get(key, float("-inf")):
                problems.append(f"track {key}: ts regressed at event {i} "
                                f"({e.get('name')})")
            last_ts[key] = ts
            if e.get("dur", 0) < 0:
                problems.append(f"event {i} ({e.get('name')}): negative dur")
            rid = (e.get("args") or {}).get("request_id")
            if rid is not None:
                slice_rids.add(rid)
        elif ph in ("s", "t", "f"):
            flows.setdefault(e.get("id"), []).append(ph)
    for fid, phs in sorted(flows.items()):
        if phs[0] != "s" or phs[-1] != "f" \
                or any(p != "t" for p in phs[1:-1]):
            problems.append(f"flow {fid}: incomplete chain {phs} "
                            f"(want s, t*, f)")
    if expect_rids is not None:
        for rid in sorted(set(expect_rids)):
            if rid not in flows:
                problems.append(f"request {rid}: no flow in the trace")
            if rid not in slice_rids:
                problems.append(f"request {rid}: no phase slice in the "
                                f"trace")
    return problems


# -- fleet timeline join ------------------------------------------------------


def fleet_chrome_trace(router_dump: dict,
                       replica_dumps: dict[str, dict]) -> dict:
    """Join the router's span ring with each replica's flight dump into
    one Chrome trace keyed by the fleet request id.

    ``router_dump`` is a ``/debug/fleet`` body (its ``spans`` list holds
    the RouterSpanRing records: string ``request_id``, ``phase`` from
    telemetry.ROUTER_PHASES, ``replica``, ``hop``). ``replica_dumps``
    maps replica name → that replica's ``/debug/flight`` body, whose
    ``spans`` carry engine-local integer request ids plus the
    ``fleet``/``hop`` fields the API layer bound, and whose ``events``
    include the ``fleet_rid`` lifecycle binding (``rid`` = local id,
    ``reason`` = fleet id, ``hop``); either join path suffices.

    Track layout: pid 1 = the router (tid = hop index, so a retried
    request's two hops stack as two visible rows), pid 2+i = one process
    per replica with the usual per-slot threads. Every joined slice
    carries ``args.request_id`` = the fleet id (a string — flow ids and
    slice ids must be one type, the validator sorts them); one flow per
    fleet id chains router and replica slices in timestamp order, so a
    retried request reads as ONE flow crossing two replica tracks.
    Replica spans with no fleet binding (direct/local requests) render
    as slices under a ``local:`` id but contribute no flow. A top-level
    ``fleetJoin`` summary counts what joined — the offline
    ``fleettrace`` CLI exits 1 when nothing does. Timestamps are each
    process's monotonic ns: same-process fleets (tests, bench) share one
    clock; cross-process dumps keep per-track order but tracks may be
    mutually offset."""
    out: list[dict] = []
    # (ts, dur, pid, tid) per fleet id, to chain the flow afterwards
    by_fleet: dict[str, list[tuple[float, float, int, int]]] = {}

    def meta(pid, tid, what, name):
        e = {"ph": "M", "pid": pid, "name": what, "args": {"name": name}}
        if tid is not None:
            e["tid"] = tid
        out.append(e)

    meta(1, None, "process_name", "router")
    router_spans = router_dump.get("spans") or []
    for hop in sorted({max(0, int(s.get("hop", 0))) for s in router_spans}
                      or {0}):
        meta(1, hop, "thread_name", f"hop {hop}")
    n_router_ids = len({s["request_id"] for s in router_spans})
    for s in router_spans:
        rid = str(s["request_id"])
        tid = max(0, int(s.get("hop", 0)))
        ts = s["start_ns"] / 1e3
        dur = max(0.0, (s["end_ns"] - s["start_ns"]) / 1e3)
        args = {"request_id": rid, "phase": s["phase"]}
        for k in ("replica", "hop", "code", "state", "load"):
            if k in s:
                args[k] = s[k]
        out.append({"ph": "X", "pid": 1, "tid": tid, "ts": ts, "dur": dur,
                    "name": f"{s['phase']}", "cat": "router", "args": args})
        by_fleet.setdefault(rid, []).append((ts, dur, 1, tid))

    joined_ids: set[str] = set()
    n_unjoined_spans = 0
    for i, (name, dump) in enumerate(sorted(replica_dumps.items())):
        pid = 2 + i
        meta(pid, None, "process_name", f"replica {name}")
        # fleet_rid lifecycle events: local int rid -> (fleet id, hop) —
        # the binding for spans emitted before bind_fleet took effect
        bind: dict[int, tuple[str, int]] = {}
        for ev in dump.get("events") or []:
            if ev.get("event") == "fleet_rid" and ev.get("reason"):
                bind[ev.get("rid")] = (str(ev["reason"]),
                                       int(ev.get("hop", 0)))
        seen_tids: set[int] = set()
        for s in dump.get("spans") or []:
            local = s.get("request_id")
            fleet, hop = (s["fleet"], s.get("hop", 0)) \
                if "fleet" in s else bind.get(local, (None, 0))
            tid = _span_tid(s.get("slot", -1))
            if tid not in seen_tids:
                seen_tids.add(tid)
                meta(pid, tid, "thread_name",
                     "engine" if tid == _NO_SLOT_TID else f"slot {tid}")
            ts = s["start_ns"] / 1e3
            dur = max(0.0, (s["end_ns"] - s["start_ns"]) / 1e3)
            rid = fleet if fleet is not None else f"local:{name}:{local}"
            args = {"request_id": rid, "phase": s["phase"],
                    "local_rid": local, "hop": hop,
                    "n_tokens": s.get("n_tokens", 0)}
            out.append({"ph": "X", "pid": pid, "tid": tid, "ts": ts,
                        "dur": dur, "name": f"{s['phase']}",
                        "cat": "replica", "args": args})
            if fleet is not None:
                joined_ids.add(fleet)
                by_fleet.setdefault(fleet, []).append((ts, dur, pid, tid))
            else:
                n_unjoined_spans += 1

    for rid, slices in sorted(by_fleet.items()):
        slices.sort()
        if len(slices) == 1:
            ts, dur, pid, tid = slices[0]
            out.append({"ph": "s", "pid": pid, "tid": tid, "ts": ts,
                        "id": rid, "name": "request", "cat": "fleet"})
            out.append({"ph": "f", "pid": pid, "tid": tid, "ts": ts + dur,
                        "id": rid, "bp": "e", "name": "request",
                        "cat": "fleet"})
            continue
        for j, (ts, dur, pid, tid) in enumerate(slices):
            ph = "s" if j == 0 else ("f" if j == len(slices) - 1 else "t")
            flow = {"ph": ph, "pid": pid, "tid": tid, "ts": ts, "id": rid,
                    "name": "request", "cat": "fleet"}
            if ph == "f":
                flow["bp"] = "e"
            out.append(flow)

    out.sort(key=lambda e: e.get("ts", -1.0))
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "fleetJoin": {"router_requests": n_router_ids,
                          "joined": len(joined_ids),
                          "replicas": len(replica_dumps),
                          "unjoined_replica_spans": n_unjoined_spans}}
