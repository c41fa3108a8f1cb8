"""OpenAI-compatible HTTP API (the port of the JAX package's
``serve/api.py``): the single-sequence server and continuous batching.

* ``POST /v1/chat/completions`` — messages → completion, optional SSE
  streaming (``"stream": true``), ``temperature``/``top_p``/``seed``/
  ``max_tokens``/``stop``/``timeout`` per request;
* ``GET /v1/models``, ``/health`` and ``/healthz`` (liveness), ``/readyz``
  (readiness with a machine-readable code; unready once the step watchdog
  tripped);
* ``GET /metrics`` (the telemetry registry in the Prometheus text format),
  ``/debug`` (an index of the diagnostic routes), ``/debug/requests``
  (recent per-request phase timelines from the span ring),
  ``/debug/flight`` (the flight recorder's rings and the spans),
  ``/debug/timeline`` (the same as a Perfetto-loadable Chrome trace),
  ``/debug/numerics`` (the numerics observatory: tripwire totals per site,
  the last tapped forward's per-layer stats, the canary's status),
  ``/debug/eval`` (the last teacher-forced eval run of this process),
  ``/debug/tenants`` (the tenant observatory: per-tenant usage, limits and
  the fairness view), ``/debug/compiles`` (the compile ledger: kernel
  builds, graph captures, first runs, the retrace sentinel's steady flags;
  ``runtime/introspection.py``), ``/debug/roofline`` (per-program achieved
  bytes and operations against the card's ceilings; ``runtime/roofline.py``)
  and ``POST /debug/profile?ms=N[&ops=1]`` (a live ``torch.profiler``
  window over the serving loop: the Eval/Sync split, the tp merges'
  traffic and, with ``ops=1``, the per-op attribution;
  ``runtime/profiling.py``; 409 while another capture runs).

Two states behind one handler, as in the JAX package:

* :class:`ApiState` (``api`` without ``--batch-slots``) — the reference's
  own ``dllama-api``: one sequence on the engine, a plain ``HTTPServer``
  that serves one request at a time, and the message-prefix KV reuse of
  :class:`NaiveCache` (a body that extends the previous conversation
  prefills only its new messages);
* :class:`BatchedApiState` (``--batch-slots N``) — a
  ``ThreadingHTTPServer`` over
  :class:`~dllama_tpu_torch.runtime.serving.BatchScheduler` (the dense slot
  pool, or the paged block pool with ``--kv-block-size``): handler threads
  submit and block on a per-request queue fed by the scheduler thread's
  ``on_token`` callback.

Status codes are the JAX server's: 400 for a malformed body, 404 for an
unknown route, 408 for a deadline that expired before any output, 429 when
the queue is full, 503 when the scheduler is draining, crashed or stalled
or when the device-memory admission guard refuses the prompt (code
``queue_full``: load, not damage), 500 naming the site when a fail-fast
numerics tripwire fires on the single-sequence server (the batched one
fails the poisoned request 503-shaped). Every answer counts into
``dllama_http_requests_total{route, status}``; a body with ``"timing":
true`` gets the TTFT attribution block (non-streaming responses). The
``emit`` failpoint fires before every SSE write. ``/readyz`` carries
``eval_resident`` while teacher-forced eval sequences are queued or
prefilling. With ``--canary-interval`` the engine's canary golden is
recorded at startup and replayed after single-sequence completions, or on
the batch scheduler's tick.

Fleet tier, at the JAX package's sites: the ``X-Dllama-Request-Id`` /
``X-Dllama-Hop`` identity a fleet router sends is bound to the local
request id (the span tracer's ``bind_fleet`` and a ``fleet_rid`` flight
event) and echoed on every response with the sanitized ``X-Dllama-Tenant``
label; the tenant owns the request's accounting
(:mod:`~dllama_tpu_torch.runtime.tenancy`). The batched state stamps every
SSE chunk with a ``dllama`` block (the cumulative generated-token index and
the ids the chunk covers), and admits a router's mid-stream resume
(``resume_from``/``resume_tokens``): the history becomes prompt, the coin
stream is fast-forwarded by its length, and nothing at or below
``resume_from`` is emitted again. The single-sequence server refuses a
resume, as the JAX one does.

KV migration, at the JAX package's sites: on paged batched serving ``POST
/v1/kv/export {"tokens": [...]}`` answers the longest device-resident prefix
of ``tokens`` as a checksummed Q80 frame stream (``runtime/kvwire.py``; 404
when nothing is resident, 400 for a malformed body, 503 when the scheduler
cannot serve it); an ``X-Dllama-KV-Peer: host:port`` hint makes the replica
pull the prompt's prefix from that peer before admission (any wire failure
recomputes it, counted by reason); ``/readyz`` advertises the ``--role``
tag and ``kv_prefixes``, the affinity keys of prompts whose KV the pool
recently held, which the fleet router's donor map and prefill warm-up read.

At startup the server prints the device-memory table of the compile
ledger (``introspection.hbm_startup_report``: weights and KV against the
captured graphs' pool bytes). The retrace sentinel marks the engine's
scope steady after two quiet scheduler ticks (batched) or one quiet
completion (single sequence).
"""

from __future__ import annotations

import copy
import json
import os
import queue
import random
import re
import signal
import threading
import time
import uuid
from collections import OrderedDict
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer

from ..runtime import (evalharness, failpoints, flightrec, introspection, kvwire, numerics,
                       profiling, roofline, telemetry, tenancy)
from ..runtime.speculative import NgramProposer
from ..runtime.serving import (BatchScheduler, HbmAdmissionError, QueueFullError,
                               RequestTimeoutError, SchedulerUnavailableError,
                               check_hbm_admission)
from ..tokenizer.chat import (ChatItem, ChatTemplateGenerator, ChatTemplateType,
                              EosDetector, EosResult)
from .router import affinity_key

# absurd-deadline guard: a request may not park a slot for more than an hour
_MAX_TIMEOUT_S = 3600.0

# one Retry-After policy for every backpressure answer (429 transient queue
# pressure, 503 needs orchestrator time), with bounded random jitter so
# clients backpressured in the same instant don't return in one wave
RETRY_AFTER_S = {429: 1, 503: 5}
RETRY_AFTER_JITTER_S = {429: 1, 503: 3}

# POST /debug/profile capture-window bounds (ms): long enough to catch a few
# decode steps, short enough that a handler thread never parks for minutes
_PROFILE_MS_DEFAULT = 500
_PROFILE_MS_MAX = 10_000

# the closed machine-readable readiness vocabulary of every /readyz and
# 5xx-backpressure body (the fleet router sanitizes probe codes against it;
# serve/router.py spells the same tuple)
READY_CODES = ("ok", "draining", "crashed", "queue_full", "loading")


def backpressure_headers(status: int) -> dict:
    return {"Retry-After": str(RETRY_AFTER_S[status]
                               + random.randint(0, RETRY_AFTER_JITTER_S[status]))}


# fleet trace identity (serve/router.py is the usual sender): one request id
# names a request at every tier — the router mints it (or sanitizes a
# client-supplied one) and stamps the dispatch attempt index, both as
# headers on every hop. The replica binds them to its local integer rid
# (telemetry.tracer().bind_fleet + a "fleet_rid" flight event), echoes the
# id on its response, and threads it into the opt-in timing block
FLEET_RID_HEADER = "X-Dllama-Request-Id"
FLEET_HOP_HEADER = "X-Dllama-Hop"
FLEET_RID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")
# tenant identity (runtime/tenancy): who this request's tokens, latency,
# KV residency and shed decisions are attributed to; absent or malformed
# is "anon". Echoed (sanitized) on every completion response
TENANT_HEADER = "X-Dllama-Tenant"
# a router's spliced continuation names the count of tokens the client
# already holds (the body carries the history itself)
RESUME_FROM_HEADER = "X-Dllama-Resume-From"
# KV migration hint (a fleet router sends it): "host:port" of a peer replica
# whose paged pool holds this prompt's prefix. The replica pulls the prefix
# over the kvwire stream (POST /v1/kv/export on the peer) before admission
# instead of recomputing it; ANY wire failure degrades to ordinary chunked
# prefill. Advisory: an unsanitary or stale value is dropped, never an error
KV_PEER_HEADER = "X-Dllama-KV-Peer"
KV_PEER_RE = re.compile(r"^[A-Za-z0-9._\-\[\]:]{1,255}:\d{1,5}$")


def kv_peer(headers) -> str | None:
    """The sanitized KV migration hint off a request's headers (its value
    feeds ``http.client`` connections and flight notes, so an
    out-of-vocabulary string is dropped, never stored)."""
    peer = headers.get(KV_PEER_HEADER)
    if not peer or not KV_PEER_RE.match(peer):
        return None
    return peer


def tenant_identity(headers) -> str:
    """The sanitized tenant label off a request's headers."""
    return tenancy.sanitize_tenant(headers.get(TENANT_HEADER))


def fleet_identity(headers) -> tuple[str, int] | None:
    """``(fleet_id, hop)`` off a request's fleet trace headers, or None
    when absent or unsanitary (an out-of-vocabulary id is dropped, never
    stored: header values go into dumps and logs)."""
    rid = headers.get(FLEET_RID_HEADER)
    if not rid or not FLEET_RID_RE.match(rid):
        return None
    try:
        hop = int(headers.get(FLEET_HOP_HEADER) or 0)
    except ValueError:
        hop = 0
    return rid, max(0, hop)


class ClientDisconnect(Exception):
    """The SSE peer vanished mid-stream (BrokenPipeError / ConnectionResetError)."""


def _validate_body(body: dict) -> None:
    """Schema-check a /v1/chat/completions body; raises ``ValueError``
    (→ HTTP 400) with a client-actionable message. Every malformed shape
    dies here — a 500 from a typed field is a server bug."""
    if not isinstance(body, dict):
        raise ValueError("body must be a JSON object")
    # an explicit JSON null means "absent" (OpenAI semantics)
    for k in [k for k, v in body.items() if v is None]:
        del body[k]
    messages = body.get("messages")
    if not isinstance(messages, list) or not messages:
        raise ValueError("messages must be a non-empty list")
    for i, m in enumerate(messages):
        if not isinstance(m, dict):
            raise ValueError(f"messages[{i}] must be an object")
        if not isinstance(m.get("role", "user"), str):
            raise ValueError(f"messages[{i}].role must be a string")
        if not isinstance(m.get("content", ""), str):
            raise ValueError(f"messages[{i}].content must be a string")

    def _number(key, lo, hi):
        v = body.get(key)
        if v is None:
            return
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ValueError(f"{key} must be a number")
        if not (lo <= float(v) <= hi):
            raise ValueError(f"{key} must be in [{lo}, {hi}]")

    _number("temperature", 0.0, 100.0)
    _number("top_p", 0.0, 1.0)
    mt = body.get("max_tokens")
    if mt is not None:
        if isinstance(mt, bool) or not isinstance(mt, int):
            raise ValueError("max_tokens must be an integer")
        if mt < 0:
            raise ValueError("max_tokens must be >= 0")
    seed = body.get("seed")
    if seed is not None and (isinstance(seed, bool) or not isinstance(seed, int)):
        raise ValueError("seed must be an integer")
    timeout = body.get("timeout")
    if timeout is not None:
        if isinstance(timeout, bool) or not isinstance(timeout, (int, float)):
            raise ValueError("timeout must be a number (seconds)")
        if not (0 < float(timeout) <= _MAX_TIMEOUT_S):
            raise ValueError(f"timeout must be in (0, {_MAX_TIMEOUT_S:.0f}] seconds")
    timing = body.get("timing")
    if timing is not None and not isinstance(timing, bool):
        raise ValueError("timing must be a boolean")
    stop = body.get("stop")
    if stop is not None and not isinstance(stop, (str, list)):
        raise ValueError("stop must be a string or a list of strings")
    if isinstance(stop, list) and not all(isinstance(s, str) for s in stop):
        raise ValueError("stop must be a string or a list of strings")
    # mid-stream resume (a fleet router sends these on a failover
    # re-dispatch): the already-emitted token history rides in the body
    rf = body.get("resume_from")
    rtoks = body.get("resume_tokens")
    if rf is not None or rtoks is not None:
        if isinstance(rf, bool) or not isinstance(rf, int) or rf < 1:
            raise ValueError("resume_from must be a positive integer")
        if (not isinstance(rtoks, list) or len(rtoks) != rf
                or not all(isinstance(t, int) and not isinstance(t, bool) and t >= 0
                           for t in rtoks)):
            raise ValueError("resume_tokens must be a list of exactly "
                             "resume_from non-negative token ids")


@dataclass
class CachedMessage:
    role: str
    content: str
    end_pos: int


@dataclass
class NaiveCache:
    """Message-prefix KV cache (reference: NaiveCache, dllama-api.cpp:294-339)."""

    items: list[CachedMessage] = field(default_factory=list)

    def resolve_delta(self, messages: list[dict]) -> tuple[list[dict], int]:
        """If ``messages`` strictly extends the cached history, return the new
        suffix plus the cached end position; else clear and return all."""
        n = len(self.items)
        if n and len(messages) > n:
            for i, item in enumerate(self.items):
                m = messages[i]
                if item.role != m.get("role") or item.content != m.get("content"):
                    break
            else:
                return messages[n:], self.items[n - 1].end_pos
        self.items.clear()
        return messages, 0

    def push(self, messages: list[dict], end_pos: int) -> None:
        for m in messages:
            self.items.append(CachedMessage(m.get("role", ""), m.get("content", ""),
                                            end_pos))


def _request_stops(base: list[str], body: dict) -> list[str]:
    """Tokenizer stop pieces + the request's OpenAI ``stop`` strings."""
    req = body.get("stop")
    if isinstance(req, str):
        req = [req]
    if not isinstance(req, list):
        return base
    return base + [s for s in req if isinstance(s, str) and s]


class _EosGate:
    """EosDetector + text accumulation + delta emission."""

    def __init__(self, tok, stop_pieces, emit=None):
        # padding is in BYTES (the detector buffers UTF-8)
        max_stop = max((len(s.encode("utf-8")) for s in stop_pieces), default=0)
        self.detector = EosDetector(tok.eos_token_ids, stop_pieces, max_stop, max_stop)
        self.emit = emit
        self.parts: list[str] = []

    def _out(self, d: str | None) -> None:
        if d:
            self.parts.append(d)
            if self.emit:
                self.emit(d)

    def feed(self, token: int, piece: str | None) -> bool:
        """Process one decoded token; True when a stop sequence completed."""
        res = self.detector.append(token, piece)
        if res in (EosResult.NOT_EOS, EosResult.EOS):
            self._out(self.detector.get_delta())
            self.detector.reset()
        return res == EosResult.EOS

    def flush_tail(self) -> None:
        """Emit text still buffered as a MAYBE_EOS prefix when generation
        ends by length."""
        self._out(self.detector.get_delta())


def chat_template(tok, template_type: ChatTemplateType
                  ) -> tuple[ChatTemplateGenerator, list[str]]:
    """The tokenizer's chat template (or the forced family) and the stop
    pieces of its EOS tokens."""
    eos_piece = (tok.vocab[tok.eos_token_ids[0]].decode("utf-8", "replace")
                 if tok.eos_token_ids else "")
    template = ChatTemplateGenerator(tok.chat_template, eos=eos_piece, type=template_type)
    return template, [tok.vocab[t].decode("utf-8", "replace") for t in tok.eos_token_ids]


class ApiState:
    """The single-sequence server's state: the engine, its chat template and
    the message-prefix cache. The server runs one request at a time."""

    def __init__(self, engine, model_name: str = "dllama-tpu",
                 template_type: ChatTemplateType = ChatTemplateType.UNKNOWN,
                 request_timeout: float = 0.0):
        self.engine = engine
        self.model_name = model_name
        self.request_timeout = request_timeout  # server default (0 = none)
        self.template, self.stop_pieces = chat_template(engine.tokenizer, template_type)
        self.cache = NaiveCache()
        self._rid = 0  # request counter for trace spans (one request at a time)

    def readiness(self) -> tuple[bool, str, str]:
        """No queue or supervisor here, but a wedged dispatch still flips
        ``/readyz`` (the batch scheduler's contract)."""
        if self.engine.watchdog.stalled:
            return False, "step watchdog tripped (wedged device dispatch)", "crashed"
        return True, "ok", "ok"

    def complete(self, body: dict, emit=None, fleet=None,
                 tenant: str = tenancy.ANON) -> dict:
        """Run one chat completion; ``emit(text)`` streams deltas when set.
        ``fleet`` is the optional ``(fleet_request_id, hop)`` of
        :func:`fleet_identity`, bound to this request's local rid so its
        spans and lifecycle events join fleet-wide; ``tenant``
        (:func:`tenant_identity`) binds the same rid to its caller (the
        accounting registry is batched-scheduler work).

        The flow of ApiServer::complete (dllama-api.cpp:363-484): resolve the
        new messages against the cache (the engine resumes at the cached end
        position, or starts over), template + encode them, prefill in
        chunks, then decode on the engine with the EOS detector gating the
        emitted text. The deadline is checked between decode dispatches."""
        engine = self.engine
        tok = engine.tokenizer
        _validate_body(body)
        if body.get("resume_from"):
            # mid-stream resume admission is scheduler work; this server
            # never stamps resumable chunks, so a resume landing here is a
            # router or client bug — 400-shaped
            raise ValueError("stream resume requires batched serving (--batch-slots N)")
        # the retrace sentinel: a completion that ran end to end without a
        # capture or a new signature is this server's steady state
        led, scope = introspection.ledger(), engine.introspection_scope
        compiles_before = led.compile_count(scope)
        messages = body["messages"]
        timeout_s = float(body.get("timeout") or self.request_timeout or 0)
        deadline = time.monotonic() + timeout_s if timeout_s > 0 else 0.0
        self._rid += 1
        engine.trace_rid = self._rid  # stamps the engine's prefill span
        if fleet is not None:
            # one id from router to kernel: every span and lifecycle event
            # of this local rid now carries the fleet identity
            telemetry.tracer().bind_fleet(self._rid, fleet[0], fleet[1])
            flightrec.recorder().note("fleet_rid", rid=self._rid, reason=fleet[0],
                                      hop=fleet[1])
        telemetry.tracer().bind_tenant(self._rid, tenancy.registry().resolve(tenant))
        # TTFT attribution origin (queue = 0: no scheduler queue here)
        t_req0 = telemetry.now_ns()
        rt = telemetry.RequestTimer()
        if "temperature" in body:
            engine.sampler.set_temp(float(body["temperature"]))
        if "seed" in body:
            engine.sampler.set_seed(int(body["seed"]))
        if "top_p" in body:
            engine.sampler.topp = float(body["top_p"])
        max_tokens = int(body.get("max_tokens") or 0)

        delta, start_pos = self.cache.resolve_delta(messages)
        if start_pos == 0:
            engine.reset()
        else:
            engine.pos = start_pos
        items = [ChatItem(m.get("role", "user"), m.get("content", "")) for m in delta]
        prompt = self.template.generate(items, append_generation_prompt=True)
        ids = tok.encode(prompt.content, is_start=start_pos == 0, add_special_tokens=True)
        # the device-memory admission guard (the scheduler's submit-time
        # check): refuse before prefill, not through an out-of-memory error
        check_hbm_admission(engine, len(ids), engine.hbm_estimate["need_per_device"])
        prompt_end = min(start_pos + len(ids) - 1, engine.cfg.seq_len)
        max_pred = min(engine.cfg.seq_len,
                       prompt_end + max_tokens if max_tokens > 0 else engine.cfg.seq_len)
        self.cache.push(delta, prompt_end)

        stops = _request_stops(self.stop_pieces, body)
        custom_stops = len(stops) > len(self.stop_pieces)
        gate = _EosGate(tok, stops, emit)
        if prompt.public_prompt:
            gate._out(prompt.public_prompt)
        prefill_ms = 0.0
        if len(ids) > 1:
            _, pf_metrics = engine.prefill(ids[: prompt_end - start_pos])
            prefill_ms = sum(m.ms for m in pf_metrics)
        token = ids[prompt_end - start_pos] if prompt_end - start_pos < len(ids) else ids[-1]
        tok.reset_decoder()

        proposer = None
        n_drafted = n_spec_acc = 0
        if engine.spec_active:
            proposer = NgramProposer(engine.spec_lookup)
            proposer.extend(ids)
        n_completion = 0
        finish_reason = "length"
        t_decode = telemetry.now_ns()
        while engine.pos < max_pred:
            if deadline and time.monotonic() >= deadline:
                # the decode loop runs on the handler thread: cancelling is
                # stopping it
                telemetry.registry().counter(telemetry.REQUEST_TIMEOUTS).inc()
                if n_completion == 0:
                    raise RequestTimeoutError(f"no output within timeout ({timeout_s:g}s)")
                finish_reason = "timeout"
                break
            if proposer is not None and max_pred - engine.pos >= engine.spec_lookup + 1:
                run = engine.speculative_tokens(token, proposer.draft())
                n_drafted += engine.spec_lookup
                n_spec_acc += len(run) - 1
                n_keep, stopped = len(run), False
                for j, t in enumerate(run):
                    rt.token()
                    if gate.feed(t, tok.decode(t)):
                        n_keep, stopped = j + 1, True
                        break
                engine.commit_chunk(n_keep)
                n_completion += n_keep
                proposer.extend(run[:n_keep])
                token = run[n_keep - 1]
                if stopped:
                    finish_reason = "stop"
                    break
                continue
            token = engine.next_token(token)
            n_completion += 1
            rt.token()
            if gate.feed(token, tok.decode(token)):
                finish_reason = "stop"
                break
        if finish_reason in ("length", "timeout"):
            gate.flush_tail()
        rt.done(len(ids), n_completion)
        telemetry.tracer().emit(self._rid, "decode", t_decode, telemetry.now_ns(),
                                n_tokens=n_completion)
        # TTFT attribution of one sequence: admission = templating, encoding
        # and cache work, prefill = the chunks' measured wall (the phase
        # formula is flightrec.ttft_phases, shared with the batched path)
        timing = None
        if rt.first_ns is not None:
            bd = flightrec.ttft_phases(t_req0, t_req0, t_decode, rt.first_ns, prefill_ms)
            flightrec.record_ttft(telemetry.registry().histogram(telemetry.TTFT_ATTRIB_MS), bd)
            timing = {k: round(v, 3) for k, v in bd.items()}
            if fleet is not None:
                # the fleet-wide id and the hop that served this attempt
                timing["request_id"] = fleet[0]
                timing["hop"] = fleet[1]
            if n_drafted:
                timing["spec_drafted"] = n_drafted
                timing["spec_accepted"] = n_spec_acc
                timing["spec_accept_rate"] = round(n_spec_acc / n_drafted, 4)
        if not (custom_stops and finish_reason == "stop"):
            # a custom-stop finish leaves the hidden stop text and an
            # unterminated assistant turn in the cache: a continuation from
            # engine.pos would decode against malformed context, so the next
            # request re-prefills the assistant text from the prompt's end
            self.cache.push([{"role": "assistant", "content": "".join(gate.parts)}],
                            engine.pos)
        if led.compile_count(scope) == compiles_before:
            led.mark_steady(scope)
        # the canary piggybacks here (this server has no scheduler loop):
        # the handler thread owns every dispatch, so a replay between
        # completions never races a request's decode
        if engine.canary is not None:
            engine.canary.maybe_run()
        out = {"text": "".join(gate.parts), "finish_reason": finish_reason,
               "prompt_tokens": len(ids), "completion_tokens": n_completion}
        if body.get("timing") and timing is not None:
            out["timing"] = timing  # opt-in latency attribution block
        return out


class BatchedApiState:
    """The engine, its chat template and the batch scheduler, shared by
    the handler threads; on the paged pool also the ``--role`` tag and the
    prefix-residency advertisement the fleet router reads off ``/readyz``."""

    # how many prefix keys the residency advertisement remembers (a fleet's
    # worth of sticky sessions; /readyz bodies stay probe-sized)
    KV_PREFIX_MAX = 64
    # advertisement TTL (seconds): the pool evicts cached blocks on its own,
    # so an older advertisement is more likely stale than resident
    KV_PREFIX_TTL_S = 120.0

    def __init__(self, engine, n_slots: int, model_name: str = "dllama-tpu",
                 template_type: ChatTemplateType = ChatTemplateType.UNKNOWN,
                 max_queue: int = 0, request_timeout: float = 0.0,
                 role: str | None = None):
        self.engine = engine
        self.model_name = model_name
        self.request_timeout = request_timeout  # server default (0 = none)
        # disaggregation tag (--role prefill|decode, None = untagged):
        # advertised on /readyz, so the fleet router keeps prefill replicas
        # out of the decode dispatch pool
        self.role = role
        self.template, self.stop_pieces = chat_template(engine.tokenizer, template_type)
        self.sched = BatchScheduler(engine, n_slots, max_queue=max_queue)
        # affinity keys (serve/router.py affinity_key, the router's join) of
        # prompts whose KV the paged pool RECENTLY held: a bounded LRU with a
        # TTL (key -> monotonic stamp), written by handler threads, read by
        # the probe; advisory (a stale entry costs one 404 export probe)
        self._kv_prefixes: OrderedDict[str, float] = OrderedDict()
        self._kv_lock = threading.Lock()

    def readiness(self) -> tuple[bool, str, str]:
        return self.sched.readiness()

    def eval_resident(self) -> int:
        """Teacher-forced eval sequences queued or admitted right now."""
        return self.sched.eval_resident()

    def note_kv_prefix(self, key: str | None) -> None:
        """Record (most recent first, TTL-stamped) a prefix the pool holds
        now; a re-note refreshes the stamp."""
        if not key:
            return
        with self._kv_lock:
            self._kv_prefixes.pop(key, None)
            self._kv_prefixes[key] = time.monotonic()
            self._prune_kv_prefixes()

    def drop_kv_prefix(self, key: str | None) -> None:
        """Forget one advertisement early."""
        if not key:
            return
        with self._kv_lock:
            self._kv_prefixes.pop(key, None)

    def _prune_kv_prefixes(self) -> None:
        # the caller holds _kv_lock
        cutoff = time.monotonic() - self.KV_PREFIX_TTL_S
        for k in [k for k, ts in self._kv_prefixes.items() if ts < cutoff]:
            del self._kv_prefixes[k]
        while len(self._kv_prefixes) > self.KV_PREFIX_MAX:
            self._kv_prefixes.popitem(last=False)

    def kv_prefix_list(self) -> list[str]:
        """Most-recent-first snapshot for ``/readyz`` (expired entries
        pruned on read)."""
        with self._kv_lock:
            self._prune_kv_prefixes()
            return list(reversed(self._kv_prefixes))

    def begin_drain(self) -> None:
        self.sched.begin_drain()

    def close(self, drain_s: float = 0.0) -> None:
        self.sched.close(drain_s)

    def complete(self, body: dict, emit=None, fleet=None, kv_peer: str | None = None,
                 tenant: str = tenancy.ANON) -> dict:
        """Run one chat completion; ``emit(text, meta)`` streams deltas when
        set, ``meta`` being the chunk's resume stamp ``{"index": n,
        "tokens": [...]}``. ``fleet`` and ``tenant`` are the request's
        fleet identity and tenant label (see :meth:`ApiState.complete`);
        ``kv_peer`` (:func:`kv_peer`) the replica to pull the prompt's
        prefix KV from before admission.

        A body with ``resume_from`` is a router's mid-stream continuation:
        the dead replica's emitted tokens are prompt now (one ordinary
        admission: prefix match, chunked prefill), decode continues from
        there with the coin stream fast-forwarded by the same count
        (scheduler-side), ``max_tokens`` shrinks by what was delivered, and
        the stamps start at ``resume_from`` so nothing at or below it is
        emitted again."""
        tok = self.engine.tokenizer
        _validate_body(body)
        items = [ChatItem(m.get("role", "user"), m.get("content", ""))
                 for m in body["messages"]]
        prompt = self.template.generate(items, append_generation_prompt=True)
        ids = tok.encode(prompt.content, is_start=True, add_special_tokens=True)
        resume_from = int(body.get("resume_from") or 0)
        if resume_from:
            history = [int(t) for t in body["resume_tokens"]]
            # ids index the embedding on the device: one past the vocabulary
            # would fault the card, not just this request
            if max(history) >= self.engine.cfg.vocab_size:
                raise ValueError(f"resume_tokens must be token ids below the vocabulary "
                                 f"size {self.engine.cfg.vocab_size}")
            ids = ids + history
        max_tokens = int(body.get("max_tokens") or 0)
        if max_tokens <= 0:
            max_tokens = max(1, self.engine.cfg.seq_len - len(ids))
        else:
            # the client's bound covers the whole generation; resume_from of
            # it was already delivered by the dead replica
            max_tokens = max(1, max_tokens - resume_from)
        timeout_s = float(body.get("timeout") or self.request_timeout or 0)

        # SSE token stamping: each streamed chunk carries the cumulative
        # generated-token index and the ids emitted since the previous
        # chunk, so a fleet router can keep a resume record and splice a
        # failover continuation with exactly-once delivery
        n_fed = resume_from
        since: list[int] = []
        memit = None
        if emit is not None:
            def memit(d):
                emit(d, {"index": n_fed, "tokens": since.copy()})
                since.clear()

        sampler = self.engine.sampler  # CLI flags are the per-request defaults
        q: queue.Queue = queue.Queue()
        req = self.sched.submit(
            ids, max_tokens,
            temperature=float(body.get("temperature", sampler.temperature)),
            topp=float(body.get("top_p", sampler.topp)),
            seed=int(body.get("seed", 0xB1A5)),
            stop_on_eos=True,
            timeout_s=timeout_s if timeout_s > 0 else None,
            on_token=lambda t, p: q.put((t, p)),
            kv_peer=kv_peer, resume_from=resume_from, tenant=tenant)
        if fleet is not None:
            # bound after submit (the scheduler assigns the rid there): the
            # submit span predates the binding, every later span joins
            telemetry.tracer().bind_fleet(req.rid, fleet[0], fleet[1])
            flightrec.recorder().note("fleet_rid", rid=req.rid, reason=fleet[0],
                                      hop=fleet[1])
        gate = _EosGate(tok, _request_stops(self.stop_pieces, body), memit)
        if resume_from:
            # prime the gate with the history, emission suppressed (the
            # client holds those tokens), so the stop-string detector's
            # buffer and the UTF-8 carry-over match the dead replica's state
            # at the splice point
            gate.emit = None
            dec = copy.copy(tok)
            dec._pending = bytearray()
            for t in ids[len(ids) - resume_from:]:
                gate.feed(t, dec.decode(t))
            gate.emit = memit
        rt = telemetry.RequestTimer()
        n_completion = 0
        finish_reason = "length"
        try:
            # inside the try: the public-prompt echo is the first socket
            # write, so a peer that disconnected right after POSTing cancels
            # the slot here too (a resume never re-echoes: the client got
            # the echo from the first replica)
            if prompt.public_prompt and not resume_from:
                gate._out(prompt.public_prompt)
            while True:
                try:
                    t, piece = q.get(timeout=0.1)
                except queue.Empty:
                    if req.done.is_set() and q.empty():
                        break
                    continue
                n_completion += 1
                n_fed += 1
                since.append(t)
                rt.token()
                if gate.feed(t, piece):
                    # a stop STRING matched (ordinary tokens the scheduler's
                    # raw EOS check can't see): cancel the slot
                    finish_reason = "stop"
                    req.cancel.set()
                    break
        except (BrokenPipeError, ConnectionResetError) as e:
            req.cancel.set()
            raise ClientDisconnect(str(e)) from e
        # done is set on every path (retire, timeout, crash fail-all,
        # shutdown); the alive check guards against a loop thread that died
        # in a way supervision missed
        while not req.done.wait(timeout=5.0):
            if not self.sched.is_alive():
                raise SchedulerUnavailableError(
                    "scheduler stopped while the request was in flight")
        if req.timed_out and finish_reason == "length":
            if n_completion == 0:
                raise RequestTimeoutError(f"no output within timeout ({timeout_s:g}s)")
            finish_reason = "timeout"
        elif req.error:
            if req.server_error:  # crash/shutdown: 503 + retry, not a 400
                raise SchedulerUnavailableError(req.error)
            raise ValueError(req.error)
        if finish_reason in ("length", "timeout"):
            gate.flush_tail()
        rt.done(len(ids), n_completion)
        if self.engine.kv_block_size:
            # paged pool: the retired request's prefix blocks are parked in
            # the cached LRU, matchable — advertise the residency so a fleet
            # router can migrate the KV instead of recomputing it
            self.note_kv_prefix(affinity_key(body))
        out = {"text": "".join(gate.parts), "finish_reason": finish_reason,
               "prompt_tokens": len(ids), "completion_tokens": n_completion}
        bd = req.ttft_breakdown() if body.get("timing") else None
        if bd is not None:
            # opt-in latency attribution from the scheduler's stamps (the
            # histogram twins land in dllama_ttft_attrib_ms and
            # dllama_itl_attrib_ms at first token and at retire)
            timing = out["timing"] = {k: round(v, 3) for k, v in bd.items()}
            if fleet is not None:
                timing["request_id"] = fleet[0]
                timing["hop"] = fleet[1]
            timing["decode_step_ms"] = round(req.ms_decode_steps, 3)
            timing["preempt_ms"] = round(req.ms_preempt, 3)
            if req.ms_verify:
                timing["verify_ms"] = round(req.ms_verify, 3)
            if req.spec_drafted:
                timing["spec_drafted"] = req.spec_drafted
                timing["spec_accepted"] = req.spec_accepted
                timing["spec_accept_rate"] = round(req.spec_accepted / req.spec_drafted, 4)
        return out


def _completion_json(state: ApiState | BatchedApiState, out: dict) -> dict:
    resp = {
        "id": f"chatcmpl-{uuid.uuid4().hex[:12]}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": state.model_name,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant", "content": out["text"]},
            "finish_reason": out["finish_reason"],
        }],
        "usage": {
            "prompt_tokens": out["prompt_tokens"],
            "completion_tokens": out["completion_tokens"],
            "total_tokens": out["prompt_tokens"] + out["completion_tokens"],
        },
    }
    if "timing" in out:
        # the opt-in attribution block, non-streaming responses only (SSE
        # chunks stay OpenAI-shaped)
        resp["timing"] = out["timing"]
    return resp


def _chunk_json(state: ApiState | BatchedApiState, delta: dict, finish_reason=None) -> dict:
    return {
        "id": "chatcmpl-stream",
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": state.model_name,
        "choices": [{"index": 0, "delta": delta, "finish_reason": finish_reason}],
    }


_ROUTES = ("/v1/chat/completions", "/v1/kv/export", "/v1/models", "/metrics", "/health",
           "/healthz", "/readyz", "/debug", "/debug/compiles", "/debug/requests",
           "/debug/profile", "/debug/numerics", "/debug/flight", "/debug/timeline",
           "/debug/roofline", "/debug/eval", "/debug/tenants")

# the GET /debug index: one line per diagnostic route this server has
_DEBUG_INDEX = {
    "/debug/compiles": "GET: compile ledger — every kernel build, graph capture and "
                       "first run with program/scope/signature, seconds, the bytes and "
                       "operations K1-K5 move a dispatch, retrace-sentinel state",
    "/debug/profile": "POST ?ms=N[&ops=1]: live torch.profiler window over the "
                      "serving loop — Eval/Sync split, tp merge traffic, and (ops=1) "
                      "the per-op class attribution",
    "/debug/roofline": "GET: roofline observatory — per-program achieved bytes/"
                       "operations vs the card's ceilings, memory- vs compute-bound "
                       "classification",
    "/debug/requests": "GET: recent per-request phase timelines from the span ring "
                       "(queue/admit/prefill/prefill_chunk/decode/verify)",
    "/debug/flight": "GET: flight-recorder rings (per-tick scheduler decisions, "
                     "request lifecycle events) plus the span ring",
    "/debug/timeline": "GET: Perfetto-loadable Chrome trace of the flight rings "
                       "(save the body, open it in ui.perfetto.dev)",
    "/debug/numerics": "GET: numerics observatory — non-finite tripwire totals per "
                       "site, the last tapped forward's per-layer activation stats, "
                       "the canary's status",
    "/debug/eval": "GET: quality observatory — the most recent teacher-forced eval "
                   "run's summary (per-sequence NLL, total NLL hex, perplexity) or "
                   "its partial results",
    "/debug/tenants": "GET: tenant observatory — per-tenant cumulative usage (tokens, "
                      "sheds, latency quantiles, KV block-seconds), configured limits, "
                      "and the windowed fairness view (Jain index, shares)",
}


def make_handler(state: ApiState | BatchedApiState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # whole-socket timeout: a client that stalls mid-body or stops
        # reading an SSE stream is disconnected instead of pinning a thread
        timeout = 120

        def log_message(self, fmt, *args):
            print(f"🕸️ {self.address_string()} {fmt % args}")

        _counted = False  # whether THIS request hit the telemetry counter
        # the current POST's fleet trace id and sanitized tenant label,
        # echoed on every response (reset per request: keep-alive reuses
        # the handler instance)
        _fleet_rid: str | None = None
        _tenant: str | None = None

        def _echo_identity(self) -> None:
            if self._fleet_rid:
                self.send_header(FLEET_RID_HEADER, self._fleet_rid)
            if self._tenant is not None:
                self.send_header(TENANT_HEADER, self._tenant)

        def _route(self) -> str:
            return self.path.split("?", 1)[0]

        def _count(self, status: int | str) -> None:
            # status: an HTTP code, or "client_disconnect" for a vanished peer
            path = self._route()
            telemetry.registry().counter(telemetry.HTTP_REQUESTS).inc(
                route=path if path in _ROUTES else "other", status=str(status))
            self._counted = True

        def _json(self, code: int, payload: dict, headers: dict | None = None) -> None:
            self._count(code)
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self._echo_identity()
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _not_found(self) -> None:
            self._json(404, {"error": "not found", "path": self.path,
                             "routes": list(_ROUTES)})

        def do_GET(self):
            self._fleet_rid = None  # keep-alive: no stale POST echo
            self._tenant = None
            path = self._route()
            if path == "/v1/models":
                self._json(200, {"object": "list", "data": [{
                    "id": state.model_name, "object": "model",
                    "created": int(time.time()), "owned_by": "dllama_tpu",
                }]})
            elif path in ("/health", "/healthz"):
                self._json(200, {"status": "ok"})  # liveness: always 200
            elif path == "/readyz":
                ready, reason, code = state.readiness()
                rz = {"status": "ok" if ready else "unready", "reason": reason, "code": code}
                # disaggregation and migration advertisement (batched paged
                # replicas): the router's probe reads them off this body —
                # role keeps prefill replicas out of the decode pool,
                # kv_prefixes feeds the migration donor map
                if getattr(state, "role", None):
                    rz["role"] = state.role
                if isinstance(state, BatchedApiState) and state.engine.kv_block_size:
                    rz["kv_prefixes"] = state.kv_prefix_list()
                # eval sequences inflate the queue without producing tokens:
                # say why the depth is up
                ev = getattr(state, "eval_resident", None)
                n_eval = ev() if ev is not None else 0
                if n_eval:
                    rz["eval_resident"] = n_eval
                self._json(200 if ready else 503, rz,
                           headers=None if ready else backpressure_headers(503))
            elif path == "/metrics":
                self._count(200)
                body = telemetry.registry().render().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/debug":
                self._json(200, {"endpoints": dict(_DEBUG_INDEX)})
            elif path == "/debug/requests":
                self._json(200, {"requests": telemetry.tracer().recent_requests()})
            elif path in ("/debug/flight", "/debug/timeline"):
                data = flightrec.recorder().snapshot()
                data["spans"] = telemetry.tracer().raw_spans()
                self._json(200, data if path == "/debug/flight"
                           else flightrec.to_chrome_trace(data))
            elif path == "/debug/numerics":
                self._json(200, numerics.debug_snapshot(state.engine))
            elif path == "/debug/eval":
                last = evalharness.last_run()
                self._json(200, last if last is not None else {
                    "run": None,
                    "note": "no eval run in this process (python -m dllama_tpu_torch eval)"})
            elif path == "/debug/tenants":
                # cumulative per-tenant usage, limits, the fairness view
                self._json(200, tenancy.registry().snapshot())
            elif path == "/debug/roofline":
                # per-program achieved bandwidth/compute against the card's
                # ceilings: host reads of the ledger and the histograms
                self._json(200, roofline.snapshot())
            elif path == "/debug/compiles":
                self._json(200, introspection.ledger().snapshot())
            else:
                self._not_found()

        def _debug_profile(self) -> None:
            # POST /debug/profile?ms=N — hold a live profiler window over the
            # serving loop's steps and answer the Eval/Sync split, the tp
            # merges' traffic and, with ops=1, the per-op attribution
            from urllib.parse import parse_qs, urlsplit

            self._drain_small_body()
            try:
                qs = parse_qs(urlsplit(self.path).query)
                ms = int(qs.get("ms", [_PROFILE_MS_DEFAULT])[0])
                ops = int(qs.get("ops", ["0"])[0])
            except ValueError:
                self._json(400, {"error": "ms and ops must be integers"})
                return
            if not (10 <= ms <= _PROFILE_MS_MAX):
                self._json(400, {"error": f"ms must be in [10, {_PROFILE_MS_MAX}]"})
                return
            # batched serving: the session starts and stops on the
            # scheduler's loop thread, between ticks
            on_loop = state.sched.run_on_loop if isinstance(state, BatchedApiState) else None
            try:
                self._json(200, profiling.live_split_summary(
                    state.engine, ms / 1000.0, include_ops=bool(ops), on_loop=on_loop))
            except profiling.CaptureBusyError as e:
                self._json(409, {"error": str(e)})
            except SchedulerUnavailableError as e:
                self._json(503, {"error": str(e)}, headers=backpressure_headers(503))

        def _drain_small_body(self) -> None:
            # read a small body before answering (closing with unread bytes
            # can reset the connection before the client reads the answer);
            # an oversized declaration drops keep-alive instead
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                length = 0
            if 0 < length <= (1 << 20):
                try:
                    self.rfile.read(length)
                except OSError:
                    pass
            elif length:
                self.close_connection = True

        def _kv_export(self) -> None:
            # POST /v1/kv/export {"tokens": [...]} → the kvwire frame stream of
            # the paged-KV blocks covering the longest resident prefix of
            # tokens. 404 when nothing is resident (the importer treats any
            # failure as "recompute locally"); the stream has no
            # Content-Length, so the connection closes to delimit it
            if not (isinstance(state, BatchedApiState) and state.engine.kv_block_size):
                self._drain_small_body()
                self._json(404, {"error": "KV export needs batched paged serving "
                                          "(--batch-slots N with --kv-block-size)"})
                return
            if state.engine.tp > 1:
                self._drain_small_body()
                self._json(501, {"error": f"KV export at --tp {state.engine.tp} is not "
                                          f"ported to this package yet (the KV wire "
                                          f"carries unsharded blocks)"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError):
                self._json(400, {"error": "invalid JSON body"})
                return
            tokens = body.get("tokens") if isinstance(body, dict) else None
            if (not isinstance(tokens, list) or not tokens
                    or not all(isinstance(t, int) and not isinstance(t, bool)
                               for t in tokens)):
                self._json(400, {"error": "body must carry a non-empty integer token "
                                          "list in 'tokens'"})
                return
            sched = state.sched
            try:
                n_tokens, blocks = sched.request_kv_export(tokens)
            except SchedulerUnavailableError as e:
                self._json(503, {"error": str(e),
                                 "code": "draining" if "draining" in str(e) else "crashed"},
                           headers=backpressure_headers(503))
                return
            except Exception as e:  # noqa: BLE001 — export fails as JSON; the importer recomputes
                self._json(503, {"error": f"{type(e).__name__}: {e}", "code": "crashed"},
                           headers=backpressure_headers(503))
                return
            if not n_tokens:
                self._json(404, {"error": "prefix not resident"})
                return
            geometry = dict(sched.gen.wire_geometry(), n_blocks=len(blocks),
                            n_tokens=n_tokens)
            self._count(200)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Connection", "close")
            self.end_headers()
            try:
                kvwire.write_stream(self.wfile, geometry, blocks)
            except OSError:
                pass  # the importer vanished mid-stream: it recomputes
            self.close_connection = True

        def do_POST(self):
            if self._route() == "/debug/profile":
                self._fleet_rid = None  # keep-alive: no stale POST echo
                self._tenant = None
                self._debug_profile()
                return
            if self._route() == "/v1/kv/export":
                self._fleet_rid = None  # keep-alive: no stale POST echo
                self._tenant = None
                self._kv_export()
                return
            if self._route() != "/v1/chat/completions":
                self._drain_small_body()
                self._not_found()
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError):
                self._json(400, {"error": "invalid JSON body"})
                return
            if not isinstance(body, dict):
                self._json(400, {"error": "body must be a JSON object"})
                return
            fleet = fleet_identity(self.headers)
            self._fleet_rid = fleet[0] if fleet else None
            tenant = tenant_identity(self.headers)
            self._tenant = tenant
            # the migration hint is batched-paged work; the single-sequence
            # server has no scheduler to park a request in
            extra = ({"kv_peer": kv_peer(self.headers)}
                     if isinstance(state, BatchedApiState) else {})
            stream = bool(body.get("stream", False))
            inflight = telemetry.registry().gauge(telemetry.REQUESTS_IN_FLIGHT)
            inflight.add(1)
            # the finally counts what happened: a streamed answer does not go
            # through _json, and an unexpected failure must show too
            self._counted = False
            status: int | str = 500
            # SSE headers go out lazily at the FIRST delta, so failures before
            # any output still return a real status code on stream requests
            headers_sent = False

            def start_stream() -> None:
                nonlocal headers_sent
                if headers_sent:
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self._echo_identity()
                self.end_headers()
                headers_sent = True

            def write_event(payload) -> None:
                data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
                self.wfile.write(b"data: " + data + b"\n\n")

            def emit(text: str, meta: dict | None = None) -> None:
                failpoints.fire("emit")
                start_stream()
                chunk = _chunk_json(state, {"content": text})
                if meta is not None:
                    # resume stamping (batched serving): the cumulative
                    # token index and the ids this chunk covers — a fleet
                    # router's per-request resume record reads these
                    chunk["dllama"] = meta
                write_event(chunk)
                self.wfile.flush()

            def fail(code: int, payload: dict, reason: str, headers=None) -> None:
                nonlocal status
                status = code
                if not headers_sent:
                    self._json(code, payload, headers=headers)
                    return
                # headers already went out as 200: end the SSE stream with an
                # explicit finish_reason + [DONE]
                try:
                    write_event(_chunk_json(state, {}, reason))
                    write_event(b"[DONE]")
                except OSError:
                    pass
                self.close_connection = True

            try:
                if stream:
                    out = state.complete(body, emit=emit, fleet=fleet, tenant=tenant, **extra)
                    start_stream()  # zero-delta completion: headers now
                    write_event(_chunk_json(state, {}, out["finish_reason"]))
                    write_event(b"[DONE]")
                    status = 200
                else:
                    out = state.complete(body, fleet=fleet, tenant=tenant, **extra)
                    self._json(200, _completion_json(state, out))
            except QueueFullError as e:
                fail(429, {"error": str(e), "code": "queue_full"}, "error",
                     backpressure_headers(429))
            except (SchedulerUnavailableError, HbmAdmissionError) as e:
                # an admission-guard refusal is load, not damage: the code
                # says so (a router reclassifies instead of ejecting)
                fail(503, {"error": str(e),
                           "code": ("queue_full" if isinstance(e, HbmAdmissionError)
                                    else "draining" if "draining" in str(e) else "crashed")},
                     "error", backpressure_headers(503))
            except numerics.NumericsError as e:
                # fail-fast tripwire: non-finite decode-step logits — a 5xx
                # naming the site, never garbage tokens
                fail(500, {"error": str(e)}, "error")
            except RequestTimeoutError as e:
                fail(408, {"error": str(e)}, "timeout")
            except (ClientDisconnect, BrokenPipeError, ConnectionResetError):
                status = "client_disconnect"
                self.close_connection = True  # the peer hung up
            except ValueError as e:
                # mid-stream the wire status can no longer change: a 500
                fail(400 if not headers_sent else 500, {"error": str(e)}, "error")
            finally:
                inflight.add(-1)
                if not self._counted:
                    self._count(status)

    return Handler


def check_role(args) -> None:
    """``--role`` tags a disaggregated replica: refused outside batched
    paged serving, whose KV wire has blocks to export and import (the CLI
    checks it before any device is resolved)."""
    if args.role and ((args.batch_slots or 0) <= 1 or not args.kv_block_size):
        raise SystemExit("--role tags a disaggregated replica; it needs batched paged "
                         "serving (--batch-slots N with --kv-block-size) so the KV wire "
                         "has blocks to export and import")
    if args.role and (args.tp or 1) > 1:
        raise SystemExit(f"--role with --tp {args.tp} is not ported to this package yet "
                         f"(the KV wire carries unsharded blocks)")


def build_api_server(args) -> tuple[HTTPServer, ApiState | BatchedApiState]:
    """The engine, the API state and the bound (not yet serving) HTTP server
    for ``args`` (the CLI's ``api`` flags): the single-sequence server
    without ``--batch-slots``, else continuous batching on the dense slot
    pool, or on the paged block pool with ``--kv-block-size``."""
    from .cli import make_engine

    n_slots = args.batch_slots or 0
    if args.kv_block_size and n_slots <= 1:
        raise SystemExit("--kv-block-size is the paged BATCHED serving cache; it needs "
                         "--batch-slots N (N > 1) to serve through the "
                         "continuous-batching scheduler")
    if args.sp > 1 and not args.kv_block_size:  # the paged engine refuses --sp itself
        raise SystemExit("api --sp N is not ported to this package yet (the single-"
                         "sequence server and the dense slot pool run at sp = 1; use "
                         "python -m dllama_tpu api)")
    if not args.kv_block_size or args.role:
        if (args.tp or 1) > 1:
            raise SystemExit(f"api --tp {args.tp} needs --batch-slots N with "
                             f"--kv-block-size B in this package (the single-sequence "
                             f"server and the dense slot pool run at tp = 1; use python "
                             f"-m dllama_tpu api)")
        args.tp = 1  # the default tp stays 1 where tp > 1 is not ported
    ttype = ChatTemplateType(args.chat_template or "unknown")
    engine = make_engine(args)
    try:
        if args.canary_interval > 0:
            # the golden is recorded now, before any traffic; replays run on
            # the scheduler's tick or after single-sequence completions
            engine.canary = numerics.CanarySentinel(engine, interval_s=args.canary_interval)
            engine.canary.ensure_golden()
            print(f"🐤 canary sentinel: fixed-seed replay every {args.canary_interval:g}s "
                  f"(drift → dllama_canary_drift_total, the warning names the divergent "
                  f"layer" + (")" if engine.numerics_taps else " with --numerics-taps)"))
        if n_slots > 1:
            state: ApiState | BatchedApiState = BatchedApiState(
                engine, n_slots, template_type=ttype, max_queue=args.max_queue,
                request_timeout=args.request_timeout, role=args.role)
            server_cls = ThreadingHTTPServer
        else:
            # one request at a time: the engine holds one sequence
            state = ApiState(engine, template_type=ttype,
                             request_timeout=args.request_timeout)
            server_cls = HTTPServer
        try:
            server = server_cls((args.host, args.port), make_handler(state))
        except BaseException:
            if isinstance(state, BatchedApiState):
                state.close()
            raise
    except BaseException:
        engine.close()
        raise
    if isinstance(state, BatchedApiState):
        gen = state.sched.gen
        print(f"🕸️ continuous batching: {gen.n_slots} slots"
              + (f", queue bound {args.max_queue} (429 beyond)" if args.max_queue else ""))
        if engine.kv_block_size:
            print(f"🕸️ paged KV: {gen.pool.n_blocks - 1} blocks × {gen.pool.block_size} "
                  f"rows, {gen.pool_bytes / 1e9:.2f} GB (block-priced admission, "
                  f"block-level prefix sharing)")
            if gen.mirror is not None:
                print(f"🕸️ tiered KV memory: {gen.pool.n_host_blocks} host blocks "
                      f"({gen.mirror.kind}, {gen.mirror.host_bytes / 1e9:.2f}"
                      f" GB) — cold blocks spill under pressure, resumed sessions page "
                      f"back in (dllama_kv_spill/pagein_* metrics)")
            if engine.tp == 1:
                print("🕸️ KV migration: POST /v1/kv/export serves resident prefixes over "
                      "the checksummed Q80 wire"
                      + (f"; role={args.role} advertised on /readyz" if args.role else ""))
        else:
            print(f"🕸️ dense KV slot pool: {gen.n_slots} × {engine.cfg.seq_len} rows, "
                  f"{gen.pool_bytes / 1e9:.2f} GB (cross-slot prefix reuse)"
                  + (f", {engine.decode_chunk} steps per dispatch"
                     if engine.decode_chunk > 1 else ""))
        if engine.spec_lookup:
            print(f"🕸️ speculative serving: verify K={engine.spec_lookup} per slot "
                  + ("(greedy and temperature > 0 rows, exact-match verify)"
                     if engine.kv_block_size else "(greedy requests)"))
    if args.request_timeout:
        print(f"🕸️ per-request deadline: {args.request_timeout:g}s "
              f"(request 'timeout' field overrides)")
    return server, state


def run_api_server(args, on_listening=None) -> int:
    """Serve until SIGTERM (main thread only) or ``server.shutdown()``; then
    let batched serving's active slots finish for up to ``--drain-timeout``
    seconds and fail the rest. ``on_listening(server, state)``, when given,
    runs once the socket is bound (``server.server_address`` holds the real
    port under ``--port 0``) — for a caller that embeds the server in its
    process."""
    from .cli import start_stats_reporter

    if args.trace_out:
        telemetry.tracer().configure(args.trace_out)
        print(f"🔬 request trace (JSONL spans) → {args.trace_out}")
    # the tenant observatory: fair-share limits and the usage ledger
    # configure the process-wide registry before the scheduler builds, so
    # its FairQueue weights apply from the first request
    if args.tenant_limits:
        try:
            limits = tenancy.load_limits(args.tenant_limits)
        except ValueError as e:
            telemetry.tracer().configure(None)
            raise SystemExit(f"--tenant-limits: {e}") from None
        tenancy.registry().set_limits(limits)
        print(f"🕸️ tenant limits: {len(limits)} entr{'y' if len(limits) == 1 else 'ies'} "
              f"(weighted round-robin admission; over-budget → 429)")
    if args.usage_ledger:
        tenancy.ledger().configure(args.usage_ledger)
        print(f"📒 usage ledger (per-tenant cumulative JSONL) → {args.usage_ledger}")
    if failpoints.configure_from_env():
        print(f"💣 fault injection armed from DLLAMA_FAILPOINTS="
              f"{os.environ['DLLAMA_FAILPOINTS']}")
    try:
        server, state = build_api_server(args)
    except BaseException:
        telemetry.tracer().configure(None)
        raise
    stats = start_stats_reporter(args.stats) if args.stats else None

    def _on_sigterm(signum, frame):
        print("🛑 SIGTERM: draining (readyz → 503, no new admissions)", flush=True)
        if isinstance(state, BatchedApiState):
            state.begin_drain()
        # shutdown() from the serving thread itself would deadlock the poll
        threading.Thread(target=server.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        pass  # not the main thread (embedded use): no signal hook
    try:
        # the device-memory table: weights and KV against the graphs captured
        # so far (batched serving captures its step before it listens)
        introspection.hbm_startup_report(state.engine)
        host, port = server.server_address[:2]
        print(f"🕸️ listening on http://{host}:{port}", flush=True)
        if on_listening is not None:
            on_listening(server, state)
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if isinstance(state, BatchedApiState):
            state.close(drain_s=args.drain_timeout)
        state.engine.close()
        if stats is not None:
            stats.stop.set()
        telemetry.tracer().configure(None)
    return 0
