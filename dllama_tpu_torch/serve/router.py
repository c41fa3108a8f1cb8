"""Fleet router (the port of the JAX package's ``serve/router.py``) —
health-driven HTTP dispatch over N api-server replicas.

Host tier only: stdlib http/sockets/threads plus the port's host-side
runtime modules (``telemetry``, ``flightrec``, ``failpoints``, ``slo``,
``tenancy``). No model, no tokenizer, no device: the router process never
initialises CUDA and never imports ``serve/api.py`` (the few constants it
shares with the replicas are spelled here). It fronts any number of
``python -m dllama_tpu_torch api --batch-slots N`` replicas::

    python -m dllama_tpu_torch router --replica http://10.0.0.1:9990 \\
        --replica http://10.0.0.2:9990 --port 8080

Pieces, and the failure contract each one carries (``tests/test_router.py``
drives every path against stub replicas, ``tests/test_torch_router.py``
runs those behaviours on this module):

* **Health probes** — one daemon thread per replica polls the replica's
  ``GET /readyz`` (the machine-readable ``code`` field: draining / crashed
  / queue_full / loading) and ``GET /metrics`` (queue depth, in-flight,
  block occupancy) on a jittered interval.
* **Least-loaded dispatch with session affinity** — a request's affinity
  key (body ``session_id``/``user``, else a hash of the conversation's
  first message) sticks to its replica while that replica stays healthy;
  everything else goes to the lowest queue+in-flight score.
* **Per-replica circuit breaker** — consecutive connect/5xx failures eject
  the replica (``dllama_router_ejects_total``); probes keep hitting it on
  bounded exponential backoff, and the first half-open success re-admits
  it (``dllama_router_readmits_total``).
* **Per-request budgets** — a dispatch that fails before the first byte
  reaches the client is retried once on a different replica
  (``dllama_router_retries_total``); when every replica is saturated (or
  the router-level ``--max-queue`` in-flight bound is hit) the request is
  shed with 429 + ``Retry-After`` (``dllama_router_shed_total``).
* **Durable streams** — a stream that dies mid-flight (EOF without the
  ``[DONE]`` sentinel, a read error, or a replica-written terminal
  ``finish_reason: "error"`` chunk) is re-dispatched to a healthy replica
  as a token-exact spliced continuation when its chunks carried the
  batched replica's ``dllama`` index stamps: the router replays the full
  token history (body ``resume_from``/``resume_tokens`` + the
  ``X-Dllama-Resume-From`` header) and drops any replayed index, so
  delivery is exactly-once (``dllama_router_stream_resumes_total{outcome}``,
  ``dllama_router_stream_resume_ms``, the ``rt_resume`` span). Bounded by
  ``--max-stream-resumes`` (default 1) and the remaining
  ``--request-timeout`` budget; past either bound, and for unstamped
  streams always, the stream ends with an explicit terminal SSE error
  event naming the 502 plus ``[DONE]`` — never a silent hang.
* **KV migration hints** — a replica whose ``/readyz`` advertises the
  request's affinity key in ``kv_prefixes`` is named as the KV donor in an
  ``X-Dllama-KV-Peer`` header (``rt_kv_donor`` span), and ``prefill``-role
  replicas are kept out of the dispatch pool and warmed first, the
  decode replica then pulling the prefix over the KV wire (``rt_prefill``
  span); a warm-up is not a dispatch.
* **Drain awareness** — a replica whose ``/readyz`` goes 503 (draining)
  stops receiving new dispatches while its in-flight streams finish; the
  router's own SIGTERM does the same one level up.
* **Fleet trace identity** — every completion dispatch carries an
  ``X-Dllama-Request-Id`` (client-supplied when sanitary, else minted
  here) plus an ``X-Dllama-Hop`` attempt index; the router keeps its own
  span ring (:class:`RouterSpanRing`, phases = ``telemetry.ROUTER_PHASES``)
  so ``GET /debug/fleet/timeline`` and the offline ``python -m
  dllama_tpu_torch fleettrace`` joiner render one Chrome-trace flow per
  request across the router and every replica it touched
  (``runtime/flightrec.fleet_chrome_trace``).
* **Tenancy** — the ``X-Dllama-Tenant`` identity is sanitized at the edge
  and forwarded on every upstream dispatch (first hops, retries, stream
  continuations); ``GET /debug/fleet/tenants`` sums the replicas'
  ``/debug/tenants`` views.
* **SLO observatory** — ``--slo "ttft_p95_ms=500,itl_p50_ms=40,
  shed_rate=0.01"`` (or a JSON file) evaluates declarative objectives
  over router-measured streaming histograms with burn-rate windows
  (``runtime/slo``): ``GET /debug/slo``, the ``dllama_slo_compliance`` /
  ``dllama_slo_burn_rate`` gauges, and an SLO fragment on the ``--stats``
  line.

Thread model: one probe thread per replica owns that replica's health
transitions; HTTP handler threads dispatch/relay and only touch shared
state under the per-replica or router lock.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import random
import re
import threading
import time
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlsplit

from ..runtime import failpoints, flightrec, slo, telemetry, tenancy

# the replicas' readiness vocabulary and Retry-After policy (serve/api.py
# READY_CODES, RETRY_AFTER_S, backpressure_headers), spelled here so the
# router never imports the api module and its engine
READY_CODES = ("ok", "draining", "crashed", "queue_full", "loading")
RETRY_AFTER_S = {429: 1, 503: 5}
RETRY_AFTER_JITTER_S = {429: 1, 503: 3}


def backpressure_headers(status: int) -> dict:
    """The shared Retry-After header block for a 429/503 answer, with
    bounded random jitter (base..base+jitter seconds)."""
    return {"Retry-After": str(RETRY_AFTER_S[status]
                               + random.randint(
                                   0, RETRY_AFTER_JITTER_S[status]))}


# known routes for the HTTP request counter's route label (the router's
# twin of serve/api.py _ROUTES; anything else folds into "other")
_ROUTES = ("/v1/chat/completions", "/v1/models", "/metrics",
           "/health", "/healthz", "/readyz", "/debug/fleet",
           "/debug/fleet/timeline", "/debug/fleet/tenants",
           "/debug/slo")

# fleet trace identity headers — canonical parse side in serve/api.py
# (FLEET_RID_HEADER / FLEET_HOP_HEADER / FLEET_RID_RE there); spelled
# here too so this module's import graph stays engine-free. The id
# charset is closed because the value travels verbatim into response
# headers, dumps, and logs on every tier.
FLEET_RID_HEADER = "X-Dllama-Request-Id"
FLEET_HOP_HEADER = "X-Dllama-Hop"
# KV migration hint stamped on first-hop dispatches: "host:port" of a
# peer replica whose paged pool holds the prompt's prefix (the replica
# pulls it over the kvwire stream instead of recomputing). Re-spelled
# from serve/api.py for the same engine-free-import reason as above.
KV_PEER_HEADER = "X-Dllama-KV-Peer"
# Mid-stream failover: a spliced continuation names the count of tokens
# the client already holds; the replica admits the request with the full
# token history (body "resume_from"/"resume_tokens") and emits nothing
# at or below that index. Re-spelled from serve/api.py, same reason.
RESUME_FROM_HEADER = "X-Dllama-Resume-From"
# Tenant identity: sanitized at the edge (runtime/tenancy — absent or
# malformed collapses to "anon"), echoed on every router-authored
# answer, and forwarded on EVERY upstream dispatch — first hops, retry
# hops, spliced stream continuations, and prefill warm-ups alike — so a
# replica never misattributes router-originated work to "anon".
# Re-spelled from serve/api.py, same engine-free-import reason.
TENANT_HEADER = "X-Dllama-Tenant"
# Closed outcome vocabulary of dllama_router_stream_resumes_total (the
# failure-taxonomy dlint rule holds it to telemetry's label docs and
# PERF.md): resumed — continuation spliced, the client's transcript
# continued token-exactly; exhausted — another death after
# --max-stream-resumes continuations; no_budget — no remaining
# --request-timeout budget to resume into; failed — the re-dispatch
# itself found no healthy replica or died before the splice.
RESUME_OUTCOMES = ("resumed", "exhausted", "no_budget", "failed")
_RID_SAFE_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

# upstream response headers relayed verbatim; everything hop-by-hop or
# regenerated by our own http.server (Date, Server) is dropped
_RELAY_HEADERS = ("Content-Type", "Content-Length", "Retry-After",
                  "Cache-Control")

# consecutive connect/5xx failures before the breaker ejects a replica
EJECT_AFTER = 3
# half-open probe backoff while ejected: bounded exponential
BACKOFF_MIN_S = 0.5
BACKOFF_MAX_S = 30.0

# the replica-state vocabulary /debug/fleet and the probes speak:
# loading (never successfully probed), up (dispatchable), unready
# (replica /readyz said no — its `code` says why), down (breaker-ejected)
STATES = ("loading", "up", "unready", "down")


def affinity_key(body: dict) -> str | None:
    """The session-stickiness key: an explicit ``session_id``/``user``
    field when the client sent one, else a hash of the conversation's
    FIRST message (role + content head) — the stable prefix of a
    multi-turn conversation, which is exactly what the replica-side
    NaiveCache / paged block sharing can reuse."""
    sid = body.get("session_id") or body.get("user")
    if isinstance(sid, str) and sid:
        return "sid:" + sid
    msgs = body.get("messages")
    if isinstance(msgs, list) and msgs and isinstance(msgs[0], dict):
        m = msgs[0]
        head = f"{m.get('role')}\x00{str(m.get('content'))[:256]}"
        return "pfx:" + hashlib.sha1(
            head.encode("utf-8", "replace")).hexdigest()
    return None


class Replica:
    """One upstream api-server: probe-observed health + load, the
    circuit breaker, and the router-side in-flight count.

    Ownership: the replica's probe thread drives state transitions from
    probe results; handler threads record dispatch outcomes and read
    dispatchability — every mutation of the shared fields holds
    ``_lock`` (dlint lock-guard enforces the declarations below)."""

    def __init__(self, url: str, *, eject_after: int = EJECT_AFTER,
                 backoff_min_s: float = BACKOFF_MIN_S,
                 backoff_max_s: float = BACKOFF_MAX_S,
                 connect_timeout_s: float = 2.0,
                 read_timeout_s: float = 120.0):
        u = urlsplit(url if "//" in url else f"http://{url}")
        if u.scheme not in ("", "http") or not u.hostname or not u.port:
            raise ValueError(f"replica URL must be http://host:port, "
                             f"got {url!r}")
        self.name = f"{u.hostname}:{u.port}"
        self.host, self.port = u.hostname, u.port
        self.eject_after = eject_after
        self.backoff_min_s = backoff_min_s
        self.backoff_max_s = backoff_max_s
        self.connect_timeout_s = connect_timeout_s
        self.read_timeout_s = read_timeout_s
        self._lock = threading.Lock()
        self.state = "loading"         # dlint: guarded-by=_lock
        self.unready_code = "loading"  # dlint: guarded-by=_lock
        self.queue_depth = 0.0         # dlint: guarded-by=_lock
        self.engine_inflight = 0.0     # dlint: guarded-by=_lock
        self.block_occupancy = 0.0     # dlint: guarded-by=_lock
        self.inflight = 0              # dlint: guarded-by=_lock
        self.consecutive_failures = 0  # dlint: guarded-by=_lock
        self.ejected_until = 0.0       # dlint: guarded-by=_lock
        self.backoff_s = backoff_min_s  # dlint: guarded-by=_lock
        self.last_probe_t = 0.0        # dlint: guarded-by=_lock
        # disaggregation/migration advertisement off the last /readyz
        # body: the replica's --role tag and its resident-prefix keys
        self.role = None               # dlint: guarded-by=_lock
        self.kv_prefixes: list = []    # dlint: guarded-by=_lock
        # invoked OUTSIDE the lock when the breaker ejects this replica
        # (the FleetRouter hangs its sticky-affinity purge here)
        self.on_eject = None
        reg = telemetry.registry()
        self._g_up = reg.gauge(telemetry.ROUTER_REPLICA_UP)
        self._g_inflight = reg.gauge(telemetry.ROUTER_INFLIGHT)
        self._c_ejects = reg.counter(telemetry.ROUTER_EJECTS)
        self._c_readmits = reg.counter(telemetry.ROUTER_READMITS)
        self._g_up.set(0, replica=self.name)
        self._g_inflight.set(0, replica=self.name)

    # -- dispatch-side reads/writes (handler threads) ------------------------

    def dispatchable(self) -> bool:  # dlint: owner=any
        with self._lock:
            return self.state == "up"

    def load_score(self) -> float:  # dlint: owner=any
        """Least-loaded ranking: the replica's own reported queue +
        in-flight plus the router-side in-flight count (which covers
        dispatches newer than the last probe)."""
        with self._lock:
            return self.queue_depth + self.engine_inflight + self.inflight

    def begin_request(self) -> None:  # dlint: owner=any
        with self._lock:
            self.inflight += 1
            n = self.inflight
        self._g_inflight.set(n, replica=self.name)

    def end_request(self) -> None:  # dlint: owner=any
        with self._lock:
            self.inflight -= 1
            n = self.inflight
        self._g_inflight.set(n, replica=self.name)

    def note_unready(self, code: str) -> None:  # dlint: owner=any
        """An explicit unready answer observed on the DISPATCH path (a
        503 whose body code says draining/queue_full): classify the
        replica the way the probe would — alive but not dispatchable —
        WITHOUT feeding the breaker. A draining pod must never be
        ejected into the crash-backoff schedule."""
        with self._lock:
            if self.state != "down":
                self.state = "unready"
                self.unready_code = code
            self.consecutive_failures = 0
        self._g_up.set(0, replica=self.name)

    def note_failure(self) -> None:  # dlint: owner=any
        """One connect/5xx failure toward the breaker threshold; at
        ``eject_after`` consecutive ones the replica is ejected and the
        half-open backoff schedule starts."""
        ejected = False
        with self._lock:
            self.consecutive_failures += 1
            if self.state != "down" \
                    and self.consecutive_failures >= self.eject_after:
                self.state = "down"
                self.unready_code = "crashed"
                self.backoff_s = self.backoff_min_s
                self.ejected_until = time.monotonic() + self.backoff_s
                ejected = True
        if ejected:
            self._g_up.set(0, replica=self.name)
            self._c_ejects.inc(replica=self.name)
            if self.on_eject is not None:
                self.on_eject(self)

    def is_prefill(self) -> bool:  # dlint: owner=any
        with self._lock:
            return self.role == "prefill"

    def holds_prefix(self, key: str) -> bool:  # dlint: owner=any
        """Whether this replica's last probe advertised ``key`` as a
        resident paged-KV prefix. Advisory by construction: the pool
        evicts independently of the probe cadence, so a stale True costs
        one export round trip that answers \"not resident\"."""
        with self._lock:
            return self.state != "down" and key in self.kv_prefixes

    def purge_kv_prefixes(self) -> None:  # dlint: owner=any
        """Breaker-eject hygiene: a down replica must stop being a
        KV-donor candidate NOW, not one stale ``holds_prefix`` miss per
        dispatch until its next probe refresh (``holds_prefix`` already
        refuses ``down`` replicas — this keeps /debug/fleet and any
        direct reader honest too)."""
        with self._lock:
            self.kv_prefixes = []

    def note_success(self, *, from_probe: bool = False) -> None:  # dlint: owner=any
        """A successful probe or dispatch: failures reset; an ejected
        replica is re-admitted (the half-open probe succeeded). Only a
        PROBE may promote a probe-classified ``unready`` replica back
        to ``up`` — a late response arriving after the replica started
        draining must not pull new sessions onto it; dispatches promote
        only from ``loading``/``down``."""
        with self._lock:
            self.consecutive_failures = 0
            promote = from_probe or self.state in ("loading", "down")
            readmitted = promote and self.state == "down"
            if promote and self.state != "up":
                self.state = "up"
                self.unready_code = "ok"
                self.backoff_s = self.backoff_min_s
            is_up = self.state == "up"
        if is_up:
            self._g_up.set(1, replica=self.name)
        if readmitted:
            self._c_readmits.inc(replica=self.name)

    # -- probe side (this replica's probe thread) ----------------------------

    def probe_due(self, interval_s: float) -> float:  # dlint: owner=probe-thread
        """Seconds until the next probe: the jittered interval while
        healthy, the breaker's current backoff while ejected (the
        half-open schedule)."""
        with self._lock:
            if self.state == "down":
                return max(0.0, self.ejected_until - time.monotonic())
        return interval_s * random.uniform(0.8, 1.2)

    def probe_once(self) -> None:  # dlint: owner=probe-thread
        """One /readyz + /metrics round trip; classifies the replica and
        refreshes its load snapshot. Runs on this replica's probe thread
        only — the transitions ride the same breaker accounting the
        dispatch path uses."""
        with self._lock:
            self.last_probe_t = time.monotonic()
        try:
            status, body = self._get("/readyz")
        except OSError:
            half_open_failed = False
            with self._lock:
                if self.state == "down":
                    # half-open probe failed: double the backoff, bounded
                    self.backoff_s = min(self.backoff_s * 2,
                                         self.backoff_max_s)
                    self.ejected_until = time.monotonic() + self.backoff_s
                    half_open_failed = True
            if not half_open_failed:
                self.note_failure()
            return
        # the disaggregation/migration advertisement rides the same body
        # on BOTH answers (a draining replica still holds its blocks);
        # the vocabulary is closed — role outside {prefill, decode} and
        # non-string prefixes are dropped, never stored
        role, prefixes = None, []
        try:
            rz = json.loads(body)
            if rz.get("role") in ("prefill", "decode"):
                role = rz["role"]
            pf = rz.get("kv_prefixes")
            if isinstance(pf, list):
                prefixes = [p for p in pf if isinstance(p, str)][:64]
        except (ValueError, AttributeError):
            pass
        with self._lock:
            self.role = role
            self.kv_prefixes = prefixes
        if status == 200:
            self.note_success(from_probe=True)
        else:
            # READY_CODES is the closed vocabulary (serve/api.py); an
            # unknown/missing code degrades to "crashed" rather than
            # leaking arbitrary strings into /debug/fleet and dispatch
            code = "crashed"
            try:
                got = json.loads(body).get("code")
                if got in READY_CODES:
                    code = got
            except (ValueError, AttributeError):
                pass
            with self._lock:
                # an explicit unready answer is drain/overload signal,
                # not a breaker failure: the replica is alive and will
                # come back on its own (draining pods must not be
                # ejected into a backoff schedule) — and an ejected
                # replica that ANSWERS again is connect-level alive, so
                # it leaves "down" for "unready" rather than busy-
                # probing a zeroed backoff
                self.state = "unready"
                self.unready_code = code
                self.consecutive_failures = 0
            self._g_up.set(0, replica=self.name)
        try:
            _, mtext = self._get("/metrics")
            load = _parse_replica_metrics(mtext)
            with self._lock:
                self.queue_depth = load.get("queue_depth", 0.0)
                self.engine_inflight = load.get("inflight", 0.0)
                self.block_occupancy = load.get("block_occupancy", 0.0)
        except OSError:
            pass  # readyz already classified health; stale load is fine

    def _get(self, path: str) -> tuple[int, str]:  # dlint: owner=probe-thread
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.connect_timeout_s)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, resp.read().decode("utf-8", "replace")
        finally:
            conn.close()

    def snapshot(self) -> dict:  # dlint: owner=any
        with self._lock:
            return {
                "replica": self.name,
                "state": self.state,
                "code": self.unready_code if self.state != "up" else "ok",
                "queue_depth": self.queue_depth,
                "engine_inflight": self.engine_inflight,
                "block_occupancy": self.block_occupancy,
                "router_inflight": self.inflight,
                "role": self.role,
                "kv_prefixes": list(self.kv_prefixes),
                "consecutive_failures": self.consecutive_failures,
                "backoff_s": self.backoff_s if self.state == "down" else 0.0,
                "last_probe_s_ago": (round(time.monotonic()
                                           - self.last_probe_t, 3)
                                     if self.last_probe_t else None),
            }


def _parse_replica_metrics(text: str) -> dict:
    """Pull the load gauges the dispatcher ranks on out of a replica's
    Prometheus text exposition (no client library — repo idiom)."""
    want = {"dllama_queue_depth": "queue_depth",
            "dllama_requests_in_flight": "inflight",
            "dllama_kv_blocks_used": "_blocks_used",
            "dllama_kv_blocks_total": "_blocks_total"}
    out: dict = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        name, _, rest = line.partition(" ")
        name = name.partition("{")[0]
        key = want.get(name)
        if key is None:
            continue
        try:
            out[key] = float(rest.strip())
        except ValueError:
            continue
    total = out.pop("_blocks_total", 0.0)
    used = out.pop("_blocks_used", 0.0)
    if total:
        out["block_occupancy"] = used / total
    return out


class RouterSpanRing:
    """Bounded ring of router-side request spans — the fleet tier's
    twin of ``telemetry.SpanTracer``. Records carry the STRING fleet
    request id (the ``X-Dllama-Request-Id`` value) plus dispatch
    context (``replica``, ``hop``); phases come from
    ``telemetry.ROUTER_PHASES`` and are closed-world-checked by the
    span-phases dlint rule exactly like the engine span vocabulary.
    Served raw as ``/debug/fleet``'s ``spans`` key — which is also the
    offline joiner's ``--router-dump`` input — and joined with replica
    flight dumps by ``flightrec.fleet_chrome_trace``."""

    RING = 2048

    def __init__(self):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.RING)  # dlint: guarded-by=_lock

    def emit_span(self, request_id: str, phase: str, start_ns: int,
                  end_ns: int, *, replica: str = "", hop: int = -1,
                  **extra) -> None:  # dlint: owner=any
        """One completed router-side span; ``start_ns == end_ns`` marks
        an instant event (dispatch decisions, eject markers)."""
        rec = {"request_id": str(request_id), "phase": phase,
               "start_ns": int(start_ns), "end_ns": int(end_ns)}
        if replica:
            rec["replica"] = replica
        if hop >= 0:
            rec["hop"] = hop
        rec.update(extra)
        with self._lock:
            self._ring.append(rec)

    def raw_spans(self) -> list[dict]:  # dlint: owner=any
        with self._lock:
            return [dict(s) for s in self._ring]


class FleetRouter:
    """Replica set + probe threads + dispatch policy — the state behind
    :func:`make_router_handler`."""

    AFFINITY_MAX = 4096  # bounded sticky map (LRU)

    def __init__(self, replica_urls: list[str], *,
                 probe_interval_s: float = 2.0, max_inflight: int = 0,
                 eject_after: int = EJECT_AFTER,
                 backoff_min_s: float = BACKOFF_MIN_S,
                 backoff_max_s: float = BACKOFF_MAX_S,
                 connect_timeout_s: float = 2.0,
                 read_timeout_s: float = 120.0,
                 max_stream_resumes: int = 1,
                 request_timeout_s: float = 0.0,
                 start_probes: bool = True,
                 slo_objectives: dict[str, float] | None = None):
        if not replica_urls:
            raise ValueError("at least one --replica URL is required")
        self.replicas = [Replica(u, eject_after=eject_after,
                                 backoff_min_s=backoff_min_s,
                                 backoff_max_s=backoff_max_s,
                                 connect_timeout_s=connect_timeout_s,
                                 read_timeout_s=read_timeout_s)
                         for u in replica_urls]
        if len({r.name for r in self.replicas}) != len(self.replicas):
            raise ValueError("duplicate --replica URLs")
        for r in self.replicas:
            # affinity hygiene: a breaker eject drops the replica's
            # sticky entries immediately (not one dispatchable() miss
            # per returning session at a time)
            r.on_eject = self._on_replica_eject
        self.probe_interval_s = probe_interval_s
        self.max_inflight = max_inflight
        self.read_timeout_s = read_timeout_s
        # mid-stream failover budget: how many spliced continuations one
        # stream may consume (--max-stream-resumes; the N+1th death is
        # terminal) and the wall deadline resumes must fit inside
        # (--request-timeout; 0 = unbounded — a client body "timeout"
        # still bounds its own request)
        self.max_stream_resumes = max_stream_resumes
        self.request_timeout_s = request_timeout_s
        self._lock = threading.Lock()
        self._affinity: OrderedDict = OrderedDict()  # dlint: guarded-by=_lock
        self._inflight_total = 0                     # dlint: guarded-by=_lock
        self._draining = False                       # dlint: guarded-by=_lock
        self._rid_seq = 0                            # dlint: guarded-by=_lock
        # boot-unique prefix: two router incarnations never mint the
        # same id, so joined dumps across a restart stay unambiguous
        self._rid_boot = f"{random.getrandbits(32):08x}"
        self._stop = threading.Event()
        self.spans = RouterSpanRing()
        self.slo = (slo.SloEngine(slo_objectives)
                    if slo_objectives else None)
        reg = telemetry.registry()
        self.c_dispatch = reg.counter(telemetry.ROUTER_DISPATCHES)
        self.c_retries = reg.counter(telemetry.ROUTER_RETRIES)
        self.c_shed = reg.counter(telemetry.ROUTER_SHED)
        self.c_affinity = reg.counter(telemetry.ROUTER_AFFINITY_HITS)
        self.c_affinity_purged = reg.counter(
            telemetry.ROUTER_AFFINITY_PURGED)
        self.c_retry_hops = reg.counter(telemetry.ROUTER_RETRY_HOPS)
        self.h_ttft = reg.histogram(telemetry.ROUTER_TTFT_MS)
        self.h_connect = reg.histogram(telemetry.ROUTER_CONNECT_MS)
        self.h_retry = reg.histogram(telemetry.ROUTER_RETRY_MS)
        self.c_resumes = reg.counter(telemetry.ROUTER_STREAM_RESUMES)
        self.h_resume = reg.histogram(telemetry.ROUTER_STREAM_RESUME_MS)
        self._threads: list[threading.Thread] = []
        if start_probes:
            self.start()

    def mint_rid(self, client_rid: str | None) -> str:  # dlint: owner=any
        """The fleet request id for one completion: a client-supplied
        ``X-Dllama-Request-Id`` is honored when it matches the sanitary
        charset (``[A-Za-z0-9._-]{1,64}`` — the value travels verbatim
        into headers, dumps, and logs on every tier), anything else is
        replaced by a freshly minted boot-unique id."""
        if isinstance(client_rid, str) and _RID_SAFE_RE.match(client_rid):
            return client_rid
        with self._lock:
            self._rid_seq += 1
            n = self._rid_seq
        return f"r{self._rid_boot}-{n:x}"

    def start(self) -> None:  # dlint: owner=any
        for rep in self.replicas:
            t = threading.Thread(target=self._probe_loop, args=(rep,),
                                 daemon=True,
                                 name=f"dllama-probe-{rep.name}")
            t.start()
            self._threads.append(t)

    def close(self) -> None:  # dlint: owner=any
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)

    def begin_drain(self) -> None:  # dlint: owner=any
        """Flip the router's own /readyz (a load balancer above stops
        routing) while accepted work keeps relaying — the same two-phase
        drain the replicas implement."""
        with self._lock:
            self._draining = True

    def is_draining(self) -> bool:  # dlint: owner=any
        with self._lock:
            return self._draining

    def _probe_loop(self, rep: Replica) -> None:  # dlint: owner=probe-thread
        # first probe immediately (a router must converge fast at start),
        # then the jittered interval / half-open backoff schedule
        while not self._stop.is_set():
            rep.probe_once()
            if self._stop.wait(rep.probe_due(self.probe_interval_s)):
                return

    # -- dispatch policy -----------------------------------------------------

    def _on_replica_eject(self, rep: Replica) -> None:  # dlint: owner=any
        """Breaker eject → sticky-map hygiene: purge every affinity
        entry pointing at the ejected replica so returning sessions
        re-pick (and possibly KV-migrate) immediately instead of riding
        a dead pointer through a dispatchable() miss each."""
        rep.purge_kv_prefixes()
        with self._lock:
            stale = [k for k, v in self._affinity.items() if v is rep]
            for k in stale:
                del self._affinity[k]
        if stale:
            self.c_affinity_purged.inc(len(stale), replica=rep.name)

    def prefill_replicas(self) -> list:  # dlint: owner=any
        """Dispatchable prefill-role replicas (disaggregation donors)."""
        return [r for r in self.replicas
                if r.dispatchable() and r.is_prefill()]

    def kv_donor(self, key: str | None,
                 chosen: Replica) -> Replica | None:  # dlint: owner=any
        """The migration source for a fleet-global prefix hit: a replica
        (≠ ``chosen``) whose last probe advertised ``key`` as resident.
        Advisory — a stale advertisement costs one export probe that
        answers \"not resident\", after which the destination recomputes."""
        if key is None:
            return None
        for rep in self.replicas:
            if rep is not chosen and rep.holds_prefix(key):
                return rep
        return None

    def pick(self, key: str | None,
             exclude: set | None = None) -> Replica | None:  # dlint: owner=any
        """The dispatch decision: sticky replica while it stays healthy
        (and isn't excluded by a retry), else least-loaded; updates the
        sticky map so the session returns here next time. Prefill-role
        replicas serve warm-up work only, so they are excluded — unless
        they are ALL that remains, in which case availability beats
        disaggregation purity."""
        exclude = exclude or set()
        if key is not None:
            with self._lock:
                sticky = self._affinity.get(key)
                if sticky is not None:
                    self._affinity.move_to_end(key)
            if sticky is not None and sticky not in exclude \
                    and sticky.dispatchable() and not sticky.is_prefill():
                self.c_affinity.inc()
                return sticky
        live = [r for r in self.replicas
                if r not in exclude and r.dispatchable()]
        if not live:
            return None
        decode = [r for r in live if not r.is_prefill()]
        chosen = min(decode or live, key=lambda r: r.load_score())
        if key is not None:
            with self._lock:
                self._affinity[key] = chosen
                self._affinity.move_to_end(key)
                while len(self._affinity) > self.AFFINITY_MAX:
                    self._affinity.popitem(last=False)
        return chosen

    def unready_reason(self) -> tuple[str, str]:  # dlint: owner=any
        """(human reason, machine code) when no replica is dispatchable
        — the router-level /readyz body and the no-replica error path
        share this one classification."""
        with self._lock:
            if self._draining:
                return "router is draining", "draining"
        snaps = [r.snapshot() for r in self.replicas]
        codes = {s["code"] for s in snaps}
        if codes <= {"loading"}:
            return "no replica probed ready yet", "loading"
        if codes <= {"queue_full", "draining", "loading"} \
                and "queue_full" in codes:
            return "every replica is saturated (queue_full)", "queue_full"
        if codes <= {"draining", "loading"}:
            return "every replica is draining", "draining"
        return "no healthy replica (all ejected or unready)", "crashed"

    def readiness(self) -> tuple[bool, str, str]:  # dlint: owner=any
        with self._lock:
            if self._draining:
                return False, "router is draining", "draining"
        if any(r.dispatchable() for r in self.replicas):
            return True, "ok", "ok"
        reason, code = self.unready_reason()
        return False, reason, code

    def admit(self) -> bool:  # dlint: owner=any
        """Router-level in-flight bound (--max-queue): False = shed."""
        with self._lock:
            if self._draining:
                return False
            if self.max_inflight and \
                    self._inflight_total >= self.max_inflight:
                return False
            self._inflight_total += 1
        return True

    def release(self) -> None:  # dlint: owner=any
        with self._lock:
            self._inflight_total -= 1

    def fleet_snapshot(self) -> dict:  # dlint: owner=any
        with self._lock:
            n_aff = len(self._affinity)
            inflight = self._inflight_total
            draining = self._draining
        return {"replicas": [r.snapshot() for r in self.replicas],
                "inflight_total": inflight,
                "max_inflight": self.max_inflight,
                "affinity_entries": n_aff,
                "draining": draining,
                "probe_interval_s": self.probe_interval_s,
                # the router span ring rides the fleet snapshot: a saved
                # /debug/fleet body IS the fleettrace --router-dump file
                "spans": self.spans.raw_spans()}


class _UpstreamDied(Exception):
    """The replica connection failed or returned 5xx before the client
    saw a byte — the retryable class."""

    def __init__(self, msg: str, status: int | None = None,
                 headers=None, body: bytes = b"", code: str | None = None):
        super().__init__(msg)
        self.status = status  # a relayable 5xx when retry is impossible
        self.headers = headers
        self.body = body
        # the 5xx body's machine code when it carried one: draining /
        # queue_full answers classify the replica as unready, they do
        # NOT feed the circuit breaker
        self.code = code


class _StreamState:
    """Per-request resume ledger carried across relay attempts: every
    SSE event the client was sent passes through :meth:`admit`, which
    reads the replica's ``dllama`` stamp (``{"index": n, "tokens":
    [...]}``; serve/api.py batched mode) and keeps the transcript's
    position — ``n_tokens`` tokens held by the client, their ids in
    ``tokens``. A spliced continuation re-enters the same ledger, so a
    replayed index (``<= n_tokens``) is dropped before the client can
    see a duplicate: the exactly-once half of the token-exact contract
    (the gap-free half is the replica resuming AT ``n_tokens``)."""

    def __init__(self):
        self.headers_sent = False   # response status/headers relayed once
        self.stamped = False        # any dllama index stamp observed
        self.echo_relayed = False   # the index-0 prompt-echo chunk sent
        self.done = False           # the [DONE] sentinel reached the client
        self.upstream_error = False  # held-back terminal "error" chunk
        self.n_tokens = 0           # last stamped index relayed
        self.tokens: list[int] = []  # the ids behind those indices
        self.resumes = 0            # spliced continuations consumed
        # resume-latency attribution, armed by the resume dispatch and
        # consumed by the relay loop at the first continued event:
        # (t_detect_ns, t_redispatch_ns, t_connect_ns, resume_from)
        self.resume_t: tuple | None = None

    def resumable(self) -> bool:
        """Only a stamped stream whose ledger is self-consistent (ids
        held == indices relayed — what the replica-side resume admission
        validates) can be spliced; anything else keeps the legacy
        terminal-502 contract."""
        return self.stamped and len(self.tokens) == self.n_tokens

    def admit(self, evt: bytes) -> bool:
        """Whether one complete SSE event reaches the client; updates
        the ledger from the event's ``dllama`` stamp. Unstamped events
        (errors, usage epilogues, non-JSON) always pass."""
        body = evt.strip()
        if not body.startswith(b"data:"):
            return True
        data = body[5:].strip()
        if data == b"[DONE]":
            self.done = True
            return True
        try:
            obj = json.loads(data)
        except ValueError:
            return True
        if not isinstance(obj, dict):
            return True
        if self.stamped:
            # a replica-authored terminal `finish_reason: "error"` chunk
            # (scheduler crash fail-all, watchdog trip) is a mid-stream
            # death in a cleanly-FINed socket: hold it back and let the
            # caller splice a continuation — a terminal abort past the
            # resume budget still ends the stream explicitly
            ch = obj.get("choices")
            if isinstance(ch, list) and ch and isinstance(ch[0], dict) \
                    and ch[0].get("finish_reason") == "error":
                self.upstream_error = True
                return False
        meta = obj.get("dllama")
        if not isinstance(meta, dict):
            return True
        try:
            idx = int(meta.get("index"))
            toks = [int(t) for t in meta.get("tokens") or ()]
        except (TypeError, ValueError):
            return True
        self.stamped = True
        if idx == 0:
            # the prompt-echo chunk: once, ever (a from-zero re-dispatch
            # replays it; the client already holds it)
            if self.echo_relayed:
                return False
            self.echo_relayed = True
            return True
        if idx <= self.n_tokens:
            # a tail flush (same index, no new tokens) is text the
            # stop-string detector held back past the last counted
            # token — never yet relayed, so it passes; anything
            # carrying token ids at a held index is a splice replay
            return idx == self.n_tokens and not toks
        self.n_tokens = idx
        self.tokens.extend(toks)
        return True


class _StreamDied(Exception):
    """The upstream died AFTER the client saw stream bytes — not
    retryable as a fresh dispatch (the transcript is half-delivered);
    resumable as a spliced continuation when the chunks carried the
    replica's ``dllama`` index stamps. Carries the request's
    :class:`_StreamState` ledger and the underlying failure."""

    def __init__(self, st: _StreamState, exc: Exception):
        super().__init__(f"{type(exc).__name__}: {exc}")
        self.st = st
        self.exc = exc


def make_router_handler(fleet: FleetRouter):
    class RouterHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        timeout = 120  # stalled-peer guard, same rationale as serve/api.py

        # per-request trace state (reset at the top of each do_GET/do_POST
        # — keep-alive reuses the handler instance across requests)
        _fleet_rid: str | None = None
        _tenant: str | None = None
        _t_first_ns: int | None = None

        def log_message(self, fmt, *args):
            print(f"🕸️ router {self.address_string()} {fmt % args}")

        def _count(self, status: int | str) -> None:
            path = self.path.split("?", 1)[0]
            route = path if path in _ROUTES else "other"
            telemetry.registry().counter(telemetry.HTTP_REQUESTS).inc(
                route=route, status=str(status))

        def _json(self, code: int, payload: dict,
                  headers: dict | None = None) -> None:
            self._count(code)
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if self._fleet_rid:
                # every router-authored answer names the request: the
                # client learns the minted id even on shed/error paths
                self.send_header(FLEET_RID_HEADER, self._fleet_rid)
            if self._tenant is not None:
                self.send_header(TENANT_HEADER, self._tenant)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        # -- upstream plumbing ----------------------------------------------

        def _open_upstream(self, rep: Replica, method: str, path: str,
                           body: bytes | None, extra_headers=None):
            """One upstream request; returns (conn, resp) with headers
            parsed. Raises :class:`_UpstreamDied` on connect failure or
            a 5xx answer (the breaker is fed by the caller).
            ``extra_headers`` carries the fleet trace identity
            (request-id + hop index) on completion dispatches."""
            conn = http.client.HTTPConnection(
                rep.host, rep.port, timeout=fleet.read_timeout_s)
            try:
                # the chaos sever point: an armed `proxy` failpoint
                # (conn_reset/broken_pipe/raise) kills this dispatch
                # exactly where a dying replica would
                failpoints.fire("proxy")
                headers = {}
                if body is not None:
                    headers["Content-Type"] = "application/json"
                if extra_headers:
                    headers.update(extra_headers)
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
            except (OSError, http.client.HTTPException,
                    failpoints.FailpointError) as e:
                conn.close()
                raise _UpstreamDied(
                    f"replica {rep.name} connection failed: "
                    f"{type(e).__name__}: {e}") from e
            if resp.status >= 500:
                # a 5xx before any relay is retryable on another
                # replica; keep the payload so a retry-exhausted path
                # can still pass it through unmangled, and its machine
                # code so a draining replica isn't breaker-ejected
                data = resp.read()
                hdrs = resp.getheaders()
                conn.close()
                code = None
                try:
                    code = json.loads(data).get("code")
                except (ValueError, AttributeError):
                    pass
                raise _UpstreamDied(
                    f"replica {rep.name} answered {resp.status}",
                    status=resp.status, headers=hdrs, body=data,
                    code=code)
            return conn, resp

        def _relay_headers(self, resp, status: int,
                           force_close: bool) -> None:
            self.send_response(status)
            for k, v in resp.getheaders():
                if k in _RELAY_HEADERS and k != FLEET_RID_HEADER:
                    self.send_header(k, v)
            if self._fleet_rid:
                # the fleet trace id rides every relayed response, so a
                # client can join its request into /debug/fleet/timeline
                self.send_header(FLEET_RID_HEADER, self._fleet_rid)
            if self._tenant is not None:
                self.send_header(TENANT_HEADER, self._tenant)
            if force_close:
                self.send_header("Connection", "close")
                self.close_connection = True
            self.end_headers()

        def _note_first_byte(self, rid: str, rep: Replica, hop: int,
                             t0_ns: int) -> None:
            """First upstream body byte relayed: the router-measured
            TTFT — ``rt_first_byte`` span (admission → now), the
            dllama_router_ttft_ms histogram, and the SLO observation —
            recorded once per request, whichever hop serves it."""
            if self._t_first_ns is not None or not rid:
                return
            now = telemetry.now_ns()
            self._t_first_ns = now
            ms = (now - t0_ns) / 1e6
            fleet.h_ttft.record(ms)
            fleet.spans.emit_span(rid, "rt_first_byte", t0_ns, now,
                                  replica=rep.name, hop=hop)
            if fleet.slo is not None:
                fleet.slo.observe_ttft(ms, tenant=self._tenant)

        def _end_stream(self, rid: str, rep: Replica, hop: int,
                        status) -> None:
            """Close the ``rt_stream`` span (first relayed byte → last)
            once the relay is over — clean end or mid-stream 502."""
            if self._t_first_ns is None or not rid:
                return
            fleet.spans.emit_span(rid, "rt_stream", self._t_first_ns,
                                  telemetry.now_ns(), replica=rep.name,
                                  hop=hop, code=str(status))

        def _relay_response(self, rep: Replica, conn, resp, *,
                            rid: str = "", hop: int = 0,
                            t0_ns: int = 0,
                            st: _StreamState | None = None) -> int:
            """Stream the upstream response to the client. Buffered when
            a Content-Length is known (an upstream death mid-body stays
            retryable because nothing reached the client); incremental
            for SSE/EOF-delimited bodies, event-parsed through the
            request's :class:`_StreamState` ledger so a mid-stream death
            raises :class:`_StreamDied` for the caller to either splice
            a continuation (``_resume_stream``) or send the explicit
            terminal 502 event. ``rid``/``hop``/``t0_ns`` feed the trace
            spans and the router-measured TTFT/ITL."""
            try:
                length = resp.getheader("Content-Length")
                if length is not None:
                    try:
                        data = resp.read(int(length))
                    except (OSError, http.client.HTTPException) as e:
                        raise _UpstreamDied(
                            f"replica {rep.name} died mid-body: "
                            f"{type(e).__name__}") from e
                    if len(data) < int(length):
                        raise _UpstreamDied(
                            f"replica {rep.name} died mid-body")
                    self._note_first_byte(rid, rep, hop, t0_ns)
                    self._relay_headers(resp, resp.status,
                                        force_close=False)
                    self.wfile.write(data)
                    self._end_stream(rid, rep, hop, resp.status)
                    return resp.status
                # EOF-delimited (the api server's SSE streams): relay as
                # data arrives; from the first byte on, failures are no
                # longer retryable as a fresh dispatch — a death raises
                # _StreamDied and the caller splices a continuation (a
                # stamped stream) or sends the terminal 502 event.
                # A dying replica's socket closes with a clean FIN, so
                # EOF alone can't prove completion: the api server's SSE
                # contract is that a healthy stream ends with the
                # ``data: [DONE]`` sentinel, and an EOF without it IS a
                # mid-stream death.
                is_sse = (resp.getheader("Content-Type") or "").startswith(
                    "text/event-stream")
                if st is None:
                    st = _StreamState()
                if not st.headers_sent:
                    self._relay_headers(resp, resp.status,
                                        force_close=True)
                    st.headers_sent = True
                buf = b""
                t_prev: int | None = None
                while True:
                    try:
                        chunk = resp.read1(65536)
                    except (OSError, http.client.HTTPException) as e:
                        raise _StreamDied(st, e) from e
                    if not chunk:
                        if is_sse and not st.done:
                            raise _StreamDied(st, ConnectionError(
                                "EOF before the [DONE] sentinel"))
                        self._end_stream(rid, rep, hop, resp.status)
                        return resp.status
                    now = telemetry.now_ns()
                    if t_prev is None:
                        self._note_first_byte(rid, rep, hop, t0_ns)
                    elif fleet.slo is not None:
                        # router-measured ITL: inter-chunk relay gaps
                        # (one SSE event per chunk in practice)
                        fleet.slo.observe_itl((now - t_prev) / 1e6,
                                              tenant=self._tenant)
                    t_prev = now
                    if not is_sse:
                        self.wfile.write(chunk)
                        self.wfile.flush()
                        continue
                    # event-parsed relay: the exactly-once filter needs
                    # whole `data:` events (split on the SSE separator),
                    # and in practice each chunk IS one event
                    buf += chunk
                    out = b""
                    while b"\n\n" in buf:
                        evt, buf = buf.split(b"\n\n", 1)
                        if st.upstream_error:
                            # the held-back terminal error chunk ends
                            # this upstream: its trailing [DONE] belongs
                            # to the dead stream, never to the client
                            break
                        if st.admit(evt):
                            out += evt + b"\n\n"
                    if out:
                        if st.resume_t is not None:
                            self._note_resume_spliced(rid, rep, hop,
                                                      st, now)
                        self.wfile.write(out)
                        self.wfile.flush()
                    if st.upstream_error:
                        raise _StreamDied(st, ConnectionError(
                            "upstream terminal error chunk"))
            finally:
                conn.close()

        def _note_resume_spliced(self, rid: str, rep: Replica, hop: int,
                                 st: _StreamState, now_ns: int) -> None:
            """First continued event of a spliced continuation reached
            the client: the resume succeeded — record the detect→
            first-token latency (dllama_router_stream_resume_ms), the
            outcome counter, and the ``rt_resume`` span with its phase
            attribution (re-dispatch decision, upstream connect, first
            continued token) in the span's extra fields."""
            t_detect, t_redispatch, t_connect, n_resume = st.resume_t
            st.resume_t = None
            fleet.c_resumes.inc(outcome="resumed")
            fleet.h_resume.record((now_ns - t_detect) / 1e6)
            fleet.spans.emit_span(
                rid, "rt_resume", t_detect, now_ns,
                replica=rep.name, hop=hop, resume_from=n_resume,
                detect_ms=round((t_redispatch - t_detect) / 1e6, 3),
                redispatch_ms=round((t_connect - t_redispatch) / 1e6, 3),
                first_token_ms=round((now_ns - t_connect) / 1e6, 3))

        def _stream_abort(self, rep: Replica, exc: Exception) -> None:
            """Mid-stream upstream death: an explicit terminal SSE event
            naming the 502, then [DONE] — the client can always tell a
            server-side abort from a dropped socket."""
            try:
                evt = {"error": {
                    "message": f"replica {rep.name} died mid-stream "
                               f"({type(exc).__name__})",
                    "type": "upstream_error", "code": 502}}
                self.wfile.write(b"data: "
                                 + json.dumps(evt).encode("utf-8")
                                 + b"\n\n")
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except OSError:
                pass  # the peer is gone too; nothing left to tell it
            self.close_connection = True

        def _resume_stream(self, body: dict, rid: str, rep: Replica,
                           hop: int, sd: _StreamDied,
                           t0_ns: int) -> int:
            """Mid-stream failover: the serving replica died with the
            transcript half-delivered — re-dispatch the request to a
            healthy replica as a spliced continuation (``resume_from`` +
            the full token history from the relay ledger) and keep
            relaying from the splice, exactly-once (``_StreamState``
            drops any replayed index). Bounded by ``--max-stream-
            resumes`` spliced continuations and the remaining request
            deadline; past either bound — or for a stream whose chunks
            carried no index stamps (single-sequence replicas) — the
            legacy contract stands: the explicit terminal 502 event.
            Returns the final relayed status."""
            st, exc = sd.st, sd.exc
            dead = {rep}
            while True:
                t_detect = telemetry.now_ns()
                if not st.resumable():
                    # unstamped stream or a ledger hole: not spliceable
                    self._stream_abort(rep, exc)
                    self._end_stream(rid, rep, hop, 502)
                    return 502
                outcome = None
                if st.resumes >= fleet.max_stream_resumes:
                    outcome = "exhausted"
                # the deadline a continuation must fit inside: the
                # client's own body "timeout" when it set one, else the
                # router-level --request-timeout default (0 = unbounded)
                limit_s = 0.0
                t = body.get("timeout")
                if isinstance(t, (int, float)) \
                        and not isinstance(t, bool) and t > 0:
                    limit_s = float(t)
                elif fleet.request_timeout_s > 0:
                    limit_s = fleet.request_timeout_s
                remaining_s = (limit_s - (t_detect - t0_ns) / 1e9
                               if limit_s else 0.0)
                if outcome is None and limit_s and remaining_s <= 0.05:
                    outcome = "no_budget"
                rep2 = None
                if outcome is None:
                    st.resumes += 1
                    rep2 = fleet.pick(affinity_key(body), exclude=dead)
                    if rep2 is None:
                        outcome = "failed"
                if outcome is not None:
                    fleet.c_resumes.inc(outcome=outcome)
                    self._stream_abort(rep, exc)
                    self._end_stream(rid, rep, hop, 502)
                    return 502
                hop += 1
                rbody = dict(body)
                rbody.pop("resume_from", None)
                rbody.pop("resume_tokens", None)
                if st.n_tokens:
                    rbody["resume_from"] = st.n_tokens
                    rbody["resume_tokens"] = list(st.tokens)
                if limit_s:
                    rbody["timeout"] = round(remaining_s, 3)
                extra = {FLEET_RID_HEADER: rid,
                         FLEET_HOP_HEADER: str(hop),
                         RESUME_FROM_HEADER: str(st.n_tokens),
                         # router-authored re-dispatch: without this the
                         # continuation lands on the new replica as
                         # "anon" and the tenant's usage splits across
                         # identities mid-stream
                         TENANT_HEADER: self._tenant or tenancy.ANON}
                # prefer pulling the prefix (prompt + history) over the
                # KV wire: any advertising peer serves — including the
                # dying donor while it still answers, or a prefill-role
                # replica — with the replica's recompute fallback
                # covering every refusal
                donor = fleet.kv_donor(affinity_key(body), rep2)
                if donor is not None:
                    extra[KV_PEER_HEADER] = donor.name
                    t_don = telemetry.now_ns()
                    fleet.spans.emit_span(rid, "rt_kv_donor", t_don,
                                          t_don, replica=rep2.name,
                                          donor=donor.name)
                t_redispatch = telemetry.now_ns()
                rep2.begin_request()
                try:
                    try:
                        # the resume chaos sever point: an armed
                        # `resume` failpoint kills the re-dispatch
                        # exactly where a dying resume target would
                        failpoints.fire("resume")
                        conn, resp = self._open_upstream(
                            rep2, "POST", "/v1/chat/completions",
                            json.dumps(rbody).encode("utf-8"),
                            extra_headers=extra)
                    except (OSError, failpoints.FailpointError,
                            _UpstreamDied) as e:
                        if isinstance(e, _UpstreamDied) \
                                and e.code in ("draining", "queue_full"):
                            rep2.note_unready(e.code)
                        else:
                            rep2.note_failure()
                        fleet.c_resumes.inc(outcome="failed")
                        dead.add(rep2)
                        rep, exc = rep2, e
                        continue  # another attempt if the budget allows
                    rep2.note_success()
                    fleet.c_dispatch.inc(replica=rep2.name)
                    st.upstream_error = False
                    st.resume_t = (t_detect, t_redispatch,
                                   telemetry.now_ns(), st.n_tokens)
                    try:
                        return self._relay_response(
                            rep2, conn, resp, rid=rid, hop=hop,
                            t0_ns=t0_ns, st=st)
                    except _StreamDied as sd2:
                        if st.resume_t is not None:
                            # died before one continued event: the
                            # splice never happened — attempt failed
                            st.resume_t = None
                            fleet.c_resumes.inc(outcome="failed")
                        dead.add(rep2)
                        rep, exc = rep2, sd2.exc
                        continue
                finally:
                    rep2.end_request()

        def _proxy_buffered(self, method: str, path: str,
                            body: bytes | None) -> None:
            """Relay a small non-completion resource (/v1/models) with
            one failover: buffered, so any pre-client failure retries."""
            tried: set = set()
            for _ in range(2):
                rep = fleet.pick(None, exclude=tried)
                if rep is None:
                    break
                tried.add(rep)
                try:
                    conn, resp = self._open_upstream(rep, method, path,
                                                     body)
                except _UpstreamDied:
                    rep.note_failure()
                    continue
                rep.note_success()
                try:
                    data = resp.read()
                finally:
                    conn.close()
                self._count(resp.status)
                self.send_response(resp.status)
                for k, v in resp.getheaders():
                    if k in _RELAY_HEADERS and k != "Content-Length":
                        self.send_header(k, v)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            reason, code = fleet.unready_reason()
            self._json(503, {"error": reason, "code": code},
                       headers=backpressure_headers(503))

        # -- routes ---------------------------------------------------------

        def _fleet_timeline(self) -> None:
            """``GET /debug/fleet/timeline`` — pull every replica's live
            ``/debug/flight`` and join it with the router span ring into
            one Chrome trace (``flightrec.fleet_chrome_trace``). A
            replica that cannot answer contributes no track (its spans
            survive in the join only if another dump carries them); the
            trace's ``fleetJoin`` summary says how much joined."""
            dumps: dict[str, dict] = {}
            for rep in fleet.replicas:
                conn = http.client.HTTPConnection(
                    rep.host, rep.port, timeout=rep.connect_timeout_s)
                try:
                    conn.request("GET", "/debug/flight")
                    resp = conn.getresponse()
                    if resp.status == 200:
                        dumps[rep.name] = json.loads(resp.read())
                except (OSError, ValueError, http.client.HTTPException):
                    continue  # dead replica: absent track, not a 5xx
                finally:
                    conn.close()
            self._json(200, flightrec.fleet_chrome_trace(
                fleet.fleet_snapshot(), dumps))

        def _fleet_tenants(self) -> None:
            """``GET /debug/fleet/tenants`` — pull every replica's live
            ``/debug/tenants`` and join them into one fleet-wide usage
            view: per-replica registries verbatim, per-tenant totals
            summed across replicas, and a fleet Jain's index over the
            summed decode tokens. A replica that cannot answer
            contributes nothing (``replicas_joined`` says how many did);
            the router's own registry rides along so router-tier sheds
            (``router_queue_full``) are visible in the same body."""
            replicas: dict[str, dict] = {}
            for rep in fleet.replicas:
                conn = http.client.HTTPConnection(
                    rep.host, rep.port, timeout=rep.connect_timeout_s)
                try:
                    conn.request("GET", "/debug/tenants")
                    resp = conn.getresponse()
                    if resp.status == 200:
                        replicas[rep.name] = json.loads(resp.read())
                except (OSError, ValueError, http.client.HTTPException):
                    continue  # dead replica: absent entry, not a 5xx
                finally:
                    conn.close()
            totals: dict[str, dict] = {}
            for snap in replicas.values():
                for t, st in (snap.get("tenants") or {}).items():
                    agg = totals.setdefault(t, {})
                    for k, v in st.items():
                        if isinstance(v, (int, float)):
                            agg[k] = agg.get(k, 0) + v
                        elif isinstance(v, dict) and k == "sheds":
                            sh = agg.setdefault("sheds", {})
                            for r, n in v.items():
                                sh[r] = sh.get(r, 0) + n
            self._json(200, {
                "replicas_joined": len(replicas),
                "replicas": replicas,
                "tenants": totals,
                "fleet_jain_index": tenancy.jain_index(
                    st.get("decode_tokens", 0)
                    for st in totals.values()),
                "router": tenancy.registry().snapshot()})

        def do_GET(self):
            self._fleet_rid = None  # keep-alive: no stale POST echo
            self._tenant = None
            path = self.path.split("?", 1)[0]
            if path in ("/health", "/healthz"):
                self._json(200, {"status": "ok"})
            elif path == "/readyz":
                ready, reason, code = fleet.readiness()
                self._json(
                    200 if ready else 503,
                    {"status": "ok" if ready else "unready",
                     "reason": reason, "code": code},
                    headers=None if ready else backpressure_headers(503))
            elif path == "/metrics":
                if fleet.slo is not None:
                    # scrape-time evaluation keeps the compliance/burn
                    # gauges current without a timer thread of their own
                    fleet.slo.evaluate()
                self._count(200)
                body = telemetry.registry().render().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/debug/fleet":
                self._json(200, fleet.fleet_snapshot())
            elif path == "/debug/fleet/timeline":
                self._fleet_timeline()
            elif path == "/debug/fleet/tenants":
                self._fleet_tenants()
            elif path == "/debug/slo":
                if fleet.slo is None:
                    self._json(404, {"error": "no SLO objectives "
                                              "configured (start the "
                                              "router with --slo)"})
                else:
                    self._json(200, fleet.slo.evaluate())
            elif path == "/v1/models":
                self._proxy_buffered("GET", "/v1/models", None)
            else:
                self._json(404, {"error": "not found", "path": self.path,
                                 "routes": list(_ROUTES)})

        def do_POST(self):
            self._fleet_rid = None
            t_recv = telemetry.now_ns()  # rt_queue span origin
            path = self.path.split("?", 1)[0]
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                length = 0
            raw = b""
            if 0 < length <= (1 << 22):
                raw = self.rfile.read(length)
            elif length:
                # never forward a body we refused to read: an explicit
                # 413, and drop the connection instead of draining 4 MiB
                self.close_connection = True
                self._json(413, {"error": f"request body too large "
                                          f"({length} bytes; limit "
                                          f"{1 << 22})"})
                return
            if path != "/v1/chat/completions":
                self._json(404, {"error": "not found", "path": self.path,
                                 "routes": list(_ROUTES)})
                return
            try:
                body = json.loads(raw or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except ValueError:
                # malformed enough that no affinity key exists; the
                # replica owns the full validation answer
                body = {}
            # fleet trace identity: honor a sanitary client id, else mint
            rid = fleet.mint_rid(self.headers.get(FLEET_RID_HEADER))
            self._fleet_rid = rid
            # tenant identity: sanitized + cardinality-bounded here (the
            # router's own registry attributes router-tier decisions);
            # the canonical label rides every upstream hop and answer
            tenant = tenancy.registry().resolve(
                self.headers.get(TENANT_HEADER))
            self._tenant = tenant
            if not fleet.admit():
                if fleet.is_draining():
                    fleet.spans.emit_span(rid, "rt_queue", t_recv,
                                          telemetry.now_ns(),
                                          outcome="draining",
                                          tenant=tenant)
                    self._json(503, {"error": "router is draining",
                                     "code": "draining"},
                               headers=backpressure_headers(503))
                    return
                fleet.c_shed.inc()
                tenancy.registry().note_shed(tenant, "router_queue_full")
                if fleet.slo is not None:
                    fleet.slo.observe_outcome(shed=True, tenant=tenant)
                fleet.spans.emit_span(rid, "rt_queue", t_recv,
                                      telemetry.now_ns(), outcome="shed",
                                      tenant=tenant,
                                      reason="router_queue_full")
                self._json(429, {"error": f"router at --max-queue "
                                          f"({fleet.max_inflight} in "
                                          f"flight); retry later",
                                 "code": "queue_full"},
                           headers=backpressure_headers(429))
                return
            # request receipt → admission decision: the router's queue
            # phase (near-zero here — admission is one lock — but the
            # span anchors the request's flow at the router tier)
            fleet.spans.emit_span(rid, "rt_queue", t_recv,
                                  telemetry.now_ns(), outcome="admitted",
                                  tenant=tenant)
            shed = False
            try:
                shed = self._dispatch_completion(raw, body, rid, t_recv)
            finally:
                fleet.release()
            if fleet.slo is not None:
                fleet.slo.observe_outcome(shed=shed, tenant=tenant)

        def _note_eject(self, rid: str, rep: Replica, hop: int) -> None:
            """Instant ``rt_eject`` marker when a dispatch failure trips
            the breaker (state observed down right after note_failure)."""
            if rep.snapshot()["state"] == "down":
                now = telemetry.now_ns()
                fleet.spans.emit_span(rid, "rt_eject", now, now,
                                      replica=rep.name, hop=hop)

        def _prefill_warm(self, body: dict, rid: str) -> Replica | None:
            """Explicit disaggregation: run the prompt (one token, no
            stream) on the least-loaded prefill-role replica so its
            paged pool holds the prefix, then name it as the KV donor
            for the decode dispatch. Best-effort on every path — a
            failed or refused warm-up just means the decode replica
            prefills locally."""
            pre = fleet.prefill_replicas()
            if not pre:
                return None
            rep = min(pre, key=lambda r: r.load_score())
            warm = dict(body)
            warm["max_tokens"] = 1
            warm["stream"] = False
            warm.pop("timing", None)
            t0 = telemetry.now_ns()
            rep.begin_request()
            try:
                conn, resp = self._open_upstream(
                    rep, "POST", "/v1/chat/completions",
                    json.dumps(warm).encode("utf-8"),
                    extra_headers={FLEET_RID_HEADER: rid,
                                   FLEET_HOP_HEADER: "0",
                                   # warm-up work bills to its caller,
                                   # not to "anon" on the prefill pod
                                   TENANT_HEADER: self._tenant
                                   or tenancy.ANON})
                try:
                    resp.read()
                finally:
                    conn.close()
                rep.note_success()
                return rep
            except _UpstreamDied:
                return None
            finally:
                rep.end_request()
                fleet.spans.emit_span(rid, "rt_prefill", t0,
                                      telemetry.now_ns(),
                                      replica=rep.name)

        def _dispatch_completion(self, raw: bytes, body: dict,
                                 rid: str, t0_ns: int) -> bool:
            """Dispatch one admitted completion (with one cross-replica
            retry); returns True when the request was ultimately SHED
            (queue_full) — the caller's SLO shed-rate observation."""
            key = affinity_key(body)
            tried: set = set()
            last: _UpstreamDied | None = None
            ns_failed = 0  # wall burned on failed hops before serving
            self._t_first_ns = None
            for attempt in range(2):
                t_pick = telemetry.now_ns()
                rep = fleet.pick(key, exclude=tried)
                if rep is None:
                    break
                tried.add(rep)
                if attempt:
                    fleet.c_retries.inc()
                # dispatch attempts by hop index: hop="1"+ are retry
                # hops — the same index the X-Dllama-Hop header carries
                fleet.c_retry_hops.inc(hop=str(attempt))
                snap = rep.snapshot()
                # the dispatch decision as an instant marker, carrying
                # the probe snapshot that justified the pick
                fleet.spans.emit_span(
                    rid, "rt_dispatch", t_pick, t_pick,
                    replica=rep.name, hop=attempt, state=snap["state"],
                    load=round(snap["queue_depth"]
                               + snap["engine_inflight"]
                               + snap["router_inflight"], 3))
                extra = {FLEET_RID_HEADER: rid,
                         FLEET_HOP_HEADER: str(attempt),
                         TENANT_HEADER: self._tenant or tenancy.ANON}
                if attempt == 0 and key is not None \
                        and not rep.holds_prefix(key):
                    # fleet-global prefix reuse: a peer advertising this
                    # key becomes the KV donor; with none, explicit
                    # disaggregation warms a prefill-role replica first.
                    # First hop only — a retry hop already paid for one
                    # migration attempt and must not stack another wire
                    # wait on a degraded fleet
                    donor = fleet.kv_donor(key, rep)
                    if donor is None:
                        donor = self._prefill_warm(body, rid)
                        if donor is rep:
                            donor = None
                    if donor is not None:
                        extra[KV_PEER_HEADER] = donor.name
                        t_don = telemetry.now_ns()
                        fleet.spans.emit_span(rid, "rt_kv_donor", t_don,
                                              t_don, replica=rep.name,
                                              donor=donor.name)
                rep.begin_request()
                t_hop0 = telemetry.now_ns()
                try:
                    try:
                        conn, resp = self._open_upstream(
                            rep, "POST", "/v1/chat/completions", raw,
                            extra_headers=extra)
                    except _UpstreamDied as e:
                        t_fail = telemetry.now_ns()
                        ns_failed += t_fail - t_hop0
                        fleet.h_connect.record((t_fail - t_hop0) / 1e6,
                                               replica=rep.name)
                        fleet.spans.emit_span(
                            rid, "rt_retry", t_hop0, t_fail,
                            replica=rep.name, hop=attempt,
                            code=e.code or "connect")
                        if e.code in ("draining", "queue_full"):
                            # an explicit backpressure answer: the
                            # replica is alive — reclassify, don't eject
                            rep.note_unready(e.code)
                        else:
                            rep.note_failure()
                            self._note_eject(rid, rep, attempt)
                        last = e
                        continue
                    t_conn = telemetry.now_ns()
                    fleet.h_connect.record((t_conn - t_hop0) / 1e6,
                                           replica=rep.name)
                    fleet.spans.emit_span(rid, "rt_connect", t_hop0,
                                          t_conn, replica=rep.name,
                                          hop=attempt)
                    rep.note_success()
                    fleet.c_dispatch.inc(replica=rep.name)
                    if attempt:
                        # the serving hop follows >=1 failed hop: record
                        # the retry tax this request paid, once
                        fleet.h_retry.record(ns_failed / 1e6)
                    try:
                        status = self._relay_response(
                            rep, conn, resp, rid=rid, hop=attempt,
                            t0_ns=t0_ns)
                    except _UpstreamDied as e:
                        # buffered body died before the client saw a
                        # byte: feed the breaker and retry
                        ns_failed += telemetry.now_ns() - t_hop0
                        fleet.spans.emit_span(
                            rid, "rt_retry", t_hop0, telemetry.now_ns(),
                            replica=rep.name, hop=attempt,
                            code="mid_body")
                        rep.note_failure()
                        self._note_eject(rid, rep, attempt)
                        last = e
                        continue
                    except _StreamDied as sd:
                        # the stream died with bytes already relayed: a
                        # fresh retry would duplicate the transcript —
                        # splice a continuation instead (or send the
                        # explicit terminal 502 past the resume budget)
                        try:
                            status = self._resume_stream(
                                body, rid, rep, attempt, sd, t0_ns)
                        except (BrokenPipeError, ConnectionResetError):
                            status = "client_disconnect"
                            self.close_connection = True
                    except (BrokenPipeError, ConnectionResetError):
                        status = "client_disconnect"
                        self.close_connection = True
                    self._count(status)
                    return False
                finally:
                    rep.end_request()
            # retry budget exhausted or no replica at all
            if last is not None and last.status is not None \
                    and len(tried) >= len(fleet.replicas):
                # single-replica degradation: the upstream's own 5xx
                # passes through unmangled (status, headers, body)
                self._count(last.status)
                self.send_response(last.status)
                if self._fleet_rid:
                    self.send_header(FLEET_RID_HEADER, self._fleet_rid)
                for k, v in (last.headers or ()):
                    if k in _RELAY_HEADERS and k != "Content-Length":
                        self.send_header(k, v)
                self.send_header("Content-Length", str(len(last.body)))
                self.end_headers()
                self.wfile.write(last.body)
                return False
            if last is not None:
                self._json(502, {"error": f"dispatch failed on "
                                          f"{len(tried)} replica(s): "
                                          f"{last}",
                                 "code": "crashed"},
                           headers=backpressure_headers(503))
                return False
            reason, code = fleet.unready_reason()
            if code == "queue_full":
                fleet.c_shed.inc()
                # fleet-saturated shed is attributable too: same
                # router-tier reason as the --max-queue bound
                tenant = self._tenant or tenancy.ANON
                tenancy.registry().note_shed(tenant, "router_queue_full")
                fleet.spans.emit_span(rid, "rt_queue", t0_ns,
                                      telemetry.now_ns(), outcome="shed",
                                      tenant=tenant,
                                      reason="router_queue_full")
                self._json(429, {"error": reason, "code": code},
                           headers=backpressure_headers(429))
                return True
            self._json(503, {"error": reason, "code": code},
                       headers=backpressure_headers(503))
            return False

    return RouterHandler


def run_router(args) -> int:
    """``python -m dllama_tpu_torch router --replica URL [--replica URL
    ...]`` — pure host tier: no model, no tokenizer, no device; never
    initialises CUDA."""
    import os
    import signal

    replicas = list(args.replica or [])
    if not replicas:
        raise SystemExit("router mode needs at least one --replica URL "
                         "(repeat the flag per replica)")
    if failpoints.configure_from_env():
        print("💣 fault injection armed from DLLAMA_FAILPOINTS="
              f"{os.environ['DLLAMA_FAILPOINTS']}")
    slo_objectives = None
    if getattr(args, "slo", None):
        try:
            slo_objectives = slo.load_slo(args.slo)
        except ValueError as e:
            # a typo'd SLO must fail at startup with the objective
            # named, not silently never alarm
            raise SystemExit(f"--slo: {e}")
    fleet = FleetRouter(
        replicas,
        probe_interval_s=getattr(args, "probe_interval", 2.0) or 2.0,
        max_inflight=getattr(args, "max_queue", 0) or 0,
        max_stream_resumes=getattr(args, "max_stream_resumes", 1),
        request_timeout_s=getattr(args, "request_timeout", 0.0) or 0.0,
        slo_objectives=slo_objectives)
    if slo_objectives:
        print("🎯 SLO observatory: "
              + ", ".join(f"{k}≤{v:g}"
                          for k, v in slo_objectives.items())
              + " (burn windows "
              + "/".join(label for label, _ in slo.WINDOWS)
              + "; GET /debug/slo)")
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_router_handler(fleet))
    print(f"🕸️ fleet router: {len(fleet.replicas)} replicas "
          f"({', '.join(r.name for r in fleet.replicas)}), probe every "
          f"~{fleet.probe_interval_s:g}s"
          + (f", shed beyond {fleet.max_inflight} in flight"
             if fleet.max_inflight else "")
          + (f", streams survive ≤{fleet.max_stream_resumes} replica "
             f"death(s) mid-flight"
             if fleet.max_stream_resumes else ""))

    def _on_sigterm(signum, frame):
        print("🛑 SIGTERM: router draining (readyz → 503, in-flight "
              "streams finish)", flush=True)
        fleet.begin_drain()
        threading.Thread(target=server.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        pass  # not the main thread (embedded/test usage)
    stats_every = getattr(args, "stats", 0) or 0
    if stats_every:
        def _stats_loop():  # dlint: owner=any
            while not fleet._stop.wait(stats_every):
                if fleet.slo is not None:
                    fleet.slo.evaluate()  # refresh gauges for the line
                print(telemetry.stats_line(window_s=stats_every),
                      flush=True)
        threading.Thread(target=_stats_loop, daemon=True,
                         name="router-stats").start()
    host, port = server.server_address[:2]  # the bound port under --port 0
    print(f"🕸️ listening on http://{host}:{port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        fleet.close()
    return 0
