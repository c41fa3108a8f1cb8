"""Runtime telemetry — metrics registry + per-request span tracing (the
port of the JAX package's ``runtime/telemetry.py``, host-only, stdlib only).

* **Metrics registry** — monotonic :class:`Counter`, :class:`Gauge`, and
  fixed-bucket :class:`Histogram` (a ``record()`` is one lock + one bisect
  + three float ops). Every metric name is declared once in :data:`SPECS`,
  letter for letter the JAX package's vocabulary, and rendered as
  Prometheus text by :meth:`Registry.render` for the API server's ``GET
  /metrics``. A name whose layer did not run in this process renders at
  zero, as a JAX server that never ran that layer shows it.
* **Span tracer** — per-request phase spans (``queue|prefill|decode|
  verify``) emitted as JSONL to an operator-chosen file (``--trace-out``)
  and kept in an always-on bounded ring (``GET /debug/requests``).

Every call site sits in host code around a CUDA-graph replay and its
readback, never inside a captured step: a capture runs the body once, so
a counter inside it would count once, at capture. No site reads a device
tensor: gauges read host mirrors (the block allocator's counts, the slot
tables), step times are host-clock windows around readbacks that exist
anyway.
"""

from __future__ import annotations

import json
import threading
import time
from bisect import bisect_left
from collections import deque
from dataclasses import dataclass

# -- metric name constants ----------------------------------------------------
# One declaration point: instrumentation imports these. The names equal the
# JAX package's (tests/test_torch_telemetry.py holds them letter for letter).

# engine (runtime/engine.py)
PREFILL_CHUNK_MS = "dllama_prefill_chunk_ms"
PREFILL_TOKENS = "dllama_prefill_tokens_total"
DECODE_STEP_MS = "dllama_decode_step_ms"
DECODE_TOKENS = "dllama_decode_tokens_total"
SPEC_DRAFT_TOKENS = "dllama_spec_draft_tokens_total"
SPEC_ACCEPTED_TOKENS = "dllama_spec_accepted_tokens_total"
SPEC_DEGRADED = "dllama_spec_degraded_total"
KV_OCCUPANCY = "dllama_kv_occupancy"
HBM_NEED_BYTES = "dllama_hbm_need_bytes"
HBM_LIMIT_BYTES = "dllama_hbm_limit_bytes"
# reference-parity static accounting (runtime/profiling.py, published by
# InferenceEngine.measure_split)
SYNC_FRACTION = "dllama_sync_fraction"
SYNC_FRACTION_PREFILL = "dllama_sync_fraction_prefill"
COLLECTIVE_SENT_KB = "dllama_collective_sent_kb_per_token"
COLLECTIVE_RECV_KB = "dllama_collective_recv_kb_per_token"
COLLECTIVE_OPS = "dllama_collective_ops_per_step"
# overlapped/quantized multichip decode (parallel/qcollectives.py,
# published by runtime/engine.py + runtime/serving.py)
COLLECTIVE_BYTES = "dllama_collective_bytes_total"
COMM_EXPOSED_MS = "dllama_comm_exposed_ms"

# batched serving (runtime/serving.py)
QUEUE_WAIT_MS = "dllama_queue_wait_ms"
QUEUE_DEPTH = "dllama_queue_depth"
BATCH_STEP_MS = "dllama_batch_step_ms"
BATCH_OCCUPANCY = "dllama_batch_occupancy"
BATCH_SLOTS = "dllama_batch_slots"
BATCH_TOKENS = "dllama_batch_tokens_total"
ADMISSIONS = "dllama_admissions_total"
RETIRES = "dllama_retires_total"
PREFIX_REUSE_TOKENS = "dllama_prefix_reuse_tokens_total"
# paged KV block pool (runtime/kvblocks.py via runtime/serving.py)
KV_BLOCKS_TOTAL = "dllama_kv_blocks_total"
KV_BLOCKS_USED = "dllama_kv_blocks_used"
KV_BLOCKS_SHARED = "dllama_kv_blocks_shared"
KV_BLOCK_EXHAUSTION = "dllama_kv_block_exhaustion_total"

KV_BLOCKS_HOST_TOTAL = "dllama_kv_blocks_host_total"
KV_BLOCKS_HOST_USED = "dllama_kv_blocks_host_used"
KV_SPILL_BLOCKS = "dllama_kv_spill_blocks_total"
KV_SPILL_BYTES = "dllama_kv_spill_bytes_total"
KV_SPILL_MS = "dllama_kv_spill_ms_total"
KV_PAGEIN_BLOCKS = "dllama_kv_pagein_blocks_total"
KV_PAGEIN_BYTES = "dllama_kv_pagein_bytes_total"
KV_PAGEIN_MS = "dllama_kv_pagein_ms_total"
# KV migration wire (runtime/kvwire.py, runtime/serving.py import path)
KVWIRE_TX_FRAMES = "dllama_kvwire_tx_frames_total"
KVWIRE_TX_BYTES = "dllama_kvwire_tx_bytes_total"
KVWIRE_TX_MS = "dllama_kvwire_tx_ms_total"
KVWIRE_RX_FRAMES = "dllama_kvwire_rx_frames_total"
KVWIRE_RX_BYTES = "dllama_kvwire_rx_bytes_total"
KVWIRE_RX_MS = "dllama_kvwire_rx_ms_total"
KVWIRE_MIGRATIONS = "dllama_kvwire_migrations_total"
KVWIRE_FALLBACK = "dllama_kvwire_fallback_total"
# fault tolerance (runtime/serving.py, runtime/failpoints.py)
REQUESTS_SHED = "dllama_requests_shed_total"
REQUEST_TIMEOUTS = "dllama_request_timeouts_total"
SCHEDULER_CRASHES = "dllama_scheduler_crashes_total"
SCHEDULER_RESTARTS = "dllama_scheduler_restarts_total"
SERVER_DRAINING = "dllama_server_draining"
FAILPOINTS_FIRED = "dllama_failpoints_fired_total"
# runtime hardening (runtime/weights.py, runtime/watchdog.py, runtime/hbm.py)
WEIGHT_IO_RETRIES = "dllama_weight_io_retries_total"
LOAD_CORRUPTION = "dllama_load_corruption_total"
WATCHDOG_STALLS = "dllama_watchdog_stalls_total"
HBM_ADMISSION_REJECTS = "dllama_hbm_admission_rejects_total"
# quality observatory (runtime/evalharness.py — teacher-forced NLL eval)
EVAL_TOKENS = "dllama_eval_tokens_total"
EVAL_NLL = "dllama_eval_nll_total"
EVAL_PERPLEXITY = "dllama_eval_perplexity"

# flight recorder + latency attribution (runtime/flightrec.py, wired in
# runtime/serving.py and serve/api.py)
TTFT_ATTRIB_MS = "dllama_ttft_attrib_ms"
ITL_ATTRIB_MS = "dllama_itl_attrib_ms"
FLIGHT_TICKS = "dllama_flight_ticks_total"
FLIGHT_DUMPS = "dllama_flight_dumps_total"

# fleet router (serve/router.py — the scheduler-over-engines tier)
ROUTER_REPLICA_UP = "dllama_router_replica_up"
ROUTER_INFLIGHT = "dllama_router_inflight"
ROUTER_DISPATCHES = "dllama_router_dispatch_total"
ROUTER_RETRIES = "dllama_router_retries_total"
ROUTER_EJECTS = "dllama_router_ejects_total"
ROUTER_READMITS = "dllama_router_readmits_total"
ROUTER_SHED = "dllama_router_shed_total"
ROUTER_AFFINITY_HITS = "dllama_router_affinity_hits_total"
ROUTER_AFFINITY_PURGED = "dllama_router_affinity_purged_total"
ROUTER_TTFT_MS = "dllama_router_ttft_ms"
ROUTER_CONNECT_MS = "dllama_router_connect_ms"
ROUTER_RETRY_MS = "dllama_router_retry_ms"
ROUTER_RETRY_HOPS = "dllama_router_retry_hops_total"
ROUTER_STREAM_RESUMES = "dllama_router_stream_resumes_total"
ROUTER_STREAM_RESUME_MS = "dllama_router_stream_resume_ms"
# SLO observatory (runtime/slo.py, evaluated at the router)
SLO_COMPLIANCE = "dllama_slo_compliance"
SLO_BURN_RATE = "dllama_slo_burn_rate"

# tenant observatory (runtime/tenancy.py — per-tenant accounting bound
# to the X-Dllama-Tenant identity; label cardinality bounded by the
# registry's LRU, overflow collapsing into tenant="other")
TENANT_PREFILL_TOKENS = "dllama_tenant_prefill_tokens_total"
TENANT_DECODE_TOKENS = "dllama_tenant_decode_tokens_total"
TENANT_ADMISSIONS = "dllama_tenant_admissions_total"
TENANT_SHED = "dllama_tenant_shed_total"
TENANT_TIMEOUTS = "dllama_tenant_timeouts_total"
TENANT_OVERFLOW = "dllama_tenant_overflow_total"
TENANT_KV_BLOCK_SECONDS = "dllama_tenant_kv_block_seconds_total"
TENANT_SPEC_DRAFT_TOKENS = "dllama_tenant_spec_draft_tokens_total"
TENANT_SPEC_ACCEPTED_TOKENS = "dllama_tenant_spec_accepted_tokens_total"
TENANT_QUEUE_WAIT_MS = "dllama_tenant_queue_wait_ms"
TENANT_TTFT_MS = "dllama_tenant_ttft_ms"
TENANT_ITL_MS = "dllama_tenant_itl_ms"
TENANT_FAIRNESS_JAIN = "dllama_tenant_fairness_jain"
TENANT_SHARE_MAX = "dllama_tenant_share_max"
TENANT_SHARE_MIN = "dllama_tenant_share_min"
TENANT_ACTIVE = "dllama_tenant_active"

# HTTP layer (serve/api.py)
HTTP_REQUESTS = "dllama_http_requests_total"
REQUESTS_IN_FLIGHT = "dllama_requests_in_flight"
TTFT_MS = "dllama_ttft_ms"
ITL_MS = "dllama_itl_ms"
PROMPT_TOKENS = "dllama_prompt_tokens_total"
COMPLETION_TOKENS = "dllama_completion_tokens_total"
# numerics observatory (runtime/numerics.py, models/llama.py taps)
NONFINITE = "dllama_nonfinite_total"
CANARY_RUNS = "dllama_canary_runs_total"
CANARY_DRIFT = "dllama_canary_drift_total"
Q80_ROUNDTRIP_ERROR = "dllama_q80_roundtrip_error"
ACTIVATION_RMS = "dllama_activation_rms"
ACTIVATION_ABSMAX = "dllama_activation_absmax"
QUANT_AUDIT_MIN_SNR = "dllama_quant_audit_min_snr_db"
QUANT_AUDIT_NONFINITE = "dllama_quant_audit_nonfinite_total"
# roofline observatory (runtime/roofline.py)
ROOFLINE_FRACTION = "dllama_roofline_fraction"
ACHIEVED_HBM_GBPS = "dllama_achieved_hbm_gbps"
ACHIEVED_TFLOPS = "dllama_achieved_tflops"
# XLA compile introspection (runtime/introspection.py)
COMPILE_TOTAL = "dllama_compile_total"
COMPILE_SECONDS = "dllama_compile_seconds"
PROGRAM_HBM_BYTES = "dllama_program_hbm_bytes"
PROGRAM_FLOPS = "dllama_program_flops"
RETRACE_UNEXPECTED = "dllama_retrace_unexpected_total"

# latency buckets in ms: sub-ms CPU ticks through multi-second TPU compiles
_LATENCY_BUCKETS_MS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                       500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0)

# compile wall-time buckets in SECONDS: ms-scale CPU-mesh traces through
# multi-minute cold TPU compiles of the full-model program
_COMPILE_BUCKETS_S = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                      60.0, 120.0, 300.0)


@dataclass(frozen=True)
class MetricSpec:
    name: str
    kind: str  # "counter" | "gauge" | "histogram"
    help: str
    buckets: tuple = ()


def _spec(name, kind, help, buckets=_LATENCY_BUCKETS_MS):
    if kind != "histogram":
        buckets = ()
    return MetricSpec(name, kind, help, buckets)


SPECS: dict[str, MetricSpec] = {s.name: s for s in (
    _spec(PREFILL_CHUNK_MS, "histogram",
          "Wall time of one prefill chunk dispatch"),
    _spec(PREFILL_TOKENS, "counter", "Prompt tokens prefilled"),
    _spec(DECODE_STEP_MS, "histogram",
          "Wall time of one decode dispatch (single, fused-chunk, or "
          "speculative verify)"),
    _spec(DECODE_TOKENS, "counter",
          "Tokens emitted by single-sequence decode"),
    _spec(SPEC_DRAFT_TOKENS, "counter",
          "Speculative draft tokens submitted to verify dispatches "
          "(label generator = engine | dense | paged)"),
    _spec(SPEC_ACCEPTED_TOKENS, "counter",
          "Speculative draft tokens accepted (rate = accepted / draft; "
          "label generator = engine | dense | paged)"),
    _spec(SPEC_DEGRADED, "counter",
          "Speculative steps degraded to plain decode because a "
          "proposer raised (the `draft` failpoint drives it)"),
    _spec(KV_OCCUPANCY, "gauge",
          "KV cache rows holding live context / total rows (pooled over "
          "slots in batched serving; retired slots' rows are reclaimable "
          "and do not count)"),
    _spec(HBM_NEED_BYTES, "gauge",
          "Estimated per-device HBM bytes for the loaded model"),
    _spec(HBM_LIMIT_BYTES, "gauge",
          "Reported per-device HBM limit (0 = unknown)"),
    _spec(SYNC_FRACTION, "gauge",
          "Measured collective share of decode-step device time "
          "(measure_split)"),
    _spec(SYNC_FRACTION_PREFILL, "gauge",
          "Measured collective share of a prefill chunk's device time"),
    _spec(COLLECTIVE_SENT_KB, "gauge",
          "Per-token per-device collective bytes sent, kB (from the "
          "compiled HLO)"),
    _spec(COLLECTIVE_RECV_KB, "gauge",
          "Per-token per-device collective bytes received, kB"),
    _spec(COLLECTIVE_OPS, "gauge",
          "Collective ops executed per decode step"),
    _spec(COLLECTIVE_BYTES, "counter",
          "Analytic per-device wire bytes moved by the explicit col-split "
          "partial merges, by collective op (all_reduce/ppermute) and wire "
          "format (f32/q80) — qcollectives.wire_traffic_model priced per "
          "emitted decode token (the compiled-HLO TrafficStats gauges are "
          "the exact per-program oracle)"),
    _spec(COMM_EXPOSED_MS, "gauge",
          "EXPOSED collective wall per decode step from the last profiler "
          "capture (measure_split): collective lane time not covered by "
          "concurrent compute — the quantity --comm-overlap exists to "
          "shrink; 0 until a capture ran"),
    _spec(QUEUE_WAIT_MS, "histogram",
          "Submit-to-admission wait in the batch scheduler queue"),
    _spec(QUEUE_DEPTH, "gauge", "Requests waiting for a slot"),
    _spec(BATCH_STEP_MS, "histogram",
          "Wall time of one ragged batched decode dispatch"),
    _spec(BATCH_OCCUPANCY, "gauge", "Active slots in the last batched step"),
    _spec(BATCH_SLOTS, "gauge", "Configured slot-pool size"),
    _spec(BATCH_TOKENS, "counter", "Tokens emitted by batched serving"),
    _spec(ADMISSIONS, "counter", "Requests admitted into a slot"),
    _spec(RETIRES, "counter", "Slots retired (EOS, limits, or cancel)"),
    _spec(PREFIX_REUSE_TOKENS, "counter",
          "Prompt tokens skipped via KV prefix reuse (cross-slot on the "
          "dense pool; block-level sharing + copy-on-write on the paged "
          "pool)"),
    _spec(KV_BLOCKS_TOTAL, "gauge",
          "Usable physical blocks in the paged KV pool (excludes the "
          "null block; 0 when serving runs the dense slot pool)"),
    _spec(KV_BLOCKS_USED, "gauge",
          "Paged KV blocks held by live sequences (refcount >= 1)"),
    _spec(KV_BLOCKS_SHARED, "gauge",
          "Paged KV blocks referenced by more than one live sequence "
          "(block-level prefix sharing in effect)"),
    _spec(KV_BLOCK_EXHAUSTION, "counter",
          "Block-pool exhaustion events: an admission or decode step "
          "found no free/evictable block and degraded to queueing (or "
          "failed that one request 503-shaped mid-decode), never a "
          "crash"),
    _spec(KV_BLOCKS_HOST_TOTAL, "gauge",
          "Host-tier KV mirror capacity in blocks (--kv-host-blocks "
          "through hbm.fit_host_pool; 0 = tiering off)"),
    _spec(KV_BLOCKS_HOST_USED, "gauge",
          "Host-tier blocks holding spilled cold KV (registered, "
          "page-in-able; never live/refcounted)"),
    _spec(KV_SPILL_BLOCKS, "counter",
          "Cold KV blocks spilled device->host under allocation "
          "pressure (batched block-granular copies; content survives "
          "for page-in instead of drop-evicting)"),
    _spec(KV_SPILL_BYTES, "counter",
          "Bytes of KV moved device->host by spills"),
    _spec(KV_SPILL_MS, "counter",
          "Wall ms spent dispatching spill copies (the transfers "
          "themselves run async, overlapped with decode ticks)"),
    _spec(KV_PAGEIN_BLOCKS, "counter",
          "Spilled KV blocks paged host->device at admission for "
          "resumed / prefix-matched sessions"),
    _spec(KV_PAGEIN_BYTES, "counter",
          "Bytes of KV moved host->device by page-ins"),
    _spec(KV_PAGEIN_MS, "counter",
          "Wall ms of page-in batches (also the per-request `pagein` "
          "TTFT attribution phase, dllama_ttft_attrib_ms)"),
    _spec(KVWIRE_TX_FRAMES, "counter",
          "KV-wire frames serialized and written by the export side "
          "(runtime/kvwire.py; header + per-block + end frames)"),
    _spec(KVWIRE_TX_BYTES, "counter",
          "Bytes of framed Q80 KV written by the export side (wire "
          "payload + framing + crc32 trailers)"),
    _spec(KVWIRE_TX_MS, "counter",
          "Wall ms spent encoding + writing KV-wire frames on the "
          "export side"),
    _spec(KVWIRE_RX_FRAMES, "counter",
          "KV-wire frames read and crc32-verified by the import side"),
    _spec(KVWIRE_RX_BYTES, "counter",
          "Bytes of framed Q80 KV read by the import side"),
    _spec(KVWIRE_RX_MS, "counter",
          "Wall ms spent reading + decoding KV-wire frames on the "
          "import side (the fetch thread's wall, not the loop thread's)"),
    _spec(KVWIRE_MIGRATIONS, "counter",
          "KV migrations attempted, by outcome (migrated: prefix KV "
          "fetched from the peer, scattered, and committed; fallback: "
          "any failure rolled back to ordinary chunked-prefill "
          "recompute)"),
    _spec(KVWIRE_FALLBACK, "counter",
          "KV migrations that fell back to local recompute, by reason "
          "(timeout: per-transfer deadline exceeded; crc: checksum "
          "mismatch or truncated frame; peer_death: connect/read "
          "failure or clean EOF mid-stream; exhaustion: destination "
          "block pool could not stage the blocks). A fallback is never "
          "a user-visible failure"),
    _spec(REQUESTS_SHED, "counter",
          "Requests rejected at admission because the queue was full "
          "(HTTP 429 load shedding)"),
    _spec(REQUEST_TIMEOUTS, "counter",
          "Requests cancelled because their deadline expired (queued or "
          "in-flight)"),
    _spec(SCHEDULER_CRASHES, "counter",
          "Unexpected batch-scheduler loop crashes (each fails every "
          "pending request)"),
    _spec(SCHEDULER_RESTARTS, "counter",
          "Successful batch-scheduler restarts after a crash (bounded; "
          "exhaustion marks the server unready)"),
    _spec(SERVER_DRAINING, "gauge",
          "1 while the server is draining (shutdown started, no new "
          "admissions), else 0"),
    _spec(FAILPOINTS_FIRED, "counter",
          "Fault-injection failpoint fires by name (runtime/failpoints)"),
    _spec(WEIGHT_IO_RETRIES, "counter",
          "Transient weight-read failures retried by the streaming loader "
          "(bounded backoff; exhaustion fails the load atomically)"),
    _spec(LOAD_CORRUPTION, "counter",
          "Weight tensors whose bytes failed checksum verification against "
          "the .m.sums manifest (each one fails the load, naming the "
          "tensor)"),
    _spec(WATCHDOG_STALLS, "counter",
          "Step-watchdog deadline expiries: a device dispatch exceeded the "
          "EWMA-derived budget (engine marked unhealthy, in-flight "
          "requests failed)"),
    _spec(HBM_ADMISSION_REJECTS, "counter",
          "Admissions rejected by the HBM admission guard (estimated + "
          "measured per-program bytes would exceed the device limit)"),
    _spec(NONFINITE, "counter",
          "Non-finite tripwire events by site (decode/batch/verify/"
          "prefill/canary/taps): a dispatch whose logits — or a tapped "
          "activation — contained NaN/Inf. One increment per event, not "
          "per lane"),
    _spec(CANARY_RUNS, "counter",
          "Golden-canary replays (fixed-seed prompt through the live "
          "weights; runtime/numerics.CanarySentinel)"),
    _spec(CANARY_DRIFT, "counter",
          "Canary replays whose token ids or logit fingerprint diverged "
          "from the recorded golden — a silent numerics regression; the "
          "WARN names the first divergent layer when taps are on"),
    _spec(Q80_ROUNDTRIP_ERROR, "gauge",
          "Relative RMS error of one Q80 quantize→dequantize roundtrip "
          "of the tapped activation, by site — the quantization loss the "
          "Q80 sync/wire collectives apply (parallel/qcollectives)"),
    _spec(ACTIVATION_RMS, "gauge",
          "Tapped activation rms by site (last layer for the stacked "
          "sites; --numerics-taps)"),
    _spec(ACTIVATION_ABSMAX, "gauge",
          "Tapped activation abs-max by site (max over layers)"),
    _spec(QUANT_AUDIT_MIN_SNR, "gauge",
          "Worst per-tensor Q40 roundtrip SNR (dB) from the last "
          "`dllama_tpu audit` sweep (0 until one ran; exact roundtrips "
          "excluded)"),
    _spec(QUANT_AUDIT_NONFINITE, "counter",
          "Non-finite values found in model tensors by audit sweeps "
          "(any growth means a damaged or mis-scaled tensor; the audit "
          "table names it)"),
    _spec(ROOFLINE_FRACTION, "gauge",
          "Per-program roofline fraction: max of achieved-bandwidth / "
          "ceiling-bandwidth and achieved-compute / ceiling-compute, "
          "clamped to (0, 1] (runtime/roofline joins the compile "
          "ledger's measured bytes/FLOPs with the step-histogram walls "
          "against the hw_probe or nameplate ceilings; refreshed by "
          "GET /debug/roofline, the --stats tick, and bench.py)"),
    _spec(ACHIEVED_HBM_GBPS, "gauge",
          "Per-program achieved HBM bandwidth, GB/s: measured "
          "argument+temp+output bytes per dispatch over the "
          "compile-corrected steady-state dispatch wall"),
    _spec(ACHIEVED_TFLOPS, "gauge",
          "Per-program achieved compute, TFLOP/s: measured FLOPs per "
          "dispatch over the same steady-state wall"),
    _spec(COMPILE_TOTAL, "counter",
          "XLA trace+compile events by program and engine scope "
          "(runtime/introspection ledger)"),
    _spec(COMPILE_SECONDS, "histogram",
          "Wall time of one trace+compile event, seconds (includes the "
          "triggering dispatch's first execution)",
          buckets=_COMPILE_BUCKETS_S),
    _spec(PROGRAM_HBM_BYTES, "gauge",
          "Per-program device bytes by kind (temp/output/argument/code/"
          "alias) from compiled.memory_analysis()"),
    _spec(PROGRAM_FLOPS, "gauge",
          "Per-program FLOPs per dispatch from compiled.cost_analysis()"),
    _spec(RETRACE_UNEXPECTED, "counter",
          "Recompiles observed AFTER an engine scope reached serving "
          "steady state (each is a latency cliff; the shape/plan diff is "
          "WARN-logged and kept in the /debug/compiles ledger)"),
    _spec(TTFT_ATTRIB_MS, "histogram",
          "Per-request TTFT decomposition by phase (queue: submit to "
          "admission start minus any peer-KV migration wall; kvmigrate: "
          "peer-KV fetch + scatter while parked pre-admission; pagein: "
          "host->device restore of spilled blocks; admission: admission "
          "start to decode-armed minus own prefill dispatch wall; "
          "prefill: own prefill chunk dispatch wall; first_decode: "
          "decode-armed to first emitted token). The six phases sum to "
          "wall TTFT by construction (runtime/flightrec, recorded by "
          "the generators and the single-sequence API path)"),
    _spec(ITL_ATTRIB_MS, "histogram",
          "Per-request decode-phase wall attribution by cause (step: "
          "total decode dispatch wall while the request's slot was "
          "active; preempt: other admissions' interleaved prefill-chunk "
          "wall charged to the waiting decode slots — the tick-budget "
          "preemption share of inter-token stalls). Recorded once per "
          "request at retire"),
    _spec(FLIGHT_TICKS, "counter",
          "Work-carrying scheduler ticks recorded by the flight recorder "
          "(idle ticks are dropped; gaps in the dump's tick numbering "
          "mark idle stretches)"),
    _spec(FLIGHT_DUMPS, "counter",
          "Flight-recorder postmortem dumps written, by reason "
          "(watchdog_stall / scheduler_crash / kv_block_exhaustion; "
          "rate-limited per reason)"),
    _spec(EVAL_TOKENS, "counter",
          "Teacher-forced eval positions scored by the quality "
          "observatory, by dataset and config (runtime/evalharness.py; "
          "config drawn from the EVAL_CONFIGS closed world)"),
    _spec(EVAL_NLL, "counter",
          "Summed per-token negative log-likelihood over scored eval "
          "positions, by dataset and config (perplexity = "
          "exp(nll / tokens); NLL is >= 0 per token, so the counter "
          "is monotone)"),
    _spec(EVAL_PERPLEXITY, "gauge",
          "Perplexity of the labeled dataset from the most recent eval "
          "run in this process (what tools/quality_baseline.py gates)"),
    _spec(ROUTER_REPLICA_UP, "gauge",
          "Fleet router: 1 while the labeled replica is dispatchable "
          "(probed up, not breaker-ejected, not draining), else 0"),
    _spec(ROUTER_INFLIGHT, "gauge",
          "Fleet router: requests currently proxied to the labeled "
          "replica (the router-side share of its load score)"),
    _spec(ROUTER_DISPATCHES, "counter",
          "Fleet router: completion dispatches by replica (includes "
          "retry re-dispatches)"),
    _spec(ROUTER_RETRIES, "counter",
          "Fleet router: dispatches transparently retried on a "
          "different replica after a pre-first-byte failure"),
    _spec(ROUTER_EJECTS, "counter",
          "Fleet router: circuit-breaker ejections by replica "
          "(consecutive connect/5xx failures reached the threshold)"),
    _spec(ROUTER_READMITS, "counter",
          "Fleet router: ejected replicas re-admitted by a successful "
          "half-open probe or dispatch, by replica"),
    _spec(ROUTER_SHED, "counter",
          "Fleet router: requests shed 429-shaped because the router's "
          "--max-queue in-flight bound was hit or every replica "
          "reported queue_full"),
    _spec(ROUTER_AFFINITY_HITS, "counter",
          "Fleet router: dispatches that landed on their session's "
          "sticky replica (prefix-cache-aware affinity in effect)"),
    _spec(ROUTER_AFFINITY_PURGED, "counter",
          "Fleet router: sticky affinity entries purged from the LRU "
          "because their replica was circuit-breaker-ejected, by "
          "replica (a restarted cold-cache replica must not inherit "
          "stale stickiness)"),
    _spec(ROUTER_TTFT_MS, "histogram",
          "Fleet router: time from request admission to the first "
          "upstream body byte the router relayed (router-measured TTFT "
          "— queue + dispatch + replica prefill included)"),
    _spec(ROUTER_CONNECT_MS, "histogram",
          "Fleet router: per-hop upstream connect + request-send time "
          "(one observation per dispatch attempt, retries included)"),
    _spec(ROUTER_RETRY_MS, "histogram",
          "Fleet router: wall time burned on failed hops before the "
          "serving hop (recorded once per retried request)"),
    _spec(ROUTER_RETRY_HOPS, "counter",
          "Fleet router: dispatch attempts by hop index (hop=\"0\" first "
          "attempt, hop=\"1\" retry — the same index the "
          "X-Dllama-Hop header carries to the replica)"),
    _spec(ROUTER_STREAM_RESUMES, "counter",
          "Fleet router: mid-stream failover attempts by outcome "
          "(outcome=\"resumed\" spliced continuation, \"exhausted\" "
          "--max-stream-resumes used up, \"no_budget\" no remaining "
          "request-timeout budget, \"failed\" re-dispatch itself died)"),
    _spec(ROUTER_STREAM_RESUME_MS, "histogram",
          "Fleet router: wall time from mid-stream death detection to "
          "the first continued token relayed to the client (the "
          "client-visible stall a successful resume costs)"),
    _spec(SLO_COMPLIANCE, "gauge",
          "SLO observatory: 1 while the labeled objective currently "
          "meets its target over the evaluation window, else 0 "
          "(runtime/slo.py; objectives from --slo)"),
    _spec(SLO_BURN_RATE, "gauge",
          "SLO observatory: error-budget burn rate for the labeled "
          "objective over the labeled sliding window (1.0 = burning "
          "exactly the budget; >1 exhausts it early)"),
    _spec(TENANT_PREFILL_TOKENS, "counter",
          "Prompt positions prefilled for the labeled tenant by batched "
          "serving (post-prefix-reuse — skipped positions are not "
          "charged; runtime/tenancy.py)"),
    _spec(TENANT_DECODE_TOKENS, "counter",
          "Tokens emitted to the labeled tenant's requests by batched "
          "serving (sums over tenants to dllama_batch_tokens_total for "
          "scheduler-run work — the conservation invariant the tenancy "
          "tests pin)"),
    _spec(TENANT_ADMISSIONS, "counter",
          "Requests of the labeled tenant admitted into a slot"),
    _spec(TENANT_SHED, "counter",
          "Requests of the labeled tenant shed at admission, by reason "
          "(queue_full: the shared --max-queue bound; "
          "tenant_rate_budget: the tenant's own --tenant-limits token "
          "bucket ran dry; router_queue_full: the fleet router's "
          "admission gate — both 429-shaped)"),
    _spec(TENANT_TIMEOUTS, "counter",
          "Requests of the labeled tenant cancelled by deadline expiry"),
    _spec(TENANT_OVERFLOW, "counter",
          "Tenant ids collapsed into the `other` label because the "
          "registry's LRU cardinality bound was full — a tenant-id "
          "fuzzer inflates this counter, never /metrics"),
    _spec(TENANT_KV_BLOCK_SECONDS, "counter",
          "KV residency charged to the labeled tenant, block-seconds by "
          "tier (device: blocks held by its live slots per tick — one "
          "synthetic block per slot column on the dense pool; host: "
          "spilled blocks awaiting its admissions' page-in restores)"),
    _spec(TENANT_SPEC_DRAFT_TOKENS, "counter",
          "Speculative draft tokens offered on the labeled tenant's "
          "slots (charged at retire from the per-request accounting)"),
    _spec(TENANT_SPEC_ACCEPTED_TOKENS, "counter",
          "Speculative draft tokens accepted on the labeled tenant's "
          "slots (per-tenant accept rate = accepted / draft)"),
    _spec(TENANT_QUEUE_WAIT_MS, "gauge",
          "Per-tenant submit-to-admission wait quantile estimate, ms "
          "(log-bucket streaming histogram, runtime/slo.LogHistogram; "
          "labels tenant + q in {p50,p95})"),
    _spec(TENANT_TTFT_MS, "gauge",
          "Per-tenant time-to-first-token quantile estimate, ms "
          "(labels tenant + q)"),
    _spec(TENANT_ITL_MS, "gauge",
          "Per-tenant inter-token latency quantile estimate, ms "
          "(per emit-run mean gap; labels tenant + q)"),
    _spec(TENANT_FAIRNESS_JAIN, "gauge",
          "Jain fairness index over the active tenants' weight-"
          "normalized dominant-resource shares (slot-ticks vs emitted "
          "tokens) in the trailing occupancy window — 1.0 is perfectly "
          "fair, 1/n is one tenant hogging everything"),
    _spec(TENANT_SHARE_MAX, "gauge",
          "Largest weight-normalized dominant-resource share held by "
          "any tenant over the trailing occupancy window"),
    _spec(TENANT_SHARE_MIN, "gauge",
          "Smallest weight-normalized dominant-resource share held by "
          "any active tenant over the trailing occupancy window"),
    _spec(TENANT_ACTIVE, "gauge",
          "Tenants with accounted activity in the trailing occupancy "
          "window (bounded by the registry's LRU cap)"),
    _spec(HTTP_REQUESTS, "counter",
          "HTTP requests by route and status code"),
    _spec(REQUESTS_IN_FLIGHT, "gauge", "Completions currently executing"),
    _spec(TTFT_MS, "histogram", "Time to first generated token per request"),
    _spec(ITL_MS, "histogram", "Inter-token latency between emitted tokens"),
    _spec(PROMPT_TOKENS, "counter", "Prompt tokens received over HTTP"),
    _spec(COMPLETION_TOKENS, "counter", "Completion tokens served over HTTP"),
)}


# -- metric types -------------------------------------------------------------


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _fmt_labels(key: tuple, extra: str = "") -> str:
    parts = [f'{k}="{_escape(str(v))}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    # integral values print without a trailing .0 (Prometheus-conventional)
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class _Metric:
    def __init__(self, spec: MetricSpec):
        self.spec = spec
        self._lock = threading.Lock()
        self._series: dict[tuple, object] = {}

    def _reset(self) -> None:
        with self._lock:
            self._series.clear()


class Counter(_Metric):
    """Monotonic counter; ``labels`` select an independent series."""

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def total(self, **labels) -> float:
        """Sum over every series whose labels are a superset of ``labels``
        (no labels = everything), so ``total(route="/x")`` aggregates all
        statuses of one route."""
        want = set(_label_key(labels))
        with self._lock:
            return float(sum(v for k, v in self._series.items()
                             if want <= set(k)))

    def _render(self, out: list[str]) -> None:
        with self._lock:
            items = sorted(self._series.items())
        if not items and not self.spec.buckets:
            items = [((), 0.0)]  # an unlabeled counter always renders
        for key, v in items:
            if key == () and len(items) > 1:
                continue  # labeled metric: skip the phantom unlabeled row
            out.append(f"{self.spec.name}{_fmt_labels(key)} {_fmt_value(v)}")


class Gauge(_Metric):
    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def add(self, delta: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + delta

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_label_key(labels), 0.0))

    def items(self) -> list[tuple[tuple, float]]:
        """Every ``(label_key, value)`` series, sorted — label keys are
        the ``(name, value)`` pair tuples ``value(**dict(key))`` accepts
        back. Lets the --stats line enumerate SLO objectives without
        knowing the configured set."""
        with self._lock:
            return sorted((k, float(v)) for k, v in self._series.items())

    def _render(self, out: list[str]) -> None:
        with self._lock:
            items = sorted(self._series.items()) or [((), 0.0)]
        for key, v in items:
            out.append(f"{self.spec.name}{_fmt_labels(key)} {_fmt_value(v)}")


class Histogram(_Metric):
    """Fixed-bucket histogram: per-series ``[counts..., +Inf count]`` plus
    sum and count. ``record`` is the hot-path call."""

    def record(self, value: float, **labels) -> None:
        key = _label_key(labels)
        i = bisect_left(self.spec.buckets, value)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                # [bucket counts..., overflow] , total count, total sum
                s = self._series[key] = [
                    [0] * (len(self.spec.buckets) + 1), 0, 0.0]
            s[0][i] += 1
            s[1] += 1
            s[2] += value

    def count(self, **labels) -> int:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return int(s[1]) if s else 0

    def sum(self, **labels) -> float:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return float(s[2]) if s else 0.0

    def quantile(self, q: float, **labels) -> float:
        """Bucket-upper-bound estimate of the q-quantile (0..1); 0.0 when
        empty. Good enough for the --stats one-liner, not for SLOs."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            if not s or s[1] == 0:
                return 0.0
            counts, total = list(s[0]), s[1]
        rank = q * total
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= rank and c:
                return (self.spec.buckets[i] if i < len(self.spec.buckets)
                        else self.spec.buckets[-1])
        return self.spec.buckets[-1]

    def _render(self, out: list[str]) -> None:
        with self._lock:
            items = sorted((k, (list(v[0]), v[1], v[2]))
                           for k, v in self._series.items())
        if not items:
            items = [((), ([0] * (len(self.spec.buckets) + 1), 0, 0.0))]
        name = self.spec.name
        for key, (counts, count, total) in items:
            cum = 0
            for i, bound in enumerate(self.spec.buckets):
                cum += counts[i]
                le = 'le="%s"' % _fmt_value(bound)
                out.append(f"{name}_bucket{_fmt_labels(key, le)} {cum}")
            cum += counts[-1]
            le = 'le="+Inf"'
            out.append(f"{name}_bucket{_fmt_labels(key, le)} {cum}")
            out.append(f"{name}_sum{_fmt_labels(key)} {_fmt_value(total)}")
            out.append(f"{name}_count{_fmt_labels(key)} {count}")


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Registry:
    """All metrics of one process. Metrics are created eagerly from
    :data:`SPECS` so a scrape always shows the full schema (zero-valued
    until first use); handles stay valid across :meth:`reset`."""

    def __init__(self, specs: dict[str, MetricSpec] = SPECS):
        self._metrics: dict[str, _Metric] = {
            name: _KINDS[s.kind](s) for name, s in specs.items()}

    def _get(self, name: str, kind: type) -> _Metric:
        m = self._metrics[name]  # KeyError = unregistered name, on purpose
        if not isinstance(m, kind):
            raise TypeError(f"{name} is {type(m).__name__}, not {kind.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def reset(self) -> None:
        """Zero every series (tests); metric handles stay valid."""
        for m in self._metrics.values():
            m._reset()

    def render(self) -> str:
        """Prometheus text exposition (text/plain; version=0.0.4)."""
        out: list[str] = []
        for name, m in self._metrics.items():
            out.append(f"# HELP {name} {m.spec.help}")
            out.append(f"# TYPE {name} {m.spec.kind}")
            m._render(out)
        return "\n".join(out) + "\n"


_registry = Registry()


def registry() -> Registry:
    """The process-wide default registry (what ``GET /metrics`` renders)."""
    return _registry


# -- per-request span tracing -------------------------------------------------

# The documented span-phase vocabulary — the closed world
# tools/check_span_phases.py lints against (both directions: every
# tracer().emit call site uses a name listed here, and every name here
# has a call site and a PERF.md mention):
#
# * ``queue`` — submit → admission start (batched serving).
# * ``admit`` — the paged pool's admission bookkeeping (block
#   match/share/alloc + column gather) inside ``begin_admit``.
# * ``prefill`` — admission start → decode-armed (the whole prompt
#   build, including interleave gaps).
# * ``prefill_chunk`` — one prefill chunk dispatch (nested inside
#   ``prefill``; the single-sequence engine records the same chunks as
#   flight-recorder events instead).
# * ``decode`` — decode-armed → retire (batched) or the decode loop of
#   one single-sequence completion.
# * ``verify`` — one speculative verify dispatch.
# * ``requeue`` — an instant marker: admission found no KV blocks and
#   the request went back to the queue head.
# * ``pagein`` — one host→device page-in batch restoring a resumed
#   session's spilled KV blocks during admission (the KV tier,
#   runtime/kvblocks.py; also a TTFT attribution phase).
# * ``kvmigrate`` — one peer-KV migration attempt: fetch start → staged
#   blocks committed (or rolled back to recompute) on the destination
#   (runtime/kvwire.py + the serving import path; also a TTFT
#   attribution phase).
# * ``eval`` — one teacher-forced eval sequence scored end to end by the
#   quality observatory (runtime/evalharness.py): admission → final NLL
#   chunk when riding the batch scheduler, or the engine oracle's
#   chunked ``prefill_nll`` loop in the single-sequence path.
PHASES = ("queue", "admit", "prefill", "prefill_chunk", "decode", "verify",
          "requeue", "pagein", "kvmigrate", "eval")

# The closed-world eval config vocabulary (tools/check_eval_names.py
# lints it both directions): the ``eval --compare`` CLI grammar, the
# parity keys in QUALITY_BASELINE.json, and the ``config`` label on
# dllama_eval_* series all draw from exactly this set.
#
# * ``single`` — the single-sequence engine oracle: chunked
#   ``prefill_nll`` dispatches via InferenceEngine.score_nll, no
#   scheduler.
# * ``dense`` — eval sequences admitted through BatchScheduler over the
#   dense slot-pool generator as continuous-batching work.
# * ``paged`` — same, over the paged block-pool generator
#   (PagedGenerator), speculation off.
# * ``paged_spec`` — ``paged`` with speculative serving armed; eval
#   sequences never decode, so spec-on greedy must match spec-off
#   bit for bit.
EVAL_CONFIGS = ("single", "dense", "paged", "paged_spec")

# Exact-parity pairs: each (config, reference) pair must produce
# BIT-IDENTICAL total NLL — same jitted prefill_nll program, same chunk
# boundaries, same zero padding, same summation order. A mismatch is
# parity drift, not a quality tradeoff.
EVAL_PARITY = (("dense", "single"), ("paged", "single"),
               ("paged_spec", "paged"))

# Router span vocabulary (serve/router.py RouterSpanRing.emit_span) — the
# fleet-side counterpart of PHASES, closed-world-checked the same way
# (tools/dlint span-phases). One request's router-side life:
#
# * ``rt_queue`` — request receipt → admission decision (the router's
#   own in-flight gate; shed requests end here).
# * ``rt_dispatch`` — the dispatch decision: replica pick with the
#   probe snapshot (load score, state) that justified it.
# * ``rt_connect`` — one hop's connect + request send → response
#   headers (per dispatch attempt; a retried request has two).
# * ``rt_first_byte`` — admission → the first upstream body byte the
#   router relayed (the router-measured TTFT span).
# * ``rt_stream`` — first relayed byte → last (the body/SSE relay of
#   the serving hop).
# * ``rt_retry`` — one failed hop, dispatch → classified failure (the
#   wall the retry burned before the serving hop).
# * ``rt_eject`` — an instant marker: the circuit breaker ejected the
#   replica this request just failed on.
# * ``rt_prefill`` — one synchronous warm-up completion on a
#   ``--role prefill`` replica before the decode dispatch
#   (prefill/decode disaggregation; failures are spanned too — the
#   dispatch then proceeds without a donor).
# * ``rt_kv_donor`` — an instant marker: the dispatch carried an
#   ``X-Dllama-KV-Peer`` pointer naming the replica the decode side
#   should pull its prefix KV from (runtime/kvwire).
# * ``rt_resume`` — one mid-stream failover: death detection → the
#   first continued token relayed (detect / re-dispatch / first-token
#   attribution rides in the span's extra fields).
ROUTER_PHASES = ("rt_queue", "rt_dispatch", "rt_connect", "rt_first_byte",
                 "rt_stream", "rt_retry", "rt_eject", "rt_prefill",
                 "rt_kv_donor", "rt_resume")


class SpanTracer:
    """JSONL span sink + bounded in-memory span ring. One record per
    completed span:

    ``{"request_id": int, "phase": <one of PHASES>,
       "start_ns": int, "end_ns": int, "slot": int, "n_tokens": int}``

    plus optional ``fleet``/``hop`` fields when the request arrived
    through the fleet router (:meth:`bind_fleet`).

    Timestamps are ``time.monotonic_ns`` (durations, not wall clock).
    The file sink is opt-in (``--trace-out``; ``enabled`` is one attribute
    read for per-dispatch call sites). The ring is ALWAYS on — request-level
    spans arrive a few times per request, so keeping the last ``RING_SPANS``
    of them costs one dict + deque append each and gives ``GET
    /debug/requests`` a phase timeline without any operator setup.
    """

    RING_SPANS = 512

    def __init__(self):
        self._lock = threading.Lock()
        self._f = None
        self.enabled = False
        self._ring: deque = deque(maxlen=self.RING_SPANS)
        # engine-local int rid -> (fleet request id, dispatch hop): the
        # X-Dllama-Request-Id binding the API layer registers so every
        # span for that request carries the fleet-wide join key
        self._fleet: dict[int, tuple[str, int]] = {}
        # engine-local int rid -> sanitized tenant id (X-Dllama-Tenant):
        # same registration point, same bound, so spans and --trace-out
        # JSONL attribute every phase to the tenant it served
        self._tenant: dict[int, str] = {}

    def bind_fleet(self, request_id: int, fleet_id: str,
                   hop: int = 0) -> None:
        """Bind an engine-local integer request id to the fleet-wide
        request id (the router's ``X-Dllama-Request-Id``) and the
        dispatch hop that delivered it. Every span subsequently emitted
        for that id — the ring, ``--trace-out`` JSONL, ``/debug/flight``
        ``spans`` — then carries ``fleet``/``hop`` fields, the join key
        ``flightrec.fleet_chrome_trace`` groups cross-tier tracks by."""
        with self._lock:
            self._fleet[int(request_id)] = (str(fleet_id), int(hop))
            while len(self._fleet) > self.RING_SPANS * 8:
                # dicts iterate in insertion order: drop the oldest binding
                self._fleet.pop(next(iter(self._fleet)))

    def bind_tenant(self, request_id: int, tenant: str) -> None:
        """Bind an engine-local integer request id to its sanitized
        tenant id (the api layer's ``X-Dllama-Tenant`` parse). Spans
        emitted for that id then carry a ``tenant`` field — the ring,
        ``--trace-out`` JSONL, and ``/debug/flight`` ``spans`` alike —
        so cross-tier timelines stay attributable per caller."""
        with self._lock:
            self._tenant[int(request_id)] = str(tenant)
            while len(self._tenant) > self.RING_SPANS * 8:
                self._tenant.pop(next(iter(self._tenant)))

    def configure(self, path: str | None) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None
            if path:
                self._f = open(path, "a", encoding="utf-8")
            self.enabled = self._f is not None

    def emit(self, request_id: int, phase: str, start_ns: int, end_ns: int,
             *, slot: int = -1, n_tokens: int = 0) -> None:
        rec = {"request_id": request_id, "phase": phase,
               "start_ns": start_ns, "end_ns": end_ns,
               "slot": slot, "n_tokens": n_tokens}
        with self._lock:
            bound = self._fleet.get(request_id)
            if bound is not None:
                rec["fleet"], rec["hop"] = bound
            ten = self._tenant.get(request_id)
            if ten is not None:
                rec["tenant"] = ten
            self._ring.append(rec)
            if self._f is not None:
                self._f.write(json.dumps(rec) + "\n")
                self._f.flush()

    def raw_spans(self) -> list[dict]:
        """The span ring's raw records, oldest first — absolute
        ``start_ns``/``end_ns`` preserved so the flight recorder's
        Chrome-trace export can place them against tick timestamps
        (``recent_requests`` rebases to per-request ms and loses that)."""
        with self._lock:
            return [dict(s) for s in self._ring]

    def recent_requests(self, limit: int = 64) -> list[dict]:
        """Most-recent per-request phase timelines from the span ring
        (``GET /debug/requests``), newest first. Request ids are per
        engine/scheduler counters, so two engines in one process can
        collide on an id — a best-effort debug view, not an audit log."""
        with self._lock:
            spans = list(self._ring)
        by_rid: dict[int, list[dict]] = {}
        order: list[int] = []
        for s in spans:
            rid = s["request_id"]
            if rid not in by_rid:
                by_rid[rid] = []
                order.append(rid)
            by_rid[rid].append(s)
        out = []
        for rid in reversed(order[-limit:]):
            ss = by_rid[rid]
            t0 = min(s["start_ns"] for s in ss)
            t1 = max(s["end_ns"] for s in ss)
            out.append({
                "request_id": rid,
                "total_ms": (t1 - t0) / 1e6,
                "phases": [{"phase": s["phase"],
                            "start_ms": (s["start_ns"] - t0) / 1e6,
                            "ms": (s["end_ns"] - s["start_ns"]) / 1e6,
                            "slot": s["slot"],
                            "n_tokens": s["n_tokens"]} for s in ss],
            })
        return out


_tracer = SpanTracer()


def tracer() -> SpanTracer:
    return _tracer


def now_ns() -> int:
    return time.monotonic_ns()


# -- request-level timing helper (HTTP layer) ---------------------------------


class RequestTimer:
    """TTFT / inter-token-latency recorder for one completion: call
    :meth:`token` per emitted token, :meth:`done` once at the end."""

    def __init__(self, reg: Registry | None = None):
        self._reg = reg or registry()
        self._t0 = time.monotonic_ns()
        self._last: int | None = None
        # first-token stamp (monotonic ns; None until one arrived) — the
        # single-sequence TTFT-attribution path reads it
        self.first_ns: int | None = None

    def token(self) -> None:
        now = time.monotonic_ns()
        if self._last is None:
            self.first_ns = now
            self._reg.histogram(TTFT_MS).record((now - self._t0) / 1e6)
        else:
            self._reg.histogram(ITL_MS).record((now - self._last) / 1e6)
        self._last = now

    def done(self, prompt_tokens: int, completion_tokens: int) -> None:
        self._reg.counter(PROMPT_TOKENS).inc(prompt_tokens)
        self._reg.counter(COMPLETION_TOKENS).inc(completion_tokens)


def stats_line(reg: Registry | None = None, *,
               window_tokens: float | None = None,
               window_s: float | None = None) -> str:
    """One-line operator summary (the ``--stats`` periodic print) — the
    serving-era analogue of the reference's per-token console line."""
    reg = reg or registry()
    ttft = reg.histogram(TTFT_MS)
    itl = reg.histogram(ITL_MS)
    # reqs = completions only — /metrics scrapes and health probes are
    # monitoring self-traffic and would otherwise read as inference load
    n_reqs = reg.counter(HTTP_REQUESTS).total(route="/v1/chat/completions")
    parts = [
        f"reqs={int(n_reqs)}",
        f"inflight={int(reg.gauge(REQUESTS_IN_FLIGHT).value())}",
        f"queue={int(reg.gauge(QUEUE_DEPTH).value())}",
        f"occ={int(reg.gauge(BATCH_OCCUPANCY).value())}"
        f"/{int(reg.gauge(BATCH_SLOTS).value())}",
        f"kv={reg.gauge(KV_OCCUPANCY).value():.2f}",
    ]
    # paged block pool (--kv-block-size): used/total + shared — otherwise
    # the paged path is invisible between Prometheus scrapes
    n_blocks = reg.gauge(KV_BLOCKS_TOTAL).value()
    if n_blocks:
        parts.append(f"blocks={int(reg.gauge(KV_BLOCKS_USED).value())}"
                     f"/{int(n_blocks)}")
        parts.append(f"shared={int(reg.gauge(KV_BLOCKS_SHARED).value())}")
    if window_tokens is not None and window_s:
        parts.append(f"tok/s={window_tokens / window_s:.1f}")
    # speculative serving: accept rate over all generators + the running
    # draft spend — invisible between Prometheus scrapes otherwise
    n_draft = reg.counter(SPEC_DRAFT_TOKENS).total()
    if n_draft:
        n_acc = reg.counter(SPEC_ACCEPTED_TOKENS).total()
        parts.append(f"spec={100 * n_acc / n_draft:.0f}%/{int(n_draft)}")
    parts.append(f"ttft_p50={ttft.quantile(0.5):.0f}ms")
    parts.append(f"itl_p50={itl.quantile(0.5):.0f}ms")
    # SLO observatory (runtime/slo): per-objective compliance + the worst
    # burn rate across windows, only when --slo armed an evaluator (the
    # gauges stay unset otherwise and the fragment disappears)
    slo_g = reg.gauge(SLO_COMPLIANCE)
    slo_keys = sorted(k for k, _ in slo_g.items())
    if slo_keys:
        burn_g = reg.gauge(SLO_BURN_RATE)
        worst = max((v for _, v in burn_g.items()), default=0.0)
        marks = "".join("✓" if slo_g.value(**dict(k)) >= 1.0 else "✗"
                        for k in slo_keys)
        parts.append(f"slo={marks} burn={worst:.2f}"
                     + ("!" if worst > 1.0 else ""))
    # tenant observatory (runtime/tenancy): active-tenant count + the
    # windowed Jain fairness index — the fragment appears only once the
    # fairness window saw occupancy, so a server that never ran tenant
    # accounting keeps its old stats line verbatim
    n_tenants = reg.gauge(TENANT_ACTIVE).value()
    if n_tenants:
        parts.append(f"tenants={int(n_tenants)} "
                     f"fair={reg.gauge(TENANT_FAIRNESS_JAIN).value():.2f}")
    # TTFT attribution p50s (runtime/flightrec): where first-token time
    # actually went — queue / admission / prefill / first decode
    attrib = reg.histogram(TTFT_ATTRIB_MS)
    if attrib.count(phase="first_decode"):
        parts.append("ttft[q/a/p/d]=" + "/".join(
            f"{attrib.quantile(0.5, phase=ph):.0f}"
            for ph in ("queue", "admission", "prefill", "first_decode"))
            + "ms")
    # roofline observatory (runtime/roofline): the dominant decode program's
    # achieved-against-ceiling fraction, refreshing its gauges. Global
    # registry only: the observatory joins the process-wide ledger and
    # histograms, which say nothing about a caller's private registry
    if reg is registry():
        from . import roofline

        frac = roofline.stats_fraction()
        if frac is not None:
            parts.append(f"roofline={100 * frac:.1f}%")
    sync = reg.gauge(SYNC_FRACTION).value()
    sent = reg.gauge(COLLECTIVE_SENT_KB).value()
    if sync or sent:
        parts.append(f"sync={100 * sync:.1f}%")
        parts.append(f"sent={sent:.1f}kB/tok")
    # compile-layer health (runtime/introspection): total compiles, and the
    # retrace sentinel's count when it ever fired (a steady-state server
    # should show a stable compile count and no retrace= at all)
    n_compiles = reg.counter(COMPILE_TOTAL).total()
    if n_compiles:
        parts.append(f"compiles={int(n_compiles)}")
    n_retrace = reg.counter(RETRACE_UNEXPECTED).total()
    if n_retrace:
        parts.append(f"retrace={int(n_retrace)}!")
    # numerics alarms (runtime/numerics): same `=N!` convention as retrace —
    # a steady healthy server never shows either marker
    n_nonfinite = reg.counter(NONFINITE).total()
    if n_nonfinite:
        parts.append(f"nonfinite={int(n_nonfinite)}!")
    n_drift = reg.counter(CANARY_DRIFT).total()
    if n_drift:
        parts.append(f"drift={int(n_drift)}!")
    return "📈 " + " ".join(parts)
