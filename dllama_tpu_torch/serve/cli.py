"""``python -m dllama_tpu_torch inference|chat|perplexity|api|verify|timeline|eval|audit|
router|fleettrace`` (the port of the JAX package's ``serve/cli.py``
``make_engine``/``main``, these ten modes).

``router --replica URL [--replica URL ...]`` is the fleet tier
(``serve/router.py``): health-probed least-loaded dispatch with session
affinity over ``api`` replicas, a circuit breaker, retries, shedding,
mid-stream resume (``--max-stream-resumes``) and the SLO observatory
(``--slo``). Host only: no model, no device, no CUDA context.
``fleettrace --router-dump F --replica-dump NAME=F ...`` joins a saved
router ``/debug/fleet`` body and the replicas' ``/debug/flight`` bodies
into one Chrome trace, validated (rc 1 on malformed or unjoinable input).

``eval --data d.jsonl [--json] [--compare CONFIG]`` scores a dataset
teacher-forced through the serving stack (``runtime/evalharness.py``) in
the config the serving flags imply — ``single`` (the engine), ``dense``
(``--batch-slots N``), ``paged`` (``--batch-slots N --kv-block-size B``) or
``paged_spec`` (with ``--spec-lookup K``) — and with ``--compare`` once more
under a second config, whose total NLL must equal the first bit for bit
(rc 1 on parity drift; a mid-run abort prints the partial JSON, rc 1).

``audit --model m.m [--audit-json]`` is the offline per-tensor quant-error
audit (``runtime/numerics.py``), on the host alone: rc 1 when a tensor holds
non-finite values.

``verify --model m.m [--write]`` checks every tensor of a model against its
``.m.sums`` checksum manifest (or writes the manifest with ``--write``) on
the host alone: rc 0 clean, 1 corrupt or unreadable, 2 no manifest.

``timeline --dump f.json [--out t.json]`` converts a flight-recorder dump
(a postmortem file or a saved ``GET /debug/flight`` body) into a
Perfetto-loadable Chrome trace, validated, on the host alone: rc 0 valid,
1 missing, malformed or invalid.

``api`` serves one sequence with message-prefix reuse (no
``--batch-slots``), or continuous batching over the dense slot pool
(``--batch-slots N``) or the paged block pool (``--batch-slots N
--kv-block-size B``); ``--stats SEC`` prints a telemetry line every SEC
seconds. ``--trace-out FILE`` appends every request's phase spans as JSONL
(every mode). ``chat`` is the interactive REPL.

Runs on ``cuda`` unless ``--device cpu`` is given; asking for CUDA without a
usable GPU fails with a clear error. On the card each decode step is one
replay of a captured CUDA graph; ``--decode-chunk K`` decodes ``K`` tokens
per dispatch with one readback (``inference`` and the dense slot pool);
``--spec-lookup K`` verifies K drafts from the token history per dispatch
(greedy ``inference``, ``api`` and ``chat``; every slot of the paged pool,
the greedy slots of the dense one), a replayed graph too. ``--sp N`` splits
the KV cache along the sequence over ``N`` visible CUDA devices (ring
attention for prefill, a flash-decoding merge for decode; ``[cpu] * N``
under ``--device cpu``); ``--tp N`` splits every matmul weight and the KV
cache's heads over ``N`` (the reference's nodes; without it the JAX rule
picks the largest power of two of the visible cards the model takes, 1 on
the CPU), for ``inference``, ``perplexity``, ``chat``, ``eval``'s single
config and the paged ``api``, MoE files (their expert stacks cut over the
expert hidden axis) and turbo planes included. ``--kv-dtype f8`` stores the KV cache as float8
e4m3, ``--weight-mode f32|bf16`` loads dense dequantized weights,
``--nbatches N`` pins the prefill chunk, ``--quant-mode
auto|exact|fast|turbo|turbo16`` picks the quantized matmuls' numerics (to
every engine the CLI builds, ``eval``'s and ``api``'s included; the banner
prints the resolved mode), ``--host-sampling`` samples on the
host from downloaded logits, ``--verify-weights`` crc-checks the whole file
before anything is staged. ``--numerics-taps`` collects per-layer
activation stats on prefill and canary forwards, ``--numerics-failfast``
fails a request whose decode logits turn non-finite (the tripwire always
counts them), and ``api --canary-interval SEC`` replays a fixed-seed canary
prompt against its golden. ``--profile DIR`` writes a ``torch.profiler``
trace of an ``inference``, ``perplexity`` or ``chat`` run, and
``--profile-split`` prints the per-token Eval/Sync split of the tp merges
and their traffic (``runtime/profiling.py``); ``inference`` prints the
decode rate's ``roofline:`` share of the card's HBM ceiling. Modes and
flags of the JAX CLI that are not ported yet fail loudly instead of being
ignored; the reference's executor
and network flags ``--nthreads``, ``--workers`` and ``--net-turbo`` are
accepted and ignored, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from typing import TYPE_CHECKING

from ..formats.quants import F32, Q80
from ..tokenizer.chat import ChatItem, ChatTemplateType

if TYPE_CHECKING:
    # imported where an engine is built: the host-only modes (router,
    # fleettrace, timeline, verify, audit) never load torch
    from ..runtime.engine import InferenceEngine

PORTED_MODES = ("inference", "chat", "perplexity", "api", "verify", "timeline", "eval",
                "audit", "router", "fleettrace")
# modes of the JAX CLI that later slices of the port bring over
PENDING_MODES = ("worker",)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dllama-tpu-torch",
        description="Q40 Llama/Qwen3 inference on one NVIDIA GPU (PyTorch + CUDA)")
    p.add_argument("mode", help="inference | chat | perplexity | api | verify | timeline | "
                                "eval | audit | router | fleettrace")
    p.add_argument("--model", default=None,
                   help=".m model file (every mode but timeline)")
    p.add_argument("--tokenizer", default=None,
                   help=".t tokenizer file (every mode but verify, timeline and audit; "
                        "optional for eval over token-id datasets)")
    p.add_argument("--verify-weights", action="store_true",
                   help="crc-verify every weight tensor against the .m.sums "
                        "checksum manifest before any device staging (the "
                        "loader always verifies tensors it reads when a "
                        "manifest exists; this forces the full offline "
                        "sweep first). See also the 'verify' mode")
    p.add_argument("--write", action="store_true",
                   help="verify mode: (re)generate the .m.sums checksum "
                        "manifest for --model instead of checking it — the "
                        "migration path for models converted before "
                        "manifests existed")
    p.add_argument("--prompt", default=None)
    p.add_argument("--file", default=None, help="text file (perplexity mode)")
    p.add_argument("--steps", type=int, default=0, help="max total positions")
    p.add_argument("--max-seq-len", type=int, default=0)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--topp", type=float, default=0.9)
    p.add_argument("--chat-template", default=None,
                   choices=["llama2", "llama3", "deepSeek3", "chatml"],
                   help="chat/api: force the chat template family instead of "
                        "detecting it from the tokenizer")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--buffer-float-type", choices=["f32", "q80"], default="q80",
                   help="sync buffer type: q80 fake-quantizes activations at "
                        "the reference's sync points")
    p.add_argument("--weight-mode",
                   choices=["auto", "f32", "bf16", "offload"], default="auto",
                   help="auto: Q40 planes resident on device; f32/bf16: "
                        "dequantized dense; offload: Q40 planes in host DRAM, "
                        "streamed per layer during forward (not ported)")
    p.add_argument("--compute-dtype", choices=["f32", "bf16"], default="f32",
                   help="f32 = exact Q40 numerics (golden parity); bf16 = fast")
    p.add_argument("--quant-mode",
                   choices=["auto", "exact", "fast", "turbo", "turbo16"], default="auto",
                   help="quantized-matmul numerics (ops/linear.py): exact = f32 dequant "
                        "and f32 sums (golden parity); fast = bf16 dequant, bf16 "
                        "operands, f32 sums; turbo/turbo16 = per-column int8 planes "
                        "with the scales in the epilogue (ops/turbo.py; turbo also "
                        "row-quantizes activations to int8 for an integer dot); auto = "
                        "fast iff --compute-dtype bf16")
    p.add_argument("--kv-dtype", choices=["auto", "f32", "bf16", "f8"], default="auto",
                   help="KV cache dtype (auto = compute dtype). f8 "
                        "(float8_e4m3) halves bf16's cache footprint and "
                        "read bandwidth — long-context decode is "
                        "KV-bandwidth-bound")
    p.add_argument("--nbatches", type=int, default=None,
                   help="pin a fixed prefill chunk size (reference default "
                        "32, app.cpp:28); unset = adaptive buckets "
                        "(engine.PREFILL_BUCKETS)")
    p.add_argument("--host-sampling", action="store_true",
                   help="sample on host from downloaded logits (parity oracle) "
                        "instead of the fused on-device sampler")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain versions)")
    p.add_argument("--tp", type=int, default=None,
                   help="tensor-parallel device count (reference: number of nodes)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel device count (ring attention; "
                        "long-context — no reference equivalent)")
    p.add_argument("--decode-chunk", type=int, default=1, metavar="K",
                   help="fuse K decode steps into one dispatch (tokens feed "
                        "back on device; output identical to K=1, EOS "
                        "overshoot discarded). Cuts per-token dispatch "
                        "overhead; streaming granularity becomes K tokens")
    p.add_argument("--spec-lookup", type=int, default=0, metavar="K",
                   help="prompt-lookup speculative decode (greedy only): "
                        "verify K history-drafted tokens per dispatch; "
                        "output identical to plain greedy, accepted drafts "
                        "multiply decode throughput (HBM cost of a verify "
                        "is one decode step)")
    # api mode
    p.add_argument("--batch-slots", type=int, default=0,
                   help="api: concurrent sequences of continuous batching "
                        "(0 or 1: the single-sequence server)")
    p.add_argument("--kv-block-size", type=int, default=0,
                   help="api: rows per paged KV block (a power of two)")
    p.add_argument("--kv-host-blocks", type=int, default=0, metavar="N",
                   help="api with --kv-block-size: tiered KV memory — a host-DRAM mirror "
                        "pool of up to N blocks (page-locked on the card). Under "
                        "allocation pressure cold cached blocks (idle sessions' KV) spill "
                        "device->host in batched block copies instead of dropping; a "
                        "resumed, prefix-matched session pages them back in at admission, "
                        "bit-exact. Sized against the host DRAM budget "
                        "(runtime/hbm.py fit_host_pool; DLLAMA_HOST_KV_BYTES overrides). "
                        "0 (the default) = tiering off")
    p.add_argument("--max-queue", type=int, default=0,
                   help="api: waiting requests beyond the slots (429 beyond; 0 = unbounded); "
                        "router: requests in flight (429 beyond)")
    p.add_argument("--host", default="127.0.0.1", help="api/router: bind address")
    p.add_argument("--port", type=int, default=9990, help="api/router: port (0 = any free)")
    p.add_argument("--request-timeout", type=float, default=0.0,
                   help="api: default per-request deadline in seconds (0 = none); "
                        "router: the deadline a stream resume must fit inside")
    p.add_argument("--role", choices=("prefill", "decode"), default=None,
                   help="api, batched paged serving: disaggregation tag advertised on "
                        "/readyz. The fleet router keeps 'prefill' replicas out of the "
                        "decode dispatch pool and uses them to compute prompt KV that "
                        "decode replicas pull over the checksummed Q80 wire (POST "
                        "/v1/kv/export) instead of recomputing")
    p.add_argument("--tenant-limits", default=None, metavar="SPEC",
                   help="api, batched serving: per-tenant fair-share limits — a JSON "
                        "object (inline or a file path) mapping tenant ids (or '*' for "
                        "the default) to {weight, max_slots, tokens_per_s}. Admission "
                        "drains per-tenant FIFOs by weighted round-robin; a tenant at "
                        "max_slots is skipped (others keep admitting), one over its "
                        "token rate is shed with its own HTTP 429 (runtime/tenancy.py; "
                        "identity from the X-Dllama-Tenant header, absent → anon)")
    p.add_argument("--usage-ledger", default=None, metavar="FILE",
                   help="api: append periodic per-tenant usage snapshots (monotonic "
                        "cumulative totals — tokens, sheds, KV block-seconds) to FILE "
                        "as JSONL; diff any two lines for an interval's usage (GET "
                        "/debug/tenants serves the live view)")
    # router mode (serve/router.py)
    p.add_argument("--replica", action="append", default=None, metavar="URL",
                   help="router: one api-server replica base URL (http://host:port; "
                        "repeat the flag per replica). The router probes each "
                        "replica's /readyz + /metrics and dispatches least-loaded "
                        "with session affinity")
    p.add_argument("--probe-interval", type=float, default=2.0, metavar="SEC",
                   help="router: health-probe interval per replica (jittered ±20%%)")
    p.add_argument("--max-stream-resumes", type=int, default=1, metavar="N",
                   help="router: how many mid-stream replica deaths one streaming "
                        "request may survive — each death re-dispatches the stream to "
                        "a healthy replica as a token-exact spliced continuation (0 = "
                        "the first death is the terminal SSE 502). Batched replicas "
                        "(--batch-slots) stamp their chunks with token indices to "
                        "make the splice exactly-once; unstamped streams keep the "
                        "terminal-502 contract")
    p.add_argument("--slo", default=None, metavar="SPEC",
                   help="router: declarative serving objectives — "
                        "'ttft_p95_ms=500,itl_p50_ms=40,shed_rate=0.01' or the path of "
                        "a JSON file mapping objective names to thresholds. Compliance "
                        "+ error-budget burn rates at GET /debug/slo, the "
                        "dllama_slo_compliance / dllama_slo_burn_rate gauges, and an "
                        "slo fragment in --stats (runtime/slo.py)")
    p.add_argument("--drain-timeout", type=float, default=5.0, metavar="SEC",
                   help="api: on SIGTERM or shutdown, stop admitting and let active "
                        "requests finish for up to SEC seconds before failing the rest")
    p.add_argument("--stats", type=float, default=0.0, metavar="SEC",
                   help="api: print a one-line telemetry summary every SEC seconds "
                        "(requests, in-flight, queue depth, batch/KV occupancy, tok/s, "
                        "ttft/itl p50)")
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="append per-request phase spans (queue/admit/prefill/decode/"
                        "verify) as JSONL to FILE (runtime.telemetry.SpanTracer)")
    # numerics observatory (runtime/numerics.py)
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="inference/perplexity/chat: write a torch.profiler trace (Chrome "
                        "JSON, CPU and CUDA activities) of the run to DIR (load it in "
                        "ui.perfetto.dev; runtime/profiling.py op_attribution reads it)")
    p.add_argument("--profile-split", action="store_true",
                   help="measure and print the per-token Eval/Sync split and the tp "
                        "merges' Sent/Recv traffic (the reference's per-token metrics, "
                        "dllama.cpp:59-67): one short profiler capture of scratch steps "
                        "classifies the merges' device time as sync; 0 at --tp 1")
    p.add_argument("--numerics-taps", action="store_true",
                   help="collect per-layer activation stats (rms/abs-max/non-finite "
                        "count/Q80 roundtrip error per block site) on prefill and "
                        "canary forwards (surfaced via /debug/numerics and "
                        "dllama_activation_* gauges); off by default")
    p.add_argument("--numerics-failfast", action="store_true",
                   help="turn the always-on non-finite logits tripwire into "
                        "fail-fast: a poisoned request dies with an explicit numerics "
                        "error naming the site instead of emitting garbage tokens; "
                        "default counts dllama_nonfinite_total only")
    p.add_argument("--canary-interval", type=float, default=0.0, metavar="SEC",
                   help="api: replay a fixed-seed canary prompt every SEC seconds and "
                        "compare token ids + a logit fingerprint against the golden "
                        "recorded at startup (drift → dllama_canary_drift_total, the "
                        "warning names the first divergent layer with "
                        "--numerics-taps); 0 = off")
    # audit mode
    p.add_argument("--audit-json", action="store_true",
                   help="audit: print the per-tensor table as one JSON object")
    # eval mode (runtime/evalharness.py)
    p.add_argument("--data", default=None, metavar="FILE.jsonl",
                   help="eval: the teacher-forced dataset — one JSON object per line "
                        "with 'tokens' (token-id list) or 'text' (tokenized with "
                        "--tokenizer), plus an optional 'id'")
    p.add_argument("--compare", default=None, metavar="CONFIG",
                   choices=["single", "dense", "paged", "paged_spec"],
                   help="eval: also score the dataset under CONFIG and require its "
                        "total NLL to equal the primary run's bit for bit (exit 1 on "
                        "parity drift)")
    p.add_argument("--json", action="store_true",
                   help="eval: print the run summary as one JSON line")
    # timeline mode
    p.add_argument("--dump", default=None, metavar="FILE",
                   help="timeline: the flight-recorder JSON to convert (a "
                        "dllama-flight-*.json postmortem or a saved GET /debug/flight "
                        "body)")
    p.add_argument("--out", default=None, metavar="FILE",
                   help="timeline/fleettrace: write the Chrome trace-event JSON here "
                        "(default: stdout); load it in ui.perfetto.dev or "
                        "chrome://tracing")
    # fleettrace mode
    p.add_argument("--router-dump", default=None, metavar="FILE",
                   help="fleettrace: a saved GET /debug/fleet body (the router's probe "
                        "+ span snapshot)")
    p.add_argument("--replica-dump", action="append", default=None, metavar="NAME=FILE",
                   help="fleettrace: one replica's saved GET /debug/flight body, "
                        "labeled with the replica name (repeat the flag per replica); "
                        "bare FILE uses the filename stem as the track name")
    # accepted for reference-flag compatibility and ignored, as the JAX CLI
    # does: the reference's executor threads and worker network
    p.add_argument("--nthreads", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--workers", nargs="*", default=None, help=argparse.SUPPRESS)
    p.add_argument("--net-turbo", type=int, default=None, help=argparse.SUPPRESS)
    return p


def start_stats_reporter(interval: float) -> threading.Thread:
    """Daemon thread printing one telemetry summary line every ``interval``
    seconds (``--stats``) until its ``stop`` event is set. Tok/s is the
    per-step emission counters' delta over the window (batched and
    single-sequence decode)."""
    from ..runtime import telemetry

    reg = telemetry.registry()
    stop = threading.Event()

    def emitted() -> float:
        return (reg.counter(telemetry.BATCH_TOKENS).total()
                + reg.counter(telemetry.DECODE_TOKENS).total())

    def loop() -> None:
        prev = emitted()
        while not stop.wait(interval):
            cur = emitted()
            print(telemetry.stats_line(reg, window_tokens=cur - prev, window_s=interval),
                  flush=True)
            prev = cur

    t = threading.Thread(target=loop, daemon=True, name="dllama-stats")
    t.stop = stop
    t.start()
    return t


def run_timeline(args) -> int:
    """``timeline --dump flight.json [--out t.json]``: a flight-recorder
    dump (a postmortem or a saved ``GET /debug/flight`` body) to
    Perfetto-loadable Chrome trace-event JSON, with the structural
    validation (per-track monotonic timestamps, complete request flows).
    Host only. rc 0 valid, 1 unreadable, malformed or invalid."""
    from ..runtime import flightrec

    if not args.dump:
        raise SystemExit("--dump FILE (a flight-recorder dump, or a saved GET "
                         "/debug/flight body) is required for timeline mode")
    try:
        with open(args.dump, encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError) as e:
        print(f"❌ {args.dump}: {e}")
        return 1
    if not isinstance(data, dict):
        print(f"❌ {args.dump}: not a flight-recorder dump (expected a JSON object, "
              f"got {type(data).__name__})")
        return 1
    try:
        trace = flightrec.to_chrome_trace(data)
        problems = flightrec.validate_chrome_trace(trace)
    except (KeyError, TypeError, AttributeError) as e:
        # a truncated or hand-edited dump fails with a name, not a traceback
        print(f"❌ {args.dump}: malformed flight dump ({type(e).__name__}: {e})")
        return 1
    payload = json.dumps(trace)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(payload)
        print(f"🧾 {len(trace['traceEvents'])} trace events "
              f"({len(data.get('ticks') or [])} ticks, {len(data.get('spans') or [])} "
              f"spans) → {args.out} — load in ui.perfetto.dev or chrome://tracing")
    else:
        print(payload)
    for prob in problems:
        print(f"⚠️ {prob}", file=sys.stderr)
    return 1 if problems else 0


def run_fleettrace(args) -> int:
    """``fleettrace --router-dump F --replica-dump name=F ...``: the offline
    joiner from a saved router ``GET /debug/fleet`` body plus per-replica
    ``GET /debug/flight`` bodies to one fleet-wide Chrome trace — a router
    track and one track per replica, requests joined across tiers by the
    ``X-Dllama-Request-Id`` fleet id (one flow per request; a resumed
    request's flow crosses two replica tracks). Host only. rc 1 on
    malformed input or when nothing joins."""
    import os

    from ..runtime import flightrec

    if not args.router_dump:
        raise SystemExit("--router-dump FILE (a saved GET /debug/fleet body) is required "
                         "for fleettrace mode")

    def _load(path: str):
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        if not isinstance(data, dict):
            raise ValueError(f"expected a JSON object, got {type(data).__name__}")
        return data

    try:
        router_dump = _load(args.router_dump)
    except (OSError, ValueError) as e:
        print(f"❌ {args.router_dump}: {e}")
        return 1
    replica_dumps: dict = {}
    for spec in args.replica_dump or []:
        name, sep, path = spec.partition("=")
        if not sep:
            # bare FILE: the filename stem names the replica track
            name, path = os.path.splitext(os.path.basename(spec))[0], spec
        try:
            replica_dumps[name] = _load(path)
        except (OSError, ValueError) as e:
            print(f"❌ {path}: {e}")
            return 1
    try:
        trace = flightrec.fleet_chrome_trace(router_dump, replica_dumps)
        problems = flightrec.validate_chrome_trace(trace)
    except (KeyError, TypeError, AttributeError) as e:
        # a truncated or hand-edited dump fails with a name, not a traceback
        print(f"❌ malformed dump ({type(e).__name__}: {e})")
        return 1
    join = trace.get("fleetJoin", {})
    payload = json.dumps(trace)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(payload)
        print(f"🧾 {len(trace['traceEvents'])} trace events "
              f"({join.get('router_requests', 0)} router requests, "
              f"{join.get('joined', 0)} joined across {join.get('replicas', 0)} replica "
              f"dump(s)) → {args.out} — load in ui.perfetto.dev or chrome://tracing")
    else:
        print(payload)
    for prob in problems:
        print(f"⚠️ {prob}", file=sys.stderr)
    if replica_dumps and join.get("router_requests", 0) > 0 and join.get("joined", 0) == 0:
        print("⚠️ no request joined across tiers (trace-id propagation broken, or dumps "
              "from different runs)", file=sys.stderr)
        return 1
    return 1 if problems else 0


def make_engine(args) -> InferenceEngine:
    """The engine of ``args``; a model the card cannot hold exits with the
    device-memory guard's message before anything is staged."""
    from ..ops.linear import quant_mode_label
    from ..runtime.engine import InferenceEngine
    from ..runtime.hbm import HbmBudgetError

    seed = args.seed if args.seed is not None else int(time.time())
    try:
        engine = InferenceEngine(
            args.model, args.tokenizer, device=args.device,
            max_seq_len=args.max_seq_len,
            compute_dtype="bfloat16" if args.compute_dtype == "bf16" else "float32",
            sync_type=Q80 if args.buffer_float_type == "q80" else F32,
            temperature=args.temperature, topp=args.topp, seed=seed,
            kv_block_size=args.kv_block_size, sp=args.sp, tp=args.tp,
            decode_chunk=args.decode_chunk,
            spec_lookup=args.spec_lookup, n_batches=args.nbatches, kv_dtype=args.kv_dtype,
            weight_mode=args.weight_mode, host_sampling=args.host_sampling,
            verify_weights=args.verify_weights, numerics_taps=args.numerics_taps,
            numerics_failfast=args.numerics_failfast, kv_host_blocks=args.kv_host_blocks,
            quant_mode=args.quant_mode, profile_split=getattr(args, "profile_split", False))
    except HbmBudgetError as e:
        raise SystemExit(f"❌ {e}") from None
    h = engine.model_file.header
    print(f"💡 Arch: {h.arch_type.name}  Dim: {h.dim}  Layers: {h.n_layers}  "
          f"Heads: {h.n_heads}/{h.n_kv_heads}  SeqLen: {h.seq_len}")
    print(f"🕸️ TP devices: {engine.tp}  SP devices: {engine.sp}  PP stages: 1")
    label = quant_mode_label(engine.quant_mode, engine.cfg.compute_dtype == "bfloat16")
    print(f"🖥️ Device: {engine.device}  Compute: {engine.cfg.compute_dtype}  "
          f"KV: {str(engine.kv_dtype).removeprefix('torch.')}  Weights: {engine.weight_mode}  "
          f"Quant: {label}")
    return engine


def profiled(args):
    """The ``--profile DIR`` capture around a mode's work (one
    ``torch.profiler`` session, ``runtime/profiling.py::capture``), or
    nothing."""
    from contextlib import nullcontext

    from ..runtime import profiling

    return profiling.capture(args.profile) if args.profile else nullcontext()


def print_split(engine) -> None:
    """The ``--profile-split`` summary: the decode step's and the prefill
    chunk's Eval/Sync device time, and the tp merges' traffic."""
    sp, pf, tr = engine.split, engine.split_prefill, engine.traffic
    print(f"  eval/sync: {sp.eval_ms:.2f}/{sp.sync_ms:.2f} ms device time "
          f"per decode step (sync {100 * sp.sync_frac:.1f}%)")
    if pf is not None and pf.n_steps > 0:
        print(f"             {pf.eval_ms:.2f}/{pf.sync_ms:.2f} ms per "
              f"prefill chunk (sync {100 * pf.sync_frac:.1f}%)")
    if tr:
        print(f"    traffic: {tr.sent_kb:.1f} kB/token/device over "
              f"{tr.n_collectives} collectives "
              + " ".join(f"{k}={v:.1f}kB" for k, v in tr.by_kind.items()))


def run_inference(args) -> int:
    if args.prompt is None:
        raise SystemExit("Prompt is required")
    if args.steps == 0:
        raise SystemExit("Number of steps is required")
    engine = make_engine(args)
    try:
        print(args.prompt)
        ids = engine.tokenizer.encode(args.prompt)
        max_new = max(0, min(args.steps, engine.cfg.seq_len) - len(ids))

        def on_token(_tid, piece):
            sys.stdout.write(piece if piece is not None else "")
            sys.stdout.flush()

        with profiled(args):
            result = engine.generate(ids, max_new, on_token=on_token, stop_on_eos=False)
        if args.profile:
            print(f"\n🔬 profiler trace written to {args.profile}")
            if args.profile_split:
                engine.fill_split(result.steps)  # the capture's session is closed now
        print()
        n_eval = sum(s.n_tokens for s in result.steps if s.kind == "eval")
        n_pred = sum(s.n_tokens for s in result.steps if s.kind == "pred")
        buckets = engine.prefill_buckets
        print("\nEvaluation")
        print(f"   nBatches: {buckets[0] if len(buckets) == 1 else list(buckets)}")
        print(f"    nTokens: {n_eval}")
        print(f"   tokens/s: {result.eval_tok_per_s:.2f} "
              f"({result.eval_ms / max(1, n_eval):.2f} ms/tok)")
        if args.profile_split and engine.split is not None:
            # the reference's per-token 🔶 lines (dllama.cpp:59-67), after
            # the stream so they don't garble the generated text; traffic
            # scales with the dispatch's width (a verify runs K+1 columns)
            tr = engine.traffic
            for s in result.steps:
                if s.kind != "pred" or s.sync_ms is None:
                    continue
                skb = f"{tr.sent_kb * s.width:7.1f}" if tr else "    0.0"
                rkb = f"{tr.recv_kb * s.width:7.1f}" if tr else "    0.0"
                print(f"🔶 P {s.ms:8.2f} ms  E {s.eval_only_ms:8.2f} ms  "
                      f"S {s.sync_ms:6.2f} ms  Sent {skb} kB  Recv {rkb} kB"
                      + (f"  ({s.n_tokens} tok)" if s.n_tokens > 1 else ""))
        print("Prediction")
        print(f"    nTokens: {n_pred}")
        print(f"   tokens/s: {result.pred_tok_per_s:.2f} "
              f"({result.pred_ms / max(1, n_pred):.2f} ms/tok)")
        if n_pred and result.pred_tok_per_s:
            # the measured decode rate against the card's HBM ceiling: every
            # decode step streams the weight planes, so ceiling_GBps /
            # weight_GB is the speed limit (runtime/roofline.py); the
            # ceiling's source is printed with it
            from ..runtime import roofline

            ceil = roofline.load_ceilings()
            rf = roofline.rate_roofline(result.pred_tok_per_s,
                                        engine.hbm_estimate["weights_bytes"] / 1e9, ceil)
            if "no_evidence" in rf:
                print(f"   roofline: no evidence ({rf['no_evidence']})")
            else:
                print(f"   roofline: {100 * rf['roofline_fraction']:.1f}% of "
                      f"{rf['roofline_tok_per_s']:.0f} tok/s [{rf['ceiling_source']}]")
        if args.profile_split and engine.split is not None:
            print_split(engine)
        if engine.spec_active:
            n_disp = sum(1 for s in result.steps if s.kind == "pred")
            print(f"  spec rate: {n_pred / max(1, n_disp):.2f} tokens/dispatch "
                  f"({n_disp} dispatches)")
    finally:
        engine.close()
    return 0


def run_chat(args) -> int:
    """Interactive chat REPL (reference: dllama.cpp:174-258): each user line
    is templated, prefilled after the conversation so far and answered on
    the engine until an EOS piece; EOF or a full context ends it."""
    from .api import _EosGate, chat_template  # api imports make_engine from here

    engine = make_engine(args)
    tok = engine.tokenizer
    template, stop_pieces = chat_template(
        tok, ChatTemplateType(args.chat_template or "unknown"))

    def _print_delta(d: str) -> None:
        sys.stdout.write(d)
        sys.stdout.flush()

    def repl() -> None:
        first = True
        while True:
            try:
                user = input("\n💻 > ")
            except EOFError:
                break
            if not user.strip():
                continue
            chat = template.generate([ChatItem("user", user)], append_generation_prompt=True)
            ids = tok.encode(chat.content, is_start=first, add_special_tokens=True)
            first = False
            if engine.pos + len(ids) >= engine.cfg.seq_len:
                print("🚧 context is full (seq_len reached), stopping")
                break
            if chat.public_prompt:
                sys.stdout.write(chat.public_prompt)
            sys.stdout.write("\n🤖 ")
            sys.stdout.flush()
            if len(ids) > 1:
                engine.prefill(ids[:-1])
            token = ids[-1]
            gate = _EosGate(tok, stop_pieces, emit=_print_delta)
            tok.reset_decoder()
            stopped = False
            while engine.pos < engine.cfg.seq_len and not stopped:
                token = engine.next_token(token)
                stopped = gate.feed(token, tok.decode(token))
            if not stopped:
                # the context bound ended the turn: flush what the detector
                # still holds as a possible stop prefix
                gate.flush_tail()
                sys.stdout.flush()
            print()

    try:
        with profiled(args):
            repl()
        _after_profile(args, engine)
    finally:
        engine.close()
    return 0


def _after_profile(args, engine) -> None:
    """What ``--profile`` and ``--profile-split`` print after a mode's work:
    the trace's place, and the split measured now."""
    if args.profile:
        print(f"🔬 profiler trace written to {args.profile}")
    if args.profile_split:
        engine.measure_split()
        print_split(engine)


def run_perplexity(args) -> int:
    if args.file:
        with open(args.file, encoding="utf-8") as f:
            text = f.read()
    elif args.prompt is not None:
        text = args.prompt
    else:
        raise SystemExit("--file or --prompt required for perplexity")
    engine = make_engine(args)
    try:
        ids = engine.tokenizer.encode(text)
        if args.max_seq_len:
            ids = ids[: args.max_seq_len]
        ids = ids[: engine.cfg.seq_len]
        t0 = time.perf_counter()
        with profiled(args):
            ppl = engine.perplexity(ids)
        dt = time.perf_counter() - t0
        print(f"📊 nTokens: {len(ids)}")
        print(f"📊 Perplexity: {ppl:.4f}")
        print(f"📊 Time: {dt:.2f}s ({len(ids) / dt:.1f} tok/s)")
        _after_profile(args, engine)
    finally:
        engine.close()
    return 0


def run_verify(args) -> int:
    """``verify --model m.m [--write]``: offline weight-integrity check (or
    manifest generation with ``--write``) against the .m.sums sidecar, on
    the host alone (no device is touched). rc 0 clean, 1 corrupt or
    unreadable, 2 no manifest (the JAX CLI's codes)."""
    from ..formats import mfile
    from ..runtime.weights import WeightIntegrityError, verify_weights

    try:
        if args.write:
            out = mfile.write_manifest(args.model)
            with mfile.ModelFile.open(args.model) as mf:
                n = len(mf.tensors)
            print(f"🔏 checksum manifest written: {out} ({n} tensors)")
            return 0
        with mfile.ModelFile.open(args.model) as mf:
            try:
                res = verify_weights(mf, emit=print)
            except WeightIntegrityError as e:
                print(f"❌ {e}")
                return 2
    except (OSError, ValueError) as e:
        # a structurally broken file (bad magic, truncation, stale
        # manifest): a clean diagnostic, not a traceback
        print(f"❌ {args.model}: {e}")
        return 1
    if res["corrupt"]:
        print(f"❌ {len(res['corrupt'])} of {res['tensors']} tensors corrupt: "
              f"{', '.join(res['corrupt'])}")
        return 1
    print(f"✅ {res['tensors']} tensors verified against {mfile.manifest_path(args.model)}")
    return 0


def run_audit(args) -> int:
    """``audit --model m.m [--audit-json]``: the offline per-tensor
    quant-error audit (``runtime/numerics.audit_model``) on the host alone.
    rc 1 when any tensor holds non-finite values or the file is unreadable."""
    from ..runtime.numerics import audit_model

    try:
        res = audit_model(args.model, emit=None if args.audit_json else print)
    except (OSError, ValueError) as e:
        print(f"❌ {args.model}: {e}")
        return 1
    if args.audit_json:
        print(json.dumps(res))
    return 1 if res["nonfinite_tensors"] else 0


def _eval_primary_config(args) -> str:
    """The eval config the serving flags imply (one of
    ``telemetry.EVAL_CONFIGS``)."""
    if args.batch_slots and args.batch_slots > 1:
        if args.kv_block_size:
            return "paged_spec" if args.spec_lookup else "paged"
        return "dense"
    return "single"


def _eval_args_for(args, config: str):
    """A copy of ``args`` shaped for one eval config: the config decides the
    generator family; unset sizing flags get eval-sized defaults, so
    ``--compare paged`` works without more flags."""
    import copy

    a = copy.copy(args)
    if config == "single":
        a.batch_slots, a.kv_block_size, a.spec_lookup = 0, 0, 0
        a.kv_host_blocks = 0
    elif config == "dense":
        a.kv_block_size, a.spec_lookup, a.kv_host_blocks = 0, 0, 0
        if (a.tp or 1) > 1:
            raise SystemExit(f"eval's dense config runs at tp = 1 in this package (the "
                             f"dense slot pool is not sharded); with --tp {a.tp} score "
                             f"the single or paged config")
        a.tp = 1
    elif config == "paged":
        a.kv_block_size = args.kv_block_size or 16
        a.spec_lookup = 0
    else:  # paged_spec
        a.kv_block_size = args.kv_block_size or 16
        a.spec_lookup = args.spec_lookup or 4
    return a


def _run_eval_config(args, seqs, dataset: str, config: str) -> dict:
    """Build the serving stack for ``config``, score ``seqs``, tear it down.
    Each config gets its own engine, so a comparison covers the real
    construction path."""
    from ..runtime import evalharness
    from ..runtime.serving import BatchScheduler

    eng = make_engine(_eval_args_for(args, config))
    sched = None
    try:
        if config == "single":
            return evalharness.run_eval(seqs, dataset=dataset, config=config, engine=eng)
        n_slots = args.batch_slots if args.batch_slots > 1 else 4
        sched = BatchScheduler(eng, n_slots=n_slots)
        return evalharness.run_eval(seqs, dataset=dataset, config=config, sched=sched)
    finally:
        if sched is not None:
            sched.close()
        eng.close()


def run_eval_mode(args) -> int:
    """``eval``: teacher-forced NLL over ``--data`` through the serving
    stack. ``--json`` prints the one-line summary; ``--compare`` re-scores
    under a second config and requires a bit-identical total NLL (rc 1 on
    parity drift). A mid-run failure exits 1 with the partial-results JSON
    naming completed and in-flight sequences."""
    import os

    from ..runtime import evalharness, failpoints

    if not args.data:
        raise SystemExit("--data FILE.jsonl is required for eval mode")
    if failpoints.configure_from_env():
        print(f"💣 fault injection armed from DLLAMA_FAILPOINTS="
              f"{os.environ.get('DLLAMA_FAILPOINTS')}", file=sys.stderr)
    dataset = os.path.splitext(os.path.basename(args.data))[0]
    tok = None
    if args.tokenizer:
        from ..tokenizer.bpe import Tokenizer

        tok = Tokenizer.load(args.tokenizer)
    seqs = evalharness.load_dataset(args.data, tok, seq_len=args.max_seq_len or 0)
    primary = _eval_primary_config(args)
    try:
        result = _run_eval_config(args, seqs, dataset, primary)
        if args.compare and args.compare != primary:
            cmp_res = _run_eval_config(args, seqs, dataset, args.compare)
            result = dict(result)
            result["compare"] = cmp_res
            result["parity_drift"] = cmp_res["total_nll_hex"] != result["total_nll_hex"]
    except evalharness.EvalAborted as e:
        print(json.dumps(e.partial), flush=True)
        print(f"💥 {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(result), flush=True)
    else:
        print(f"📊 eval {dataset} [{result['config']}]: {result['n_seqs']} seqs, "
              f"{result['n_tokens']} tokens")
        print(f"📊 Perplexity: {result['perplexity']:.4f}  total NLL: "
              f"{result['total_nll']:.6f} ({result['total_nll_hex']})")
        print(f"📊 Time: {result['wall_s']:.2f}s ({result['eval_tok_per_s']:.1f} tok/s)")
        if "compare" in result:
            c = result["compare"]
            print(f"📊 compare [{c['config']}]: perplexity {c['perplexity']:.4f} "
                  f"({c['total_nll_hex']})")
    if result.get("parity_drift"):
        print(f"💥 parity drift: total NLL differs bit-from-bit between "
              f"{result['config']} and {result['compare']['config']} — these configs "
              f"are exact-parity by contract", file=sys.stderr)
        return 1
    return 0


def main(argv=None, on_listening=None) -> int:
    """The CLI. ``on_listening(server, state)`` is handed to the ``api``
    server (:func:`~dllama_tpu_torch.serve.api.run_api_server`) for a
    caller that embeds it in its own process."""
    args, unknown = build_parser().parse_known_args(argv)
    if args.mode in PENDING_MODES:
        raise SystemExit(f"mode {args.mode!r} is not ported to the PyTorch/CUDA "
                         f"package yet (ported: {', '.join(PORTED_MODES)}); use "
                         f"python -m dllama_tpu {args.mode}")
    if args.mode not in PORTED_MODES:
        raise SystemExit(f"unknown mode {args.mode!r} (ported: {', '.join(PORTED_MODES)})")
    if unknown:
        raise SystemExit(f"unknown or not-yet-ported flag(s): {' '.join(unknown)} "
                         f"(this package takes: --model --tokenizer --prompt --file "
                         f"--steps --temperature --topp --seed --max-seq-len "
                         f"--buffer-float-type --compute-dtype --quant-mode --weight-mode "
                         f"--kv-dtype --nbatches --host-sampling --verify-weights "
                         f"--device --sp --tp --decode-chunk --spec-lookup --chat-template "
                         f"--trace-out --numerics-taps --numerics-failfast; inference, "
                         f"perplexity, chat: --profile --profile-split; api: "
                         f"--batch-slots --kv-block-size --kv-host-blocks --role --max-queue "
                         f"--host --port "
                         f"--request-timeout --drain-timeout --stats --canary-interval "
                         f"--tenant-limits --usage-ledger; router: --replica "
                         f"--probe-interval --max-stream-resumes --slo --max-queue "
                         f"--request-timeout --host --port --stats; verify: --write; "
                         f"timeline: --dump --out; fleettrace: --router-dump "
                         f"--replica-dump --out; audit: --audit-json; eval: --data "
                         f"--compare --json --batch-slots --kv-block-size)")
    if (args.profile or args.profile_split) and args.mode not in ("inference", "perplexity",
                                                                   "chat"):
        raise SystemExit(f"--profile/--profile-split take inference, perplexity or chat "
                         f"(an api server profiles a live window: POST /debug/profile)")
    if args.mode == "api":
        from .api import check_role

        check_role(args)  # before any device is resolved: the flags alone decide it
    if args.mode == "timeline":
        return run_timeline(args)  # host only: no model, no device
    if args.mode == "fleettrace":
        return run_fleettrace(args)  # host only: no model, no device
    if args.mode == "router":
        # the fleet tier: no model, no device, never a CUDA context — it
        # fronts api replicas over plain HTTP (serve/router.py)
        from .router import run_router

        return run_router(args)
    if args.model is None:
        raise SystemExit(f"--model is required for {args.mode} mode")
    if args.mode == "verify":
        return run_verify(args)  # host only: no device is touched
    if args.mode == "audit":
        return run_audit(args)  # host only: no device is touched
    if args.mode != "eval" and args.tokenizer is None:
        raise SystemExit(f"--tokenizer is required for {args.mode} mode")
    if args.weight_mode == "offload":
        raise SystemExit("--weight-mode offload (host-DRAM weight streaming) is not "
                         "ported to the PyTorch/CUDA package yet (ported: auto, f32, "
                         "bf16); use python -m dllama_tpu")
    try:
        # the mesh's device count first: --sp N (--tp N) needs N visible cards
        from ..runtime.engine import mesh_plan, resolve_device

        mesh_plan(args.device, args.sp, tp=args.tp or 1)
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"error: {e}") from None
    if args.mode == "eval":
        return run_eval_mode(args)
    if args.mode == "api":
        from .api import run_api_server

        # the api server opens and closes the span sink itself
        return run_api_server(args, on_listening=on_listening)
    from ..runtime import telemetry

    if args.trace_out:
        telemetry.tracer().configure(args.trace_out)
        print(f"🔬 request trace (JSONL spans) → {args.trace_out}")
    try:
        if args.mode == "inference":
            return run_inference(args)
        if args.mode == "chat":
            return run_chat(args)
        return run_perplexity(args)
    finally:
        if args.trace_out:
            telemetry.tracer().configure(None)
