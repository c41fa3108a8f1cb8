#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``dllama_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each failing loudly (non-zero exit, no result line):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build the CUDA kernels from ``dllama_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and print the build time and ptxas register use;
3. kernels K1 (Q40/Q80 tile matmul), K2 (Q40/Q80 decode GEMV, at M = 1 on
   its SIMT kernel and at the serving batch M = 8 on the tensor cores, wq
   also at M = 2, 4 and 16; each launch's kernel held to the path rule and
   its code kind to the planes', every K1/K2 case also on Q80 planes with
   codes over [-127, 127]), K3 (flash attention, with decode at depth 2047 in
   a 2048-row cache, and decode at depth 20145 and a 256-token prefill
   chunk at depth 19000 in a 32768-row cache, the long sp cell at sp = 1)
   and K4 (paged attention, decode at B = 1, 8 ragged rows and 8 rows at
   depth 2047, each launch split, its split count recorded) on the card
   against their plain
   PyTorch versions at the Llama 3.1 8B shapes of the main paths, exact
   (f32) and fast (bf16): one JSON line per case with the error, the median
   of >= 20 CUDA-event timed runs (L2 flushed before each), the plain
   version's and a library call's time (for K4 the gather + SDPA pair, a
   yardstick of two library calls), the bound (the larger of bytes / 3.35
   TB/s and operations / peak rate: FP32 for the SIMT kernels, bf16 for
   the tensor-core ones), and the K split (K1, K2) or split-S count and
   kernel path (K3) that the launch took (read from the wrapper; K3 decode
   must split, its prefill must not; a single pass over a bf16 cache must
   take the tensor-core path ``tc``, held against its twin
   ``flash_attention_tc_plain`` within 1e-3 and the f32 plain version
   within 1e-2 of max|out|; every other case ``simt``, within 1e-4); the
   fast logits head also times the dense bf16 ``F.linear`` that fast
   configs load it as;
4. end to end at full Llama 3.1 8B width: write a synthetic Q40 model (random
   blocks from a seed) and a 128256-piece tokenizer with a llama3 chat
   template with the port's own writers, run ``inference`` and
   ``perplexity`` through the port's CLI ``main`` in process under
   ``--compute-dtype f32`` and ``bf16``, and check the tokens, a finite
   perplexity and each path's launch counts (set to 0 before each run): K1,
   K2 and K3 for ``inference``, K1 and K3 for ``perplexity``; then, under
   ``torch.profiler``, device time per 128-token prefill chunk and per
   decode step (a replay of the captured step), each session's trace also
   through the port's ``op_attribution`` (class rollup and top ops; its
   summed kernel ms within 2% of the session's ``key_averages()``, every
   kernel of the port classified); one short f32 ``inference --profile
   DIR`` on the 8-layer copy (:func:`profiled_inference`: the trace read by
   ``op_attribution``, the ``roofline:`` line's fraction in (0, 1]); then
   the ``graphs`` phase
   (:func:`graphs_phase`): first the sampler's one-row scan
   (``ops/sampling.py::_cumsum_rows``) must give one bitwise result in 50
   runs on a vocabulary-wide row; then, f32 and bf16: 64 greedy and 64 sampled tokens
   from the captured single-sequence step (``next_token``) and from
   ``decode_chunk_tokens(token, 8)`` equal the eager step's
   (``greedy_step``/``sampled_step`` called by name) from the same prefill,
   a chunk's replays launch under ``torch.cuda.set_sync_debug_mode("error")``,
   the 8-row paged step's graph equals eager ``paged_sampled_step`` in
   tokens and pool bytes after 8 steps, and the launches per replay equal
   the eager launches per step (K2 + K3, K2 + K4); eager / graph / chunk-8
   tok/s, eager / graph device ms and busy share, eager / graph paged
   step wall ms, capture seconds and pool bytes per graph are printed;
5. serving at the same width (on the 8-layer copy since slice 17): the
   port's ``api --batch-slots 8 --kv-block-size 16`` in process on a free
   local port, under f32 and
   bf16; 16 concurrent clients (9 share a system message, 2 SSE streams, an
   identical greedy pair whose second request admits while the first
   decodes, half sampled); every request must return 200 with tokens, the
   pair identical text, prefix reuse must happen and K1-K4 must each launch
   (counts set to 0 before each run); tok/s, latencies, step time, the
   column take/put cost and the pool are printed; the f32 run first sends
   one body whose prefill runs every chunk width, takes a live ``POST
   /debug/profile?ms=500&ops=1`` while the clients run, and after them
   holds ``/debug/compiles`` (every capture of the run listed, the scope
   steady, no unexpected retrace), ``/debug/roofline`` (the decode
   summary's fraction in (0, 1], no raw fraction above 1.05) and the
   ``--stats`` line's ``compiles=`` and ``roofline=``
   (:func:`observe_device`); then one 8-row paged
   decode step of that geometry (a replay of ``PagedGenerator``'s captured
   step) under ``torch.profiler`` in f32 and bf16
   (:func:`paged_step_profile`: device ms, K2's and K4's device ms,
   kernels per step, busy share, and the port's op attribution of the
   session);
6. model parity on the card: 2 layers at 8B widths, the kernel path
   (``attn_impl=auto``, ``quant_impl=auto``) against the plain path (``xla``)
   on the same weights and tokens, on Q40 and on Q80 planes: a 128-token
   prefill plus 8 teacher-forced decode steps; then ``paged_forward`` over
   8 ragged rows through scrambled
   tables (kernel against plain), and ``paged_forward``'s kernel path (K4)
   against the dense ``forward`` (K3) for one row;
7. sequence parallelism (``--sp``): K3s (the block-statistics mode of K3)
   against its plain version at 8B shapes over one 2048-row shard
   (``ring_cases``: decode over a whole, a partly visible and a fully masked
   block, a 64-token prefill chunk past the block and on its diagonal) and
   decode over a whole 16384-row shard (the long sp cell's), the same split
   and path checks as K3's;
   ``guard_cost``: the host time of a wrapper call with no device guard,
   the shipped ``on_card`` guard and ``torch.cuda.device`` on every launch;
   ``sp_parity``: 2 layers at 8B width with a 256-row cache, sp = 2 (K3s)
   against sp = 1 (K3) and against sp = 2 on the plain block version, over
   a 160-token prefill and 8 decode steps; ``sp_path``: the 8-layer copy
   at sp = 2 and sp = 1 in three cells: ``--max-seq-len 4096``, a
   2551-token prompt (prefill crosses the shard boundary at 2048) and 64
   greedy steps in f32 and bf16, then ``perplexity`` over the prompt in f32;
   the same ``perplexity`` with the Q80 sync casts on; ``--max-seq-len
   32768`` (two 16384-row shards), a prompt of more than 20000 tokens, 64
   greedy steps and ``perplexity`` in f32, 64 greedy steps in bf16; every
   run's prefill attention must take the tensor-core path in bf16 and
   never in f32. With two or more cards it drives
   the CLI's ``--sp 2``; with one card ``InferenceEngine(sp=2,
   sp_devices=[cuda:0, cuda:0])``;
8. prompt-lookup speculative decoding at K = 4 (``--spec-lookup 4``) at
   full width, with f32 sync buffers on both sides of each comparison (the
   Q80 casts would turn the verify kernels' other summation orders into
   whole int8 steps): ``spec_single``, ``inference --spec-lookup 4
   --temperature 0`` against the same run without spec in f32 and bf16,
   once with the n-gram table's drafts and once with the run without
   spec's own tokens as the drafts (:func:`oracle_drafts`: on random
   weights the table's drafts are never accepted; these are, and every
   verify step must accept them in f32). Transcripts are held to the
   near-tie rule (:data:`NEAR_TIE`): in exact mode they may part only
   where the spec side's token came within 1e-4 (greedy, of the top
   logit) or 1e-3 of the CDF (sampled) of being picked. Spec rate, decode
   tok/s, and the captured verify step's device ms, busy share and
   kernels per replay under ``torch.profiler``, its replays fed drafts it
   accepts; ``spec_serving``, ``api --batch-slots 8 --kv-block-size 16
   --spec-lookup 4`` with the serving mix against the same api without
   spec, with both kinds of drafts (every request's tokens, greedy and
   sampled, under the same rule; accept rates, verify step ms, capture),
   and the 8-row paged verify step alone, graph against eager (outputs and
   pool bytes equal, K1's, K4's and the sort's device ms), with rows that
   draft the step's own picks (all accepted) and its logits and tokens
   against plain decode steps at the same positions; in the sp path, the
   short cell with spec at sp = 2 (eager, K3s at T = 5) and sp = 1
   (graph) against sp = 2 without spec and against each other. Phase 3
   holds the kernels at the verify shapes: K2 at M = 5 and K1 at M = 40
   on every shape, K3 at T = 5 over depth 2047, K4 at 8 ragged rows,
   T = 5, draft lengths 0-4;
9. the dense slot pool, the single-sequence ``api`` and ``chat`` at full
   width (on the 8-layer copy; the single ``api`` at 32 layers until slice
   14): ``api --batch-slots 8`` without ``--kv-block-size``
   with the serving mix in f32 and bf16 (K1-K3 must launch, K4 never),
   then one dense step of that geometry under ``torch.profiler``
   (:func:`dense_step_profile`: device ms, K2's and K3's share, the replay
   against the eager step); the dense pool's ``--decode-chunk 4`` and
   ``--spec-lookup 4`` (n-gram and oracle drafts) in f32 on f32 buffers
   against its K = 1 run, whose greedy transcripts are held to the paged
   pool's (near-tie rule); ``api`` without ``--batch-slots``: a three-turn
   conversation whose later turns hit the ``NaiveCache`` (fewer prefilled
   tokens), each answer against a fresh engine over the same token history,
   a ``stop`` body and an SSE body; ``python -m dllama_tpu_torch chat`` as
   a subprocess with two lines on stdin. Phase 3 holds K3 at the dense
   pool's shapes: 8 ragged rows at T = 1 and T = K + 1, single pass
   (``tc`` over bf16). The graphs phase and the dense pool's runs run on
   an 8-layer copy of the model (:data:`LONG_LAYERS`), the long sp cell and
   ``spec_serving`` on a 4-layer copy since slice 20
   (:data:`SHORT_LAYERS`), to keep the run under 900 s;
10. the engine options of slice 10 and weight integrity, at full width and
   32 layers (``--kv-dtype f8``'s single-sequence runs and sp cell,
   ``--nbatches``, ``--host-sampling`` and the weight modes on the 8-layer
   copy, integrity on the 4-layer one).
   Phase 3 adds K3, K3s and K4 over a float8 e4m3 cache (the
   ``f8-*`` modes of :data:`ATTN_MODES` in the attention cases, under
   the rules of the f32 and bf16 caches, against the plain version on the
   same cache, the bound at 1 byte an element, the yardstick an upcast to
   bf16 + SDPA) and the cache write's e4m3 cast on the card against the
   JAX package's bits (:func:`f8_cast_check`). Then ``inference`` and
   ``perplexity`` with ``--kv-dtype f8`` in f32 and bf16 (the logits'
   drift from the default cache within 0.15 max|logit|, every K3 launch on
   SIMT), the paged ``api`` on an e4m3 pool in bf16 (K4 launches, half
   the pool bytes), the sp short cell's ``perplexity`` on e4m3 shards at sp
   = 2 against sp = 1; ``--weight-mode f32`` and ``bf16`` in one CLI
   process of their own (:func:`weight_modes`: f32 transcript and
   perplexity against the quantized-plane exact run, K1 and K2 never
   launched, TF32 off); ``--nbatches 32`` and ``--host-sampling`` against
   the runs without (near-tie rule); ``verify --write`` / ``verify``, a
   corrupt copy refused by ``verify``, by ``inference --verify-weights``
   and by the loader with no device memory left behind
   (:func:`integrity_phase`);
11. C7 and the observability of slice 11. Phase 3 adds K3 prefill chunks
   of 1024 tokens at depths 0 and 1024 and of 2048 tokens at depth 0 in
   the 2048-row cache (4096 and 8192 folded query rows a KV head, past the
   old 2048-row cap), and K3s 1024- and 2048-token chunks on a shard's
   diagonal, exact and fast; ``--nbatches 2048`` runs beside
   ``--nbatches 32`` (one 2048-row prefill chunk, tokens against the
   bucketed run's). The f32 serving run writes ``--trace-out`` spans and,
   after its 16 requests, holds ``/metrics`` against what the phase
   counts itself (:func:`observe_serving`: tokens, admissions, retires,
   reused prompt tokens, the idle block gauge, one step sample per replay
   of the captured step), converts its ``/debug/flight`` body with the
   ``timeline`` mode (valid, one flow per request) and checks three
   ``"timing": true`` bodies. On the 8-layer model (:func:`watchdog_phase`)
   ``step:raise`` crashes and restarts the scheduler and ``step_hang``
   trips the step watchdog with the JAX package's failure semantics;
   :func:`paged_step_syncs` counts one synchronisation per paged step with
   every instrument on; :func:`obs_cost` times the per-step
   instrumentation calls alone;
12. slice 12 at full width: ``eval_phase`` (on the 8-layer copy; ``eval --json``
   in the four configs ``single``, ``dense``, ``paged`` and ``paged_spec``,
   f32 and bf16, in one CLI process: equal NLL hexes per dtype, ``--compare
   single`` without drift, K1 and K3 launched; the f32 NLLs against the
   plain versions; bf16 perplexity within 5% of f32), ``numerics_phase``
   (the canary under traffic and a weight patched in place, one poisoned
   request at a time on the paged and dense ``api``, ``inference`` with
   and without ``--numerics-failfast``, the single-sequence canary, the
   tripwire's cost), ``hbm_phase`` (an f32-weight engine refused before
   staging under 16 GB; a 256-slot f32 dense pool shrunk to what the card
   fits, serving, then refusing a prompt 503), and beside them and the
   fleet ``audit --audit-json`` of the 32-layer file (host only, at nice
   19: it starts after the phases whose host rates PERF.md compares). To
   make room in the 900 s, ``spec_single``, the sp path's short and q80
   cells, the weight modes, the integrity phase, eval and numerics run on
   the 8-layer copy;
13. the fleet tier at full width (:func:`fleet_phase`, on the 8-layer copy
   since slice 14): two
   paged replicas (A in this process, B a process of its own) behind
   ``python -m dllama_tpu_torch router`` (a third process, which must hold
   no CUDA context), both under ``--tenant-limits`` with a usage ledger:
   the serving mix routed in two tenants (all 200, both replicas
   dispatched, greedy transcripts against a direct run on A, the router's
   tenant view the sum of the replicas'), two streams resumed after B's
   SIGKILL and one after a ``step:raise`` on A (gapless, no duplicate,
   ``[DONE]``, held to the unbroken run on A by the near-tie rule; no new
   graph on A), B restarted and readmitted, tenancy (``flood`` at most 2
   slots a replica, ``light``'s queue wait below ``flood``'s, ``metered``
   shed with 429), ``/debug/slo``, ``fleettrace`` over the saved dumps, and
   A's K1-K4 launched; :func:`paged_step_syncs` counts its one
   synchronisation a scheduler tick with tenant limits set;
14. tiered KV memory and KV migration: :func:`kvtier_phase` (8 layers,
   ``api --batch-slots 2 --kv-block-size 16 --kv-host-blocks 512``: idle
   sessions 2.6x the device pool spill to pinned host chunks and resume bit
   for bit against a never-spilled run, transcripts and every step's
   logits; the spilled block's bytes against its host lane and its paged-in
   block, on f32 and e4m3 pools; ``pagein:raise:1`` and ``spill:raise``;
   resumed TTFT with the tier against the same resumes prefilled again;
   spill / page-in GB/s beside the host link; a spilling tick's
   synchronisations against a plain tick's) and :func:`kvmigrate_phase`
   (8 layers: a ``--role prefill`` replica, a ``--role decode`` one and
   the router; four routed migrations, the drift of D's first-token logits
   from a replica that computed every prefix itself, three wire faults
   that recompute bit for bit, the ingested bytes against the decoded
   export). ``f8_serving`` and ``single_api`` run on the 8-layer copy with
   the fleet and the tier;
15. mixture of experts and turbo planes, kernel K5 (the grouped expert
   matmul, ``csrc/moe_matmul.cu``). Phase 3 adds :func:`moe_cases`: K5
   against its plain version at the Qwen3-30B-A3B expert shapes (128
   experts; w1/w3 K 2048, N 768; w2 K 768, N 2048) at 8, 64, 1024 and 2048
   rows on Q40 planes, exact and fast, and on a skewed routing (one expert
   holding 512 of 1024 rows, 100 experts empty), on turbo expert planes in
   both regimes (a8 and a16 at 8 rows, pre-scaled at 64 and 1024), on dense
   expert planes, and as the dense turbo linear on the 8B wq and w1 at M =
   1, 8, 128 and 256 (a8 bit for bit; the drift from the exact product
   within the JAX package's 8e-2 / 5e-2 of its RMS). Every case on the
   tensor-core kernel is also held against its twin
   ``moe_matmul_tc_plain`` (``TC_TWIN_TOL``; a8 bit for bit) and names the
   kernel it took; yardsticks: ``torch._grouped_mm`` over planes
   dequantized to bf16 beforehand (Q40, pre-scaled, dense bf16),
   ``torch.matmul`` over the upcast codes (the a16 linear),
   ``torch._int_mm`` (the a8 linear). Then a synthetic Qwen3-30B-A3B file
   (full width, 8 of 48 layers) through :func:`moe_phase` (``inference``,
   ``perplexity``, one engine's decode / prefill / paged-step profiles with
   K5's device share
   and the per-call K5 hold on recorded inputs (:func:`k5_hold`), the paged
   ``api`` with the serving mix cut to 8 requests, f32 and bf16; one
   synchronisation a paged tick; no graph captured while serving) and
   :func:`turbo_phase` (``inference --quant-mode turbo | turbo16`` on the
   8-layer 8B copy and the MoE file: K5 only, the card's derived planes
   against the host's bit for bit, the logits within 0.15 of their RMS of
   the fast run's; ``--quant-mode turbo --weight-mode f32`` refused before
   the load);
16. tensor parallelism (``--tp``), the shards on one card
   (``InferenceEngine(tp=2, tp_devices=[cuda:0, cuda:0])``: the CLI's
   ``--tp 2`` needs two visible cards). Phase 3 adds :func:`tp_cases`: K1
   at M = 128 and K2 at M = 1 on the 8B's tp = 2 local weight shapes (wq,
   wk, w1 and the head cut along N, wo and w2 along K), K3 (decode at depth
   2047, a 128-token chunk) and K4 (8 ragged decode rows) over one shard's
   16 q heads and 4 kv heads, against their plain versions. Then
   :func:`tp_phase` on the 4-layer copy (:data:`SHORT_LAYERS`), tp = 2
   against tp = 1, f32 and
   bf16: the logits of a 128-token chunk and 8 teacher-forced decode steps
   (f32 buffers; within 1e-4 / 5e-2 of max|logit|), the greedy 64-token
   transcripts (the near-tie rule), ``perplexity`` over 511 tokens (f32
   buffers within 1e-4 relative, Q80 buffers within 1e-2, f32 only), the
   paged ``BatchScheduler`` (8 slots, block 16) over 8 requests that share
   a system prompt (the near-tie rule); K1-K4 launches of each tp path
   (counts set to 0 before each run), decode and prefill tok/s and device
   ms per decode step at tp = 2 and at tp = 1 (eager), beside the card;
17. MoE models and turbo planes under ``--tp``, and expert parallelism,
   the shards on one card. Phase 3 adds :func:`moe_tp_cases`: K5 at one
   shard's Qwen3-30B-A3B expert shapes, a tp = 2 shard's (128 experts,
   hidden 384) and an ep = 2 x tp = 2 shard's (64 experts, the rows routed
   to the other 64 past its last group), w1 and w2 at 8, 64 and 1024 rows,
   exact and fast, against the plain version and the twin on the rows it
   writes. Then :func:`moe_tp_phase` (after ``turbo_phase``, on the
   Qwen3-30B-A3B file): the engine at tp = 2 against tp = 1 on f32 sync
   buffers, f32 and bf16 (the prompt's logits within
   :data:`MOE_TP_LOGIT_TOL`, 64 greedy tokens held by the routing and
   logit near-tie rules, eager decode device ms and K5's share), in f32
   ``perplexity`` (within 1e-3 relative), the paged scheduler over 8
   requests, one forward and 8 decode steps under ``{"ep": 2, "tp": 2}`` on
   ``[cuda:0] * 4``; under the CLI's Q80 buffers the prompt's logits
   against ``moe_phase``'s within :data:`MOE_TP_Q80_LOGIT_TOL`, and in
   bf16 ``--quant-mode turbo`` on the MoE file and ``turbo16`` on the
   8-layer 8B at tp = 2 against ``turbo_phase``'s logits. K5 launches once
   per shard and layer and projection on every path, no more, no fewer;
18. the ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

``--layers N`` cuts the end-to-end depth (default 32, the full model).
``--only eval,numerics,hbm,fleet,kvtier,kvmigrate,audit,moe,turbo,moe_tp,tp``
is a development run of the phases of slices 12-20 alone (no kernel cases,
exit 3, no result line).
``--ab TAG --assets DIR`` runs one side of a same-call A/B of two checkouts
instead (see :func:`ab_side`): phase 4, the long sp cell at sp = 1 (f32
and bf16) and the paged decode step's profile on the package of the
current directory, then an ``AB`` line.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
PEAK_OPS = {"f32": 67e12,     # FP32 outside the tensor cores
            "bf16": 989e12,   # dense bf16 tensor cores
            "int8": 1979e12}  # dense int8 tensor cores
SEED = 1234
DEV = "cuda"

# Llama 3.1 8B (meta-llama/Llama-3.1-8B config.json; the repo's 8b preset)
DIM, HIDDEN, HEADS, KV_HEADS, HEAD_DIM, VOCAB = 4096, 14336, 32, 8, 128, 128256
MATMULS_8B = [  # (name, K, N): one layer's seven matmuls and the head
    ("wq", DIM, HEADS * HEAD_DIM), ("wk", DIM, KV_HEADS * HEAD_DIM),
    ("wv", DIM, KV_HEADS * HEAD_DIM), ("wo", HEADS * HEAD_DIM, DIM),
    ("w1", DIM, HIDDEN), ("w3", DIM, HIDDEN), ("w2", HIDDEN, DIM),
    ("head", DIM, VOCAB)]
MAX_SEQ = 2048
SP_LONG_SEQ = 32768   # the long sp cell's --max-seq-len: 2 shards of 16384 rows
LONG_DEPTH = 20145    # its decode depth: the newest position after its prompt
LONG_PREFILL_AT = 19000  # first position of one of its 256-token prefill chunks
LONG_LAYERS = 8       # the long sp cell's depth: its 20146-token prefills at 32 layers
                      # took 137 s of the run's 900 (width is never cut)
# the depth of the phases moved to a 4-layer copy to pay for the MoE tp
# phase (slice 20: 54.6 s): the long sp cell, spec_serving, tp_phase and the
# integrity phase (44.4, 43.2, 38.6 and 24.5 s at 8 layers; width is never cut)
SHORT_LAYERS = 4
SPEC_K = 4            # --spec-lookup K of the spec phases: verify steps K + 1 wide

# kernel-vs-plain tolerances, relative to max|plain output|:
#   exact: f32 sums in another order over K up to 14336 terms;
#   fast: both sides cast the f32 result to bf16 (one bf16 ulp ~ 2^-8)
TOL = {"exact": 1e-4, "fast": 1e-2}
# K3/K3s's tensor-core path (a single pass over a bf16 cache) against its
# twin, the plain version with the kernel's roundings (q and p to bf16,
# 64-key tiles; ops/flash_attention.py::flash_attention_tc_plain): f32 sums
# in another order, and a rare p that rounds the other way; against the
# f32 plain version it keeps TOL["fast"], inside the JAX package's own
# bound for its flash kernel over a bf16 cache (rtol = atol = 2e-2)
TC_TWIN_TOL = 1e-3
# model parity (2 layers + head, logits relative to max|logits|, Q80 sync
# off: a Q80 requantization turns a last-ulp difference into a whole int8
# step): exact carries f32 sums taken in another order through 15 matmuls
# and 2 attentions; fast adds the bf16 rounding of every activation, where
# one flipped ulp propagates to the next layer
PARITY_TOL = {"exact": 1e-4, "fast": 5e-2}


def fail(msg: str) -> None:
    print(f"❌ {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class Timer:
    """Median CUDA-event time of one call, with the 50 MB L2 flushed before
    every timed run (the decode path streams each weight once per token).
    The flush writes 1 GiB, about 0.3 ms of device work, so the host has
    enqueued the timed call before the device reaches it: the events time
    the device work, not the wrapper's Python."""

    def __init__(self, n: int = 21):
        self.n = n
        self.flush = torch.empty(1024 * 1024 * 1024 // 4, dtype=torch.float32,
                                 device=DEV)

    def __call__(self, fn) -> float:
        for _ in range(2):
            fn()
        times = []
        for _ in range(self.n):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            times.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in times)


def bound(kernel: str, **shape) -> tuple[float, str]:
    """The least time the card could take for one launch of ``kernel`` at
    ``shape``: the bytes it must move over the memory rate against its
    operations over the peak of their type, both from the port's count
    (``ops/cost.py::launch_cost``, the one the kernel wrappers add to their
    counters and the roofline divides), fed this run's data."""
    from dllama_tpu_torch.ops.cost import launch_cost

    c = launch_cost(kernel, **shape)
    t_bytes = c.bytes / HBM_BYTES_PER_S * 1e3
    t_ops = c.ops / PEAK_OPS[c.rate] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def random_planes(K: int, N: int, fast: bool, g: torch.Generator, kind: str = "q40"):
    """Random planes of a Q40 (codes over [-8, 7]) or Q80 (codes over
    [-127, 127]) weight."""
    from dllama_tpu_torch.ops.linear import QuantizedWeight

    lo, hi = (-127, 128) if kind == "q80" else (-8, 8)
    codes = torch.randint(lo, hi, (K, N), generator=g, device=DEV, dtype=torch.int8)
    scales = torch.rand((K // 32, N), generator=g, device=DEV) * 0.01 + 0.002
    return QuantizedWeight(scales=scales.to(torch.bfloat16 if fast else torch.float32),
                           codes=codes, kind=kind)


def check_gemv_path(what: str, M: int, path: str) -> None:
    """K2's kernel: the FP32 SIMT kernel for one row, the tensor cores for
    2..16 rows."""
    want = "simt" if M == 1 else "tc"
    if path != want:
        fail(f"{what}: K2 took the {path!r} kernel at M={M}, want {want!r}")


def matmul_cases(timer: Timer, results: list) -> None:
    from dllama_tpu_torch.ops import quant_matmul as qm
    from dllama_tpu_torch.ops.linear import dequantize_weight, linear

    g = torch.Generator(device=DEV).manual_seed(SEED)
    for kind, mode in (("q40", "exact"), ("q40", "fast"), ("q80", "exact"), ("q80", "fast")):
        fast = mode == "fast"
        act = torch.bfloat16 if fast else torch.float32
        for name, K, N in MATMULS_8B:
            w = random_planes(K, N, fast, g, kind)
            wd = dequantize_weight(w, act)  # the library yardstick's operand
            # fast configs load the logits head as a dense bf16 [vocab, dim]
            # matrix (the loader's rule) and run it through ``linear``'s
            # F.linear: time that beside K1/K2 on the same weights
            head_dense = (wd.t().contiguous() if fast and name == "head" and kind == "q40"
                          else None)
            # every shape at decode (M = 1), at the serving decode step of 8
            # slots (M = 8) and a 128-token chunk; one shape (Q40 planes)
            # also at the other widths the main path gives the kernels: K2's
            # other tensor-core widths (short verifies, a context-tail
            # chunk) and the 32-, 64- and 256-token prefill chunks (K1
            # exact's three row tiles); Q80 planes at the same K1 widths
            widths = [("K2", 1), ("K2", 8), ("K1", 128)]
            if kind == "q40":  # the verify widths at K = 4: one sequence, 8 slots
                widths += [("K2", SPEC_K + 1), ("K1", SLOTS * (SPEC_K + 1))]
            if name == "wq":
                widths += [("K1", 32), ("K1", 64), ("K1", 256)]
                if kind == "q40":
                    widths += [("K2", 2), ("K2", 4), ("K2", 16)]
            for kname, M in widths:
                fn = qm.q40_gemv if kname == "K2" else qm.q40_matmul
                x = torch.randn((M, K), generator=g, device=DEV).to(act)
                got = fn(x, w, fast=fast).float()
                # what this launch took: its K split, code kind and kernel
                splits, codes = fn.last_splits, fn.last_codes
                path = fn.last_path if kname == "K2" else "tc" if fast else "simt"
                want = qm.quant_matmul_plain(x, w, fast=fast).float()
                # K2 exact on the tensor cores against its twin (the same
                # reassociated arithmetic written plainly)
                twin = (qm.q40_gemv_tc_exact_plain(x, w) if kname == "K2" and path == "tc"
                        and not fast else None)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                scale = want.abs().max().item()
                err_twin = (got - twin).abs().max().item() if twin is not None else None
                ms = timer(lambda: fn(x, w, fast=fast))
                plain_ms = timer(lambda: qm.quant_matmul_plain(x, w, fast=fast))
                lib_ms = timer(lambda: torch.matmul(x, wd))
                # exact on the tensor cores is three bf16 products (x in
                # three parts); K1 exact and K2 at M = 1 are FP32 SIMT
                b_ms, b_by = bound(kname, M=M, K=K, N=N, fast=fast, path=path)
                rec = dict(case="matmul", kernel=kname, mode=mode, codes=codes, weight=name,
                           M=M, K=K, N=N, splits=splits, path=path, max_abs_err=err,
                           max_abs_ref=scale, max_abs_err_twin=err_twin, ms=ms,
                           plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
                if head_dense is not None:
                    rec["dense_head_ms"] = timer(lambda: linear(x, head_dense))
                print(json.dumps(rec), flush=True)
                results.append(rec)
                what = f"{kname} {kind} {mode} {name} M={M}"
                if codes != kind:
                    fail(f"{what}: the launch read {codes!r} codes")
                if kname == "K2":
                    check_gemv_path(what, M, path)
                if not (err <= TOL[mode] * scale) or not math.isfinite(err):
                    fail(f"{what}: max|err| {err:.3g} > {TOL[mode]} x max|y| {scale:.3g}")
                if twin is not None and not err_twin <= TOL[mode] * scale:
                    fail(f"{what}: max|err| {err_twin:.3g} against the twin > "
                         f"{TOL[mode]} x max|y| {scale:.3g}")
            del w, wd, head_dense
    # K2's 4-byte copy path: a width that is not a multiple of 16 (N % 16 =
    # 4), both kernels, both code kinds; held to TOL, not timed
    for kind, mode in (("q40", "exact"), ("q40", "fast"), ("q80", "exact"), ("q80", "fast")):
        fast = mode == "fast"
        w = random_planes(DIM, 1028, fast, g, kind)
        for M in (1, 8, 16):
            x = torch.randn((M, DIM), generator=g, device=DEV).to(
                torch.bfloat16 if fast else torch.float32)
            got = qm.q40_gemv(x, w, fast=fast).float()
            want = qm.quant_matmul_plain(x, w, fast=fast).float()
            err, scale = (got - want).abs().max().item(), want.abs().max().item()
            print(json.dumps(dict(case="matmul_narrow_n", kernel="K2", mode=mode, codes=kind,
                                  M=M, K=DIM, N=1028, path=qm.q40_gemv.last_path,
                                  max_abs_err=err, max_abs_ref=scale)), flush=True)
            if not (err <= TOL[mode] * scale):
                fail(f"K2 {kind} {mode} N=1028 M={M}: max|err| {err:.3g} > "
                     f"{TOL[mode]} x max|y| {scale:.3g}")
    torch.cuda.empty_cache()


# the attention kernels' case modes, as (cache dtype, query dtype): exact
# (an f32 cache), fast (a bf16 cache), and a float8 e4m3 cache (``--kv-dtype
# f8``) under f32 queries (f32 compute) and under bf16 ones (bf16 compute)
F8 = torch.float8_e4m3fn
ATTN_MODES = {"exact": (torch.float32, torch.float32),
              "fast": (torch.bfloat16, torch.float32),
              "f8-exact": (F8, torch.float32), "f8-fast": (F8, torch.bfloat16)}


def random_kv(shape, mode: str, g: torch.Generator) -> torch.Tensor:
    """Random K or V in the cache dtype of ``mode``; an e4m3 one through the
    port's cache write (``runtime/kvcache.py::to_cache``)."""
    from dllama_tpu_torch.runtime.kvcache import to_cache

    return to_cache(torch.randn(shape, generator=g, device=DEV), ATTN_MODES[mode][0])


def upcast(t: torch.Tensor) -> torch.Tensor:
    """The library yardstick's cache: SDPA reads no e4m3, so an e4m3 cache
    is widened to bf16 first (a second call, timed with it)."""
    return t.to(torch.bfloat16) if t.dtype == F8 else t


def out_errs(got: torch.Tensor, want: torch.Tensor, twin: torch.Tensor | None) -> dict:
    """A K3/K4 output's error fields against the plain version and, on the
    tensor cores, the twin. Under bf16 queries the kernel and the plain
    version both return bf16, so the two may land one bf16 ulp (at most
    2^-7 |ref|) apart: ``err_past_ulp`` / ``twin_err_past_ulp`` are the
    excess past it."""
    rounded = got.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    rec = dict(max_abs_err=(got - want).abs().max().item(),
               max_abs_ref=want.abs().max().item(),
               max_abs_err_twin=None if twin is None else (got - twin.float()).abs().max().item())
    if rounded:
        def past_ulp(ref):
            return ((got - ref).abs() - 2.0 ** -7 * ref.abs()).clamp(min=0).max().item()

        rec.update(err_past_ulp=past_ulp(want),
                   twin_err_past_ulp=None if twin is None else past_ulp(twin.float()))
    return rec


def hold_out(what: str, rec: dict, path: str) -> None:
    """The rule of every K3/K4 output case, whatever its cache: on the SIMT
    kernels 1e-4 of max(max|out|, 1) (f32 online softmax against the
    one-shot oracle: reordered sums and exps), past one bf16 ulp where the
    output is bf16; on the tensor cores :data:`TC_TWIN_TOL` of max|out|
    against the twin (past one ulp likewise) and ``TOL["fast"]`` of max|out|
    against the f32 plain version."""
    err, scale = rec["max_abs_err"], rec["max_abs_ref"]
    if path == "tc":
        twin = rec.get("twin_err_past_ulp", rec["max_abs_err_twin"])
        if not (twin <= TC_TWIN_TOL * scale and err <= TOL["fast"] * scale):
            fail(f"{what}: max|err| {twin:.3g} against the twin, {err:.3g} against the "
                 f"plain version (max|out| {scale:.3g})")
    elif not (rec.get("err_past_ulp", err) <= 1e-4 * max(scale, 1.0)) \
            or not math.isfinite(err):
        fail(f"{what}: max|err| {err:.3g} (past one bf16 ulp: "
             f"{rec.get('err_past_ulp')}; max|out| {scale:.3g})")


def attention_cases(timer: Timer, results: list) -> None:
    """K3 against its plain version (and on the tensor cores its twin) in
    every mode of :data:`ATTN_MODES`; on an e4m3 cache the decode at depth
    2047 and the long sp cell's decode and 256-token chunk, the bound at 1
    byte a cache element."""
    import torch.nn.functional as F

    from dllama_tpu_torch.ops import flash_attention as fa
    from dllama_tpu_torch.ops.attention import attention

    g = torch.Generator(device=DEV).manual_seed(SEED + 1)
    S = MAX_SEQ
    # (phase, T, start_pos, head_dim, cache rows): decode over depths up to
    # S, the 128- and 256-token prefill chunks, the kernel's other head size
    # (64, e.g. Llama 3.2 1B) at depth and in a prefill chunk, and the long
    # sp cell at sp = 1 in its 32768-row cache: decode at its depth and a
    # 256-token chunk of its prefill deep in the cache (the single pass's
    # walk over ~19000 keys)
    cases = [("decode", 1, p, HEAD_DIM, S) for p in (0, 127, 128, 1023, S - 1)] + [
        ("prefill", 128, 0, HEAD_DIM, S), ("prefill", 128, 1024, HEAD_DIM, S),
        ("prefill", 256, 0, HEAD_DIM, S), ("decode", 1, S - 1, 64, S),
        ("verify", SPEC_K + 1, S - 1 - SPEC_K, HEAD_DIM, S),
        ("prefill", 128, 0, 64, S),
        ("decode", 1, LONG_DEPTH, HEAD_DIM, SP_LONG_SEQ),
        ("prefill", 256, LONG_PREFILL_AT, HEAD_DIM, SP_LONG_SEQ)]
    f8_cases = [("decode", 1, S - 1, HEAD_DIM, S), *cases[-2:]]
    # C7: the widest chunks --nbatches can pin at --max-seq-len 2048,
    # T * kv_mul = 4096 and 8192 folded rows (the wrappers refused > 2048)
    cases += [("prefill", T, pos, HEAD_DIM, S) for T, pos in C7_CHUNKS]
    for mode, (kv_dt, q_dt) in ATTN_MODES.items():
        f8 = kv_dt == F8
        caches = {(D, rows): [random_kv((1, KV_HEADS, rows, D), mode, g) for _ in range(2)]
                  for D, rows in ((HEAD_DIM, S), (64, S), (HEAD_DIM, SP_LONG_SEQ))
                  if not f8 or D == HEAD_DIM}
        for phase, T, pos, D, rows in (f8_cases if f8 else cases):
            k, v = caches[(D, rows)]
            q = torch.randn((1, T, HEADS, D), generator=g, device=DEV).to(q_dt)
            positions = (pos + torch.arange(T, device=DEV))[None, :]
            got = fa.flash_attention(q, k, v, pos, D)
            n_splits = fa.flash_attention.last_splits  # what this launch took
            path = fa.flash_attention.last_path
            want = attention(q, k, v, positions, D)
            twin = fa.flash_attention_tc_plain(q, k, v, pos, D) if path == "tc" else None
            torch.cuda.synchronize()
            errs = out_errs(got, want, twin)
            qs = q.transpose(1, 2).to(upcast(k).dtype)
            mask = torch.arange(rows, device=DEV)[None, :] <= positions[0][:, None]
            ms = timer(lambda: fa.flash_attention(q, k, v, pos, D))
            plain_ms = timer(lambda: attention(q, k, v, positions, D))
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                qs, upcast(k), upcast(v), attn_mask=mask, enable_gqa=True))
            b_ms, b_by = bound("K3", T=T, heads=HEADS, kv_heads=KV_HEADS, head_dim=D,
                               q_elt=q.element_size(), kv_elt=k.element_size(), depths=[pos],
                               path=path)
            rec = dict(case="attention", kernel="K3", mode=mode, phase=phase, T=T,
                       start_pos=pos, S=rows, head_dim=D, n_splits=n_splits, path=path,
                       **errs, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by)
            if f8:
                rec["library_note"] = "upcast to bf16 + SDPA (two calls)"
            print(json.dumps(rec), flush=True)
            results.append(rec)
            what = f"K3 {mode} {phase} T={T} pos={pos}"
            check_path(what, mode, n_splits, path)
            hold_out(what, rec, path)
            if (n_splits > 1) != (phase in ("decode", "verify")):
                fail(f"{what}: the launch took n_splits {n_splits}; decode and verify must "
                     f"split, prefill must not")
        del caches
    torch.cuda.empty_cache()


# C7's K3 chunks (T, start position) in the 2048-row cache: T * kv_mul =
# 4096 (from depth 0 and from depth 1024) and 8192 folded query rows
C7_CHUNKS = [(1024, 0), (1024, 1024), (2048, 0)]

# the dense slot pool's verify step at K = SPEC_K: 8 rows at ragged depths,
# the deepest with room for its K + 1 rows
DENSE_VERIFY_DEPTHS = [MAX_SEQ - 1 - SPEC_K, 1500, 1023, 700, 300, 129, 17, 0]


def ragged_attention_cases(timer: Timer, results: list) -> None:
    """K3 at the dense slot pool's shapes: 8 rows of a ``[8, n_kv, 2048,
    hd]`` cache, each at its own start position (the ``pos[b]`` table), at
    the ragged depths :data:`RAGGED` with T = 1 (the dense step) and
    :data:`DENSE_VERIFY_DEPTHS` with T = K + 1 (the dense verify step),
    in every mode of :data:`ATTN_MODES` (on an e4m3 cache the dense step
    only). 64 and 128 (b, head, query tile) blocks: both keep the single
    pass, a bf16 cache and an e4m3 one under bf16 queries on the tensor
    cores (4 and 20 folded rows of its 64-row tile). Each held against the position-masked plain version at
    the same ``[B, T]`` positions and, on the tensor cores, against its twin
    ``flash_attention_tc_plain``; SDPA's time with the per-row mask beside
    it."""
    import torch.nn.functional as F

    from dllama_tpu_torch.ops import flash_attention as fa
    from dllama_tpu_torch.ops.attention import attention

    g = torch.Generator(device=DEV).manual_seed(SEED + 4)
    S = MAX_SEQ
    for mode, (kv_dt, q_dt) in ATTN_MODES.items():
        k, v = (random_kv((SLOTS, KV_HEADS, S, HEAD_DIM), mode, g) for _ in range(2))
        phases = [("ragged decode", 1, RAGGED),
                  ("ragged verify", SPEC_K + 1, DENSE_VERIFY_DEPTHS)]
        for phase, T, depths in (phases[:1] if kv_dt == F8 else phases):
            q = torch.randn((SLOTS, T, HEADS, HEAD_DIM), generator=g, device=DEV).to(q_dt)
            pos = torch.tensor(depths, device=DEV)
            positions = pos[:, None] + torch.arange(T, device=DEV)[None, :]
            got = fa.flash_attention(q, k, v, pos, HEAD_DIM)
            n_splits = fa.flash_attention.last_splits
            path = fa.flash_attention.last_path
            want = attention(q, k, v, positions, HEAD_DIM)
            twin = fa.flash_attention_tc_plain(q, k, v, pos, HEAD_DIM) if path == "tc" else None
            torch.cuda.synchronize()
            errs = out_errs(got, want, twin)
            qs = q.transpose(1, 2).to(upcast(k).dtype)
            mask = (torch.arange(S, device=DEV)[None, None, :]
                    <= positions[:, :, None])[:, None]                 # [B, 1, T, S]
            ms = timer(lambda: fa.flash_attention(q, k, v, pos, HEAD_DIM))
            plain_ms = timer(lambda: attention(q, k, v, positions, HEAD_DIM))
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                qs, upcast(k), upcast(v), attn_mask=mask, enable_gqa=True))
            b_ms, b_by = bound("K3", T=T, heads=HEADS, kv_heads=KV_HEADS, head_dim=HEAD_DIM,
                               q_elt=q.element_size(), kv_elt=k.element_size(),
                               depths=depths, path=path)
            rec = dict(case="attention", kernel="K3", mode=mode, phase=phase, B=SLOTS, T=T,
                       start_pos=depths, S=S, head_dim=HEAD_DIM, n_splits=n_splits,
                       path=path, **errs, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
            if kv_dt == F8:
                rec["library_note"] = "upcast to bf16 + SDPA (two calls)"
            print(json.dumps(rec), flush=True)
            results.append(rec)
            what = f"K3 {mode} {phase} B={SLOTS} T={T}"
            check_path(what, mode, n_splits, path)
            if n_splits != 1:
                fail(f"{what}: the launch took n_splits {n_splits}; a grid of "
                     f"{SLOTS * KV_HEADS * -(-T * HEADS // KV_HEADS // fa.BQ)} blocks must "
                     f"keep the single pass")
            hold_out(what, rec, path)
        del k, v
    torch.cuda.empty_cache()


def check_path(what: str, mode: str, n_splits: int, path: str) -> None:
    """A K3/K3s launch's kernel: a single pass over a bf16 cache (mode
    ``fast``) or over an e4m3 cache under bf16 queries (``f8-fast``) runs on
    the tensor cores; an f32 cache, an e4m3 cache under f32 queries
    (``exact``, ``f8-exact``) or a split launch on the SIMT kernel."""
    want = "tc" if mode in ("fast", "f8-fast") and n_splits == 1 else "simt"
    if path != want:
        fail(f"{what}: the launch took the {path!r} kernel, want {want!r} "
             f"(n_splits {n_splits})")


# ragged decode depths of a full 8-slot batch (deepest at the context cap)
RAGGED = [MAX_SEQ - 1, 1500, 1023, 700, 300, 129, 17, 0]
# 40 ragged rows: 320 (b, head, query tile) blocks, over two an SM, so
# the launch keeps the single pass (K4's unsplit kernel, which `api
# --batch-slots` of 33 or more runs at decode)
WIDE_B = 40
# the paged verify step at K = 4: 8 rows at ragged depths with ragged draft
# lengths 0-4 (the host allocates blocks up to pos + lens only, so the
# padded lanes of a short draft walk into null table entries); the deepest
# row's padded lanes reach past the table (pos + K > 2047)
VERIFY_DEPTHS = [MAX_SEQ - 2, 1500, 1021, 700, 300, 129, 17, 0]
VERIFY_LENS = [1, 4, 3, 0, 2, 4, 1, 0]
# (B, T, block size, first query position of each row, draft lengths or
# None); every case with B <= 8 (the serving geometry) must split the key
# walk, the WIDE_B-row decode must not
PAGED_CASES = [(1, 1, 16, [MAX_SEQ - 1], None), (8, 1, 16, RAGGED, None),
               (8, 1, 16, [MAX_SEQ - 1] * 8, None),
               (1, 1, 32, [MAX_SEQ - 1], None), (8, 1, 32, RAGGED, None),
               (2, 16, 16, [1000, MAX_SEQ - 16], None),
               (WIDE_B, 1, 16, RAGGED * (WIDE_B // len(RAGGED)), None),
               (8, SPEC_K + 1, 16, VERIFY_DEPTHS, VERIFY_LENS)]


def scrambled_tables(depths: list[int], T: int, bs: int, g: torch.Generator,
                     lens: list[int] | None = None):
    """Block tables ``[B, MAX_SEQ / bs]`` over a pool of just enough blocks:
    each row's blocks at scrambled physical ids, rows 0 and 1 sharing their
    first 4 blocks (a shared prompt prefix), null (0) entries past each
    row's last position: ``depth + T - 1``, or ``depth + lens`` for a
    verify row. Returns ``(tables, n_blocks)``."""
    M = MAX_SEQ // bs
    last = [d + (T - 1 if lens is None else n) for d, n in zip(depths, lens or depths)]
    need = [min(p, MAX_SEQ - 1) // bs + 1 for p in last]
    n_blocks = sum(need) + 1
    perm = (torch.randperm(n_blocks - 1, generator=g) + 1).tolist()
    tables = torch.zeros((len(depths), M), dtype=torch.long)
    for b, n in enumerate(need):
        tables[b, :n] = torch.tensor([perm.pop() for _ in range(n)])
    if len(depths) > 1:
        k = min(4, need[0], need[1])
        tables[1, :k] = tables[0, :k]
    return tables.to(DEV), n_blocks


def paged_cases(timer: Timer, results: list) -> None:
    """K4 against its plain version (gather + oracle) at 8B widths: n_kv 8,
    head_dim 128, kv_mul 4, block sizes 16 and 32; decode at B = 1, 8
    ragged rows and 8 rows at full depth, and a 16-token query chunk; f32
    and bf16 pools; the paged verify step's attention (8 ragged rows, T =
    K + 1, ragged draft lengths whose padded lanes see null entries). On an
    e4m3 pool under bf16 queries (``f8-fast``, the f8 serving cell's
    compute) the B = 1 and the 8 ragged rows' decode and the verify step at
    block size 16. Every case at the serving geometry must split the key
    walk (split-S); the 40-row decode must take the single pass."""
    import torch.nn.functional as F

    from dllama_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=DEV).manual_seed(SEED + 3)
    g_cpu = torch.Generator().manual_seed(SEED + 3)
    f8_cases = [c for c in PAGED_CASES if c[2] == BLOCK
                and (c[0] == 1 or c[3] in (RAGGED, VERIFY_DEPTHS))]
    for mode in ("exact", "fast", "f8-fast"):
        q_dt = ATTN_MODES[mode][1]
        for B, T, bs, depths, lens in (f8_cases if mode == "f8-fast" else PAGED_CASES):
            tables, n_blocks = scrambled_tables(depths, T, bs, g_cpu, lens)
            kp, vp = (random_kv((n_blocks, KV_HEADS, bs, HEAD_DIM), mode, g) for _ in range(2))
            q = torch.randn((B, T, HEADS, HEAD_DIM), generator=g, device=DEV).to(q_dt)
            positions = (torch.tensor(depths, device=DEV)[:, None]
                         + torch.arange(T, device=DEV)[None, :])
            got = pa.paged_attention(q, kp, vp, tables, positions, HEAD_DIM)
            n_splits = pa.paged_attention.last_splits  # what this launch took
            want = pa.paged_attention_plain(q, kp, vp, tables, positions, HEAD_DIM)
            torch.cuda.synchronize()
            errs = out_errs(got, want, None)
            S = tables.shape[1] * bs
            mask = (torch.arange(S, device=DEV)[None, None, :]
                    <= positions[:, :, None])[:, None]            # [B, 1, T, S]
            qs = q.transpose(1, 2).to(upcast(kp).dtype)

            def gather_sdpa():
                return F.scaled_dot_product_attention(
                    qs, upcast(pa.paged_view(kp, tables)), upcast(pa.paged_view(vp, tables)),
                    attn_mask=mask, enable_gqa=True)

            ms = timer(lambda: pa.paged_attention(q, kp, vp, tables, positions, HEAD_DIM))
            plain_ms = timer(lambda: pa.paged_attention_plain(q, kp, vp, tables,
                                                              positions, HEAD_DIM))
            yard_ms = timer(gather_sdpa)
            # K/V rows the rows can see (capped at the table's reach)
            b_ms, b_by = bound("K4", T=T, heads=HEADS, kv_heads=KV_HEADS, head_dim=HEAD_DIM,
                               q_elt=q.element_size(), kv_elt=kp.element_size(),
                               depths=depths, rows=S)
            rec = dict(case="paged_attention", kernel="K4", mode=mode, B=B, T=T,
                       block_size=bs, positions=depths, lens=lens, n_splits=n_splits,
                       **errs, ms=ms, plain_ms=plain_ms,
                       gather_sdpa_ms=yard_ms,
                       gather_sdpa_note="yardstick only: two library calls "
                                        "(pool[tables] gather + SDPA)"
                                        + (", the gather upcast to bf16" if kp.dtype == F8
                                           else ""),
                       bound_ms=b_ms, bound_by=b_by)
            print(json.dumps(rec), flush=True)
            results.append(rec)
            hold_out(f"K4 {mode} B={B} T={T} bs={bs}", rec, "simt")
            if (n_splits > 1) != (B <= 8):
                fail(f"K4 {mode} B={B} T={T} bs={bs}: the launch took n_splits "
                     f"{n_splits}; B <= 8 must split, B = {WIDE_B} must not")
            del kp, vp
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: end to end at 8B width
# ---------------------------------------------------------------------------


def write_tokenizer(path: str, extra_eos: tuple = (), vocab_size: int = 0,
                    n_regular: int = 128000) -> None:
    """128256 pieces (Llama 3's vocab size; ``vocab_size`` pieces when
    given): the 256 bytes, printable filler pieces that never occur in the
    prompts (so every prompt byte is one token), bos/eos at ``n_regular``
    and the next id (128000/128001, Llama 3's; and ``extra_eos`` ids as
    further EOS tokens) and reserved specials after, and a chat template
    string that the api detects as llama3. The encoder tries every special
    piece at every prompt byte, so the specials stay a few hundred, as in
    the real tokenizers."""
    from dllama_tpu_torch.formats.tfile import TokenizerData, write_tfile

    vocab = [bytes([b]) for b in range(256)]
    vocab += [b" tok%06d" % i for i in range(n_regular - 256)]
    vocab += [b"<|begin_of_text|>", b"<|end_of_text|>"]
    vocab += [b"<|reserved_%d|>" % i for i in range((vocab_size or VOCAB) - len(vocab))]
    write_tfile(path, TokenizerData(
        vocab=vocab, scores=[0.0] * len(vocab), bos_id=n_regular, add_bos=True,
        eos_token_ids=[n_regular + 1, *extra_eos], max_token_length=max(map(len, vocab)),
        chat_template="<|start_header_id|>"))


def write_model(path: str, n_layers: int) -> None:
    """Synthetic Llama 3.1 8B-shaped Q40 model: random Q40 blocks (random
    nibbles, f16 scales ~0.004 so weights have std ~0.02) and f32 norms and
    embedding, all drawn on the card from a seeded generator."""
    from dllama_tpu_torch.formats.mfile import ArchType, HiddenAct, RopeType, write_header
    from dllama_tpu_torch.formats.quants import Q40, q40_blocks

    g = torch.Generator(device=DEV).manual_seed(SEED)

    def f32(n_rows: int, n_cols: int, base: float, scale: float, f) -> None:
        for lo in range(0, n_rows, 8192):
            rows = min(8192, n_rows - lo)
            x = torch.randn((rows, n_cols), generator=g, device=DEV) * scale + base
            f.write(x.cpu().numpy().tobytes())

    def q40(out_dim: int, in_dim: int, f) -> None:
        nb = out_dim * in_dim // 32
        scales = (torch.rand(nb, generator=g, device=DEV) * 0.004 + 0.002).half()
        # nibbles 1..15 (codes -7..7, mean 0, like quantized zero-mean
        # weights): a full 0..15 draw has mean code -0.5, a bias that every
        # matmul multiplies by ~0.5 * scale * K and the layers compound
        lo, hi = (torch.randint(1, 16, (nb, 16), generator=g, device=DEV,
                                dtype=torch.uint8) for _ in range(2))
        f.write(q40_blocks(scales.cpu().numpy(), (lo | (hi << 4)).cpu().numpy()))

    header = dict(version=1, arch_type=int(ArchType.LLAMA), dim=DIM, hidden_dim=HIDDEN,
                  n_layers=n_layers, n_heads=HEADS, n_kv_heads=KV_HEADS,
                  vocab_size=VOCAB, seq_len=131072, hidden_act=int(HiddenAct.SILU),
                  rope_theta=500000, weight_float_type=Q40,
                  rope_type=int(RopeType.LLAMA3_1), head_dim=HEAD_DIM, norm_epsilon=5,
                  rope_scaling_factor=8, rope_scaling_low_freq_factor=1,
                  rope_scaling_high_freq_factory=4, rope_scaling_orig_max_seq_len=8192)
    q_dim, kv_dim = HEADS * HEAD_DIM, KV_HEADS * HEAD_DIM
    with open(path, "wb") as f:
        write_header(f, header)
        f32(VOCAB, DIM, 0.0, 1.0, f)  # embedding
        for _ in range(n_layers):
            for out_dim, in_dim in ((q_dim, DIM), (kv_dim, DIM), (kv_dim, DIM),
                                    (DIM, q_dim), (HIDDEN, DIM), (DIM, HIDDEN),
                                    (HIDDEN, DIM)):
                q40(out_dim, in_dim, f)
            f32(1, DIM, 1.0, 0.02, f)  # block_norm_0
            f32(1, DIM, 1.0, 0.02, f)  # block_norm_1
        f32(1, DIM, 1.0, 0.02, f)      # final_norm
        q40(VOCAB, DIM, f)             # final_matmul_logits


PROMPT = ("The quick brown fox jumps over the lazy dog while the synthetic "
          "model answers with whatever its random weights prefer; this prompt "
          "is long enough that its prefill fills a 128-token chunk, a 64-token "
          "chunk and a padded 32-token tail before decoding starts.")


def run_cli(argv: list[str]) -> str:
    from dllama_tpu_torch.serve import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    if rc != 0:
        fail(f"cli {argv[0]} exited {rc}:\n{out}")
    return out


def stat(lines: list[str], section: str, key: str) -> float:
    """A number of the CLI's stats block: ``key`` under ``section``."""
    i = lines.index(section)
    return float(next(ln.split()[1] for ln in lines[i + 1:] if ln.strip().startswith(key)))


def _profile(fn) -> tuple[float, list, object]:
    """Run ``fn`` under ``torch.profiler``: ``(host wall ms, device kernel
    events, the profiler)``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA], prof


def _profiled(fn, n: int) -> tuple[float, list]:
    """Run ``fn`` under ``torch.profiler``: ``(host wall ms, device kernel
    events)``."""
    wall_ms, kernels, _ = _profile(fn)
    return wall_ms, kernels


# every kernel of csrc/: each must land in an op class of the attribution,
# never in "other"
PORT_KERNELS = ("q40_gemv_kernel", "q40_gemv_tc_kernel", "q40_matmul_f32_kernel",
                "q40_matmul_bf16_kernel", "sum_splits_kernel", "flash_attention_kernel",
                "flash_attention_tc_kernel", "paged_attention_kernel", "combine_splits_kernel",
                "moe_matmul_kernel", "moe_tc_kernel", "moe_reduce_kernel")
OP_SUM_TOL = 0.02  # op_attribution's summed kernel ms against key_averages()'s


def op_account(prof, kernels: list, n: int, what: str) -> dict:
    """The port's ``op_attribution`` (``runtime/profiling.py``) on the Chrome
    trace of the same profiler session as ``kernels``: its op-class rollup
    and top ops per step, held to that session's ``key_averages()``: the
    kernel ms per step summed over every lane within :data:`OP_SUM_TOL`, and
    every kernel of the port classified (never ``other``)."""
    from dllama_tpu_torch.runtime import profiling

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dllama_trace_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            trace = json.load(f)
    att = profiling.op_attribution(trace=trace, n_steps=n, top=1_000_000)
    summed = sum(lane["sum_ms"] for lane in att["lanes"]) / n
    key_avg = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    ours = [o for o in att["top_ops"] if any(k in o["name"] for k in PORT_KERNELS)]
    rec = dict(classes=att["classes"], n_lanes=att["n_lanes"],
               summed_kernel_ms=summed, key_averages_ms=key_avg,
               sum_over_union=att["sum_over_union"],
               device_busy_ms=att["device_busy_ms_per_step"],
               top_ops=[dict(name=o["name"][:60], cls=o["class"], ms=o["ms_per_step"],
                             count=o["count"]) for o in att["top_ops"][:8]],
               seconds=time.perf_counter() - t0)
    print(f"⏱️ op attribution of {what} took {rec['seconds']:.1f} s", flush=True)
    if not key_avg or not abs(summed - key_avg) <= OP_SUM_TOL * key_avg:
        fail(f"{what}: op_attribution sums {summed:.4f} kernel ms a step, key_averages() "
             f"{key_avg:.4f} (more than {OP_SUM_TOL:.0%} apart)")
    if not ours or any(o["class"] == "other" for o in ours):
        fail(f"{what}: the port's kernels in the attribution: "
             f"{[(o['name'][:40], o['class']) for o in ours] or 'none'}")
    return rec


# K5's kernels: the tensor-core and the SIMT grouped matmul and the reduce
# of their K splits
K5_KEYS = ("moe_tc_kernel", "moe_matmul_kernel", "moe_reduce_kernel")


def _profile_rec(case: str, dtype: str, unit: str, n: int, wall_ms: float,
                 kernels: list) -> dict:
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"case": case, "compute_dtype": dtype, f"{unit}s": n,
            f"wall_ms_per_{unit}": wall_ms / n,
            f"device_ms_per_{unit}": busy_ms / n if busy_ms else "not measured",
            "device_busy_share": busy_ms / wall_ms if busy_ms else "not measured",
            f"kernels_per_{unit}": sum(e.count for e in kernels) / n,
            # K3's tensor-core single pass as the device ran it
            f"tc_attention_per_{unit}": sum(e.count for e in kernels
                                            if "flash_attention_tc_kernel" in e.key) / n,
            # K5's device time (the MoE expert dots, turbo planes' matmuls),
            # its K-split reduce included
            f"K5_device_ms_per_{unit}": sum(
                e.self_device_time_total for e in kernels
                if any(k in e.key for k in K5_KEYS)) / 1e3 / n,
            f"top_ms_per_{unit}": {e.key[:60]: e.self_device_time_total / 1e3 / n
                                   for e in top}}


def engine_profile(model: str, tok: str, dtype: str, ops: bool = False,
                   **engine_kw) -> list[dict]:
    """Where the engine's time goes, under ``torch.profiler`` on one engine
    (:func:`engine_profiles`). Device busy share = the kernels' summed
    device time over the host wall time; the rest is the device idling while
    the host enqueues the eager ops. ``ops``: each record also holds the
    port's op attribution of its session. ``engine_kw`` (``weight_mode=``)
    goes to the engine."""
    from dllama_tpu_torch.formats.quants import Q80
    from dllama_tpu_torch.runtime.engine import InferenceEngine

    eng = InferenceEngine(model, tok, device=DEV, max_seq_len=MAX_SEQ, sync_type=Q80,
                          compute_dtype="bfloat16" if dtype == "bf16" else "float32",
                          temperature=0.0, **engine_kw)
    try:
        recs = engine_profiles(eng, dtype, ops=ops)
    finally:
        eng.close()
    return [recs["prefill_profile"], recs["decode_profile"]]


def engine_profiles(eng, dtype: str, prefix: str = "", ops: bool = False) -> dict:
    """The single-sequence profile on ``eng`` (reset first): two 128-token
    prefill chunks (at depths 128 and 256, after a warm-up chunk at 0), then
    16 greedy decode steps, each a replay of the captured step (after 4
    warm-up steps, the first of which captures it). The records' cases are
    ``prefix`` + ``prefill_profile`` / ``decode_profile``; with ``ops`` each
    also holds the port's op attribution of its session (:func:`op_account`)."""
    eng.reset()
    ids = eng.tokenizer.encode(PROMPT * 2)
    eng.prefill(ids[:128])
    wall, kernels, prof = _profile(lambda: [eng.prefill(ids[a:a + 128]) for a in (128, 256)])
    out = {"prefill_profile": _profile_rec(f"{prefix}prefill_profile", dtype, "chunk", 2,
                                           wall, kernels)}
    if ops:
        out["prefill_profile"]["ops"] = op_account(prof, kernels, 2,
                                                   f"{dtype} 128-token chunk")
    token = ids[384]
    for _ in range(4):
        token = eng.next_token(token)
    n = 16

    def steps():
        t = token
        for _ in range(n):
            t = eng.next_token(t)

    wall, kernels, prof = _profile(steps)
    out["decode_profile"] = _profile_rec(f"{prefix}decode_profile", dtype, "step", n, wall,
                                         kernels)
    if ops:
        out["decode_profile"]["ops"] = op_account(prof, kernels, n, f"{dtype} decode step")
    return out


def paged_rows(gen, depths: list[int], T: int, g_cpu: torch.Generator) -> torch.Tensor:
    """Scrambled block tables of ``depths`` (:func:`scrambled_tables`, room
    for ``T`` rows each) over ``gen``'s pool, as ``[B, table_width]``."""
    tables, n_blocks = scrambled_tables(depths, T, BLOCK, g_cpu)
    if tables.shape[1] != gen.table_width or n_blocks > gen.pool.n_blocks:
        fail(f"paged rows: tables {tuple(tables.shape)} / {n_blocks} blocks do not fit "
             f"the generator's {gen.table_width} / {gen.pool.n_blocks}")
    return tables


def paged_step_profile(model: str, tok: str, dtype: str, gen=None, ops: bool = False) -> dict:
    """One 8-row paged decode step of the serving geometry (8 slots at the
    ragged depths :data:`RAGGED`, block 16, scrambled tables), as the
    serving scheduler runs it: a replay of ``PagedGenerator``'s captured
    step (``paged_sampled_step``: K2 at M = 8, K4, and in exact mode the
    quantized head on K2), on the full model, under ``torch.profiler``: 8
    replays after 2 warm-up replays. Device ms per step, K2's and K4's
    device ms per step (their kernels and their split sums / combines,
    which no other kernel of the step launches), kernels per step, busy
    share. ``gen``: profile the captured step of this generator (a serving
    run's, its requests done: the replays overwrite its pool) instead of
    building an engine on ``model``. ``ops``: the record also holds the
    port's op attribution of the same session (:func:`op_account`)."""
    from dllama_tpu_torch.formats.quants import Q80
    from dllama_tpu_torch.runtime.engine import InferenceEngine
    from dllama_tpu_torch.runtime.serving import PagedGenerator

    eng = None
    if gen is None:
        eng = InferenceEngine(model, tok, device=DEV, max_seq_len=MAX_SEQ, sync_type=Q80,
                              compute_dtype="bfloat16" if dtype == "bf16" else "float32",
                              temperature=0.0, kv_block_size=BLOCK)
    try:
        own = gen is None
        if own:
            gen = PagedGenerator(eng, SLOTS)
        graph = gen.step_graph()
        tables = paged_rows(gen, RAGGED, 1, torch.Generator().manual_seed(SEED))
        g = torch.Generator(device=DEV).manual_seed(SEED + 8)
        B = len(RAGGED)
        tokens = torch.randint(0, VOCAB, (B, 1), generator=g, device=DEV)
        gen._in.copy_(torch.cat([tokens, torch.tensor(RAGGED, device=DEV)[:, None], tables], 1))
        gen._knobs.copy_(torch.stack([torch.zeros(B, device=DEV), torch.ones(B, device=DEV),
                                      torch.zeros(B, device=DEV),
                                      torch.zeros(B, device=DEV)]))  # poison 0: clean
        for _ in range(2):
            graph.replay()
        n = 8
        wall, kernels, prof = _profile(lambda: [graph.replay() for _ in range(n)])
        if own:
            gen.close()
    finally:
        if eng is not None:
            eng.close()
    rec = _profile_rec("paged_step_profile", dtype, "step", n, wall, kernels)
    if ops:
        rec["ops"] = op_account(prof, kernels, n, f"{dtype} 8-row paged step")
    for name, keys in (("K2", ("q40_gemv", "sum_splits_kernel")),
                       ("K4", ("paged_attention_kernel", "combine_splits_kernel")),
                       ("K5", K5_KEYS)):
        rec[f"{name}_device_ms_per_step"] = sum(
            e.self_device_time_total for e in kernels if any(k in e.key for k in keys)) / 1e3 / n
        rec[f"{name}_kernels_per_step"] = sum(
            e.count for e in kernels if any(k in e.key for k in keys)) / n
    rec["rows"], rec["depths"], rec["block_size"] = B, RAGGED, BLOCK
    return rec


# ---------------------------------------------------------------------------
# phase 4b: the decode steps as CUDA graphs against the eager steps
# ---------------------------------------------------------------------------

GRAPH_STEPS = 64
# the paged graph's rows: the RAGGED depths, the deepest cut so that its 8
# steps stay inside the 2048-position context
PAGED_GRAPH_DEPTHS = [min(d, MAX_SEQ - 8) for d in RAGGED]
PAGED_GRAPH_STEPS = 8


@contextlib.contextmanager
def sync_error():
    """``torch.cuda.set_sync_debug_mode("error")``: any synchronising CUDA
    call inside raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _per_step(counts: dict, n: int) -> dict:
    return {k: v / n for k, v in counts.items()}


def graph_single(eng, ids: list[int], sampled: bool) -> dict:
    """One engine at 8B width from the same prefill (``ids[:-1]``, re-run
    before each decode run): :data:`GRAPH_STEPS` tokens from the eager
    step called by name (``greedy_step``/``sampled_step``, int positions,
    one readback a token), from ``next_token`` (one replay of the captured
    step a token) and from ``decode_chunk_tokens(token, 8)`` (8 replays,
    one readback), greedy or sampled (temperature 0.8, top-p 0.9, the
    xorshift stream of :data:`SEED`); one chunk of 8 launched under the
    sync debug mode "error". Tokens, host-clock tok/s and launches per step
    of each run."""
    from dllama_tpu_torch.models.llama import greedy_step, sampled_step
    from dllama_tpu_torch.tokenizer.sampler import xorshift_random_f32

    temp, topp = (0.8, 0.9) if sampled else (0.0, 0.9)
    n = GRAPH_STEPS

    def fresh() -> None:
        eng.reset()
        eng.prefill(ids[:-1])
        eng.sampler.set_temp(temp)
        eng.sampler.topp = topp
        eng.sampler.set_seed(SEED)

    def run(kind: str) -> tuple[list[int], float, dict]:
        fresh()
        if kind != "eager":
            eng.decode_step_graph(sampled)  # captured on the first run, not timed
        tok, pos, st, out = ids[-1], eng.pos, SEED, []
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        while len(out) < n:
            if kind == "eager":
                x = torch.tensor([[tok]], device=DEV)
                p = pos + len(out)
                if sampled:
                    coin, st = xorshift_random_f32(st)
                    nxt, _, _ = sampled_step(eng.params, eng.cfg, x, p, eng.kv, temp, topp,
                                             coin)
                else:
                    nxt, _, _ = greedy_step(eng.params, eng.cfg, x, p, eng.kv)
                tok = int(nxt[0])
                out.append(tok)
            elif kind == "graph":
                tok = eng.next_token(tok)
                out.append(tok)
            else:
                chunk = eng.decode_chunk_tokens(tok, 8)
                eng.commit_chunk(len(chunk))
                out += chunk
                tok = chunk[-1]
        dt = time.perf_counter() - t0
        return out, n / dt, _per_step(read_counts(), n)

    runs = {kind: run(kind) for kind in ("eager", "graph", "chunk8")}
    graph = eng.decode_step_graph(sampled)
    # one chunk's launch under the sync debug mode; its readback after
    fresh()
    coins = eng._coins(8) if sampled else None
    torch.cuda.synchronize()
    with sync_error():
        graph.launch(ids[-1], eng.pos, 8, temp, topp, coins)
    synced = graph.tokens()
    rec = {kind: dict(tok_per_s=r[1], launches_per_step=r[2]) for kind, r in runs.items()}
    rec.update(tokens_equal={k: runs[k][0] == runs["eager"][0] for k in ("graph", "chunk8")},
               sync_error_chunk_equal=synced == runs["eager"][0][:8],
               distinct_tokens=len(set(runs["eager"][0])),
               capture=graph.step.stats())
    return rec


def graph_paged(eng) -> dict:
    """The 8-row paged step (``PagedGenerator``'s captured step, its static
    buffers loaded as ``step`` loads them) against the eager
    ``paged_sampled_step`` called by name on a copy of the same pool:
    :data:`PAGED_GRAPH_STEPS` steps from rows at
    :data:`PAGED_GRAPH_DEPTHS` through scrambled tables, each row's pick
    fed back, rows alternating greedy and sampled (0.8 / 0.9, seeded
    coins). Tokens, pool bytes, host wall ms per step (copies in, step,
    readback), launches per step, and device ms / busy share of 8 more
    steps of each under ``torch.profiler``."""
    from dllama_tpu_torch.models.llama import paged_sampled_step
    from dllama_tpu_torch.runtime.graphs import load
    from dllama_tpu_torch.runtime.kvblocks import PagedKVCache
    from dllama_tpu_torch.runtime.serving import PagedGenerator

    gen = PagedGenerator(eng, SLOTS)
    g = torch.Generator(device=DEV).manual_seed(SEED + 9)
    for pool in (gen.pkv.k, gen.pkv.v):
        for layer in pool:
            layer.copy_(torch.randn(layer.shape, generator=g, device=DEV))
    graph = gen.step_graph()  # the warm-up writes the null block alone
    g_cpu = torch.Generator().manual_seed(SEED + 9)
    tables = paged_rows(gen, PAGED_GRAPH_DEPTHS, PAGED_GRAPH_STEPS, g_cpu)
    B, n = len(PAGED_GRAPH_DEPTHS), PAGED_GRAPH_STEPS
    depths = torch.tensor(PAGED_GRAPH_DEPTHS)
    tok0 = torch.randint(0, VOCAB, (B,), generator=g_cpu)
    knobs = [torch.stack([torch.tensor([0.0, 0.8] * (B // 2)), torch.full((B,), 0.9),
                          torch.rand(B, generator=g_cpu), torch.zeros(B)])  # poison 0
             for _ in range(n)]
    snap = PagedKVCache(gen.pkv.k.clone(), gen.pkv.v.clone())
    tables_host = tables.cpu()

    def graph_step(i: int, toks: torch.Tensor) -> torch.Tensor:
        load(gen._in, gen._in_host, torch.cat([toks[:, None], (depths + i)[:, None],
                                               tables_host], 1).numpy())
        load(gen._knobs, gen._knobs_host, knobs[i].numpy())
        graph.replay()
        return gen._out.cpu()[0]

    def eager_step(i: int, toks: torch.Tensor) -> torch.Tensor:
        # what PagedGenerator.step dispatched before the graph
        dev = torch.cat([toks[:, None], (depths + i)[:, None], tables_host], 1).to(DEV)
        kn = knobs[i].to(DEV)
        nxt, nf = paged_sampled_step(eng.params, eng.cfg, dev[:, :1], dev[:, 1], snap,
                                     dev[:, 2:], kn[0], kn[1], kn[2])
        return torch.stack([nxt.long(), nf.long()]).cpu()[0]

    rec: dict = {"rows": B, "depths": PAGED_GRAPH_DEPTHS, "steps": n}
    for kind, step in (("graph", graph_step), ("eager", eager_step)):
        toks, picks, ms = tok0, [], []
        torch.cuda.synchronize()
        zero_counts()
        for i in range(n):
            t0 = time.perf_counter()
            toks = step(i, toks)
            ms.append((time.perf_counter() - t0) * 1e3)
            picks.append(toks.tolist())
        rec[kind] = dict(wall_ms_per_step_median=statistics.median(ms),
                         launches_per_step=_per_step(read_counts(), n))
        rec[f"{kind}_tokens"] = picks
    rec["tokens_equal"] = rec.pop("graph_tokens") == rec.pop("eager_tokens")
    rec["pool_bytes_equal"] = bool(torch.equal(gen.pkv.k, snap.k)
                                   and torch.equal(gen.pkv.v, snap.v))
    for kind, step in (("graph", graph_step), ("eager", eager_step)):
        wall, kernels = _profiled(lambda: [step(i, tok0) for i in range(n)], n)
        prof = _profile_rec(f"paged_{kind}_profile", "", "step", n, wall, kernels)
        rec[kind].update({k: prof[k] for k in ("device_ms_per_step", "device_busy_share",
                                                "kernels_per_step", "wall_ms_per_step")})
    rec["capture"] = graph.stats()
    gen.close()
    del snap
    return rec


CUMSUM_RUNS = 50


def cumsum_determinism() -> dict:
    """``ops.sampling._cumsum_rows`` on one fixed softmax row of the
    vocabulary's width, :data:`CUMSUM_RUNS` times: every run must be
    bitwise equal. The sampled step's CDF relies on it; it holds only while
    PyTorch scans a tensor of two rows with its fixed-order per-row scan (a
    single row goes to a scan whose float sums depend on timing). The plain
    ``torch.cumsum`` of the single row is run as often and reported, not
    held: it says whether the two-row detour is still needed."""
    from dllama_tpu_torch.ops.sampling import _cumsum_rows

    g = torch.Generator(device=DEV).manual_seed(SEED + 11)
    row = torch.sort(torch.softmax(torch.randn((1, VOCAB), generator=g, device=DEV) * 4,
                                   dim=-1), dim=-1, descending=True).values
    rec = {"case": "cumsum_rows", "vocab": VOCAB, "runs": CUMSUM_RUNS}
    for name, fn in (("cumsum_rows", _cumsum_rows),
                     ("torch_cumsum_one_row", lambda x: torch.cumsum(x, dim=-1))):
        first = fn(row)
        rec[f"{name}_distinct"] = 1 + sum(not torch.equal(fn(row), first)
                                          for _ in range(CUMSUM_RUNS - 1))
    print(json.dumps(rec), flush=True)
    if rec["cumsum_rows_distinct"] != 1:
        fail(f"ops.sampling._cumsum_rows gave {rec['cumsum_rows_distinct']} different "
             f"results in {CUMSUM_RUNS} runs on one row: the sampled step's CDF is not "
             f"deterministic with this PyTorch ({torch.__version__})")
    return rec


def graphs_phase(model: str, tok: str, summary: dict) -> None:
    """The decode steps as CUDA graphs at 8B width, f32 and bf16: the
    single-sequence step greedy and sampled (:func:`graph_single`: graph
    and chunk-8 tokens equal the eager step's, a chunk launches with no
    synchronisation, launches per replay equal the eager launches per step:
    K2 and K3 and nothing else), the eager and the graph step's device time
    and busy share under ``torch.profiler``, and the 8-row paged step
    (:func:`graph_paged`: equal tokens and pool bytes, K2 and K4 per replay
    as per eager step). First the sampled CDF's scan is held to one result
    over many runs (:func:`cumsum_determinism`). One JSON line per
    numerics."""
    from dllama_tpu_torch.formats.quants import Q80
    from dllama_tpu_torch.models.llama import greedy_step
    from dllama_tpu_torch.runtime.engine import InferenceEngine

    summary["cumsum_rows"] = cumsum_determinism()
    for dtype in ("f32", "bf16"):
        eng = InferenceEngine(model, tok, device=DEV, max_seq_len=MAX_SEQ, sync_type=Q80,
                              compute_dtype="bfloat16" if dtype == "bf16" else "float32",
                              temperature=0.0, seed=SEED, kv_block_size=BLOCK)
        try:
            ids = eng.tokenizer.encode(PROMPT)
            rec = dict(case="graphs", compute_dtype=dtype, layers=eng.cfg.n_layers,
                       decode_steps=GRAPH_STEPS, greedy=graph_single(eng, ids, False),
                       sampled=graph_single(eng, ids, True))
            # 16 steps of each under the profiler, after the runs above
            eng.reset()
            eng.prefill(ids[:-1])
            eng.sampler.set_temp(0.0)
            p0 = eng.pos

            def eager16():
                for i in range(16):
                    greedy_step(eng.params, eng.cfg, torch.tensor([[ids[-1]]], device=DEV),
                                p0 + i, eng.kv)[0].tolist()

            def graph16():
                eng.pos = p0
                for _ in range(16):
                    eng.next_token(ids[-1])

            for kind, fn in (("eager", eager16), ("graph", graph16)):
                wall, kernels = _profiled(fn, 16)
                prof = _profile_rec(f"{kind}_decode_profile", dtype, "step", 16, wall, kernels)
                rec[f"{kind}_decode_profile"] = {k: prof[k] for k in (
                    "device_ms_per_step", "device_busy_share", "kernels_per_step",
                    "wall_ms_per_step")}
            rec["paged"] = graph_paged(eng)
        finally:
            eng.close()
        print(json.dumps(rec), flush=True)
        summary.setdefault(dtype, {})["graphs"] = rec
        torch.cuda.empty_cache()
        check_graphs(rec)


def check_graphs(rec: dict) -> None:
    dtype = rec["compute_dtype"]
    n_layers = rec["layers"]
    for mode in ("greedy", "sampled"):
        r = rec[mode]
        if not all(r["tokens_equal"].values()) or not r["sync_error_chunk_equal"]:
            fail(f"graphs {dtype} {mode}: graph / chunk-8 / sync-debug tokens differ from "
                 f"the eager step's: {r['tokens_equal']}, {r['sync_error_chunk_equal']}")
        if r["distinct_tokens"] < 2:
            fail(f"graphs {dtype} {mode}: the eager step repeats one token")
        eager = r["eager"]["launches_per_step"]
        want_k2 = 7 * n_layers + (1 if dtype == "f32" else 0)  # the Q40 head on K2 in exact mode
        if eager["K2"] != want_k2 or eager["K3"] != n_layers or any(
                eager[k] for k in ("K1", "K4", "K3s")):
            fail(f"graphs {dtype} {mode}: eager launches per step {eager}")
        for kind in ("graph", "chunk8"):
            if r[kind]["launches_per_step"] != eager:
                fail(f"graphs {dtype} {mode} {kind}: launches per step "
                     f"{r[kind]['launches_per_step']}, eager {eager}")
        per = r["capture"]["launches_per_replay"]
        if per != {"q40_gemv": eager["K2"], "flash_attention": eager["K3"]}:
            fail(f"graphs {dtype} {mode}: launches recorded per replay {per}")
    p = rec["paged"]
    if not p["tokens_equal"] or not p["pool_bytes_equal"]:
        fail(f"graphs {dtype} paged: graph and eager steps differ (tokens "
             f"{p['tokens_equal']}, pool bytes {p['pool_bytes_equal']})")
    eager = p["eager"]["launches_per_step"]
    if eager["K2"] <= 0 or eager["K4"] != n_layers or p["graph"]["launches_per_step"] != eager:
        fail(f"graphs {dtype} paged: launches per step graph "
             f"{p['graph']['launches_per_step']}, eager {eager}")
    if p["capture"]["launches_per_replay"] != {"q40_gemv": eager["K2"],
                                               "paged_attention": eager["K4"]}:
        fail(f"graphs {dtype} paged: launches recorded per replay "
             f"{p['capture']['launches_per_replay']}")


def _wrappers() -> dict:
    from dllama_tpu_torch.ops import flash_attention as fa
    from dllama_tpu_torch.ops import moe_matmul as mm
    from dllama_tpu_torch.ops import paged_attention as pa
    from dllama_tpu_torch.ops import quant_matmul as qm

    return {"K1": qm.q40_matmul, "K2": qm.q40_gemv, "K3": fa.flash_attention,
            "K4": pa.paged_attention, "K3s": fa.flash_block_stats, "K5": mm.moe_matmul}


def zero_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in _wrappers().items()}


ASSETS = ("llama31_8b.m", "tok.t", "ppl.txt")  # model, tokenizer, perplexity text


def write_assets(tmp: str, n_layers: int) -> tuple[str, str, str]:
    model, tok, text = (os.path.join(tmp, n) for n in ASSETS)
    t0 = time.perf_counter()
    write_tokenizer(tok)
    write_model(model, n_layers)
    with open(text, "w", encoding="utf-8") as f:
        f.write(PROMPT * 2)
    print(f"📝 synthetic 8B model: {os.path.getsize(model) / 1e9:.2f} GB, "
          f"{n_layers} layers, written in {time.perf_counter() - t0:.1f} s", flush=True)
    return model, tok, text


def main_path(model: str, tok: str, text: str, n_layers: int, summary: dict) -> None:
    for dtype in ("f32", "bf16"):
        common = ["--model", model, "--tokenizer", tok, "--compute-dtype", dtype,
                  "--max-seq-len", str(MAX_SEQ), "--seed", str(SEED)]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        launches = {}

        def counted(path: str, argv: list[str]) -> str:
            # each path's counts: set to 0 just before its run, read just after
            zero_counts()
            out = run_cli(argv)
            launches[path] = read_counts()
            return out

        out = counted("inference", ["inference", *common, "--prompt", PROMPT, "--steps",
                                    str(len(PROMPT.encode()) + 1 + 64), "--temperature", "0"])
        ppl_out = counted("perplexity", ["perplexity", *common, "--file", text])
        wall_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        lines = out.splitlines()
        n_prompt = int(stat(lines, "Evaluation", "nTokens:")) + 1
        n_pred = int(stat(lines, "Prediction", "nTokens:"))
        ppl_lines = ppl_out.splitlines()
        ppl = float(next(ln for ln in ppl_lines if "Perplexity" in ln).split()[-1])
        ppl_tokens = int(next(ln for ln in ppl_lines if "nTokens" in ln).split()[-1])
        rec = dict(case="e2e", compute_dtype=dtype, layers=n_layers,
                   prompt_tokens=n_prompt, generated=n_pred,
                   prefill_tok_per_s=stat(lines, "Evaluation", "tokens/s:"),
                   decode_tok_per_s=stat(lines, "Prediction", "tokens/s:"),
                   perplexity=ppl, perplexity_tokens=ppl_tokens,
                   peak_gb=peak_gb, cli_wall_s=wall_s, launches=launches)
        print(json.dumps(rec), flush=True)
        summary[dtype] = rec
        if n_prompt < 200:
            fail(f"{dtype}: the prompt has {n_prompt} tokens, need >= 200")
        if n_pred != 64:
            fail(f"{dtype}: generated {n_pred} tokens, want 64")
        if not math.isfinite(ppl) or ppl <= 1.0:
            fail(f"{dtype}: perplexity {ppl} is not a finite value above 1")
        # inference prefills (K1, K3) and decodes (K2, K3); perplexity runs
        # only prefill chunks wider than K2's 16 rows
        for path, kernels in (("inference", ("K1", "K2", "K3")),
                              ("perplexity", ("K1", "K3"))):
            if min(launches[path][k] for k in kernels) <= 0:
                fail(f"{dtype} {path}: a kernel of the path never launched: "
                     f"{launches[path]}")
        torch.cuda.empty_cache()
        for prof in engine_profile(model, tok, dtype, ops=True):
            print(json.dumps(prof), flush=True)
            rec[prof["case"]] = prof
        torch.cuda.empty_cache()
    # fast numerics round weights and activations to bf16 but must score the
    # same text about as the exact path does
    rel = abs(summary["bf16"]["perplexity"] / summary["f32"]["perplexity"] - 1.0)
    if not rel <= 0.05:
        fail(f"bf16 perplexity differs from f32 by {rel:.3g} (> 5%)")


PROFILED_STEPS = 8  # decode tokens of the profiled inference run


def profiled_inference(model: str, tok: str) -> dict:
    """One short f32 ``inference`` of the main path under ``--profile DIR``
    on ``model`` (the 8-layer copy; its own run, so the timed runs of
    :func:`main_path` stay unprofiled): the CLI writes a
    trace that the port's ``op_attribution`` reads, every kernel of the port
    in it classified, and prints a ``roofline:`` line whose fraction lies in
    (0, 1]."""
    from dllama_tpu_torch.runtime import profiling

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dllama_profile_") as d:
        zero_counts()
        out = run_cli(["inference", "--model", model, "--tokenizer", tok, "--compute-dtype",
                       "f32", "--max-seq-len", str(MAX_SEQ), "--seed", str(SEED), "--prompt",
                       PROMPT, "--steps", str(len(PROMPT.encode()) + 1 + PROFILED_STEPS),
                       "--temperature", "0", "--profile", d])
        launches = read_counts()
        att = profiling.op_attribution(d, n_steps=1, top=1_000_000)
    lines = out.splitlines()
    roof = next((ln.strip() for ln in lines if ln.strip().startswith("roofline:")), "")
    frac = float(roof.split()[1].rstrip("%")) / 100 if roof.endswith("]") else None
    ours = [o for o in att["top_ops"] if any(k in o["name"] for k in PORT_KERNELS)]
    rec = dict(case="profiled_inference", compute_dtype="f32", roofline_line=roof,
               roofline_fraction=frac, launches=launches,
               trace_line=any(ln.startswith("🔬 profiler trace written to") for ln in lines),
               classes=att["classes"], n_lanes=att["n_lanes"],
               decode_tok_per_s_under_profiler=stat(lines, "Prediction", "tokens/s:"),
               seconds=time.perf_counter() - t0)
    print(json.dumps(rec), flush=True)
    print(f"⏱️ profiled inference took {rec['seconds']:.1f} s", flush=True)
    if frac is None or not 0.0 < frac <= 1.0:
        fail(f"inference --profile: roofline line {roof!r}: the fraction must lie in (0, 1]")
    if not rec["trace_line"] or not att["n_lanes"] or not ours:
        fail(f"inference --profile: trace line {rec['trace_line']}, {att['n_lanes']} lanes, "
             f"{len(ours)} of the port's kernels in the trace")
    if any(o["class"] == "other" for o in ours):
        fail(f"inference --profile: a kernel of the port classified 'other': "
             f"{[o['name'][:40] for o in ours if o['class'] == 'other']}")
    return rec


# ---------------------------------------------------------------------------
# phase 5: serving through the port's api at 8B width
# ---------------------------------------------------------------------------

N_REQUESTS = 16
SLOTS, BLOCK = 8, 16
SYSTEM = ("You are a careful assistant of the synthetic serving check. Answer "
          "in short sentences, keep to the facts given, and say when you do "
          "not know the answer to a question.")  # 166 tokens, one per byte


def serving_bodies() -> list[dict]:
    """16 chat bodies: the even ones and 15 share the system message (the
    slots fill with about half of them first, so later ones share their
    blocks); user parts of 20 to 400 bytes; max_tokens 32 to 61; 8 greedy
    and 8 sampled at temperature 0.8 / top-p 0.9 with seeds; 13 and 14
    stream (SSE); 15 is 14's identical greedy twin."""
    import random

    bodies = []
    for i in range(N_REQUESTS - 1):
        rnd = random.Random(SEED + i)
        n = 20 + (380 * i) // (N_REQUESTS - 2)
        words = []
        while sum(len(w) + 1 for w in words) < n:
            words.append(rnd.choice(["alpha", "beta", "gamma", "delta", "river",
                                     "stone", "cloud", "seven", "orbit", "lemon"]))
        msgs = [{"role": "system", "content": SYSTEM}] if i % 2 == 0 else []
        msgs.append({"role": "user", "content": " ".join(words)[:n]})
        body = {"messages": msgs, "max_tokens": 32 + (32 * i) // (N_REQUESTS - 1)}
        if i in (0, 2, 4, 6, 8, 10, 14):
            body["temperature"] = 0.0
        else:
            body.update(temperature=0.8, top_p=0.9, seed=100 + i)
        body["stream"] = i in (13, 14)
        bodies.append(body)
    bodies.append(dict(bodies[14], stream=False))
    return bodies


def post_chat(url: str, body: dict, first_chunk=None) -> dict:
    """One client request: status, text and wall latency; SSE bodies are
    read chunk by chunk (``first_chunk`` is set at the first content)."""
    import urllib.request

    req = urllib.request.Request(url + "/v1/chat/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=900) as r:
        status = r.status
        if body.get("stream"):
            parts = []
            for raw in r:
                line = raw.decode().strip()
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                piece = json.loads(line[6:])["choices"][0]["delta"].get("content")
                if piece:
                    parts.append(piece)
                    if first_chunk is not None:
                        first_chunk.set()
            text = "".join(parts)
        else:
            text = json.loads(r.read())["choices"][0]["message"]["content"]
    return dict(status=status, text=text, latency_ms=(time.perf_counter() - t0) * 1e3)


def serve_run(model: str, tok: str, n_layers: int, dtype: str, extra: list[str],
              case: str = "serving", paged: bool = True, observe=None,
              picks: tuple | None = None, hold_twin: bool = True, on_gen=None,
              first: dict | None = None) -> dict:
    """One run of the port's api in process (``cli.main(["api", ...,
    *extra])`` on a thread, port 0) over the paged block pool
    (``--kv-block-size``), or over the dense slot pool when not ``paged``:
    the 16 concurrent clients of :func:`serving_bodies`; returns the numbers
    of the run and the scheduler's requests in submit order. Launch counts
    are set to 0 just before the run and read just after it. ``observe(url,
    gen, reqs, replays)``, when given, runs after the clients and before
    the server stops (``replays``: the captured step's replays in the run);
    its result lands in the record as ``observed``. ``picks``: indices of
    the bodies to send (the identical greedy pair 14, 15 last), all 16 by
    default. The record has the captured step's replays, the graphs
    captured while the server listened (none: each step is captured once,
    before) and whether the identical greedy pair's texts are equal, which
    the run holds unless ``hold_twin`` is False. ``on_gen(gen)``, when
    given, runs once the server listens, after the run's own wrappers.
    ``first``, when given, is a body sent alone before the clients. The
    rates and TTFTs count the 16 clients' requests alone, not ``first``'s
    nor those ``observe`` sends."""
    import threading

    from dllama_tpu_torch.runtime.graphs import StepGraph
    from dllama_tpu_torch.serve import cli

    box: dict = {}
    listening = threading.Event()
    step_ms: list[float] = []
    move_ms: dict[str, list[float]] = {"take": [], "put": []}
    reqs: list = []

    def timed_sync(fn, store):
        def wrapped(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            store.append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapped

    def on_listening(server, state):
        gen, sched = state.sched.gen, state.sched
        # the step the scheduler captured before the server listened
        box.update(server=server, gen=gen,
                   capture=(gen._verify if gen.spec else gen._graph).stats())
        submit, step = sched.submit, gen.step

        def submit_recorded(*a, **kw):
            r = submit(*a, **kw)
            reqs.append(r)
            return r

        def step_timed():
            t0 = time.perf_counter()
            n = step()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return n

        sched.submit = submit_recorded
        # the captured step's replays: one per dispatch of a paged tick
        graph = gen._verify if gen.spec else gen._graph
        replay = graph.replay
        box["replays"] = 0

        def replay_counted():
            box["replays"] += 1
            replay()

        graph.replay = replay_counted
        box["captures"] = StepGraph.captures
        if getattr(gen, "chunk", 1) == 1:
            gen.step = step_timed
        if paged:
            gen._exec_take = timed_sync(gen._exec_take, move_ms["take"])
            gen._exec_put = timed_sync(gen._exec_put, move_ms["put"])
        elif gen.chunk > 1:  # --decode-chunk K: the scheduler calls step_chunk
            step_chunk = gen.step_chunk

            def chunk_timed(k):
                t0 = time.perf_counter()
                n = step_chunk(k)
                step_ms.append((time.perf_counter() - t0) * 1e3)
                return n

            gen.step_chunk = chunk_timed
        if on_gen is not None:
            on_gen(gen)
        listening.set()

    argv = ["api", "--model", model, "--tokenizer", tok, "--compute-dtype", dtype,
            "--max-seq-len", str(MAX_SEQ), "--seed", str(SEED), "--temperature", "0",
            "--batch-slots", str(SLOTS), *(["--kv-block-size", str(BLOCK)] if paged else []),
            "--host", "127.0.0.1", "--port", "0", *extra]
    # the wrappers installed below tie the previous run's generator (and
    # its pool) into reference cycles: free it before the peak is reset
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()  # this run's counts: set to 0 just before it, read just after
    th = threading.Thread(target=lambda: box.setdefault(
        "rc", cli.main(argv, on_listening=on_listening)), daemon=True)
    th.start()
    while not listening.wait(timeout=1.0):
        if not th.is_alive():
            fail(f"{case} {dtype}: the api server exited before listening")
    url = f"http://127.0.0.1:{box['server'].server_address[1]}"
    if first is not None and post_chat(url, first).get("status") != 200:
        fail(f"{case} {dtype}: the first body failed")
    bodies = serving_bodies()
    if picks is not None:
        bodies = [bodies[i] for i in picks]
    twin = len(bodies) - 2  # body 14, whose identical twin is the last
    results: list = [None] * len(bodies)
    a_started = threading.Event()

    def client(i: int) -> None:
        try:
            if i == len(bodies) - 1:  # the twin admits while 14 decodes
                a_started.wait(timeout=600)
            results[i] = post_chat(url, bodies[i], a_started if i == twin else None)
        except Exception as e:  # noqa: BLE001 — reported as a failed request below
            results[i] = dict(status=getattr(e, "code", None), error=repr(e))
        finally:
            if i == twin:
                a_started.set()  # a failed 14 must not hold its twin back

    n_before = len(reqs)
    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=900)
    wall_s = time.perf_counter() - t0
    timed = reqs[n_before:]  # the clients' requests: the first body and observe's are not
    gen = box["gen"]
    captured = StepGraph.captures - box["captures"]  # while the clients were served
    observed = observe(url, gen, reqs, box["replays"]) if observe is not None else None
    box["server"].shutdown()
    th.join(timeout=120)
    launches = read_counts()
    if th.is_alive() or box.get("rc") != 0:
        fail(f"{case} {dtype}: the api server did not stop cleanly")
    n_tokens = [len(r.tokens) for r in timed]
    ttft = [(r.t_first_token - r.t_submit) / 1e6 for r in timed if r.t_first_token]
    lat = sorted(r["latency_ms"] for r in results if r and "latency_ms" in r)
    bad = [(i, r) for i, r in enumerate(results)
           if r is None or r.get("status") != 200 or not r.get("text")]
    rec = dict(case=case, compute_dtype=dtype, layers=n_layers, slots=SLOTS,
               pool="paged" if paged else "dense", flags=extra, requests=len(bodies),
               ok=len(bodies) - len(bad), generated_tokens=sum(n_tokens), wall_s=wall_s,
               gen_tok_per_s=sum(n_tokens) / wall_s,
               latency_ms_p50=statistics.median(lat) if lat else None,
               latency_ms_p95=lat[min(len(lat) - 1, int(0.95 * len(lat)))] if lat else None,
               ttft_ms_p50=statistics.median(ttft) if ttft else None,
               step_ms_median=statistics.median(step_ms) if step_ms else None,
               steps=len(step_ms), reused_tokens=gen.reused_tokens,
               pool_gb=gen.pool_bytes / 1e9, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               capture=box["capture"], launches={"api": launches}, replays=box["replays"],
               captures_while_listening=captured)
    if observed is not None:
        rec["observed"] = observed
    if paged:
        pool = gen.pool
        rec.update(
            block_size=BLOCK, pool_blocks=pool.n_blocks,
            pool_tensor_bytes=gen.pkv.k.nbytes + gen.pkv.v.nbytes,
            take_ms_median=statistics.median(move_ms["take"]) if move_ms["take"] else None,
            put_ms_median=statistics.median(move_ms["put"]) if move_ms["put"] else None,
            takes=len(move_ms["take"]),
            column_gb=gen.pool_bytes / pool.n_blocks * gen.table_width / 1e9)
    if bad:
        print(json.dumps(rec), flush=True)
        fail(f"{case} {dtype}: {len(bad)} request(s) failed: {bad[:3]}")
    rec["twin_equal"] = results[twin]["text"] == results[twin + 1]["text"]
    if hold_twin and not rec["twin_equal"]:
        fail(f"{case} {dtype}: the identical greedy pair differs:\n"
             f"{results[twin]['text']!r}\n{results[twin + 1]['text']!r}")
    if gen.reused_tokens <= 0:
        fail(f"{case} {dtype}: no prefix reuse happened")
    box.clear()
    return rec, reqs


def serving(model: str, tok: str, n_layers: int, summary: dict) -> None:
    """The port's api under f32 and bf16 (:func:`serve_run`, the CLI's
    default Q80 sync buffers): 16 concurrent clients, then the checks and
    the numbers of the run. The f32 run also holds the observability of
    slice 11 (:func:`observe_serving`) and writes its spans with
    ``--trace-out``, and the device observability (the compile ledger, the
    live profile, the roofline) after the timed clients
    (:func:`observe_device`)."""
    from dllama_tpu_torch.runtime import flightrec, introspection, telemetry
    from dllama_tpu_torch.runtime.graphs import StepGraph

    for dtype in ("f32", "bf16"):
        trace_out = observe = first = None
        extra = []
        if dtype == "f32":
            # this run's telemetry and compile ledger alone: the earlier
            # phases' counts and programs go
            telemetry.registry().reset()
            telemetry.tracer()._ring.clear()
            flightrec.recorder().reset()
            introspection.ledger().reset()
            fd, trace_out = tempfile.mkstemp(prefix="dllama_spans_", suffix=".jsonl")
            os.close(fd)
            extra = ["--trace-out", trace_out, "--stats", str(STATS_S)]
            captures0 = StepGraph.captures
            first = WIDTHS_BODY
            observe = lambda *a: dict(observe_serving(*a), device=observe_device(  # noqa: E731
                a[0], a[2], StepGraph.captures - captures0))
        try:
            rec, reqs = serve_run(model, tok, n_layers, dtype, extra, observe=observe,
                                  first=first)
            if trace_out:
                rec["observed"]["trace_out"] = check_trace_out(trace_out, reqs)
                rec["observed"]["serving_before"] = SERVING_BEFORE
        finally:
            if trace_out:
                os.unlink(trace_out)
        launches = rec["launches"]["api"]
        print(json.dumps(rec), flush=True)
        summary.setdefault(dtype, {}).setdefault("launches", {})["api"] = launches
        summary[dtype]["serving"] = rec
        if min(launches[k] for k in ("K1", "K2", "K3", "K4")) <= 0:
            fail(f"serving {dtype}: a kernel of the path never launched: {launches}")
        torch.cuda.empty_cache()


STATS_S = 5            # --stats of the observed serving run
# the observed run's first request: its prefill of 490 tokens (the template
# adds 90 to the 400 bytes) runs one chunk of each width (256, 128, 64, 32)
# in a row (any of 480 to 511 tokens would), so every prefill program
# of the scope has run before the retrace sentinel can mark it steady, and
# the 16 clients' chunks, all of these widths, must then file nothing new
WIDTHS_BODY = {"messages": [{"role": "user", "content": "w" * 400}], "max_tokens": 2,
               "temperature": 0.0}
PROFILE_AFTER_S = 0.5  # the live profile's start after its request's: decode under way
# the request the live profile watches (after the timed clients, so their
# rates stay unprofiled): its prefill widths are the clients', and its 256
# tokens decode for a few seconds at 8 layers
PROFILE_BODY = {"messages": [{"role": "user", "content": "profile window"}],
                "max_tokens": 256, "temperature": 0.0}
RAW_FRACTION_MAX = 1.05  # above it a program's byte or operation count is wrong


def _post_path(url: str, path: str) -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + path, data=b"{}",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def profile_live(url: str) -> dict:
    """``POST /debug/profile?ms=500&ops=1`` while :data:`PROFILE_BODY`
    decodes."""
    import threading

    done: dict = {}
    th = threading.Thread(target=lambda: done.update(post_chat(url, PROFILE_BODY)))
    th.start()
    time.sleep(PROFILE_AFTER_S)
    t0 = time.perf_counter()
    status, body = _post_path(url, "/debug/profile?ms=500&ops=1")
    seconds = time.perf_counter() - t0
    th.join(timeout=600)
    if done.get("status") != 200:
        fail(f"the request under the live profile: {done}")
    return dict(status=status, body=body, seconds=seconds)


def observe_device(url: str, reqs: list, captures: int) -> dict:
    """The device observability of the observed serving run, after its
    timed requests: a live profile while one more request decodes
    (:func:`profile_live`) saw steps and classified every kernel of the
    port; ``/debug/compiles`` lists as many
    captures as ``StepGraph.captures`` counted in the run and no unexpected
    retrace after the scope went steady; ``/debug/roofline``'s decode
    summary lies in (0, 1] and no program's raw fraction tops
    :data:`RAW_FRACTION_MAX`; the ``--stats`` line carries ``compiles=``
    and ``roofline=``. ``reqs[0]`` is :data:`WIDTHS_BODY`'s request."""
    from dllama_tpu_torch.runtime import telemetry

    live = profile_live(url)
    t0 = time.perf_counter()
    n_first = len(reqs[0].prompt_ids) - 1
    if not 480 <= n_first <= 511:
        fail(f"the widths body prefills {n_first} tokens: want 480 to 511 (one chunk of "
             f"each width)")
    prof = live.get("body") or {}
    att = prof.get("op_attribution") or {}
    ours = [o for o in att.get("top_ops", ()) if any(k in o["name"] for k in PORT_KERNELS)]
    if (live.get("status") != 200 or not prof.get("n_steps") or not att.get("n_lanes")
            or not ours or any(o["class"] == "other" for o in ours)):
        fail(f"POST /debug/profile while serving: {live.get('status')}, "
             f"{prof.get('n_steps')} steps, {att.get('n_lanes')} lanes, the port's "
             f"kernels {[(o['name'][:40], o['class']) for o in ours]}")
    _, compiles = _get_json(url + "/debug/compiles")
    listed = sum(1 for e in compiles["events"] if e.get("kind") == "capture")
    unexpected = sum(p["unexpected"] for p in compiles["programs"])
    steady = compiles["steady"]
    if listed != captures or unexpected or not steady or not all(steady.values()):
        fail(f"/debug/compiles: {listed} captures listed, StepGraph counted {captures}; "
             f"{unexpected} unexpected; steady {steady}")
    _, roof = _get_json(url + "/debug/roofline")
    summary = roof.get("summary") or {}
    raw = max((p.get("raw_fraction", 0.0) for p in roof["programs"]), default=0.0)
    if not 0.0 < summary.get("roofline_fraction", 0.0) <= 1.0 or raw > RAW_FRACTION_MAX:
        fail(f"/debug/roofline: summary {summary}, largest raw fraction {raw}")
    line = telemetry.stats_line()
    frags = {k: next((p for p in line.split() if p.startswith(k + "=")), None)
             for k in ("compiles", "roofline", "retrace")}
    if not frags["compiles"] or not frags["roofline"] or frags["retrace"]:
        fail(f"--stats line {line!r}: want compiles= and roofline=, no retrace=")
    rec = dict(profile=dict(status=live["status"], seconds=live["seconds"],
                            n_steps=prof["n_steps"], sync_frac=prof["sync_frac"],
                            classes=att["classes"], n_lanes=att["n_lanes"],
                            top_ops=[dict(name=o["name"][:60], cls=o["class"],
                                          ms=o["ms_per_step"]) for o in att["top_ops"][:8]],
                            collective_traffic=prof.get("collective_traffic")),
               compiles=dict(captures=listed, programs=len(compiles["programs"]),
                             events=len(compiles["events"]), steady=steady,
                             unexpected=unexpected,
                             analysis={p["program"]: dict(
                                 bytes=p["analysis"]["hbm_total_bytes"],
                                 ops=p["analysis"]["flops"],
                                 pool=p["analysis"]["hbm_bytes"]["temp"])
                                 for p in compiles["programs"] if p["analysis"]}),
               roofline=dict(ceilings=roof["ceilings"], summary=summary, raw_max=raw,
                             programs=[{k: p.get(k) for k in (
                                 "program", "family", "roofline_fraction", "bound",
                                 "achieved_hbm_gbps", "wall_ms", "no_evidence")}
                                 for p in roof["programs"]]),
               stats={k: v for k, v in frags.items() if v},
               seconds=time.perf_counter() - t0)
    print(f"⏱️ live profile took {live['seconds']:.1f} s, the compiles / roofline / stats "
          f"checks {rec['seconds']:.1f} s", flush=True)
    return rec


# The earlier f32 paged serving run (D2, PERF.md section 5), the newest serving
# numbers PERF.md holds: printed beside this run's, a record, not a gate
SERVING_BEFORE = {"run": "D2", "gen_tok_per_s": 108.29, "step_ms_median": 14.86}


def _metric(text: str, series: str) -> float:
    """One series' value out of a ``/metrics`` body (0 when absent)."""
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def _get_json(url: str) -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def observe_serving(url: str, gen, reqs: list, replays: int) -> dict:
    """The observability of slice 11 on the f32 serving run, after its 16
    requests and on the same server: ``/metrics`` against what the phase
    measures itself (tokens the scheduler emitted, admissions and retires
    of the 16, the generator's reused prompt tokens, the idle block gauge,
    one step histogram sample per replay of the captured step), the
    ``/debug`` routes, the saved flight body through the ``timeline`` mode
    (valid, one complete flow per request), then three ``"timing": true``
    bodies whose phases must sum to their TTFT within the block's rounding
    (7 fields at 0.0005 ms)."""
    import urllib.request

    from dllama_tpu_torch.runtime import flightrec

    with urllib.request.urlopen(url + "/metrics", timeout=120) as r:
        text = r.read().decode()
    n_req = len(reqs)
    emitted = sum(len(r.tokens) for r in reqs)
    got = {k: _metric(text, f"dllama_{k}") for k in (
        "batch_tokens_total", "completion_tokens_total", "admissions_total",
        "retires_total", "prefix_reuse_tokens_total", "kv_blocks_used", "kv_blocks_total",
        "batch_step_ms_count", "flight_ticks_total", "ttft_ms_count",
        "watchdog_stalls_total", "scheduler_crashes_total")}
    want = {"batch_tokens_total": emitted, "completion_tokens_total": emitted,
            "admissions_total": n_req, "retires_total": n_req,
            "prefix_reuse_tokens_total": gen.reused_tokens,
            "kv_blocks_used": gen.pool.used_blocks(), "batch_step_ms_count": replays,
            "ttft_ms_count": n_req, "watchdog_stalls_total": 0,
            "scheduler_crashes_total": 0}
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if bad or gen.pool.used_blocks() != 0:
        fail(f"serving /metrics: (got, want) {bad}, idle blocks used {gen.pool.used_blocks()}")
    rec = dict(metrics=got, replays=replays)
    status, index = _get_json(url + "/debug")
    _, requests = _get_json(url + "/debug/requests")
    _, flight = _get_json(url + "/debug/flight")
    _, live_trace = _get_json(url + "/debug/timeline")
    rids = {r.rid for r in reqs}
    if status != 200 or {q["request_id"] for q in requests["requests"]} != rids:
        fail(f"/debug: {status}, /debug/requests rids "
             f"{sorted(q['request_id'] for q in requests['requests'])} against {sorted(rids)}")
    if flightrec.validate_chrome_trace(live_trace, expect_rids=rids):
        fail("/debug/timeline: " + "; ".join(
            flightrec.validate_chrome_trace(live_trace, expect_rids=rids)[:5]))
    with tempfile.TemporaryDirectory(prefix="dllama_flight_") as d:
        dump, out = os.path.join(d, "flight.json"), os.path.join(d, "trace.json")
        with open(dump, "w", encoding="utf-8") as f:
            json.dump(flight, f)
        rc, _, secs = cli_rc(["timeline", "--dump", dump, "--out", out])
        with open(out, encoding="utf-8") as f:
            trace = json.load(f)
    problems = flightrec.validate_chrome_trace(trace, expect_rids=rids)
    flows = collections.Counter((e["id"], e["ph"]) for e in trace["traceEvents"]
                                if e["ph"] in ("s", "f"))
    one_flow = all(flows[(rid, "s")] == flows[(rid, "f")] == 1 for rid in rids)
    # the loop idles inside an open tick record, which end_tick then drops
    closed = sum(1 for tk in flight["ticks"] if not tk.get("open"))
    rec["timeline"] = dict(rc=rc, seconds=secs, events=len(trace["traceEvents"]),
                           ticks=closed, spans=len(flight["spans"]),
                           problems=problems, one_flow_per_request=one_flow)
    if rc != 0 or problems or not one_flow or closed != got["flight_ticks_total"]:
        fail(f"timeline of the serving run: {rec['timeline']}, "
             f"flight ticks counted {got['flight_ticks_total']}")
    timing = []
    for i in range(3):
        body = {"messages": [{"role": "system", "content": SYSTEM},
                             {"role": "user", "content": f"timing check {i}"}],
                "max_tokens": 8, "temperature": 0.0, "timing": True}
        req = urllib.request.Request(url + "/v1/chat/completions", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            t = json.loads(r.read())["timing"]
        parts = sum(t[k] for k in ("queue_ms", "kvmigrate_ms", "pagein_ms", "admission_ms",
                                   "prefill_ms", "first_decode_ms"))
        timing.append(dict(t, phase_sum_ms=parts))
        if not abs(parts - t["ttft_ms"]) <= 7 * 0.0005 + 1e-9:
            fail(f"timing block {i}: phases sum to {parts} ms, TTFT {t['ttft_ms']} ms")
    rec["timing"] = timing
    return rec


def check_trace_out(path: str, reqs: list) -> dict:
    """The ``--trace-out`` JSONL of the observed serving run: one
    ``queue``, ``prefill`` and ``decode`` span per request (the 16 and the
    three timing bodies)."""
    with open(path, encoding="utf-8") as f:
        spans = [json.loads(line) for line in f]
    phases = collections.defaultdict(collections.Counter)
    for sp in spans:
        phases[sp["request_id"]][sp["phase"]] += 1
    bad = {rid: dict(c) for rid, c in phases.items()
           if any(c[ph] != 1 for ph in ("queue", "prefill", "decode"))}
    if bad or not {r.rid for r in reqs} <= set(phases):
        fail(f"--trace-out: spans per request {bad or dict(phases)}")
    return dict(spans=len(spans), requests=len(phases))


# ---------------------------------------------------------------------------
# phase 5b: prompt-lookup speculative decoding (--spec-lookup K)
# ---------------------------------------------------------------------------

# the near-tie rule of a spec transcript against the same run without spec:
# on the card a verify step's rows go through other kernels than a decode
# step's (K2's tensor cores instead of its SIMT kernel at one row, K1
# instead of K2 at 8 slots), which sum in other orders. Where two
# transcripts part, the logits of that position must put the spec side's
# token within a hair of being picked (:func:`pick_margin`): greedy, its
# logit within NEAR_TIE of the top logit, over |top logit|; sampled, the
# coin's draw within NEAR_TIE_CDF (in probability) of the token's interval
# of the CDF walk, or the token within NEAR_TIE_CDF of the nucleus edge. A
# wrong token (another position's coin, a draft accepted that the model did
# not pick, rows of accepted drafts not written) lies a random distance
# away, a third of the CDF on average. Held in exact mode; in bf16 the
# place and the margin are printed
NEAR_TIE = 1e-4
NEAR_TIE_CDF = 1e-3
# the paged verify step's logits against the plain decode steps' at the
# same positions (exact mode, f32 buffers, relative to max|logits|): f32
# sums in other orders through 32 layers (K1 at M = 40 against K2 at M = 8)
VERIFY_LOGIT_TOL = 1e-4


@contextlib.contextmanager
def recorded_generations(store: list):
    """``(prompt ids, GenerationResult)`` of every
    ``InferenceEngine.generate`` call inside (the CLI prints only text)."""
    from dllama_tpu_torch.runtime.engine import InferenceEngine

    orig = InferenceEngine.generate

    def generate(self, prompt, *a, **kw):
        res = orig(self, prompt, *a, **kw)
        store.append((list(prompt), res))
        return res

    InferenceEngine.generate = generate
    try:
        yield store
    finally:
        InferenceEngine.generate = orig


@contextlib.contextmanager
def recorded_verifies(store: list):
    """``(position, drafts, accepted run)`` of every
    ``InferenceEngine.speculative_tokens`` call inside."""
    from dllama_tpu_torch.runtime.engine import InferenceEngine

    orig = InferenceEngine.speculative_tokens

    def speculative_tokens(self, token, drafts):
        run = orig(self, token, drafts)
        store.append((self.pos, list(drafts), list(run)))
        return run

    InferenceEngine.speculative_tokens = speculative_tokens
    try:
        yield store
    finally:
        InferenceEngine.speculative_tokens = orig


@contextlib.contextmanager
def oracle_drafts(transcripts: dict):
    """Every proposer the port builds inside (the engine's and the paged
    generator's ``NgramProposer``) drafts from ``transcripts`` ({prompt
    ids: tokens}, a run without spec) instead of the n-gram table: the K
    tokens that followed the history in the transcript whose prompt opens
    it, token 0 past its end. On the synthetic weights the table's drafts
    are never what the model says; these are, so the verify steps accept,
    commit, and read the rows of accepted drafts back on the card."""
    from dllama_tpu_torch.runtime import engine, serving

    class Oracle:
        def __init__(self, k: int):
            self.k, self.history = k, []

        def extend(self, tokens) -> None:
            self.history.extend(int(t) for t in tokens)

        def draft(self) -> list[int]:
            h = self.history
            for prompt, toks in transcripts.items():
                full = [*prompt, *toks]
                if len(prompt) <= len(h) <= len(full) and full[:len(h)] == h:
                    d = full[len(h):len(h) + self.k]
                    return d + [0] * (self.k - len(d))
            return [0] * self.k

    saved = engine.NgramProposer, serving.NgramProposer
    engine.NgramProposer = serving.NgramProposer = Oracle
    try:
        yield
    finally:
        engine.NgramProposer, serving.NgramProposer = saved


def pick_margin(logits, got: int, temperature: float = 0.0, topp: float = 0.9,
                coin: float = 0.0) -> float:
    """How far the pick from ``logits`` would have to move for token
    ``got`` to be picked, in float64 (0: it is picked). Greedy: the top
    logit less ``got``'s, over |top logit|. Sampled, on the port's walk
    (cutoff, stable descending sort, nucleus to the first cumulative mass
    over top-p, the coin's draw scaled by the nucleus mass): the distance
    of the draw from ``got``'s interval, and for a ``got`` past the nucleus
    also how far its mass stands from top-p; infinite below the cutoff."""
    import numpy as np

    x = np.asarray(logits, np.float64).reshape(-1)
    if temperature <= 0.0:
        return float((x.max() - x[got]) / max(abs(x.max()), 1e-30))
    p = np.exp((x - x.max()) / temperature)
    p /= p.sum()

    def off(r: float, lo: float, hi: float) -> float:
        return max(lo - r, r - hi, 0.0)

    if not 0.0 < topp < 1.0:
        cs = np.cumsum(p)
        return off(coin, cs[got] - p[got], cs[got])
    p = np.where(p >= (1.0 - topp) / (len(p) - 1), p, 0.0)
    if p[got] == 0.0:
        return math.inf
    order = np.argsort(-p, kind="stable")
    cs = np.cumsum(p[order])
    j = int(np.flatnonzero(order == got)[0])
    last = int(np.argmax(cs > topp)) if (cs > topp).any() else np.count_nonzero(p) - 1
    if j <= last:
        return off(coin * cs[last], cs[j] - p[got], cs[j])
    # the nucleus would have to reach got, which then closes it
    return max(cs[j - 1] - topp, off(coin * cs[j], cs[j] - p[got], cs[j]))


class TieProbe:
    """:func:`pick_margin` of the spec side's token where two transcripts
    of one prompt part, from one single-sequence forward over the prompt
    and the common tokens (f32 buffers, sp = 1), on an engine loaded at the
    first difference and kept for the next ones until :meth:`close`."""

    def __init__(self, model: str, tok: str, dtype: str, seq_len: int):
        self.args = (model, tok, dtype, seq_len)
        self.eng = None

    def close(self) -> None:
        if self.eng is not None:
            self.eng.close()
            self.eng = None

    def __call__(self, prompt: list[int], got: list[int], want: list[int],
                 temperature: float = 0.0, topp: float = 0.9, seed: int = 0) -> dict | None:
        """Where ``got`` parts from ``want`` (None: it does not), and the
        margin of ``got``'s token there."""
        from dllama_tpu_torch.formats.quants import F32
        from dllama_tpu_torch.runtime.engine import InferenceEngine

        i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
        if i is None:
            return None if len(got) == len(want) else dict(pos=min(len(got), len(want)),
                                                           margin=None)
        if self.eng is None:
            model, tok, dtype, seq_len = self.args
            self.eng = InferenceEngine(
                model, tok, device=DEV, max_seq_len=seq_len, sync_type=F32,
                compute_dtype="bfloat16" if dtype == "bf16" else "float32")
        self.eng.reset()
        logits, _ = self.eng.prefill(prompt + want[:i])
        coin = stream_coin(seed, i)
        return dict(pos=i, got=got[i], want=want[i],
                    margin=pick_margin(logits, got[i], temperature, topp, coin),
                    want_margin=pick_margin(logits, want[i], temperature, topp, coin))


def stream_coin(seed: int, i: int) -> float:
    """Coin ``i`` of a request's xorshift stream (emitted token ``i``'s)."""
    from dllama_tpu_torch.tokenizer.sampler import xorshift_random_f32

    coin, st = 0.0, seed
    for _ in range(i + 1):
        coin, st = xorshift_random_f32(st)
    return coin


def near_tie(margin, temperature: float) -> bool:
    return margin is not None and margin < (NEAR_TIE if temperature <= 0.0 else NEAR_TIE_CDF)


def hold_transcripts(what: str, dtype: str, diff: dict | None,
                     temperature: float = 0.0) -> None:
    """The near-tie rule on a :class:`TieProbe` result."""
    if diff is None:
        return
    print(json.dumps(dict(case="transcripts_part", what=what, compute_dtype=dtype, **diff)),
          flush=True)
    if dtype == "f32" and not near_tie(diff["margin"], temperature):
        fail(f"{what}: the transcripts part at token {diff['pos']}, where token "
             f"{diff.get('got')} stood {diff['margin']} from being picked (not a near tie)")


def verify_profile(model: str, tok: str, dtype: str) -> dict:
    """The single-sequence verify step at K = :data:`SPEC_K` under
    ``torch.profiler``: 16 replays of the engine's captured step
    (``speculative_tokens`` at one position, each ending in its one
    readback), on the main path's engine (Q80 buffers), as
    ``engine_profile`` profiles its decode step. The drafts are the ones
    the step itself picks (lane j's pick given drafts 0..j-1, one call per
    lane, the first of which captures the step), so every replay accepts
    all K. Device ms, busy share and kernels per replay, the launches the
    capture recorded per replay, the runs, and the engine's own K + 1
    greedy decode steps from the same position beside them (printed: the
    Q80 casts turn the other kernels' sum order into whole int8 steps)."""
    from dllama_tpu_torch.formats.quants import Q80
    from dllama_tpu_torch.runtime.engine import InferenceEngine

    eng = InferenceEngine(model, tok, device=DEV, max_seq_len=MAX_SEQ, sync_type=Q80,
                          compute_dtype="bfloat16" if dtype == "bf16" else "float32",
                          temperature=0.0, spec_lookup=SPEC_K)
    try:
        ids = eng.tokenizer.encode(PROMPT)
        eng.prefill(ids[:-1])
        drafts = [0] * SPEC_K
        for j in range(SPEC_K):
            drafts[j] = eng.speculative_tokens(ids[-1], drafts)[j]
        n, runs = 16, []
        wall, kernels = _profiled(
            lambda: [runs.append(eng.speculative_tokens(ids[-1], drafts)) for _ in range(n)], n)
        rec = _profile_rec("verify_profile", dtype, "replay", n, wall, kernels)
        rec["capture"] = eng._verify_graph.step.stats()
        rec["accepted_per_replay"] = sorted({len(r) - 1 for r in runs})
        rec["runs_equal"] = all(r == runs[0] for r in runs)
        rec["run"] = runs[0]
        rec["decode"] = eng.decode_chunk_tokens(ids[-1], SPEC_K + 1)
    finally:
        eng.close()
    return rec


def spec_single(model: str, tok: str, n_layers: int, summary: dict) -> None:
    """``inference --spec-lookup K --temperature 0`` through the CLI at full
    width, f32 and bf16, against the same run without spec: the main
    path's prompt and 64 tokens, with f32 sync buffers on all sides (the
    Q80 casts turn a last-ulp difference of the verify's other kernels into
    whole int8 steps, ``sp_path``'s reason). Two spec runs: the n-gram
    table's drafts (the flag as users run it), and the run without spec's
    own tokens as the drafts (:func:`oracle_drafts`), whose verify steps
    must each accept every such draft (f32) while the transcripts agree.
    Transcripts held to the near-tie rule; decode tok/s, the ``spec rate``
    line, launches; then the verify step's profile
    (:func:`verify_profile`), whose capture must have recorded K2 and K3
    once a matmul and a layer (K2 at M = K + 1 on the tensor cores) and
    nothing else, and whose replays must all accept their K drafts."""
    for dtype in ("f32", "bf16"):
        common = ["--model", model, "--tokenizer", tok, "--compute-dtype", dtype,
                  "--max-seq-len", str(MAX_SEQ), "--seed", str(SEED), "--temperature", "0",
                  "--buffer-float-type", "f32", "--prompt", PROMPT,
                  "--steps", str(len(PROMPT.encode()) + 1 + 64)]
        runs = {}
        for name, extra in (("plain", []), ("spec", ["--spec-lookup", str(SPEC_K)]),
                            ("oracle", ["--spec-lookup", str(SPEC_K)])):
            gens: list = []
            calls: list = []
            drafts = (oracle_drafts({tuple(runs["plain"]["prompt"]): runs["plain"]["tokens"]})
                      if name == "oracle" else contextlib.nullcontext())
            zero_counts()
            with recorded_generations(gens), recorded_verifies(calls), drafts:
                out = run_cli(["inference", *common, *extra])
            lines = out.splitlines()
            rate = [ln.split() for ln in lines if ln.startswith("  spec rate: ")]
            preds = [st for st in gens[0][1].steps if st.kind == "pred"][1:]
            runs[name] = dict(prompt=gens[0][0], tokens=gens[0][1].tokens, verifies=calls,
                              decode_tok_per_s=stat(lines, "Prediction", "tokens/s:"),
                              # without the first dispatch, which captures the step
                              steady_tok_per_s=1e3 * sum(st.n_tokens for st in preds)
                              / sum(st.ms for st in preds),
                              launches=read_counts(),
                              spec_rate=float(rate[0][2]) if rate else None,
                              dispatches=int(rate[0][4].lstrip("(")) if rate else None)
        plain = runs["plain"]
        probe = TieProbe(model, tok, dtype, MAX_SEQ)
        try:
            diffs = {k: probe(runs[k]["prompt"], runs[k]["tokens"], plain["tokens"])
                     for k in ("spec", "oracle")}
        finally:
            probe.close()
        # the oracle's verify steps before the transcripts part: each
        # accepts its real drafts (those inside the run without spec)
        oracle, n0 = runs["oracle"], len(plain["prompt"]) - 1
        upto = diffs["oracle"]["pos"] if diffs["oracle"] else len(plain["tokens"])
        short = []
        for pos, _, run in oracle["verifies"]:
            real = min(SPEC_K, len(plain["tokens"]) - (pos - n0))
            if pos - n0 + real < upto and len(run) < real + 1:
                short.append(dict(at=pos - n0, real_drafts=real, accepted=len(run) - 1))
        accepted = sum(len(r) - 1 for _, _, r in oracle["verifies"])
        drafted = sum(min(SPEC_K, len(plain["tokens"]) - (p - n0))
                      for p, _, _ in oracle["verifies"])
        prof = verify_profile(model, tok, dtype)
        print(json.dumps(prof), flush=True)
        rec = dict(case="spec_single", compute_dtype=dtype, layers=n_layers, k=SPEC_K,
                   generated={k: len(r["tokens"]) for k, r in runs.items()},
                   tokens_equal={k: runs[k]["tokens"] == plain["tokens"]
                                 for k in ("spec", "oracle")},
                   first_difference=diffs,
                   decode_tok_per_s={k: r["decode_tok_per_s"] for k, r in runs.items()},
                   steady_tok_per_s={k: r["steady_tok_per_s"] for k, r in runs.items()},
                   spec_rate={k: runs[k]["spec_rate"] for k in ("spec", "oracle")},
                   dispatches={k: runs[k]["dispatches"] for k in ("spec", "oracle")},
                   oracle_accepted=accepted, oracle_real_drafts=drafted,
                   oracle_short_verifies=short,
                   launches={k: r["launches"] for k, r in runs.items()},
                   verify_profile={k: prof[k] for k in (
                       "wall_ms_per_replay", "device_ms_per_replay", "device_busy_share",
                       "kernels_per_replay", "capture", "accepted_per_replay", "runs_equal",
                       "run", "decode")})
        print(json.dumps(rec), flush=True)
        summary.setdefault(dtype, {}).setdefault("launches", {})["inference_spec"] = \
            runs["spec"]["launches"]
        summary[dtype]["launches"]["inference_spec_oracle"] = oracle["launches"]
        summary[dtype]["spec_single"] = rec
        for k in ("spec", "oracle"):
            hold_transcripts(f"spec single {k} {dtype}", dtype, diffs[k])
            r = runs[k]
            if len(r["tokens"]) != 64 or r["spec_rate"] is None or r["dispatches"] < 1:
                fail(f"spec single {k} {dtype}: {len(r['tokens'])} tokens, spec rate line "
                     f"{r['spec_rate']} ({r['dispatches']} dispatches)")
            if min(r["launches"][n] for n in ("K1", "K2", "K3")) <= 0:
                fail(f"spec single {k} {dtype}: a kernel of the path never launched: "
                     f"{r['launches']}")
        if dtype == "f32" and (short or accepted <= 0):
            fail(f"spec single oracle f32: verify steps rejected drafts the run without "
                 f"spec emitted: {short} ({accepted} accepted)")
        per = prof["capture"]["launches_per_replay"]
        want_k2 = 7 * n_layers + (1 if dtype == "f32" else 0)  # the Q40 head in exact mode
        if not prof["capture"]["captured"] or per != {"q40_gemv": want_k2,
                                                      "flash_attention": n_layers}:
            fail(f"spec single {dtype}: the verify step's capture {prof['capture']}")
        if prof["accepted_per_replay"] != [SPEC_K] or not prof["runs_equal"]:
            fail(f"spec single {dtype}: the profiled replays of self-drafted verify steps "
                 f"accepted {prof['accepted_per_replay']} (want all {SPEC_K}), "
                 f"runs equal {prof['runs_equal']}")
        torch.cuda.empty_cache()


def graph_paged_verify(eng, dtype: str) -> dict:
    """The 8-row paged verify step at K = :data:`SPEC_K`
    (``PagedGenerator``'s captured verify step, its static buffers loaded
    as ``_spec_step`` loads them) against the eager ``paged_verify_step``
    called by name on a copy of the same pool: 4 steps of rows at
    :data:`PAGED_GRAPH_DEPTHS` through scrambled tables, ragged draft
    lengths 0-4, rows alternating greedy and sampled (0.8 / 0.9, seeded
    coins). Rows ``b % 3 == 0`` draft what the verify step itself picks
    (lane j's pick given drafts 0..j-1, found by eager steps): every draft
    must be accepted; rows ``b % 3 == 1`` the same with the last live
    draft changed: all but that one; the others draft at random.

    Before each step's graph run, on the pool copy: the step's logits
    (``paged_forward`` with its draft lengths) against K + 1 plain decode
    steps at the same positions (``paged_forward`` one token wide, the
    decode step's route: K2 at M = 8), over every live lane; the port's
    sampler on the step's logits must give its outputs exactly; and its
    emitted tokens must equal the decode steps' picks with the same coins
    or lie in a near tie of them (:func:`pick_margin`). Then ``(n_acc,
    out, nonfinite)`` and pool bytes outside the null block, graph against
    eager; host wall ms per step (copies in, step, readback), launches per
    step, and device ms / busy share of 4 more steps of each under
    ``torch.profiler``, with K1's, K4's and the samplers' sort's device ms
    per step."""
    from dllama_tpu_torch.models.llama import paged_forward, paged_verify_step
    from dllama_tpu_torch.ops.sampling import sampled_token
    from dllama_tpu_torch.runtime.graphs import load
    from dllama_tpu_torch.runtime.kvblocks import PagedKVCache
    from dllama_tpu_torch.runtime.serving import PagedGenerator

    gen = PagedGenerator(eng, SLOTS)
    K, W = SPEC_K, SPEC_K + 1
    g = torch.Generator(device=DEV).manual_seed(SEED + 12)
    for pool in (gen.pkv.k, gen.pkv.v):
        for layer in pool:
            layer.copy_(torch.randn(layer.shape, generator=g, device=DEV))
    graph = gen.verify_graph()  # the warm-up writes the null block alone
    n = 4
    depths = [min(d, MAX_SEQ - 1 - n * W) for d in RAGGED]
    B = len(depths)
    g_cpu = torch.Generator().manual_seed(SEED + 12)
    tables = paged_rows(gen, depths, n * W, g_cpu).cpu()
    temps, topps = torch.tensor([0.0, 0.8] * (B // 2)), torch.full((B,), 0.9)
    snap = PagedKVCache(gen.pkv.k.clone(), gen.pkv.v.clone())
    steps, want_acc, lanes = [], [], dict(checked=0, equal=0, parts=[], logit_rel=0.0,
                                          sampler_mismatch=0)
    for i in range(n):
        toks = torch.randint(0, VOCAB, (B, W), generator=g_cpu)
        lens = torch.tensor([(b + i) % W for b in range(B)])
        coins = torch.rand((W, B), generator=g_cpu)
        pos = torch.tensor(depths) + i * W
        on = lambda t: t.to(DEV)  # noqa: E731

        def verify():
            return paged_verify_step(eng.params, eng.cfg, on(toks), on(pos), snap, on(tables),
                                     on(lens), on(temps), on(topps), on(coins[:K].t()),
                                     on(coins[K]))

        for j in range(K):
            out = verify()[1].cpu()
            for b in range(0, B):
                if b % 3 != 2:
                    toks[b, j + 1] = out[b, j]
        for b in range(1, B, 3):
            if lens[b]:
                toks[b, lens[b]] = (toks[b, lens[b]] + 1) % VOCAB
        want_acc.append([int(lens[b]) if b % 3 == 0 else max(int(lens[b]) - 1, 0)
                         if b % 3 == 1 else None for b in range(B)])
        vlog, _ = paged_forward(eng.params, eng.cfg, on(toks), on(pos), snap, on(tables),
                                write_lens=on(lens))
        plog = []
        for j in range(W):  # the decode steps overwrite the rows they read
            tab = torch.where((j <= lens)[:, None], tables, torch.zeros_like(tables))
            plog.append(paged_forward(eng.params, eng.cfg, on(toks[:, j:j + 1]), on(pos + j),
                                      snap, on(tab))[0][:, 0])
        plog = torch.stack(plog, 1)
        n_acc, out, _ = verify()  # the step itself, on the state the graph will see
        flat = lambda lg: sampled_token(  # noqa: E731
            lg.reshape(B * W, -1), on(temps.repeat_interleave(W)),
            on(topps.repeat_interleave(W)), on(coins.t().reshape(-1))).reshape(B, W).cpu()
        vpick, ppick, out, n_acc = flat(vlog), flat(plog), out.cpu(), n_acc.cpu()
        for b in range(B):
            live = slice(0, int(lens[b]) + 1)
            lanes["sampler_mismatch"] += int((vpick[b, live] != out[b, live]).sum())
            ref = plog[b, live].abs().max()
            lanes["logit_rel"] = max(lanes["logit_rel"], float(
                (vlog[b, live] - plog[b, live]).abs().max() / ref))
            for j in range(int(n_acc[b]) + 1):
                lanes["checked"] += 1
                if out[b, j] == ppick[b, j]:
                    lanes["equal"] += 1
                    continue
                m = pick_margin(plog[b, j].double().cpu().numpy(), int(out[b, j]),
                                float(temps[b]), float(topps[b]), float(coins[j, b]))
                lanes["parts"].append(dict(step=i, row=b, lane=j, got=int(out[b, j]),
                                           want=int(ppick[b, j]), temperature=float(temps[b]),
                                           margin=m))
        knobs = torch.cat([temps[None], topps[None], coins, torch.zeros_like(temps)[None]])
        steps.append((torch.cat([toks, pos[:, None], lens[:, None], tables], 1), knobs))
        del vlog, plog
    snap.k.copy_(gen.pkv.k)
    snap.v.copy_(gen.pkv.v)

    def graph_step(i: int) -> torch.Tensor:
        load(gen._vin, gen._vin_host, steps[i][0].numpy())
        load(gen._vknobs, gen._vknobs_host, steps[i][1].numpy())
        graph.replay()
        return gen._vout.to("cpu", copy=True)  # a copy on the CPU too

    def eager_step(i: int) -> torch.Tensor:
        inp, kn = (t.to(DEV) for t in steps[i])
        n_acc, out, nf = paged_verify_step(
            eng.params, eng.cfg, inp[:, :W], inp[:, W], snap, inp[:, W + 2:], inp[:, W + 1],
            kn[0], kn[1], kn[2:W + 1].t(), kn[W + 1])
        return torch.cat([n_acc[None], nf.long()[None], out.t()]).cpu()

    rec: dict = {"rows": B, "k": K, "depths": depths, "steps": n, "lanes": lanes}
    outs = {}
    for kind, step in (("graph", graph_step), ("eager", eager_step)):
        res, ms = [], []
        torch.cuda.synchronize()
        zero_counts()
        for i in range(n):
            t0 = time.perf_counter()
            res.append(step(i))
            ms.append((time.perf_counter() - t0) * 1e3)
        rec[kind] = dict(wall_ms_per_step_median=statistics.median(ms),
                         launches_per_step=_per_step(read_counts(), n))
        outs[kind] = torch.stack(res)
    rec["outputs_equal"] = bool(torch.equal(outs["graph"], outs["eager"]))
    rec["nonfinite"] = int(outs["graph"][:, 1].sum())
    rec["accepted"] = int(outs["graph"][:, 0].sum())
    got_acc = outs["graph"][:, 0].tolist()
    rec["self_drafted"] = dict(want=want_acc, got=got_acc, held=all(
        w is None or w == a for ws, gs in zip(want_acc, got_acc) for w, a in zip(ws, gs)))
    # outside the null block: the padded lanes of several rows write one
    # null cell, and which write lands last is the scatter's own
    rec["pool_bytes_equal"] = bool(torch.equal(gen.pkv.k[:, 1:], snap.k[:, 1:])
                                   and torch.equal(gen.pkv.v[:, 1:], snap.v[:, 1:]))
    rec["null_block_equal"] = bool(torch.equal(gen.pkv.k[:, 0], snap.k[:, 0]))
    for kind, step in (("graph", graph_step), ("eager", eager_step)):
        wall, kernels = _profiled(lambda: [step(i) for i in range(n)], n)
        prof = _profile_rec(f"paged_verify_{kind}_profile", dtype, "step", n, wall, kernels)
        rec[kind].update({k: prof[k] for k in ("device_ms_per_step", "device_busy_share",
                                                "kernels_per_step", "wall_ms_per_step",
                                                "top_ms_per_step")})
        for name, keys in (("K1", ("q40_matmul", "sum_splits_kernel")),
                           ("K4", ("paged_attention_kernel", "combine_splits_kernel")),
                           ("sort", ("sort", "Sort"))):
            rec[kind][f"{name}_device_ms_per_step"] = sum(
                e.self_device_time_total for e in kernels
                if any(k in e.key for k in keys)) / 1e3 / n
    rec["capture"] = graph.stats()
    gen.close()
    del snap
    return rec


def spec_serving(model: str, tok: str, n_layers: int, summary: dict) -> None:
    """``api --batch-slots 8 --kv-block-size 16 --spec-lookup K`` with the
    serving phase's 16-request chat mix (:func:`serve_run`), f32 and bf16,
    against the same run without spec, all on f32 sync buffers
    (:func:`spec_single`'s reason). Two spec runs: the n-gram tables'
    drafts, and the run without spec's own tokens as every slot's drafts
    (:func:`oracle_drafts`). Every request's tokens held to the near-tie
    rule, greedy and sampled; in the second run a greedy request whose
    transcript equals the run without spec must have had every draft
    accepted (f32). Generated tok/s, the accept rate (accepted / drafted),
    the verify step's wall ms (the scheduler's step) and its capture; then
    the paged verify step alone, graph against eager and against plain
    decode steps (:func:`graph_paged_verify`, on f32 sync buffers too)."""
    from dllama_tpu_torch.formats.quants import F32
    from dllama_tpu_torch.runtime.engine import InferenceEngine

    f32_buf = ["--buffer-float-type", "f32"]
    spec_flag = ["--spec-lookup", str(SPEC_K)]
    for dtype in ("f32", "bf16"):
        base, base_reqs = serve_run(model, tok, n_layers, dtype, f32_buf,
                                    case="spec_serving_base")
        want = {}
        for r in base_reqs:
            want.setdefault((tuple(r.prompt_ids), r.temperature, r.seed), r.tokens)
        # the dense pool's phase holds its own transcripts to these
        summary.setdefault(dtype, {})["paged_f32_buffers_transcripts"] = want
        spec, reqs = serve_run(model, tok, n_layers, dtype, f32_buf + spec_flag,
                               case="spec_serving")
        with oracle_drafts({p: t for (p, _, _), t in want.items()}):
            oracle, oreqs = serve_run(model, tok, n_layers, dtype, f32_buf + spec_flag,
                                      case="spec_serving_oracle")
        runs = {"spec": (spec, reqs), "oracle": (oracle, oreqs)}
        diffs = {k: [] for k in runs}
        short = []
        probe = TieProbe(model, tok, dtype, MAX_SEQ)
        try:
            for k, (_, rs) in runs.items():
                for r in rs:
                    w = want[(tuple(r.prompt_ids), r.temperature, r.seed)]
                    d = probe(r.prompt_ids, r.tokens, w, r.temperature, r.topp, r.seed)
                    if d is not None:
                        diffs[k].append(dict(d, rid=r.rid, temperature=r.temperature))
                    elif (k == "oracle" and r.temperature <= 0.0
                          and len(r.tokens) == r.max_tokens
                          and r.spec_accepted != r.spec_drafted):
                        short.append(dict(rid=r.rid, drafted=r.spec_drafted,
                                          accepted=r.spec_accepted))
        finally:
            probe.close()
        eng = InferenceEngine(model, tok, device=DEV, max_seq_len=MAX_SEQ, sync_type=F32,
                              compute_dtype="bfloat16" if dtype == "bf16" else "float32",
                              temperature=0.0, seed=SEED, kv_block_size=BLOCK,
                              spec_lookup=SPEC_K)
        try:
            paged = graph_paged_verify(eng, dtype)
        finally:
            eng.close()

        def tally(rs, greedy):
            sel = [r for r in rs if (r.temperature <= 0.0) == greedy]
            return dict(drafted=sum(r.spec_drafted for r in sel),
                        accepted=sum(r.spec_accepted for r in sel))

        accept = {k: {kind: tally(rs, kind == "greedy") for kind in ("greedy", "sampled")}
                  for k, (_, rs) in runs.items()}
        for a in accept.values():
            for t in a.values():
                t["accept_rate"] = t["accepted"] / t["drafted"] if t["drafted"] else None
        rec = dict(case="spec_serving_summary", compute_dtype=dtype, k=SPEC_K,
                   gen_tok_per_s={"plain": base["gen_tok_per_s"],
                                  **{k: r["gen_tok_per_s"] for k, (r, _) in runs.items()}},
                   step_ms_median={"plain": base["step_ms_median"],
                                   **{k: r["step_ms_median"] for k, (r, _) in runs.items()}},
                   steps={"plain": base["steps"], **{k: r["steps"] for k, (r, _) in runs.items()}},
                   generated_tokens={"plain": base["generated_tokens"], **{
                       k: r["generated_tokens"] for k, (r, _) in runs.items()}},
                   accept=accept,
                   requests_equal={k: len(rs) - len(diffs[k]) for k, (_, rs) in runs.items()},
                   parts=diffs, oracle_short_requests=short,
                   capture=spec["capture"], pool_gb=spec["pool_gb"],
                   peak_gb=spec["peak_gb"],
                   launches={k: r["launches"]["api"] for k, (r, _) in runs.items()},
                   paged_verify=paged)
        print(json.dumps(base), flush=True)
        print(json.dumps(spec), flush=True)
        print(json.dumps(oracle), flush=True)
        print(json.dumps(rec), flush=True)
        summary.setdefault(dtype, {}).setdefault("launches", {})["api_spec"] = \
            spec["launches"]["api"]
        summary[dtype]["launches"]["api_spec_oracle"] = oracle["launches"]["api"]
        summary[dtype]["spec_serving"] = rec
        for k, ds in diffs.items():
            for d in ds:
                hold_transcripts(f"spec serving {k} {dtype} request {d['rid']}", dtype, d,
                                 d["temperature"])
        for k, (r, _) in runs.items():
            if not r["capture"]["captured"]:
                fail(f"spec serving {k} {dtype}: the paged verify step was not captured: "
                     f"{r['capture']}")
            if accept[k]["greedy"]["drafted"] + accept[k]["sampled"]["drafted"] <= 0:
                fail(f"spec serving {k} {dtype}: no draft was verified")
            # every tick is a verify step: K1 (M = 8 (K + 1), the head too),
            # K4 (T = K + 1); prefill K1 and K3
            launches = r["launches"]["api"]
            if min(launches[n] for n in ("K1", "K3", "K4")) <= 0:
                fail(f"spec serving {k} {dtype}: a kernel of the path never launched: "
                     f"{launches}")
        if dtype == "f32" and (short or accept["oracle"]["greedy"]["accepted"] <= 0):
            fail(f"spec serving oracle f32: greedy requests equal to the run without spec "
                 f"had drafts rejected: {short} ({accept['oracle']['greedy']})")
        if not paged["outputs_equal"] or not paged["pool_bytes_equal"] or paged["nonfinite"]:
            fail(f"spec serving {dtype}: the paged verify graph and the eager step differ "
                 f"(outputs {paged['outputs_equal']}, pool bytes "
                 f"{paged['pool_bytes_equal']}, non-finite lanes {paged['nonfinite']})")
        lanes = paged["lanes"]
        if not paged["self_drafted"]["held"] or lanes["sampler_mismatch"]:
            fail(f"spec serving {dtype}: the paged verify step's self-drafted rows accepted "
                 f"{paged['self_drafted']}; outputs off the sampler on its own logits: "
                 f"{lanes['sampler_mismatch']}")
        far = [d for d in lanes["parts"] if not near_tie(d["margin"], d["temperature"])]
        if dtype == "f32" and (far or not lanes["logit_rel"] <= VERIFY_LOGIT_TOL):
            fail(f"spec serving f32: the paged verify step against plain decode steps: "
                 f"logits {lanes['logit_rel']} (tol {VERIFY_LOGIT_TOL}), tokens not in a "
                 f"near tie {far[:4]}")
        eager = paged["eager"]["launches_per_step"]
        if (eager["K1"] <= 0 or eager["K4"] != n_layers or eager["K2"]
                or paged["graph"]["launches_per_step"] != eager
                or paged["capture"]["launches_per_replay"] != {
                    "q40_matmul": eager["K1"], "paged_attention": eager["K4"]}):
            fail(f"spec serving {dtype}: paged verify launches per step graph "
                 f"{paged['graph']['launches_per_step']}, eager {eager}, recorded "
                 f"{paged['capture']['launches_per_replay']}")
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5c: the dense slot pool, the single-sequence api and chat
# ---------------------------------------------------------------------------


def dense_step_profile(model: str, tok: str, dtype: str) -> dict:
    """One 8-row step of the dense slot pool at the serving geometry (8
    slots at the ragged depths :data:`RAGGED` of their 2048-row columns,
    random cache contents), as the serving scheduler runs it: a replay of
    ``BatchedGenerator``'s captured step (``ragged_sampled_step``: K2 at
    M = 8, K3's single pass over 8 rows with a start position each, and in
    exact mode the quantized head on K2), on the full model, under
    ``torch.profiler``: 8 replays after 2 warm-up replays. Device ms, busy
    share, K2's and K3's device ms and kernels per step, the launches the
    capture recorded per replay against the eager step's; then one replay
    against the eager ``ragged_sampled_step`` called by name on a copy of
    the pool from the same inputs: tokens and cache bytes equal."""
    from dllama_tpu_torch.formats.quants import Q80
    from dllama_tpu_torch.models.llama import ragged_sampled_step
    from dllama_tpu_torch.runtime.engine import InferenceEngine
    from dllama_tpu_torch.runtime.graphs import load
    from dllama_tpu_torch.runtime.kvcache import KVCache
    from dllama_tpu_torch.runtime.serving import BatchedGenerator

    eng = InferenceEngine(model, tok, device=DEV, max_seq_len=MAX_SEQ, sync_type=Q80,
                          compute_dtype="bfloat16" if dtype == "bf16" else "float32",
                          temperature=0.0)
    try:
        gen = BatchedGenerator(eng, SLOTS)
        g = torch.Generator(device=DEV).manual_seed(SEED + 9)
        for t in (gen.kv.k, gen.kv.v):
            for l in range(t.shape[0]):
                t[l].copy_(torch.randn(t.shape[1:], generator=g, device=DEV))
        graph = gen.step_graph()
        B = SLOTS
        tokens = torch.randint(0, VOCAB, (B,), generator=g, device=DEV)
        pos = torch.tensor(RAGGED, device=DEV)
        knobs = torch.zeros_like(gen._knobs)
        knobs[1] = 1.0
        gen._knobs.copy_(knobs)

        def step() -> None:
            # one tick as BatchedGenerator._dispatch runs it: the inputs
            # staged on the host and copied in, one replay (positions
            # past the context clamp in the step)
            load(gen._in, gen._in_host, torch.stack(
                [tokens.cpu(), pos.cpu() + i[0], torch.zeros(B, dtype=torch.long)], 1).numpy())
            graph.replay()
            i[0] += 1

        i = [0]
        for _ in range(2):
            step()
        n = 8
        wall, kernels = _profiled(lambda: [step() for _ in range(n)], n)
        # one replay against the eager step on a copy of the pool
        gen._in.copy_(torch.stack([tokens, pos, torch.zeros_like(pos)], 1))
        kv = KVCache(gen.kv.k.clone(), gen.kv.v.clone())
        graph.replay()
        got = gen._out[0, 0].clone()
        zero_counts()
        zeros = torch.zeros(B, device=DEV)
        want, nf = ragged_sampled_step(eng.params, eng.cfg, tokens[:, None],
                                       pos.clamp(max=MAX_SEQ - 1), kv, zeros,
                                       torch.ones(B, device=DEV), zeros)
        torch.cuda.synchronize()
        eager = read_counts()
        rec = _profile_rec("dense_step_profile", dtype, "step", n, wall, kernels)
        rec.update(tokens_equal=bool(torch.equal(got, want)),
                   pool_bytes_equal=bool(torch.equal(gen.kv.k, kv.k)
                                         and torch.equal(gen.kv.v, kv.v)),
                   nonfinite=int(nf.sum()), capture=graph.stats(),
                   eager_launches_per_step={k: v for k, v in eager.items() if v})
        del kv
        gen.close()
    finally:
        eng.close()
    for name, keys in (("K2", ("q40_gemv", "sum_splits_kernel")),
                       ("K3", ("flash_attention_kernel", "flash_attention_tc_kernel",
                               "combine_splits_kernel"))):
        rec[f"{name}_device_ms_per_step"] = sum(
            e.self_device_time_total for e in kernels if any(k in e.key for k in keys)) / 1e3 / n
        rec[f"{name}_kernels_per_step"] = sum(
            e.count for e in kernels if any(k in e.key for k in keys)) / n
    rec["rows"], rec["depths"] = B, RAGGED
    return rec


def check_dense_profile(rec: dict, dtype: str, n_layers: int) -> None:
    """The dense step: graph equal to eager, the eager step's launches
    recorded per replay (K2 and K3, one K3 a layer), and on the device a
    bf16 step's attention on the tensor cores, once a layer."""
    eager = rec["eager_launches_per_step"]
    recorded = rec["capture"]["launches_per_replay"]
    if not rec["tokens_equal"] or not rec["pool_bytes_equal"] or rec["nonfinite"]:
        fail(f"dense step {dtype}: graph against eager: tokens {rec['tokens_equal']}, "
             f"pool bytes {rec['pool_bytes_equal']}, non-finite lanes {rec['nonfinite']}")
    if (set(eager) != {"K2", "K3"} or eager["K3"] != n_layers
            or recorded != {"q40_gemv": eager["K2"], "flash_attention": eager["K3"]}):
        fail(f"dense step {dtype}: eager launches {eager}, recorded per replay {recorded}")
    want_tc = n_layers if dtype == "bf16" else 0
    if rec["tc_attention_per_step"] != want_tc:
        fail(f"dense step {dtype}: {rec['tc_attention_per_step']} tensor-core attention "
             f"kernels per step on the device, want {want_tc}")


def dense_serving(model: str, tok: str, n_layers: int, summary: dict) -> None:
    """``api --batch-slots 8`` without ``--kv-block-size`` (the dense slot
    pool, :func:`serve_run`), f32 and bf16, the CLI's default Q80 sync
    buffers, the serving phase's 16-request mix: every request 200 with
    text, the identical greedy pair equal, prefix reuse across slots, K1,
    K2 and K3 launched and K4 never; then the profiled dense step
    (:func:`dense_step_profile`)."""
    for dtype in ("f32", "bf16"):
        rec, _ = serve_run(model, tok, n_layers, dtype, [], case="dense_serving", paged=False)
        launches = rec["launches"]["api"]
        print(json.dumps(rec), flush=True)
        summary[dtype]["launches"]["api_dense"] = launches
        summary[dtype]["dense_serving"] = rec
        if min(launches[k] for k in ("K1", "K2", "K3")) <= 0 or launches["K4"]:
            fail(f"dense serving {dtype}: want K1, K2, K3 launched and K4 never: {launches}")
        if not rec["capture"]["captured"]:
            fail(f"dense serving {dtype}: the step was not captured: {rec['capture']}")
        torch.cuda.empty_cache()
        prof = dense_step_profile(model, tok, dtype)
        print(json.dumps(prof), flush=True)
        summary[dtype]["dense_step_profile"] = prof
        check_dense_profile(prof, dtype, n_layers)
        torch.cuda.empty_cache()


def dense_chunk_spec(model: str, tok: str, n_layers: int, summary: dict) -> None:
    """The dense slot pool's ``--decode-chunk 4`` and ``--spec-lookup 4``
    (f32, f32 sync buffers as the spec phases: the Q80 casts would turn the
    routes' other summation orders into whole int8 steps), the serving mix
    each: the pool at K = 1 (its greedy transcripts against the paged
    pool's in :func:`spec_serving`), chunk-4 (4 replays, one readback a
    tick), spec with the n-gram drafts and spec with the K = 1 run's own
    tokens as drafts (:func:`oracle_drafts`). Every request held to the
    near-tie rule against K = 1 (greedy and sampled); in the oracle run a
    greedy request equal to K = 1 must have accepted every draft inside its
    tokens. K1 and K3 launch in every run, K4 in none."""
    f32_buf = ["--buffer-float-type", "f32"]
    runs = {}
    for name, flags in (("base", []), ("chunk4", ["--decode-chunk", "4"]),
                        ("spec", ["--spec-lookup", str(SPEC_K)])):
        runs[name] = serve_run(model, tok, n_layers, "f32", f32_buf + flags,
                               case=f"dense_{name}", paged=False)
    want = {}
    for r in runs["base"][1]:
        want.setdefault((tuple(r.prompt_ids), r.temperature, r.seed), r.tokens)
    with oracle_drafts({p: t for (p, _, _), t in want.items()}):
        runs["oracle"] = serve_run(model, tok, n_layers, "f32",
                                   f32_buf + ["--spec-lookup", str(SPEC_K)],
                                   case="dense_spec_oracle", paged=False)
    paged = summary["f32"]["paged_f32_buffers_transcripts"]
    diffs = {k: [] for k in ("chunk4", "spec", "oracle", "base_vs_paged")}
    short = []
    probe = TieProbe(model, tok, "f32", MAX_SEQ)
    try:
        for k in ("chunk4", "spec", "oracle", "base"):
            ref = paged if k == "base" else want
            for r in runs[k][1]:
                if k == "base" and r.temperature > 0.0:
                    continue  # greedy only against the paged pool
                key = (tuple(r.prompt_ids), r.temperature, r.seed)
                d = probe(r.prompt_ids, r.tokens, ref[key], r.temperature, r.topp, r.seed)
                if d is not None:
                    diffs["base_vs_paged" if k == "base" else k].append(
                        dict(d, rid=r.rid, temperature=r.temperature))
                elif (k == "oracle" and r.temperature <= 0.0 and r.spec_accepted
                      < len(r.tokens) - -(-len(r.tokens) // (SPEC_K + 1))):
                    short.append(dict(rid=r.rid, tokens=len(r.tokens),
                                      drafted=r.spec_drafted, accepted=r.spec_accepted))
    finally:
        probe.close()

    def tally(rs):
        sel = [r for r in rs if r.temperature <= 0.0]
        return dict(drafted=sum(r.spec_drafted for r in sel),
                    accepted=sum(r.spec_accepted for r in sel))

    rec = dict(case="dense_chunk_spec_summary", compute_dtype="f32", k=SPEC_K,
               **{f: {k: r[0][f] for k, r in runs.items()}
                  for f in ("gen_tok_per_s", "step_ms_median", "steps", "generated_tokens",
                            "latency_ms_p50", "ttft_ms_p50", "peak_gb")},
               greedy_accept={k: tally(runs[k][1]) for k in ("spec", "oracle")},
               requests_equal={k: len(runs["base" if k == "base_vs_paged" else k][1])
                               - len(v) for k, v in diffs.items()},
               parts=diffs, oracle_short_requests=short,
               capture={k: r[0]["capture"] for k, r in runs.items()},
               launches={k: r[0]["launches"]["api"] for k, r in runs.items()})
    for k, r in runs.items():
        print(json.dumps(r[0]), flush=True)
    print(json.dumps(rec), flush=True)
    summary["f32"]["dense_chunk_spec"] = rec
    for k, (r, _) in runs.items():
        summary["f32"]["launches"][f"api_dense_{k}"] = r["launches"]["api"]
    for k, ds in diffs.items():
        for d in ds:
            hold_transcripts(f"dense {k} f32 request {d['rid']}", "f32", d, d["temperature"])
    for k, (r, _) in runs.items():
        n = r["launches"]["api"]
        if min(n["K1"], n["K3"]) <= 0 or n["K4"] or (k in ("base", "chunk4") and n["K2"] <= 0):
            fail(f"dense {k}: want K1, K3 (and K2 off spec) launched, K4 never: {n}")
        if not r["capture"]["captured"]:
            fail(f"dense {k}: the tick's step was not captured: {r['capture']}")
    if rec["greedy_accept"]["spec"]["drafted"] <= 0:
        fail("dense spec: no greedy draft was verified")
    if short or rec["greedy_accept"]["oracle"]["accepted"] <= 0:
        fail(f"dense spec oracle f32: greedy requests equal to K = 1 had drafts rejected: "
             f"{short} ({rec['greedy_accept']['oracle']})")
    torch.cuda.empty_cache()


API_TURNS = ("Tell me about the river and the stone.", "And what did the cloud say?",
             "Summarise it in seven words.")


def single_api(model: str, tok: str, n_layers: int, summary: dict) -> None:
    """``api`` without ``--batch-slots`` (the single-sequence server, its
    ``NaiveCache``), f32 on f32 sync buffers: a three-turn conversation,
    each body the last one plus its answer and a new user message, so turns
    2 and 3 resume at the cached end and prefill only their new messages
    (fewer tokens than the whole conversation's prompt); each answer held to
    the near-tie rule against a fresh engine that prefills the whole token
    history the server had fed and decodes greedily; then a body with a
    ``stop`` string (the text cut there, no assistant entry cached) and an
    SSE body against the same JSON body. K1, K2 and K3 launch, K4 never."""
    import threading

    from dllama_tpu_torch.formats.quants import F32
    from dllama_tpu_torch.runtime.engine import InferenceEngine
    from dllama_tpu_torch.serve import cli
    from dllama_tpu_torch.tokenizer.chat import ChatItem

    box: dict = {}
    listening = threading.Event()
    fed: dict[int, int] = {}
    cur: dict = {}

    def on_listening(server, state):
        eng = state.engine
        prefill, next_token = eng.prefill, eng.next_token

        def prefill_recorded(ids):
            for j, t in enumerate(ids):
                fed[eng.pos + j] = t
            cur["prefilled"] += len(ids)
            return prefill(ids)

        def next_recorded(t):
            if cur["start"] is None:
                cur["start"] = eng.pos
            fed[eng.pos] = t
            out = next_token(t)
            cur["tokens"].append(out)
            return out

        eng.prefill, eng.next_token = prefill_recorded, next_recorded
        box.update(server=server, state=state)
        listening.set()

    argv = ["api", "--model", model, "--tokenizer", tok, "--compute-dtype", "f32",
            "--buffer-float-type", "f32", "--max-seq-len", str(MAX_SEQ), "--seed", str(SEED),
            "--temperature", "0", "--host", "127.0.0.1", "--port", "0"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    th = threading.Thread(target=lambda: box.setdefault(
        "rc", cli.main(argv, on_listening=on_listening)), daemon=True)
    th.start()
    while not listening.wait(timeout=1.0):
        if not th.is_alive():
            fail("single api: the server exited before listening")
    url = f"http://127.0.0.1:{box['server'].server_address[1]}"
    state = box["state"]
    tokz = state.engine.tokenizer

    def post(body: dict) -> dict:
        cur.update(prefilled=0, start=None, tokens=[])
        out = post_chat(url, body)
        return dict(out, prefilled=cur["prefilled"], start=cur["start"],
                    tokens=list(cur["tokens"]))

    convo = [{"role": "system", "content": SYSTEM}]
    turns = []
    for text in API_TURNS:
        convo.append({"role": "user", "content": text})
        items = [ChatItem(m["role"], m["content"]) for m in convo]
        cold = tokz.encode(state.template.generate(items, append_generation_prompt=True).content,
                           is_start=True, add_special_tokens=True)
        t = post({"messages": list(convo), "max_tokens": 24, "temperature": 0.0})
        t.update(cold_prompt_tokens=len(cold),
                 history=[fed[p] for p in range(t["start"] + 1)])
        turns.append(t)
        convo.append({"role": "assistant", "content": t["text"]})
    stop_body = {"messages": [{"role": "user", "content": "Name seven stones."}],
                 "max_tokens": 24, "temperature": 0.0}
    full = post(stop_body)
    stop = full["text"][4:10]
    cut = post({**stop_body, "stop": stop})
    cached_roles = [it.role for it in state.cache.items]
    sse = post({**stop_body, "stream": True})
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    box["server"].shutdown()
    th.join(timeout=120)
    if th.is_alive() or box.get("rc") != 0:
        fail("single api: the server did not stop cleanly")
    fresh = InferenceEngine(model, tok, device=DEV, max_seq_len=MAX_SEQ, sync_type=F32,
                            temperature=0.0)
    diffs = []
    probe = TieProbe(model, tok, "f32", MAX_SEQ)
    try:
        for i, t in enumerate(turns):
            fresh.reset()
            want = fresh.generate(t["history"], len(t["tokens"]), stop_on_eos=False).tokens
            d = probe(t["history"], t["tokens"], want)
            if d is not None:
                diffs.append(dict(d, turn=i))
    finally:
        probe.close()
        fresh.close()
    rec = dict(case="single_api", compute_dtype="f32", layers=n_layers,
               turns=[{k: t[k] for k in ("latency_ms", "prefilled", "cold_prompt_tokens",
                                         "start")} | {"generated": len(t["tokens"])}
                      for t in turns],
               stop=dict(stop=stop, text_cut=cut["text"] == full["text"][:full["text"].find(
                   stop)] if stop in full["text"] else None, cached_roles=cached_roles),
               sse_equal=sse["text"] == full["text"], parts=diffs, peak_gb=peak_gb,
               launches={"api_single": launches})
    print(json.dumps(rec), flush=True)
    summary["f32"]["single_api"] = rec
    summary["f32"]["launches"]["api_single"] = launches
    for d in diffs:
        hold_transcripts(f"single api turn {d['turn']}", "f32", d)
    if turns[0]["prefilled"] != turns[0]["cold_prompt_tokens"] - 1:
        fail(f"single api: turn 1 prefilled {turns[0]['prefilled']} tokens, want its whole "
             f"prompt less the seed token ({turns[0]['cold_prompt_tokens'] - 1})")
    for i, t in enumerate(turns[1:], 1):
        if not 0 < t["prefilled"] < t["cold_prompt_tokens"] - 1 - len(turns[i - 1]["tokens"]):
            fail(f"single api: turn {i + 1} prefilled {t['prefilled']} of its "
                 f"{t['cold_prompt_tokens']}-token conversation: the NaiveCache was not hit")
    if not (len(full["text"]) >= 10 and rec["stop"]["text_cut"]
            and cached_roles == ["user"]):
        fail(f"single api: the stop body: {rec['stop']} (full text {full['text']!r}, "
             f"cut {cut['text']!r})")
    if not rec["sse_equal"] or any(len(t["tokens"]) != 24 for t in turns):
        fail(f"single api: SSE text equal {rec['sse_equal']}, tokens per turn "
             f"{[len(t['tokens']) for t in turns]}")
    if min(launches[k] for k in ("K1", "K2", "K3")) <= 0 or launches["K4"]:
        fail(f"single api: want K1, K2, K3 launched and K4 never: {launches}")
    torch.cuda.empty_cache()


CHAT_LINES = ("hello there", "tell me more about it")


def chat_phase(model: str, tok: str, tmp: str, summary: dict) -> None:
    """``python -m dllama_tpu_torch chat`` as a user runs it: a subprocess
    from the checkout's root at full width (f32, the CLI's default
    buffers), two user lines on stdin, then EOF. The random weights never
    pick the tokenizer's EOS, so the tokenizer it reads marks as further EOS
    tokens the ones its greedy reply to the first line picks from token 8
    on and not before (found in process on the same model first): that
    reply ends there, and the second ends at the first of them it picks or
    at the context. It must exit 0, print two 🤖 turns, and print as the
    first reply the text of the reply found in process."""
    from dllama_tpu_torch.runtime.engine import InferenceEngine
    from dllama_tpu_torch.serve.api import chat_template
    from dllama_tpu_torch.tokenizer.chat import ChatItem, ChatTemplateType

    from dllama_tpu_torch.formats.quants import Q80

    # the CLI's defaults: f32, Q80 sync buffers
    eng = InferenceEngine(model, tok, device=DEV, max_seq_len=MAX_SEQ, sync_type=Q80,
                          temperature=0.0)
    try:
        tokz = eng.tokenizer
        template, _ = chat_template(tokz, ChatTemplateType.UNKNOWN)
        ids = tokz.encode(template.generate([ChatItem("user", CHAT_LINES[0])],
                                            append_generation_prompt=True).content,
                          is_start=True, add_special_tokens=True)
        eng.prefill(ids[:-1])
        t, reply = ids[-1], []
        for _ in range(64):
            t = eng.next_token(t)
            reply.append(t)
        eos = sorted(set(reply[8:]) - set(reply[:8])) or [reply[0]]
        end = next(j for j, x in enumerate(reply) if x in eos)
        tokz.reset_decoder()
        want = "".join(p for p in (tokz.decode(x) for x in reply[:end]) if p)
    finally:
        eng.close()
    chat_tok = os.path.join(tmp, "tok_chat.t")
    write_tokenizer(chat_tok, tuple(eos))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dllama_tpu_torch", "chat", "--model", model,
         "--tokenizer", chat_tok, "--max-seq-len", str(MAX_SEQ), "--temperature", "0",
         "--seed", str(SEED)],
        input="".join(line + "\n" for line in CHAT_LINES), capture_output=True, text=True,
        timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    wall_s = time.perf_counter() - t0
    replies = [part.split("\n💻 > ", 1)[0].rstrip("\n")
               for part in proc.stdout.split("🤖 ")[1:]]
    rec = dict(case="chat", rc=proc.returncode, wall_s=wall_s, turns=len(replies),
               eos_ids=len(eos), first_reply_tokens=end,
               first_reply_equal=bool(replies) and replies[0] == want.rstrip("\n"),
               reply_chars=[len(r) for r in replies])
    print(json.dumps(rec), flush=True)
    summary["f32"]["chat"] = rec
    if proc.returncode != 0 or len(replies) != 2 or not rec["first_reply_equal"]:
        fail(f"chat: exit {proc.returncode}, {len(replies)} 🤖 turns, first reply equal "
             f"{rec['first_reply_equal']}\nstdout tail: {proc.stdout[-1500:]}\n"
             f"stderr tail: {proc.stderr[-1500:]}")


# ---------------------------------------------------------------------------
# phase 6: kernel path vs plain path through the model
# ---------------------------------------------------------------------------


def parity_config(dtype: str):
    """Llama 3.1 8B widths at 2 layers."""
    from dllama_tpu_torch.formats.mfile import ArchType, RopeType
    from dllama_tpu_torch.models.config import ModelConfig

    return ModelConfig(
        arch=ArchType.LLAMA, dim=DIM, hidden_dim=HIDDEN, n_layers=2, n_heads=HEADS,
        n_kv_heads=KV_HEADS, head_dim=HEAD_DIM, vocab_size=VOCAB, seq_len=MAX_SEQ,
        norm_epsilon=1e-5, rope_theta=500000.0, rope_type=RopeType.LLAMA3_1,
        rope_scaling_factor=8.0, rope_scaling_low_freq_factor=1.0,
        rope_scaling_high_freq_factor=4.0, rope_scaling_orig_max_seq_len=8192,
        compute_dtype=dtype)


def model_parity(results: dict) -> None:
    """2 layers + the head at 8B widths, the kernel path against the plain
    path, on Q40 planes and on Q80 planes (codes over [-127, 127]), in both
    numerics; every K1/K2 launch on Q80 planes must read them as Q80."""
    from dataclasses import replace

    from dllama_tpu_torch.models.llama import forward, init_random_params
    from dllama_tpu_torch.ops import flash_attention as fa
    from dllama_tpu_torch.ops import quant_matmul as qm
    from dllama_tpu_torch.runtime.kvcache import KVCache

    for kind, mode, dtype in (("q40", "exact", "float32"), ("q40", "fast", "bfloat16"),
                              ("q80", "exact", "float32"), ("q80", "fast", "bfloat16")):
        cfg = parity_config(dtype)
        params = init_random_params(cfg, seed=SEED, quantized=True, device=DEV,
                                    codes_kind=kind)
        g = torch.Generator(device=DEV).manual_seed(SEED + 2)
        tokens = torch.randint(0, VOCAB, (1, 136), generator=g, device=DEV)
        outs = {}
        for path, impl in (("kernel", "auto"), ("plain", "xla")):
            c = replace(cfg, attn_impl=impl, quant_impl=impl)
            kv = KVCache.create(c, dtype=getattr(torch, dtype), device=DEV)
            qm.q40_matmul.launches = qm.q40_gemv.launches = fa.flash_attention.launches = 0
            logits = [forward(params, c, tokens[:, :128], 0, kv)[0][0]]
            prefill_counts = (qm.q40_matmul.launches, qm.q40_gemv.launches,
                              fa.flash_attention.launches)
            for t in range(128, 136):  # teacher-forced decode steps
                logits.append(forward(params, c, tokens[:, t:t + 1], t, kv)[0][0])
            outs[path] = torch.cat(logits).float()
            if path == "kernel":
                decode = (qm.q40_matmul.launches - prefill_counts[0],
                          qm.q40_gemv.launches - prefill_counts[1],
                          fa.flash_attention.launches - prefill_counts[2])
                per = {"prefill_128": dict(zip(("K1", "K2", "K3"), prefill_counts)),
                       "decode_8": dict(zip(("K1", "K2", "K3"), decode))}
                codes = (qm.q40_matmul.last_codes, qm.q40_gemv.last_codes)
        torch.cuda.synchronize()
        err = (outs["kernel"] - outs["plain"]).abs().max().item()
        scale = outs["plain"].abs().max().item()
        rec = dict(case="parity", codes=kind, mode=mode, layers=2, max_abs_err=err,
                   max_abs_logit=scale, tol=PARITY_TOL[mode], launches_2_layers=per,
                   last_codes=codes)
        print(json.dumps(rec), flush=True)
        results[(kind, mode)] = rec
        if not (err <= PARITY_TOL[mode] * scale) or not math.isfinite(scale):
            fail(f"model parity {kind} {mode}: max|err| {err:.3g} > {PARITY_TOL[mode]} "
                 f"x max|logit| {scale:.3g}")
        if codes != (kind, kind):
            fail(f"model parity {kind} {mode}: K1/K2 read {codes} codes")
        del params, outs
        torch.cuda.empty_cache()


def paged_parity(results: dict) -> None:
    """``paged_forward`` at 8B widths (2 layers): one decode step of 8 rows
    at ragged depths through scrambled tables, the kernel path (K2 at M = 8,
    K4) against the plain path on the same weights and pool contents; and
    one row's 128-token prefill + 8 decode steps through a descending table,
    the kernel path (K1, K2, K4) against the dense ``forward`` (K1, K2,
    K3)."""
    from dataclasses import replace

    from dllama_tpu_torch.models.llama import forward, init_random_params, paged_forward
    from dllama_tpu_torch.runtime.kvblocks import PagedKVCache
    from dllama_tpu_torch.runtime.kvcache import KVCache

    for mode, dtype in (("exact", "float32"), ("fast", "bfloat16")):
        cfg = parity_config(dtype)
        dt = getattr(torch, dtype)
        params = init_random_params(cfg, seed=SEED, quantized=True, device=DEV)
        g = torch.Generator(device=DEV).manual_seed(SEED + 4)
        tables, n_blocks = scrambled_tables(RAGGED, 1, BLOCK, torch.Generator().manual_seed(SEED))
        shape = (cfg.n_layers, n_blocks, KV_HEADS, BLOCK, HEAD_DIM)
        hist = PagedKVCache(k=torch.randn(shape, generator=g, device=DEV).to(dt),
                            v=torch.randn(shape, generator=g, device=DEV).to(dt))
        tokens = torch.randint(0, VOCAB, (len(RAGGED), 1), generator=g, device=DEV)
        pos = torch.tensor(RAGGED, device=DEV)
        outs, counts = {}, {}
        for path, impl in (("kernel", "auto"), ("plain", "xla")):
            c = replace(cfg, attn_impl=impl, quant_impl=impl)
            zero_counts()
            logits, _ = paged_forward(params, c, tokens, pos,
                                      PagedKVCache(hist.k.clone(), hist.v.clone()), tables)
            outs[path] = logits.float()
            counts[path] = read_counts()
        # one row: paged (K4) against dense (K3), both on the kernels
        row = torch.randint(0, VOCAB, (1, 136), generator=g, device=DEV)
        M = MAX_SEQ // BLOCK
        table = torch.arange(M, 0, -1, device=DEV)[None]
        pkv = PagedKVCache.create(cfg, M + 1, BLOCK, dtype=dt, device=DEV)
        kv = KVCache.create(cfg, dtype=dt, device=DEV)
        dense, paged = [], []
        for t0, t1 in [(0, 128)] + [(t, t + 1) for t in range(128, 136)]:
            dense.append(forward(params, cfg, row[:, t0:t1], t0, kv)[0][0])
            paged.append(paged_forward(params, cfg, row[:, t0:t1],
                                       torch.tensor([t0], device=DEV), pkv, table)[0][0])
        outs["dense_row"], outs["paged_row"] = torch.cat(dense).float(), torch.cat(paged).float()
        torch.cuda.synchronize()
        rec = dict(case="paged_parity", mode=mode, layers=2, tol=PARITY_TOL[mode],
                   launches_kernel_path=counts["kernel"], launches_plain_path=counts["plain"])
        for name, a, b in (("ragged_kernel_vs_plain", "kernel", "plain"),
                           ("row_paged_vs_dense", "paged_row", "dense_row")):
            err = (outs[a] - outs[b]).abs().max().item()
            scale = outs[b].abs().max().item()
            rec[name] = dict(max_abs_err=err, max_abs_logit=scale)
            if not (err <= PARITY_TOL[mode] * scale) or not math.isfinite(scale):
                print(json.dumps(rec), flush=True)
                fail(f"paged parity {mode} {name}: max|err| {err:.3g} > "
                     f"{PARITY_TOL[mode]} x max|logit| {scale:.3g}")
        print(json.dumps(rec), flush=True)
        results[mode] = rec
        if counts["kernel"]["K4"] <= 0 or counts["kernel"]["K2"] <= 0 or counts["plain"]["K4"]:
            fail(f"paged parity {mode}: kernel path counts {counts}")
        del params, outs, hist, pkv, kv
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: sequence parallelism (K3s, the sp model path)
# ---------------------------------------------------------------------------

SHARD = 2048      # rows of one sp shard in the kernel cases
SP_SEQ = 4096     # --max-seq-len of the sp path's short cell: 2 shards of 2048 rows
SP_LONG_PROMPT = 20000      # its prompt's least length in tokens
# Q80 buffers, sp = 2 against sp = 1 perplexity: a last-bit difference of
# the two attention orders flips a Q80 rounding, which the next 31 layers
# carry on (6.71e-4 on this cell, measured on an H100 80GB HBM3 at 700 W);
# a split that lost or doubled a block would move it by far more
Q80_SP_TOL = 1e-2
# (name, T, q_pos0, kv_pos0, shard rows) over the shard [kv_pos0, kv_pos0 +
# rows): a 2048-row shard, and the long sp cell's first 16384-row shard,
# seen whole from its decode depth
LONG_SHARD = SP_LONG_SEQ // 2
RING_CASES = [("decode whole block", 1, 2 * SHARD - 1, SHARD, SHARD),
              ("decode partly visible", 1, 2100, SHARD, SHARD),
              ("decode fully masked", 1, 1000, SHARD, SHARD),
              ("prefill T=64 past the block", 64, SHARD, 0, SHARD),
              ("prefill T=64 diagonal", 64, SHARD, SHARD, SHARD),
              ("decode whole 16384-row shard", 1, LONG_DEPTH, 0, LONG_SHARD),
              # C7: a shard-wide chunk on the diagonal, TQ = 4096 and 8192
              ("prefill T=1024 diagonal", 1024, SHARD, SHARD, SHARD),
              ("prefill T=2048 diagonal", 2048, SHARD, SHARD, SHARD)]


def ring_cases(timer: Timer, results: list) -> None:
    """K3s against its plain version (``_block_attn`` around the folded
    layout) at 8B shapes: n_kv 8, kv_mul 4, head_dim 128, a 2048-row and a
    16384-row shard; every mode of :data:`ATTN_MODES` (on an e4m3 cache the
    two whole-shard decodes and the diagonal chunk). The library yardstick
    is SDPA over the same block with the same boolean mask; it returns the
    normalised output, not the m and l K3s returns."""
    import torch.nn.functional as F

    from dllama_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=DEV).manual_seed(SEED + 5)
    kv_mul = HEADS // KV_HEADS
    f8_cases = [c for c in RING_CASES if c[0] in (
        "decode whole block", "decode whole 16384-row shard", "prefill T=64 diagonal")]
    for mode, (kv_dt, q_dt) in ATTN_MODES.items():
        blocks = {rows: [random_kv((1, KV_HEADS, rows, HEAD_DIM), mode, g) for _ in range(2)]
                  for rows in (SHARD, LONG_SHARD)}
        for name, T, q0, kv0, rows in (f8_cases if kv_dt == F8 else RING_CASES):
            k, v = blocks[rows]
            q_g = torch.randn((1, KV_HEADS, T * kv_mul, HEAD_DIM), generator=g,
                              device=DEV).to(q_dt)
            got = fa.flash_block_stats(q_g, k, v, q0, kv0, HEAD_DIM, T)
            n_splits = fa.flash_block_stats.last_splits  # what this launch took
            path = fa.flash_block_stats.last_path
            want = fa.flash_block_stats_plain(q_g, k, v, q0, kv0, HEAD_DIM, T)
            twin = (fa.flash_block_stats_tc_plain(q_g, k, v, q0, kv0, HEAD_DIM, T)
                    if path == "tc" else None)
            torch.cuda.synchronize()

            def stat_errs(ref, against):
                out = {}
                for what, a, b in zip(("acc", "m", "l"), got, ref):
                    inf_a, inf_b = torch.isneginf(a), torch.isneginf(b)
                    if not torch.equal(inf_a, inf_b):
                        fail(f"K3s {mode} {name}: {what} is -inf at other rows than the "
                             f"{against}'s")
                    fin = ~inf_b
                    err = (a[fin] - b[fin]).abs().max().item() if fin.any() else 0.0
                    out[what] = (err, b[fin].abs().max().item() if fin.any() else 0.0)
                return out

            errs = stat_errs(want, "plain version")
            errs_twin = stat_errs(twin, "twin") if twin is not None else None
            # the kernel's folded rows back to the q-head layout for SDPA
            qs = q_g.reshape(1, KV_HEADS, T, kv_mul, HEAD_DIM).permute(0, 1, 3, 2, 4) \
                    .reshape(1, HEADS, T, HEAD_DIM).to(upcast(k).dtype)
            mask = (kv0 + torch.arange(rows, device=DEV))[None, :] \
                <= (q0 + torch.arange(T, device=DEV))[:, None]           # [T, rows]
            ms = timer(lambda: fa.flash_block_stats(q_g, k, v, q0, kv0, HEAD_DIM, T))
            plain_ms = timer(lambda: fa.flash_block_stats_plain(q_g, k, v, q0, kv0,
                                                                HEAD_DIM, T))
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                qs, upcast(k), upcast(v), attn_mask=mask, enable_gqa=True))
            # the work this data needs: keys up to the newest visible one; q
            # read, acc, m and l written in f32
            seen = [max(0, min(rows, q0 + t - kv0 + 1)) for t in range(T)]
            b_ms, b_by = bound("K3s", T=T, heads=HEADS, kv_heads=KV_HEADS, head_dim=HEAD_DIM,
                               q_elt=q_g.element_size(), kv_elt=k.element_size(), seen=seen,
                               path=path)
            rec = dict(case="ring_block", kernel="K3s", mode=mode, phase=name, T=T,
                       q_pos0=q0, kv_pos0=kv0, shard_rows=rows,
                       n_splits=n_splits, path=path,
                       max_abs_err=max(e for e, _ in errs.values()),
                       errors={w: dict(max_abs_err=e, max_abs_ref=r)
                               for w, (e, r) in errs.items()},
                       errors_twin=errs_twin and {w: dict(max_abs_err=e, max_abs_ref=r)
                                                  for w, (e, r) in errs_twin.items()},
                       ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       library_note=("upcast to bf16 + " if kv_dt == F8 else "")
                       + "SDPA with the same mask: normalised output, no m/l",
                       bound_ms=b_ms, bound_by=b_by)
            print(json.dumps(rec), flush=True)
            results.append(rec)
            check_path(f"K3s {mode} {name}", mode, n_splits, path)
            # f32 online softmax against the one-shot einsum: reordered
            # sums/exps; the tensor-core path against its twin and the f32
            # plain version, as K3's
            bounds = ([(errs_twin, TC_TWIN_TOL, "twin"), (errs, TOL["fast"], "plain")]
                      if path == "tc" else [(errs, 1e-4, "plain")])
            for table, tol, against in bounds:
                for what in ("acc", "l", "m"):
                    err, ref = table[what]
                    if not (err <= tol * max(ref, 1.0 if what == "m" else 0.0)):
                        fail(f"K3s {mode} {name}: {what} max|err| {err:.3g} against the "
                             f"{against} (max|ref| {ref:.3g}, tol {tol})")
            if (n_splits > 1) != name.startswith("decode"):
                fail(f"K3s {mode} {name}: the launch took n_splits {n_splits}; decode "
                     f"must split, prefill must not")
        del blocks, k, v
    torch.cuda.empty_cache()


def guard_cost(results: list) -> None:
    """Host cost of the wrappers' device guard, which the sp path brought
    in: K2 at M = 1 on a 4096 x 1024 weight (a launch the host bounds),
    2000 calls per round under three guards, interleaved over 5 rounds:
    none (the wrappers before the guard), ``cuda_build.on_card`` (shipped:
    a context only for a tensor off the current card) and
    ``torch.cuda.device`` entered on every launch. Host clock, median
    round."""
    from dllama_tpu_torch.ops import quant_matmul as qm
    from dllama_tpu_torch.ops.cuda_build import on_card

    g = torch.Generator(device=DEV).manual_seed(SEED + 7)
    w = random_planes(DIM, 1024, False, g)
    x = torch.randn((1, DIM), generator=g, device=DEV)
    guards = {"none": lambda device: contextlib.nullcontext(), "on_card": on_card,
              "always": torch.cuda.device}
    n, rounds = 2000, 5
    times: dict = {k: [] for k in guards}
    try:
        for _ in range(rounds):
            for name, guard in guards.items():
                qm.on_card = guard
                qm.q40_gemv(x, w, fast=False)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    qm.q40_gemv(x, w, fast=False)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) / n * 1e6)
    finally:
        qm.on_card = on_card
    us = {k: statistics.median(v) for k, v in times.items()}
    rec = dict(case="launch_guard", kernel="K2", M=1, K=DIM, N=1024, calls=n, rounds=rounds,
               us_per_call=us, us_per_call_rounds=times)
    print(json.dumps(rec), flush=True)
    results.append(rec)


def sp_parity(results: dict) -> None:
    """Two layers at 8B width with a 256-row cache (two shards of 128): the
    sp = 2 kernel path (K3s, on one card ``[cuda:0, cuda:0]``) against the
    sp = 1 kernel path (K3) and against sp = 2 with the plain block
    version, over a 160-token prefill (chunks of 128 and 32, the second
    crossing the shard boundary) and 8 decode steps."""
    from dataclasses import replace

    from dllama_tpu_torch.models.llama import forward, init_random_params
    from dllama_tpu_torch.parallel.api import make_mesh
    from dllama_tpu_torch.runtime.kvcache import KVCache, ShardedKVCache

    chunks = [(0, 128), (128, 160)] + [(t, t + 1) for t in range(160, 168)]
    for mode, dtype in (("exact", "float32"), ("fast", "bfloat16")):
        cfg = replace(parity_config(dtype), seq_len=256)
        dt = getattr(torch, dtype)
        params = init_random_params(cfg, seed=SEED, quantized=True, device=DEV)
        g = torch.Generator(device=DEV).manual_seed(SEED + 6)
        tokens = torch.randint(0, VOCAB, (1, chunks[-1][1]), generator=g, device=DEV)
        outs, counts = {}, {}
        for path, sp, impl in (("sp2_kernel", 2, "auto"), ("sp1_kernel", 1, "auto"),
                               ("sp2_plain", 2, "xla")):
            c = replace(cfg, attn_impl=impl)
            plan = make_mesh({"sp": 2}, [f"{DEV}:0"] * 2) if sp > 1 else None
            kv = (ShardedKVCache.create(c, plan.devices, dtype=dt) if plan
                  else KVCache.create(c, dtype=dt, device=DEV))
            zero_counts()
            outs[path] = torch.cat([forward(params, c, tokens[:, a:b], a, kv, plan)[0][0]
                                    for a, b in chunks]).float()
            torch.cuda.synchronize()
            counts[path] = read_counts()
        rec = dict(case="sp_parity", mode=mode, layers=2, cache_rows=256, shards=2,
                   tol=PARITY_TOL[mode], launches=counts)
        for name, a, b in (("sp2_vs_sp1", "sp2_kernel", "sp1_kernel"),
                           ("sp2_kernel_vs_plain", "sp2_kernel", "sp2_plain")):
            err = (outs[a] - outs[b]).abs().max().item()
            scale = outs[b].abs().max().item()
            rec[name] = dict(max_abs_err=err, max_abs_logit=scale)
            if not (err <= PARITY_TOL[mode] * scale) or not math.isfinite(scale):
                print(json.dumps(rec), flush=True)
                fail(f"sp parity {mode} {name}: max|err| {err:.3g} > {PARITY_TOL[mode]} "
                     f"x max|logit| {scale:.3g}")
        print(json.dumps(rec), flush=True)
        results[mode] = rec
        k = counts["sp2_kernel"]
        # 2 layers x (2 ring chunks x 4 block pairs + 8 decode steps x 2 shards)
        if k["K3s"] != 2 * (2 * 4 + 8 * 2) or k["K3"] or counts["sp1_kernel"]["K3s"] \
                or counts["sp2_plain"]["K3s"]:
            fail(f"sp parity {mode}: launch counts {counts}")
        del params, outs
        torch.cuda.empty_cache()


@contextlib.contextmanager
def recorded_paths(store: list, active=lambda: True):
    """``(n_splits, path)`` of every K3/K3s launch inside while ``active()``,
    as the wrappers take the path from ``_attn_path`` (a parent tree
    without it records none)."""
    from dllama_tpu_torch.ops import flash_attention as fa

    orig = getattr(fa, "_attn_path", None)
    if orig is None:
        yield store
        return

    def observed(kv_dtype, n_splits, *rest):
        path = orig(kv_dtype, n_splits, *rest)
        if active():
            store.append((n_splits, path))
        return path

    fa._attn_path = observed
    try:
        yield store
    finally:
        fa._attn_path = orig


@contextlib.contextmanager
def phase_counts(store: dict):
    """K3s launches split by phase: the engine's ``prefill`` (per chunk),
    decode (per token: ``decode_chunk_tokens``, which ``generate`` calls
    for every chunk, k = 1 included, and ``next_token``, which a parent
    tree's ``generate`` calls instead) and verify (per dispatch:
    ``speculative_tokens``), counted where each returns; and
    ``(n_splits, path)`` of every K3/K3s launch of the prefill
    (:func:`recorded_paths`)."""
    from dllama_tpu_torch.ops import flash_attention as fa
    from dllama_tpu_torch.runtime.engine import InferenceEngine

    saved = {name: getattr(InferenceEngine, name)
             for name in ("prefill", "next_token", "decode_chunk_tokens", "speculative_tokens")
             if hasattr(InferenceEngine, name)}
    store.update(prefill_chunks=0, prefill_k3s=0, decode_steps=0, decode_k3s=0,
                 verify_steps=0, verify_k3s=0, prefill_launches=[])
    in_prefill = [False]

    def counted_prefill(self, ids):
        n0 = fa.flash_block_stats.launches
        in_prefill[0] = True
        try:
            last, metrics = saved["prefill"](self, ids)
        finally:
            in_prefill[0] = False
        store["prefill_chunks"] += len(metrics)
        store["prefill_k3s"] += fa.flash_block_stats.launches - n0
        return last, metrics

    def counted_decode(name: str, n_tokens, kind: str = "decode"):
        def counted(self, *args):
            n0 = fa.flash_block_stats.launches
            out = saved[name](self, *args)
            store[f"{kind}_steps"] += n_tokens(out)
            store[f"{kind}_k3s"] += fa.flash_block_stats.launches - n0
            return out
        return counted

    wrapped = {"prefill": counted_prefill,
               "next_token": counted_decode("next_token", lambda tok: 1),
               "decode_chunk_tokens": counted_decode("decode_chunk_tokens", len),
               "speculative_tokens": counted_decode("speculative_tokens", lambda run: 1,
                                                    "verify")}
    for name in saved:
        setattr(InferenceEngine, name, wrapped[name])
    try:
        with recorded_paths(store["prefill_launches"], lambda: in_prefill[0]):
            yield store
    finally:
        for name, fn in saved.items():
            setattr(InferenceEngine, name, fn)


def sp_run(model: str, tok: str, via: str, *, dtype: str, sp: int, seq_len: int,
           text: str, sync: str, steps: int, ppl: bool, spec: int = 0,
           kv: str = "auto") -> dict:
    """One run of the sp path: ``steps`` greedy tokens after ``text`` (none
    when 0; speculative with ``spec`` = K), then ``perplexity`` over it
    when ``ppl``, over a ``kv`` (``--kv-dtype``) cache; through the CLI's
    ``--sp`` (``via="cli"``) or ``InferenceEngine(sp_devices=[cuda:0] *
    sp)``. Counts are set to 0 just before each and read just after it."""
    from dllama_tpu_torch.formats.quants import F32, Q80
    from dllama_tpu_torch.runtime.engine import InferenceEngine

    rec = dict(case="sp_path", via=via, compute_dtype=dtype, sp=sp, max_seq_len=seq_len,
               buffer_float_type=sync, spec_lookup=spec, kv_dtype=kv)
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)
    phases: dict = {}
    t0 = time.perf_counter()
    with phase_counts(phases):
        if via == "cli":
            common = ["--model", model, "--tokenizer", tok, "--compute-dtype", dtype,
                      "--max-seq-len", str(seq_len), "--seed", str(SEED), "--sp", str(sp),
                      "--buffer-float-type", sync,
                      *(["--kv-dtype", kv] if kv != "auto" else [])]
            if steps:
                gens: list = []
                zero_counts()
                with recorded_generations(gens):
                    out = run_cli(["inference", *common, "--prompt", text, "--steps",
                                   str(len(text.encode()) + 1 + steps), "--temperature", "0",
                                   *(["--spec-lookup", str(spec)] if spec else [])])
                rec["launches_inference"] = read_counts()
                rec.update(prompt_ids=gens[0][0], tokens=gens[0][1].tokens)
                lines = out.splitlines()
                rec.update(prompt_tokens=int(stat(lines, "Evaluation", "nTokens:")) + 1,
                           generated=int(stat(lines, "Prediction", "nTokens:")),
                           prefill_tok_per_s=stat(lines, "Evaluation", "tokens/s:"),
                           decode_tok_per_s=stat(lines, "Prediction", "tokens/s:"))
            if ppl:
                zero_counts()
                ppl_out = run_cli(["perplexity", *common, "--prompt", text])
                rec["launches_perplexity"] = read_counts()
                ppl_lines = ppl_out.splitlines()
                rec["perplexity"] = float(next(ln for ln in ppl_lines
                                               if "Perplexity" in ln).split()[-1])
                rec["perplexity_tokens"] = int(next(ln for ln in ppl_lines
                                                    if "nTokens" in ln).split()[-1])
        else:
            eng = InferenceEngine(model, tok, device=DEV, max_seq_len=seq_len,
                                  sync_type=Q80 if sync == "q80" else F32, temperature=0.0,
                                  compute_dtype="bfloat16" if dtype == "bf16" else "float32",
                                  sp=sp, sp_devices=[f"{DEV}:0"] * sp,
                                  **({"spec_lookup": spec} if spec else {}),
                                  **({"kv_dtype": kv} if kv != "auto" else {}))
            try:
                ids = eng.tokenizer.encode(text)
                if steps:
                    zero_counts()
                    res = eng.generate(ids, steps, stop_on_eos=False)
                    rec["launches_inference"] = read_counts()
                    rec.update(prompt_tokens=len(ids), generated=len(res.tokens),
                               prefill_tok_per_s=res.eval_tok_per_s,
                               decode_tok_per_s=res.pred_tok_per_s, tokens=res.tokens,
                               prompt_ids=ids)
                if ppl:
                    zero_counts()
                    t1 = time.perf_counter()
                    rec["perplexity"] = eng.perplexity(ids)
                    torch.cuda.synchronize()
                    rec["launches_perplexity"] = read_counts()
                    rec["perplexity_tokens"] = len(ids)
                    rec["perplexity_tok_per_s"] = (len(ids) - 1) / (time.perf_counter() - t1)
            finally:
                eng.close()
    torch.cuda.synchronize()
    rec["wall_s"] = time.perf_counter() - t0
    rec["peak_gb_per_device"] = [torch.cuda.max_memory_allocated(i) / 1e9
                                 for i in range(torch.cuda.device_count())]
    rec["k3s_per_decode_step"] = phases["decode_k3s"] / max(1, phases["decode_steps"])
    rec["verify_steps"] = phases["verify_steps"]
    rec["k3s_per_verify_step"] = phases["verify_k3s"] / max(1, phases["verify_steps"])
    rec["k3s_per_prefill_chunk"] = phases["prefill_k3s"] / max(1, phases["prefill_chunks"])
    rec["prefill_chunks"] = phases["prefill_chunks"]
    rec["prefill_launches"] = phases["prefill_launches"]
    rec["prefill_paths"] = dict(collections.Counter(p for _, p in rec["prefill_launches"]))
    print(json.dumps({k: v for k, v in rec.items()
                      if k not in ("tokens", "prompt_ids", "prefill_launches")}), flush=True)
    torch.cuda.empty_cache()
    return rec


def sp_path(model: str, tok: str, n_layers: int, e2e: dict, long_model: str,
            long_layers: int) -> None:
    """The model split in two sequence shards, at sp = 2 and, for
    comparison, sp = 1, in three cells (the long one on ``long_model``, of
    ``long_layers`` layers: :data:`SHORT_LAYERS` since slice 20, to keep the
    run inside its time):

    * short: ``--max-seq-len 4096`` (two 2048-row shards), a 2551-token
      prompt (the prefill crosses the boundary), 64 greedy steps in f32 and
      bf16, ``perplexity`` over the prompt in f32;
    * q80: ``perplexity`` over the same prompt with the Q80 sync casts on
      (the CLI's default buffers), sp = 2 against sp = 1 within
      :data:`Q80_SP_TOL`;
    * long: ``--max-seq-len 32768`` (two 16384-row shards), a prompt of
      more than 20000 tokens, 64 greedy steps and ``perplexity`` in f32 and
      bf16 (the bf16 prefill walks deep single passes on K3's or K3s's
      tensor-core path); bf16 perplexity within 5% of f32's at each sp, the
      main path's bf16 bound. bf16 greedy tokens are recorded, not
      compared: the random model's logits are nearly flat, so the two
      attention orders' bf16 roundings can flip an argmax.

    Each run records the kernel path of every prefill attention launch:
    each must follow :func:`check_path` (a bf16 single pass on ``tc``,
    everything else on ``simt``), and a bf16 run must take ``tc``.

    The short and long cells keep the activations f32 between layers
    (``--buffer-float-type f32``): under the Q80 sync casts the last-bit
    differences of the two attention orders flip Q80 roundings and compound
    over the layers, so sp = 2 and sp = 1 would differ by far more than the
    split itself makes them, which the q80 cell records."""
    n_cards = torch.cuda.device_count()
    via = "cli" if n_cards >= 2 else "engine"
    print(f"🕸️ sp path: {'the CLI --sp 2 over ' + str(n_cards) + ' cards' if via == 'cli' else 'InferenceEngine(sp=2, sp_devices=[cuda:0, cuda:0]) on one card'}",
          flush=True)
    short = PROMPT * 10
    long_text = PROMPT * (SP_LONG_PROMPT // len(PROMPT.encode()) + 1)
    # (cell, dtype, sp, seq_len, text, buffers, steps, perplexity, least
    # prompt, --spec-lookup)
    plan = [("short", d, sp, SP_SEQ, short, "f32", 64, d == "f32", 2300, 0)
            for d in ("f32", "bf16") for sp in (2, 1)]
    layers = {"long": (long_model, long_layers)}
    plan += [("short-spec", d, sp, SP_SEQ, short, "f32", 64, False, 2300, SPEC_K)
             for d in ("f32", "bf16") for sp in (2, 1)]
    plan += [("q80", "f32", sp, SP_SEQ, short, "q80", 0, True, 2300, 0) for sp in (2, 1)]
    plan += [("long", "f32", sp, SP_LONG_SEQ, long_text, "f32", 64, True, SP_LONG_PROMPT, 0)
             for sp in (2, 1)]
    plan += [("long", "bf16", sp, SP_LONG_SEQ, long_text, "f32", 64, True, SP_LONG_PROMPT, 0)
             for sp in (2, 1)]
    runs = {}
    for cell, dtype, sp, seq_len, text, sync, steps, ppl, least, spec in plan:
        t0 = time.perf_counter()
        cell_model, cell_layers = layers.get(cell, (model, n_layers))
        rec = sp_run(cell_model, tok, via, dtype=dtype, sp=sp, seq_len=seq_len, text=text,
                     sync=sync, steps=steps, ppl=ppl, spec=spec)
        rec["layers"] = cell_layers
        print(f"⏱️ sp {cell} {dtype} sp={sp} took {time.perf_counter() - t0:.1f} s", flush=True)
        runs[(cell, dtype, sp)] = rec
        n_prompt = rec.get("prompt_tokens", rec.get("perplexity_tokens"))
        if n_prompt < least or n_prompt <= seq_len // 2 or rec.get("generated", steps) != steps:
            fail(f"sp {cell} {dtype} sp={sp}: {n_prompt} prompt tokens, "
                 f"{rec.get('generated')} generated (want >= {least}, past the shard "
                 f"boundary at {seq_len // 2}, and {steps})")
        for path in ("inference", "perplexity"):
            n = rec.get(f"launches_{path}")
            if n is None:
                continue
            key = f"sp{sp}_{path}" if cell == "short" else f"sp{sp}_{cell}_{path}"
            e2e[dtype]["launches"][key] = n
            if n["K1"] <= 0 or (path == "inference" and n["K2"] <= 0):
                fail(f"sp {cell} {dtype} sp={sp} {path}: K1/K2 never launched: {n}")
            if sp > 1 and (n["K3s"] <= 0 or n["K3"] != 0):
                fail(f"sp {cell} {dtype} sp={sp} {path}: want K3s > 0 and K3 = 0: {n}")
            if sp == 1 and n["K3s"] != 0:
                fail(f"sp {cell} {dtype} sp=1 {path}: K3s launched: {n}")
        # every prefill launch: a single pass over a bf16 cache on the
        # tensor cores, an f32 cache or a split launch (a shard's 16-row
        # block of a 32-token chunk at sp = 2) on the SIMT kernel
        mode = "fast" if dtype == "bf16" else "exact"
        for n_splits, path in rec["prefill_launches"]:
            check_path(f"sp {cell} {dtype} sp={sp} prefill", mode, n_splits, path)
        if steps and dtype == "bf16" and not rec["prefill_paths"].get("tc"):
            fail(f"sp {cell} bf16 sp={sp}: no prefill launch took tc: {rec['prefill_paths']}")
        # a decode step and a verify step (merge decode at T = 1 or K + 1)
        # launch K3s once a layer and shard
        phase = "verify" if spec else "decode"
        if sp > 1 and steps and rec[f"k3s_per_{phase}_step"] != cell_layers * sp:
            fail(f"sp {cell} {dtype}: {rec[f'k3s_per_{phase}_step']} K3s launches per "
                 f"{phase} step, want {cell_layers * sp}")
        if spec and rec["verify_steps"] < 1:
            fail(f"sp {cell} {dtype} sp={sp}: no verify step ran")
    # speculative decoding at sp = 2 (eager, K3s merge decode at T = K + 1)
    # against sp = 2 without spec and against spec at sp = 1 (the graph),
    # under the near-tie rule
    for dtype in ("f32", "bf16"):
        got = runs[("short-spec", dtype, 2)]
        parts = {}
        probe = TieProbe(model, tok, dtype, SP_SEQ)
        try:
            for name, want in (("sp2_plain", runs[("short", dtype, 2)]),
                               ("sp1_spec", runs[("short-spec", dtype, 1)])):
                parts[name] = probe(got["prompt_ids"], got["tokens"], want["tokens"])
        finally:
            probe.close()
        print(json.dumps(dict(case="sp_spec_summary", compute_dtype=dtype, k=SPEC_K,
                              verify_steps={sp: runs[("short-spec", dtype, sp)]["verify_steps"]
                                            for sp in (2, 1)},
                              decode_tok_per_s={f"{c} sp={sp}": runs[(c, dtype, sp)].get(
                                  "decode_tok_per_s") for c in ("short", "short-spec")
                                  for sp in (2, 1)},
                              parts=parts)), flush=True)
        for name, diff in parts.items():
            hold_transcripts(f"sp spec {dtype} against {name}", dtype, diff)
    for cell, tol in (("short", 1e-4), ("q80", Q80_SP_TOL), ("long", 1e-4)):
        p2, p1 = runs[(cell, "f32", 2)]["perplexity"], runs[(cell, "f32", 1)]["perplexity"]
        rel = abs(p2 / p1 - 1.0)
        summary = dict(case="sp_summary", cell=cell, perplexity_sp2=p2, perplexity_sp1=p1,
                       rel_diff=rel, tol=tol, tokens_equal_sp1={
                           d: runs[(cell, d, 2)].get("tokens") == runs[(cell, d, 1)].get("tokens")
                           for d in ("f32", "bf16") if (cell, d, 2) in runs
                           and "tokens" in runs[(cell, d, 2)]})
        print(json.dumps(summary), flush=True)
        if not math.isfinite(p2) or not rel <= tol:
            fail(f"sp {cell}: perplexity at sp=2 {p2} differs from sp=1 {p1} by {rel:.3g} "
                 f"(> {tol})")
    # bf16 against f32 over the long prompt, at each sp
    pb = {sp: runs[("long", "bf16", sp)]["perplexity"] for sp in (2, 1)}
    rel_f32 = {sp: abs(pb[sp] / runs[("long", "f32", sp)]["perplexity"] - 1.0)
               for sp in (2, 1)}
    print(json.dumps(dict(case="sp_summary", cell="long bf16", perplexity_sp2=pb[2],
                          perplexity_sp1=pb[1], rel_diff=abs(pb[2] / pb[1] - 1.0),
                          rel_diff_f32=rel_f32, tol_f32=0.05)), flush=True)
    for sp in (2, 1):
        if not math.isfinite(pb[sp]) or not rel_f32[sp] <= 0.05:
            fail(f"sp long bf16 sp={sp}: perplexity {pb[sp]} differs from f32 by "
                 f"{rel_f32[sp]:.3g} (> 5%)")


# ---------------------------------------------------------------------------
# phase 10: the engine options of slice 10 — the f8 cache, dense weight
# modes, --nbatches, --host-sampling — and weight integrity
# ---------------------------------------------------------------------------

# e4m3 bits the JAX package's cast gives these f32 values (XLA's and
# ml_dtypes' astype(float8_e4m3fn)): round to nearest even, NaN with the
# sign past 464 and for inf and NaN; tests/test_torch_kv_dtype.py holds
# this table to JAX's cast on the CPU
F8_SPECIAL = [(0.0, 0x00), (-0.0, 0x80), (448.0, 0x7E), (-448.0, 0xFE), (449.0, 0x7E),
              (463.99, 0x7E), (464.0, 0x7E), (-464.0, 0xFE), (464.01, 0x7F),
              (465.0, 0x7F), (-465.0, 0xFF), (480.0, 0x7F), (1e9, 0x7F),
              (float("inf"), 0x7F), (float("-inf"), 0xFF), (float("nan"), 0x7F),
              (2.0 ** -9, 0x01), (-(2.0 ** -9), 0x81), (2.0 ** -10, 0x00),
              (3 * 2.0 ** -10, 0x02), (2.0 ** -7, 0x04), (1.0625, 0x38), (240.0, 0x77),
              (232.0, 0x76), (-232.0, 0xF6), (17.5, 0x59)]
# ---------------------------------------------------------------------------
# tensor parallelism: two shards on one card
# ---------------------------------------------------------------------------

TP = 2
# the 8B's tp = 2 local weight shapes (name, K, N): row splits cut N, col
# splits K (parallel/sharding.py)
TP_MATMULS = [("wq", DIM, HEADS * HEAD_DIM // TP), ("wk", DIM, KV_HEADS * HEAD_DIM // TP),
              ("wo", HEADS * HEAD_DIM // TP, DIM), ("w1", DIM, HIDDEN // TP),
              ("w2", HIDDEN // TP, DIM), ("head", DIM, VOCAB // TP)]
TP_LOGIT_TOL = {"f32": 1e-4, "bf16": 5e-2}   # of max|logit|, tp = 2 against tp = 1
TP_PPL_TOL = {"f32": 1e-4, "q80": 1e-2}      # relative: the sp path's bounds
TP_STEPS = 64          # greedy tokens of the transcripts
TP_DECODE_STEPS = 8    # teacher-forced decode steps of the logits hold
TP_API_REQUESTS = 8
TP_API_TOKENS = 24


def tp_cases(timer: Timer, results: list) -> None:
    """K1-K4 at the local shapes a tp = 2 shard of the 8B gives them, against
    their plain versions, exact and fast: K1 at M = 128 and K2 at M = 1 on
    each :data:`TP_MATMULS` shape (Q40 planes), K3 decode at depth 2047 and a
    128-token chunk at depth 0, K4 over 8 ragged decode rows at block size
    16, both over one shard's ``HEADS / 2`` q heads and ``KV_HEADS / 2`` kv
    heads. The records carry ``tp`` and join the kernels line in rows of
    their own."""
    import torch.nn.functional as F

    from dllama_tpu_torch.ops import flash_attention as fa
    from dllama_tpu_torch.ops import paged_attention as pa
    from dllama_tpu_torch.ops import quant_matmul as qm
    from dllama_tpu_torch.ops.attention import attention
    from dllama_tpu_torch.ops.linear import dequantize_weight

    g = torch.Generator(device=DEV).manual_seed(SEED + 17)
    g_cpu = torch.Generator().manual_seed(SEED + 17)
    heads, kv_heads = HEADS // TP, KV_HEADS // TP
    for mode in ("exact", "fast"):
        fast = mode == "fast"
        act = torch.bfloat16 if fast else torch.float32
        for name, K, N in TP_MATMULS:
            w = random_planes(K, N, fast, g)
            wd = dequantize_weight(w, act)
            for kname, M in (("K2", 1), ("K1", 128)):
                fn = qm.q40_gemv if kname == "K2" else qm.q40_matmul
                x = torch.randn((M, K), generator=g, device=DEV).to(act)
                got = fn(x, w, fast=fast).float()
                splits = fn.last_splits
                path = fn.last_path if kname == "K2" else "tc" if fast else "simt"
                want = qm.quant_matmul_plain(x, w, fast=fast).float()
                torch.cuda.synchronize()
                err, scale = (got - want).abs().max().item(), want.abs().max().item()
                b_ms, b_by = bound(kname, M=M, K=K, N=N, fast=fast, path=path)
                rec = dict(case="matmul", tp=TP, kernel=kname, mode=mode, codes="q40",
                           weight=name, M=M, K=K, N=N, splits=splits, path=path,
                           max_abs_err=err, max_abs_ref=scale,
                           ms=timer(lambda: fn(x, w, fast=fast)),
                           plain_ms=timer(lambda: qm.quant_matmul_plain(x, w, fast=fast)),
                           library_ms=timer(lambda: torch.matmul(x, wd)),
                           bound_ms=b_ms, bound_by=b_by)
                print(json.dumps(rec), flush=True)
                results.append(rec)
                if not (err <= TOL[mode] * scale) or not math.isfinite(err):
                    fail(f"tp {kname} {mode} {name} M={M}: max|err| {err:.3g} > "
                         f"{TOL[mode]} x max|y| {scale:.3g}")
            del w, wd
        kv_dt, q_dt = ATTN_MODES[mode]
        k, v = (random_kv((1, kv_heads, MAX_SEQ, HEAD_DIM), mode, g) for _ in range(2))
        for phase, T, pos in (("decode", 1, MAX_SEQ - 1), ("prefill", 128, 0)):
            q = torch.randn((1, T, heads, HEAD_DIM), generator=g, device=DEV).to(q_dt)
            positions = (pos + torch.arange(T, device=DEV))[None, :]
            got = fa.flash_attention(q, k, v, pos, HEAD_DIM)
            n_splits, path = fa.flash_attention.last_splits, fa.flash_attention.last_path
            want = attention(q, k, v, positions, HEAD_DIM)
            twin = (fa.flash_attention_tc_plain(q, k, v, pos, HEAD_DIM) if path == "tc"
                    else None)
            torch.cuda.synchronize()
            qs = q.transpose(1, 2).to(k.dtype)
            mask = torch.arange(MAX_SEQ, device=DEV)[None, :] <= positions[0][:, None]
            b_ms, b_by = bound("K3", T=T, heads=heads, kv_heads=kv_heads, head_dim=HEAD_DIM,
                               q_elt=q.element_size(), kv_elt=k.element_size(), depths=[pos],
                               path=path)
            rec = dict(case="attention", tp=TP, kernel="K3", mode=mode, phase=phase, T=T,
                       start_pos=pos, S=MAX_SEQ, head_dim=HEAD_DIM, heads=heads,
                       kv_heads=kv_heads, n_splits=n_splits, path=path,
                       **out_errs(got, want, twin),
                       ms=timer(lambda: fa.flash_attention(q, k, v, pos, HEAD_DIM)),
                       plain_ms=timer(lambda: attention(q, k, v, positions, HEAD_DIM)),
                       library_ms=timer(lambda: F.scaled_dot_product_attention(
                           qs, k, v, attn_mask=mask, enable_gqa=True)),
                       bound_ms=b_ms, bound_by=b_by)
            print(json.dumps(rec), flush=True)
            results.append(rec)
            what = f"tp K3 {mode} {phase} T={T} pos={pos}"
            check_path(what, mode, n_splits, path)
            hold_out(what, rec, path)
        del k, v
        tables, n_blocks = scrambled_tables(RAGGED, 1, BLOCK, g_cpu)
        kp, vp = (random_kv((n_blocks, kv_heads, BLOCK, HEAD_DIM), mode, g) for _ in range(2))
        q = torch.randn((SLOTS, 1, heads, HEAD_DIM), generator=g, device=DEV).to(q_dt)
        positions = torch.tensor(RAGGED, device=DEV)[:, None]
        got = pa.paged_attention(q, kp, vp, tables, positions, HEAD_DIM)
        n_splits = pa.paged_attention.last_splits
        want = pa.paged_attention_plain(q, kp, vp, tables, positions, HEAD_DIM)
        torch.cuda.synchronize()
        b_ms, b_by = bound("K4", T=1, heads=heads, kv_heads=kv_heads, head_dim=HEAD_DIM,
                           q_elt=q.element_size(), kv_elt=kp.element_size(), depths=RAGGED,
                           rows=tables.shape[1] * BLOCK)
        rec = dict(case="paged_attention", tp=TP, kernel="K4", mode=mode, B=SLOTS, T=1,
                   block_size=BLOCK, positions=RAGGED, heads=heads, kv_heads=kv_heads,
                   n_splits=n_splits, **out_errs(got, want, None),
                   ms=timer(lambda: pa.paged_attention(q, kp, vp, tables, positions,
                                                       HEAD_DIM)),
                   plain_ms=timer(lambda: pa.paged_attention_plain(q, kp, vp, tables,
                                                                   positions, HEAD_DIM)),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by)
        print(json.dumps(rec), flush=True)
        results.append(rec)
        hold_out(f"tp K4 {mode} B={SLOTS}", rec, "simt")
        del kp, vp
    torch.cuda.empty_cache()


def tp_engine(model: str, tok: str, dtype: str, tp: int, sync: str = "f32", **kw):
    """An engine of the 8-layer copy at ``tp`` shards, all on ``cuda:0``."""
    from dllama_tpu_torch.formats.quants import F32, Q80
    from dllama_tpu_torch.runtime.engine import InferenceEngine

    return InferenceEngine(model, tok, device=DEV, max_seq_len=MAX_SEQ,
                           sync_type=Q80 if sync == "q80" else F32, temperature=0.0,
                           compute_dtype="bfloat16" if dtype == "bf16" else "float32",
                           tp=tp, tp_devices=[f"{DEV}:0"] * tp if tp > 1 else None, **kw)


def tp_logits_drift(engs: dict, ids: list[int]) -> float:
    """Largest |tp = 2 logit - tp = 1 logit| over a 128-token chunk and
    :data:`TP_DECODE_STEPS` decode steps fed tp = 1's greedy tokens, over
    max|logit| (eager forwards on both sides)."""
    for e in engs.values():
        e.reset()
    worst, pos, chunk = 0.0, 0, ids[:128]
    for _ in range(1 + TP_DECODE_STEPS):
        out = {t: e._forward(chunk, pos)[0, -len(chunk):].float() for t, e in engs.items()}
        scale = out[1].abs().max().item()
        worst = max(worst, (out[TP] - out[1]).abs().max().item() / scale)
        pos += len(chunk)
        chunk = [int(out[1][-1].argmax())]
    return worst


def eager_decode_ms(eng, token: int, n: int = 8) -> dict:
    """``n`` eager greedy steps (``models.llama.greedy_steps``, the tp = 2
    decode loop; at tp = 1 the same eager step the graph captures), after
    one warm-up step, under ``torch.profiler``: wall and device ms per
    step."""
    from dllama_tpu_torch.models.llama import greedy_steps

    tok = torch.tensor([token], device=DEV)
    greedy_steps(eng.params, eng.cfg, tok, eng.pos, eng.kv, 1, eng.plan)
    wall, kernels = _profiled(lambda: greedy_steps(eng.params, eng.cfg, tok, eng.pos + 1,
                                                   eng.kv, n, eng.plan), n)
    rec = _profile_rec("tp_decode", "", "step", n, wall, kernels)
    return {k: rec[k] for k in ("wall_ms_per_step", "device_ms_per_step",
                                "device_busy_share", "kernels_per_step",
                                "K5_device_ms_per_step")}


def tp_api(engs: dict, probe, tokenizer, dtype: str, launches: dict) -> dict:
    """The paged ``BatchScheduler`` (8 slots, block 16) at tp = 2 and tp = 1
    over :data:`TP_API_REQUESTS` greedy requests that share the serving
    mix's system prompt, the first alone (its prompt blocks register) and
    the rest together (they share them): tp = 2's transcripts against tp =
    1's under the near-tie rule (``probe``: the margin from tp = 1's
    single-sequence logits)."""
    from dllama_tpu_torch.runtime.serving import BatchScheduler

    prompts = [tokenizer.encode(SYSTEM + f" Question {i}: " + "river stone " * (3 * i),
                                is_start=True) for i in range(TP_API_REQUESTS)]
    runs, rec = {}, {}
    for tp, eng in engs.items():
        sched = BatchScheduler(eng, n_slots=SLOTS)
        try:
            zero_counts()
            t0 = time.perf_counter()
            reqs = []
            for batch in (prompts[:1], prompts[1:]):
                reqs += [sched.submit(p, TP_API_TOKENS, stop_on_eos=False) for p in batch]
                for r in reqs:
                    if not r.done.wait(timeout=600) or r.error is not None:
                        fail(f"tp {dtype} api tp={tp}: request {r.rid} failed: {r.error}")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if tp == TP:
                launches["tp2_api"] = read_counts()
            runs[tp] = [r.tokens for r in reqs]
            rec[f"tp{tp}_gen_tok_per_s"] = sum(len(t) for t in runs[tp]) / wall
            rec[f"tp{tp}_reused_tokens"] = sched.gen.reused_tokens
        finally:
            sched.close()
    for p, got, want in zip(prompts, runs[TP], runs[1]):
        hold_transcripts(f"tp api {dtype}", dtype, probe(p, got, want))
    rec["transcripts_equal"] = sum(a == b for a, b in zip(runs[TP], runs[1]))
    if not rec[f"tp{TP}_reused_tokens"]:
        fail(f"tp {dtype} api: the shared system prompt was never reused")
    return rec


def tp_phase(model: str, tok: str, e2e: dict) -> None:
    """Tensor parallelism on one card: the 4-layer copy at tp = 2 (shards
    ``[cuda:0] * 2``, eager) against tp = 1, f32 and bf16 (see the module
    docstring's phase 16). Each tp = 2 path's K1-K4 launches are counted
    (set to 0 just before the run) into ``e2e[dtype]["launches"]`` as
    ``tp2_inference``, ``tp2_perplexity``, ``tp2_api``."""
    import gc

    card = card_line()
    print(f"🕸️ tp path: InferenceEngine(tp={TP}, tp_devices=[cuda:0] * {TP}) on one card "
          f"({card})", flush=True)
    for dtype in ("f32", "bf16"):
        launches = e2e[dtype].setdefault("launches", {})
        rec = dict(case="tp_path", compute_dtype=dtype, tp=TP, card=card)
        engs = {t: tp_engine(model, tok, dtype, t, kv_block_size=BLOCK) for t in (1, TP)}
        try:
            tokenizer = engs[1].tokenizer
            ids = tokenizer.encode(PROMPT * 2)
            rec["logit_drift"] = tp_logits_drift(engs, ids)
            if not rec["logit_drift"] <= TP_LOGIT_TOL[dtype]:
                fail(f"tp {dtype}: logits {rec['logit_drift']:.3g} of max|logit| from "
                     f"tp = 1's (> {TP_LOGIT_TOL[dtype]})")
            prompt = ids[:256]
            runs = {}
            for t, e in engs.items():
                e.reset()
                zero_counts()
                res = e.generate(prompt, TP_STEPS, stop_on_eos=False)
                if t == TP:
                    launches["tp2_inference"] = read_counts()
                runs[t] = res.tokens
                rec[f"tp{t}_prefill_tok_per_s"] = res.eval_tok_per_s
                rec[f"tp{t}_decode_tok_per_s"] = res.pred_tok_per_s
                rec[f"tp{t}_eager_decode"] = eager_decode_ms(e, res.tokens[-1])

            def probe(p, got, want):
                i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
                if i is None:
                    return None
                engs[1].reset()
                logits, _ = engs[1].prefill(p + want[:i])
                return dict(pos=i, got=got[i], want=want[i],
                            margin=pick_margin(logits, got[i]))

            hold_transcripts(f"tp inference {dtype}", dtype, probe(prompt, runs[TP], runs[1]))
            rec["transcript_equal"] = runs[TP] == runs[1]
            ppl_ids = ids[:511]
            ppl = {}
            for t, e in engs.items():
                e.reset()
                zero_counts()
                t0 = time.perf_counter()
                ppl[t] = e.perplexity(ppl_ids)
                torch.cuda.synchronize()
                if t == TP:
                    launches["tp2_perplexity"] = read_counts()
                rec[f"tp{t}_perplexity_tok_per_s"] = (len(ppl_ids) - 1) / (
                    time.perf_counter() - t0)
            rec["perplexity"] = ppl
            rec["perplexity_rel"] = abs(ppl[TP] / ppl[1] - 1.0)
            if dtype == "f32" and not rec["perplexity_rel"] <= TP_PPL_TOL["f32"]:
                fail(f"tp f32 perplexity {ppl[TP]} against tp = 1's {ppl[1]}: "
                     f"{rec['perplexity_rel']:.3g} > {TP_PPL_TOL['f32']}")
            rec["api"] = tp_api(engs, probe, tokenizer, dtype, launches)
        finally:
            for e in engs.values():
                e.close()
            engs.clear()
            gc.collect()
            torch.cuda.empty_cache()
        if dtype == "f32":
            q80 = {}
            for t in (1, TP):
                e = tp_engine(model, tok, dtype, t, sync="q80")
                try:
                    q80[t] = e.perplexity(ppl_ids)
                finally:
                    e.close()
            rec["q80_perplexity"] = q80
            rec["q80_perplexity_rel"] = abs(q80[TP] / q80[1] - 1.0)
            if not rec["q80_perplexity_rel"] <= TP_PPL_TOL["q80"]:
                fail(f"tp Q80 perplexity {q80[TP]} against tp = 1's {q80[1]}: "
                     f"{rec['q80_perplexity_rel']:.3g} > {TP_PPL_TOL['q80']}")
        for path, kernels in (("tp2_inference", ("K1", "K2", "K3")),
                              ("tp2_perplexity", ("K1", "K3")),
                              ("tp2_api", ("K1", "K2", "K3", "K4"))):
            if min(launches[path][k] for k in kernels) <= 0:
                fail(f"tp {dtype} {path}: a kernel of the path never launched: "
                     f"{launches[path]}")
        rec["launches"] = {p: launches[p] for p in ("tp2_inference", "tp2_perplexity",
                                                    "tp2_api")}
        print(json.dumps(rec), flush=True)
        e2e[dtype]["tp_path"] = rec
        torch.cuda.empty_cache()


def f8_cast_check() -> dict:
    """The cache write's e4m3 cast on the card (``runtime/kvcache.py::
    to_cache``): the JAX package's bits on :data:`F8_SPECIAL`, and on 10^6
    random values at scale 300 (a fifth of them past 464) the bits the same
    function gives on the CPU."""
    from dllama_tpu_torch.runtime.kvcache import F8, to_cache

    x = torch.tensor([v for v, _ in F8_SPECIAL], dtype=torch.float32)
    got = to_cache(x.to(DEV), F8).view(torch.uint8).cpu().tolist()
    want = [b for _, b in F8_SPECIAL]
    g = torch.Generator().manual_seed(SEED + 11)
    r = torch.randn(1_000_000, generator=g) * 300
    dev_bits = to_cache(r.to(DEV), F8).view(torch.uint8).cpu()
    cpu_bits = to_cache(r, F8).view(torch.uint8)
    rec = dict(case="f8_cast", special_equal=got == want,
               special_mismatch=[(v, hex(a), hex(b)) for (v, b), a in zip(F8_SPECIAL, got)
                                 if a != b],
               random_values=r.numel(), random_nan=int(torch.isnan(dev_bits.view(F8).float())
                                                      .sum()),
               random_equal_cpu=bool(torch.equal(dev_bits, cpu_bits)))
    print(json.dumps(rec), flush=True)
    if not rec["special_equal"] or not rec["random_equal_cpu"]:
        fail(f"f8 cast on the card: {rec}")
    return rec


def f8_single(model: str, tok: str, text: str, n_layers: int, summary: dict) -> None:
    """``inference`` (64 greedy steps) and ``perplexity`` with ``--kv-dtype
    f8`` through the CLI at full width, f32 and bf16 compute (the CLI's
    Q80 buffers, as the main path): K1-K3 launch, every K3 launch follows
    :func:`check_path` (bf16 prefill chunks on the tensor cores, the rest
    SIMT); perplexity against the main path's default cache.
    Then the drift: one engine's prefill logits over the prompt with its
    default cache and again with an e4m3 cache, max|Δ| < 0.15 max|logit|
    (tests/test_kv_dtype.py's bound); the caches' GB beside."""
    from dllama_tpu_torch.formats.quants import Q80
    from dllama_tpu_torch.runtime.engine import InferenceEngine
    from dllama_tpu_torch.runtime.kvcache import F8, KVCache

    f8 = summary.setdefault("f8", {})
    for dtype in ("f32", "bf16"):
        common = ["--model", model, "--tokenizer", tok, "--compute-dtype", dtype,
                  "--max-seq-len", str(MAX_SEQ), "--seed", str(SEED), "--kv-dtype", "f8"]
        launches, paths = {}, []
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        with recorded_paths(paths):
            out = run_cli(["inference", *common, "--prompt", PROMPT, "--steps",
                           str(len(PROMPT.encode()) + 1 + 64), "--temperature", "0"])
        launches["f8_inference"] = read_counts()
        zero_counts()
        with recorded_paths(paths):
            ppl_out = run_cli(["perplexity", *common, "--file", text])
        launches["f8_perplexity"] = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        lines = out.splitlines()
        ppl = float(next(ln for ln in ppl_out.splitlines() if "Perplexity" in ln).split()[-1])
        eng = InferenceEngine(model, tok, device=DEV, max_seq_len=MAX_SEQ, sync_type=Q80,
                              compute_dtype="bfloat16" if dtype == "bf16" else "float32")
        try:
            ids = eng.tokenizer.encode(PROMPT)
            base, _ = eng.prefill(ids)
            cache_gb = {"default": 2 * eng.kv.k.numel() * eng.kv.k.element_size() / 1e9}
            eng.kv = KVCache.create(eng.cfg, dtype=F8, device=eng.device)
            eng.reset()
            got, _ = eng.prefill(ids)
            cache_gb["f8"] = 2 * eng.kv.k.numel() * eng.kv.k.element_size() / 1e9
        finally:
            eng.close()
        drift, ref = float(abs(got - base).max()), float(abs(base).max())
        # the main path's default-cache numbers, where it ran at this depth
        main = summary[dtype] if summary[dtype].get("layers") == n_layers else {}
        rec = dict(case="f8_single", compute_dtype=dtype, layers=n_layers,
                   generated=int(stat(lines, "Prediction", "nTokens:")),
                   prefill_tok_per_s=stat(lines, "Evaluation", "tokens/s:"),
                   decode_tok_per_s=stat(lines, "Prediction", "tokens/s:"),
                   decode_tok_per_s_default_cache=main.get("decode_tok_per_s"),
                   perplexity=ppl, perplexity_default_cache=main.get("perplexity"),
                   perplexity_rel_diff=(abs(ppl / main["perplexity"] - 1.0) if main
                                        else None),
                   logits_max_abs_drift=drift, logits_max_abs=ref,
                   drift_bound=0.15 * max(ref, 1.0), cache_gb=cache_gb, peak_gb=peak_gb,
                   k3_paths=dict(collections.Counter(p for _, p in paths)),
                   launches=launches)
        print(json.dumps(rec), flush=True)
        f8[dtype] = rec
        summary[dtype]["launches"].update(launches)
        if rec["generated"] != 64 or not math.isfinite(ppl) or ppl <= 1.0:
            fail(f"f8 {dtype}: {rec['generated']} tokens, perplexity {ppl}")
        for path, kernels in (("f8_inference", ("K1", "K2", "K3")),
                              ("f8_perplexity", ("K1", "K3"))):
            if min(launches[path][k] for k in kernels) <= 0:
                fail(f"f8 {dtype} {path}: a kernel of the path never launched: "
                     f"{launches[path]}")
        for n_splits, path in paths:
            check_path(f"f8 {dtype} K3", "f8-fast" if dtype == "bf16" else "f8-exact",
                       n_splits, path)
        if dtype == "bf16" and not rec["k3_paths"].get("tc"):
            fail(f"f8 bf16: no K3 prefill launch took the tensor cores: {rec['k3_paths']}")
        if not (0.0 < drift < rec["drift_bound"]):
            fail(f"f8 {dtype}: logits drift {drift:.4g} against the default cache, want "
                 f"0 < drift < {rec['drift_bound']:.4g}")
        if abs(cache_gb["f8"] * (4 if dtype == "f32" else 2) - cache_gb["default"]) > 1e-6:
            fail(f"f8 {dtype}: cache {cache_gb}")
        torch.cuda.empty_cache()


def f8_serving(model: str, tok: str, n_layers: int, summary: dict) -> None:
    """``api --batch-slots 8 --kv-block-size 16 --kv-dtype f8`` under bf16
    with the serving mix (:func:`serve_run`): K4 launches on the e4m3 pool,
    whose allocated tensors hold half the bytes of the bf16 run's per layer
    and block (both on the 8-layer copy, this run since slice 14, the bf16
    serving run since slice 17; measured on their pools' tensors)."""
    rec, _ = serve_run(model, tok, n_layers, "bf16", ["--kv-dtype", "f8"], case="serving_f8")
    launches = rec["launches"]["api"]
    bf16 = summary["bf16"]["serving"]
    per_unit = lambda r: r["pool_tensor_bytes"] / (r["layers"] * r["pool_blocks"])  # noqa: E731
    rec["pool_bytes_per_layer_block"] = per_unit(rec)
    rec["pool_bytes_per_layer_block_bf16_cache"] = per_unit(bf16)
    print(json.dumps(rec), flush=True)
    summary["f8"]["serving"] = rec
    summary["bf16"]["launches"]["f8_api"] = launches
    if min(launches[k] for k in ("K1", "K2", "K3", "K4")) <= 0:
        fail(f"serving f8: a kernel of the path never launched: {launches}")
    if 2 * rec["pool_bytes_per_layer_block"] != rec["pool_bytes_per_layer_block_bf16_cache"]:
        fail(f"serving f8: {rec['pool_bytes_per_layer_block']} pool bytes a layer and block, "
             f"want half of the bf16 cache's {rec['pool_bytes_per_layer_block_bf16_cache']}")
    torch.cuda.empty_cache()


def f8_sp(model: str, tok: str, summary: dict) -> None:
    """The sp path's short cell on an e4m3 cache: ``perplexity`` over the
    2551-token prompt at sp = 2 (K3s over e4m3 shards) against sp = 1 (K3),
    f32 buffers, in f32 (within that cell's bound, 1e-4) and bf16
    (recorded; the prefill blocks' single passes on the tensor cores)."""
    n_cards = torch.cuda.device_count()
    via = "cli" if n_cards >= 2 else "engine"
    out = {}
    for dtype in ("f32", "bf16"):
        paths: list = []
        with recorded_paths(paths):
            runs = {sp: sp_run(model, tok, via, dtype=dtype, sp=sp, seq_len=SP_SEQ,
                               text=PROMPT * 10, sync="f32", steps=0, ppl=True, kv="f8")
                    for sp in (2, 1)}
        p2, p1 = runs[2]["perplexity"], runs[1]["perplexity"]
        rec = dict(case="f8_sp", compute_dtype=dtype, perplexity_sp2=p2, perplexity_sp1=p1,
                   rel_diff=abs(p2 / p1 - 1), tol=1e-4 if dtype == "f32" else None,
                   launches={sp: r["launches_perplexity"] for sp, r in runs.items()},
                   paths=dict(collections.Counter(p for _, p in paths)))
        print(json.dumps(rec), flush=True)
        out[dtype] = rec
        for sp in (2, 1):
            summary[dtype]["launches"][f"f8_sp{sp}_perplexity"] = runs[sp]["launches_perplexity"]
        if runs[2]["launches_perplexity"]["K3s"] <= 0 or runs[1]["launches_perplexity"]["K3"] <= 0:
            fail(f"f8 sp {dtype}: K3s at sp=2 / K3 at sp=1 never launched: {rec['launches']}")
        if not math.isfinite(p2) or (dtype == "f32" and not rec["rel_diff"] <= 1e-4):
            fail(f"f8 sp {dtype}: perplexity at sp=2 {p2} against sp=1 {p1}: "
                 f"{rec['rel_diff']:.3g}")
        for n_splits, path in paths:
            check_path(f"f8 sp {dtype}", "f8-fast" if dtype == "bf16" else "f8-exact",
                       n_splits, path)
        if dtype == "bf16" and not rec["paths"].get("tc"):
            fail(f"f8 sp bf16: no prefill block took the tensor cores: {rec['paths']}")
    summary["f8"]["sp"] = out


# One process of the CLI as a user starts it (``python -c`` from the
# checkout's root, nothing of chip_smoke.py imported, so nothing of its
# TF32 switch), one that turned TF32 on for itself: each argv of
# ``sys.argv[1]`` through ``cli.main`` in turn, each run's counts set to 0
# before it, then one ``RUN {...}`` line with its output, generations,
# launches, engine load seconds, peak memory, the f32 matmul precision in
# force at each f32 ``F.linear`` (the dense products) and the process's TF32
# flag after the run
CLI_DRIVER = r"""
import collections, contextlib, io, json, sys, time
import torch
import torch.nn.functional as F
torch.backends.cuda.matmul.allow_tf32 = True
dense, linear = [], F.linear
def watched(x, w, *a, **kw):
    if x.dtype == torch.float32:
        dense.append(torch.get_float32_matmul_precision())
    return linear(x, w, *a, **kw)
F.linear = watched
from dllama_tpu_torch.ops import flash_attention as fa, paged_attention as pa, quant_matmul as qm
from dllama_tpu_torch.runtime import engine as E
from dllama_tpu_torch.serve import cli
wr = {"K1": qm.q40_matmul, "K2": qm.q40_gemv, "K3": fa.flash_attention,
      "K4": pa.paged_attention, "K3s": fa.flash_block_stats}
load_s, gens = [], []
init, generate = E.InferenceEngine.__init__, E.InferenceEngine.generate
def timed_init(self, *a, **kw):
    torch.cuda.synchronize(); t0 = time.perf_counter()
    init(self, *a, **kw)
    torch.cuda.synchronize(); load_s.append(time.perf_counter() - t0)
def recorded(self, prompt, *a, **kw):
    res = generate(self, prompt, *a, **kw)
    gens.append((list(prompt), res.tokens))
    return res
E.InferenceEngine.__init__, E.InferenceEngine.generate = timed_init, recorded
for argv in json.loads(sys.argv[1]):
    for f in wr.values():
        f.launches = 0
    load_s.clear(); gens.clear(); dense.clear()
    torch.cuda.empty_cache(); torch.cuda.reset_peak_memory_stats()
    buf, t0 = io.StringIO(), time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    print("RUN " + json.dumps(dict(
        argv=argv, rc=rc, wall_s=time.perf_counter() - t0, load_s=load_s[0],
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, out=buf.getvalue(), gens=gens,
        launches={k: f.launches for k, f in wr.items()},
        dense_f32=dict(collections.Counter(dense)),
        tf32=torch.backends.cuda.matmul.allow_tf32)), flush=True)
"""


def cli_process(runs: list[list[str]], timeout: int = 600) -> list[dict]:
    proc = subprocess.run([sys.executable, "-c", CLI_DRIVER, json.dumps(runs)],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    out = [json.loads(ln[4:]) for ln in proc.stdout.splitlines() if ln.startswith("RUN ")]
    if proc.returncode != 0 or len(out) != len(runs):
        fail(f"CLI process exited {proc.returncode} after {len(out)} of {len(runs)} runs:\n"
             f"{proc.stderr[-3000:]}")
    return out


def _ppl(out: str) -> float:
    return float(next(ln for ln in out.splitlines() if "Perplexity" in ln).split()[-1])


def weight_modes(model: str, tok: str, n_layers: int, summary: dict) -> None:
    """``--weight-mode f32`` and ``bf16`` at full width in one CLI process
    (:data:`CLI_DRIVER`: the package's own TF32 setting, not this
    script's), f32 buffers, beside the quantized-plane exact run
    (``--weight-mode auto``): 64 greedy tokens and ``perplexity``. Dense
    f32 must give the exact run's transcript (a departure only at a near
    tie, :data:`NEAR_TIE`) and its perplexity within 1e-4 relative; dense
    bf16 (bf16 compute) its perplexity within 5%. K1 and K2 never launch
    on dense weights, K3 does. The process turned TF32 on: every dense f32
    product must still run at the "highest" f32 matmul precision, and the
    process's TF32 flag must be on again after it. Then the dense f32
    decode step's device time in this process (:func:`engine_profile`)."""
    common = ["--model", model, "--tokenizer", tok, "--max-seq-len", str(MAX_SEQ),
              "--seed", str(SEED), "--buffer-float-type", "f32"]
    sides = [("auto", "f32"), ("f32", "f32"), ("bf16", "bf16")]
    runs = []
    for mode, dtype in sides:
        side = [*common, "--weight-mode", mode, "--compute-dtype", dtype]
        runs += [["inference", *side, "--prompt", PROMPT, "--steps",
                  str(len(PROMPT.encode()) + 1 + 64), "--temperature", "0"],
                 ["perplexity", *side, "--prompt", PROMPT * 2]]
    t0 = time.perf_counter()
    out = cli_process(runs)
    wall_s = time.perf_counter() - t0
    recs = {}
    for (mode, dtype), inf, ppl in zip(sides, out[0::2], out[1::2]):
        lines = inf["out"].splitlines()
        recs[mode] = dict(
            compute_dtype=dtype, load_s=inf["load_s"], peak_gb=max(inf["peak_gb"],
                                                                   ppl["peak_gb"]),
            prefill_tok_per_s=stat(lines, "Evaluation", "tokens/s:"),
            decode_tok_per_s=stat(lines, "Prediction", "tokens/s:"),
            perplexity=_ppl(ppl["out"]), tf32_after=inf["tf32"] and ppl["tf32"],
            dense_f32_precision={"inference": inf["dense_f32"],
                                 "perplexity": ppl["dense_f32"]},
            launches={"inference": inf["launches"], "perplexity": ppl["launches"]},
            prompt_ids=inf["gens"][0][0], tokens=inf["gens"][0][1])
    exact = recs["auto"]
    probe = TieProbe(model, tok, "f32", MAX_SEQ)
    try:
        diff = probe(exact["prompt_ids"], recs["f32"]["tokens"], exact["tokens"])
    finally:
        probe.close()
    # the dense f32 decode step's device time, beside the main path's Q40
    # step (engine_profile: Q80 buffers, 16 replays under torch.profiler)
    prof = engine_profile(model, tok, "f32", weight_mode="f32")[1]
    torch.cuda.empty_cache()
    rec = dict(case="weight_modes", layers=n_layers, process_wall_s=wall_s,
               f32_decode_profile={k: prof[k] for k in (
                   "device_ms_per_step", "device_busy_share", "wall_ms_per_step",
                   "kernels_per_step")},
               sides={m: {k: v for k, v in r.items() if k not in ("prompt_ids", "tokens")}
                      for m, r in recs.items()},
               f32_tokens_equal=recs["f32"]["tokens"] == exact["tokens"], f32_part=diff,
               f32_ppl_rel=abs(recs["f32"]["perplexity"] / exact["perplexity"] - 1),
               bf16_ppl_rel=abs(recs["bf16"]["perplexity"] / exact["perplexity"] - 1))
    print(json.dumps(rec), flush=True)
    summary["weight_modes"] = rec
    summary["f32"]["launches"]["weight_auto_inference"] = exact["launches"]["inference"]
    summary["f32"]["weight_auto_tokens"] = (exact["prompt_ids"], exact["tokens"])
    summary["f32"]["weight_auto_prefill_tok_per_s"] = exact["prefill_tok_per_s"]
    hold_transcripts("--weight-mode f32 against the Q40 exact run", "f32", diff)
    if not rec["f32_ppl_rel"] <= 1e-4 or not rec["bf16_ppl_rel"] <= 0.05:
        fail(f"weight modes: perplexity off the exact run by {rec['f32_ppl_rel']:.3g} (f32, "
             f"<= 1e-4) / {rec['bf16_ppl_rel']:.3g} (bf16, <= 5%)")
    for mode in ("f32", "bf16"):
        for path, n in recs[mode]["launches"].items():
            if n["K1"] or n["K2"] or n["K3"] <= 0:
                fail(f"--weight-mode {mode} {path}: want K1 = K2 = 0 and K3 > 0: {n}")
    for path, seen in recs["f32"]["dense_f32_precision"].items():
        if set(seen) != {"highest"}:
            fail(f"--weight-mode f32 {path}: f32 dense products at the matmul "
                 f"precisions {seen}, want all 'highest'")
    if not all(r["tf32_after"] for r in recs.values()):
        fail(f"weight modes: the CLI process's TF32 flag was not restored: "
             f"{ {m: r['tf32_after'] for m, r in recs.items()} }")


def nbatches_phase(model: str, tok: str, summary: dict) -> None:
    """``inference --nbatches N`` at full width, f32, f32 buffers, for N =
    32 (the reference's fixed prefill chunk) and N = 2048 (C7: the widest
    chunk the engine can pick at ``--max-seq-len 2048``, one chunk of 2048
    rows, 8192 folded query rows a KV head in K3): greedy tokens equal the
    bucketed run's (:func:`weight_modes`' exact side; a departure only at a
    near tie); prefill tok/s against the buckets'; K1 and K3 launch, and at
    2048 the prompt is one chunk."""
    prompt, want = summary["f32"]["weight_auto_tokens"]
    probe = TieProbe(model, tok, "f32", MAX_SEQ)
    try:
        for nb in (32, MAX_SEQ):
            gens: list = []
            zero_counts()
            with recorded_generations(gens):
                out = run_cli(["inference", "--model", model, "--tokenizer", tok,
                               "--max-seq-len", str(MAX_SEQ), "--seed", str(SEED),
                               "--buffer-float-type", "f32", "--nbatches", str(nb),
                               "--prompt", PROMPT, "--steps",
                               str(len(PROMPT.encode()) + 1 + 64), "--temperature", "0"])
            launches = read_counts()
            lines = out.splitlines()
            diff = probe(prompt, gens[0][1].tokens, want)
            chunks = [s for s in gens[0][1].steps if s.kind == "eval"]
            rec = dict(case="nbatches", nbatches=nb, tokens_equal=gens[0][1].tokens == want,
                       part=diff, chunks=len(chunks), chunk_ms=[c.ms for c in chunks],
                       prefill_tok_per_s=stat(lines, "Evaluation", "tokens/s:"),
                       prefill_tok_per_s_buckets=summary["f32"]["weight_auto_prefill_tok_per_s"],
                       decode_tok_per_s=stat(lines, "Prediction", "tokens/s:"),
                       launches=launches)
            print(json.dumps(rec), flush=True)
            summary[f"nbatches_{nb}"] = rec
            summary["f32"]["launches"][f"nbatches_{nb}_inference"] = launches
            hold_transcripts(f"--nbatches {nb} against the bucketed run", "f32", diff)
            if f"nBatches: {nb}" not in out or min(launches[k] for k in ("K1", "K2", "K3")) <= 0:
                fail(f"--nbatches {nb}: {launches}")
            if nb == MAX_SEQ and len(chunks) != 1:
                fail(f"--nbatches {nb}: {len(chunks)} prefill chunks, want one")
    finally:
        probe.close()


# ---------------------------------------------------------------------------
# phase 10b (slice 11): the step watchdog and failpoints on the card, the
# instrumentation's host cost, synchronisations per paged step
# ---------------------------------------------------------------------------

WATCHDOG_FLOOR_S = 2.0   # DLLAMA_WATCHDOG_FLOOR_S of the watchdog phase
HANG_S = 10.0            # the step_hang sleep: five budgets past the floor


def _post(url: str, body: dict, headers: dict | None = None) -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + "/v1/chat/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def watchdog_phase(model: str, tok: str, summary: dict) -> None:
    """The paged ``api`` on the 8-layer model with
    ``DLLAMA_WATCHDOG_FLOOR_S`` = :data:`WATCHDOG_FLOOR_S` set before the
    engine is built, on the card's captured steps. After two warm-up
    requests (the guards' budget trained): ``step:raise`` once — the
    in-flight request fails 503 with the crash, the crash and restart
    counters read 1, and a request afterwards completes; then
    ``step_hang`` (a :data:`HANG_S` sleep inside the guard) once — the
    JAX package's stall semantics: ``dllama_watchdog_stalls_total`` 1, the
    in-flight requests fail 503 naming the stalled dispatch, ``/readyz``
    answers 503 ``crashed``, a flight postmortem is written and converts.
    A stall is permanent (the scheduler stays unready), so the crash runs
    first. Every failpoint is cleared before the phase ends."""
    import threading
    import urllib.request

    from dllama_tpu_torch.runtime import failpoints, flightrec, telemetry
    from dllama_tpu_torch.serve import cli

    saved = {k: os.environ.get(k) for k in ("DLLAMA_WATCHDOG_FLOOR_S", "DLLAMA_FLIGHT_DIR")}
    flight_dir = tempfile.mkdtemp(prefix="dllama_flightdir_")
    os.environ["DLLAMA_WATCHDOG_FLOOR_S"] = str(WATCHDOG_FLOOR_S)
    os.environ["DLLAMA_FLIGHT_DIR"] = flight_dir
    reg = telemetry.registry()
    reg.reset()
    flightrec.recorder().reset()
    box: dict = {}
    listening = threading.Event()

    def on_listening(server, state):
        box.update(server=server, state=state)
        listening.set()

    argv = ["api", "--model", model, "--tokenizer", tok, "--max-seq-len", str(MAX_SEQ),
            "--seed", str(SEED), "--temperature", "0", "--batch-slots", str(SLOTS),
            "--kv-block-size", str(BLOCK), "--host", "127.0.0.1", "--port", "0"]
    th = threading.Thread(target=lambda: box.setdefault(
        "rc", cli.main(argv, on_listening=on_listening)), daemon=True)
    rec: dict = dict(case="watchdog", layers=None, floor_s=WATCHDOG_FLOOR_S, hang_s=HANG_S)
    try:
        th.start()
        while not listening.wait(timeout=1.0):
            if not th.is_alive():
                fail("watchdog phase: the api server exited before listening")
        url = f"http://127.0.0.1:{box['server'].server_address[1]}"
        eng = box["state"].engine
        rec["layers"] = eng.cfg.n_layers
        body = lambda i: {"messages": [{"role": "user", "content": f"watch {i}"}],  # noqa: E731
                          "max_tokens": 16}
        for i in range(2):
            status, _ = _post(url, body(i))
            if status != 200:
                fail(f"watchdog phase: warm-up request {i} answered {status}")
        wd = eng.watchdog
        rec["trained"] = dict(samples=wd.n_samples, ewma_ms=wd.ewma_ms, budget_s=wd.budget_s())
        if wd.budget_s() is None or not wd.budget_s() < HANG_S / 2:
            fail(f"watchdog phase: the budget after warm-up is {wd.budget_s()} s, want "
                 f"one under half the {HANG_S} s hang ({rec['trained']})")
        # step:raise once: the crash fails the in-flight request, then a restart
        failpoints.arm("step", "raise", times=1)
        crashed = _post(url, body(2))
        after = _post(url, body(3))
        rec["crash"] = dict(status=crashed[0], body=crashed[1], after_status=after[0],
                            crashes=reg.counter(telemetry.SCHEDULER_CRASHES).total(),
                            restarts=reg.counter(telemetry.SCHEDULER_RESTARTS).total())
        if not (crashed[0] == 503 and "scheduler crashed: FailpointError" in crashed[1]["error"]
                and after[0] == 200 and rec["crash"]["crashes"] == 1
                and rec["crash"]["restarts"] == 1):
            fail(f"watchdog phase, step:raise: {rec['crash']}")
        # step_hang once, past the budget: the stall fails what is in flight
        failpoints.arm("step_hang", "sleep", times=1, delay_s=HANG_S)
        t0 = time.perf_counter()
        results: list = [None, None]
        clients = [threading.Thread(target=lambda i=i: results.__setitem__(i, _post(url, body(4 + i))))
                   for i in range(2)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        stall_s = time.perf_counter() - t0
        ready = _get_json(url + "/readyz")
        for _ in range(600):  # the monitor writes the postmortem after failing the requests
            if reg.counter(telemetry.FLIGHT_DUMPS).total(reason="watchdog_stall"):
                break
            time.sleep(0.05)
        dumps = sorted(f for f in os.listdir(flight_dir) if f.endswith("-watchdog_stall.json"))
        rec["stall"] = dict(statuses=[r and r[0] for r in results],
                            errors=[r and r[1].get("error") for r in results],
                            seconds_to_fail=stall_s, readyz=ready,
                            stalls=reg.counter(telemetry.WATCHDOG_STALLS).total(), dumps=dumps)
        if not (all(r and r[0] == 503 and "step watchdog" in r[1]["error"] for r in results)
                and ready[0] == 503 and ready[1].get("code") == "crashed"
                and rec["stall"]["stalls"] == 1 and len(dumps) == 1):
            fail(f"watchdog phase, step_hang: {rec['stall']}")
        rc, _, _ = cli_rc(["timeline", "--dump", os.path.join(flight_dir, dumps[0]),
                           "--out", os.path.join(flight_dir, "stall_trace.json")])
        with open(os.path.join(flight_dir, dumps[0]), encoding="utf-8") as f:
            doc = json.load(f)
        rec["stall"].update(dump_victims=doc["victims"], dump_label=doc["info"]["label"],
                            timeline_rc=rc)
        if rc != 0 or len(doc["victims"]) < 2:
            fail(f"watchdog phase: the stall postmortem {rec['stall']}")
    finally:
        failpoints.registry().clear()
        if "server" in box:
            box["server"].shutdown()
        th.join(timeout=120)
        shutil.rmtree(flight_dir, ignore_errors=True)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if th.is_alive() or box.get("rc") != 0:
        fail(f"watchdog phase: the api server did not stop cleanly ({box.get('rc')})")
    print(json.dumps(rec), flush=True)
    summary["watchdog"] = rec


def obs_cost(summary: dict) -> None:
    """The instrumentation's host cost per paged step, the calls alone:
    an armed watchdog guard (enter, exit, the monitor's wake-up), the
    ``step_hang`` and ``step`` failpoint checks, one flight-recorder tick
    (begin, a dispatch, end), the step histogram, the token counter, the
    occupancy, KV and block gauges, the per-slot attribution of 8 slots,
    and the compile ledger's share (the tick's two reads of the scope's
    count and the steady check, the replay's hit and its per-replay launch,
    byte and operation counts of K2 and K4); 10000 steps, host clock. There
    is no switch to turn it off (the JAX package has none either)."""
    import types

    from dllama_tpu_torch.runtime import failpoints, flightrec, introspection, telemetry
    from dllama_tpu_torch.runtime.watchdog import StepWatchdog

    reg = telemetry.Registry()
    rec_ = flightrec.FlightRecorder()
    wd = StepWatchdog("cost", min_budget_s=120.0, enabled=True)
    for _ in range(wd.min_samples):
        wd.observe(15.0)
    m_step, m_occ, m_tok = (reg.histogram(telemetry.BATCH_STEP_MS),
                            reg.gauge(telemetry.BATCH_OCCUPANCY),
                            reg.counter(telemetry.BATCH_TOKENS))
    m_kv, m_used, m_shared = (reg.gauge(telemetry.KV_OCCUPANCY),
                              reg.gauge(telemetry.KV_BLOCKS_USED),
                              reg.gauge(telemetry.KV_BLOCKS_SHARED))
    slots = [[0.0] for _ in range(SLOTS)]
    led = introspection.CompileLedger()
    entry = led.register("cost", "paged_step")
    # what a replay adds to K2 (8 layers' matmuls and the head) and K4
    per_replay = [(types.SimpleNamespace(launches=0, moved_bytes=0.0, ops=0.0), (n, 1.0, 1.0))
                  for n in (7 * 8 + 1, 8)]
    n = 10000
    try:
        t0 = time.perf_counter()
        for i in range(n):
            before = led.compile_count("cost")
            for fn, (k, b, o) in per_replay:
                fn.launches += k
                fn.moved_bytes += b
                fn.ops += o
            entry["hits"] += 1
            if not led.steady("cost") and led.compile_count("cost") == before:
                led.mark_steady("cost")
            rec_.begin_tick(queue_depth=0, n_admissions=0)
            failpoints.fire("step")
            with wd.guard("batch_step"):
                failpoints.fire("step_hang")
            for s in slots:
                s[0] += 15.0
            m_occ.set(SLOTS)
            m_step.record(15.0)
            m_tok.inc(SLOTS)
            m_kv.set(0.5)
            rec_.note_dispatch(15.0, SLOTS, SLOTS)
            m_used.set(100)
            m_shared.set(10)
            rec_.end_tick(blocks={"total": 1024, "used": 100, "shared": 10},
                          slots=list(range(SLOTS)), prefill_budget=256)
        us = (time.perf_counter() - t0) / n * 1e6
    finally:
        wd.close()
    rec = dict(case="instrumentation_cost", steps=n, us_per_step=us,
               paged_step_wall_ms=summary.get("f32", {}).get("serving", {}).get("step_ms_median"),
               note="host clock; the calls alone, no device work")
    print(json.dumps(rec), flush=True)
    summary["instrumentation_cost"] = rec


def paged_step_syncs(model: str, tok: str, summary: dict,
                     case: str = "paged_step_syncs", eng=None) -> None:
    """Synchronisations a paged decode step makes, counted with
    ``torch.cuda.set_sync_debug_mode("warn")`` over 8 scheduler ticks
    (``BatchScheduler._tick`` on this thread: 8 slots at 8 layers decoding,
    the captured step) with every instrument on and tenant limits set (the
    slots' requests in four tenants, the tick's tenant accounting and
    fair-queue admission included): the step's one readback, and nothing
    the instrumentation or the tenancy added. ``eng``: count on this engine
    (one with ``kv_block_size=BLOCK``, left open) instead of building one
    on ``model``."""
    import warnings

    from dllama_tpu_torch.formats.quants import Q80
    from dllama_tpu_torch.runtime import tenancy
    from dllama_tpu_torch.runtime.engine import InferenceEngine
    from dllama_tpu_torch.runtime.serving import BatchScheduler

    own = eng is None
    if own:
        eng = InferenceEngine(model, tok, device=DEV, max_seq_len=MAX_SEQ, sync_type=Q80,
                              temperature=0.0, kv_block_size=BLOCK)
    try:
        sched = BatchScheduler(eng, SLOTS, _start_thread=False,
                               tenant_limits=tenancy.parse_limits(FLEET_LIMITS))
        sched.gen.capture()
        ids = eng.tokenizer.encode(PROMPT)
        tenants = ["light", "flood", "team-a", "team-b"]
        for i in range(SLOTS):
            sched.submit(ids[: 40 + 20 * i], 64, stop_on_eos=False, tenant=tenants[i % 4])
        while sched.gen.n_active < SLOTS:  # flood's two: under its cap
            sched._tick()
        sched._tick()
        torch.cuda.synchronize()
        n = 8
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for _ in range(n):
                    sched._tick()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # one warning per synchronising call (the mode's own "prototype"
        # notice, printed once a process, is not one)
        syncs = [str(w.message) for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]
        sched.close()
    finally:
        tenancy.reset()
        if own:
            eng.close()
    rec = dict(case=case, steps=n, syncs=len(syncs), tenant_limits=True,
               syncs_per_step=len(syncs) / n, first=syncs[:2])
    print(json.dumps(rec), flush=True)
    summary[case] = rec
    if len(syncs) != n:
        fail(f"{case}: {len(syncs)} synchronisations in {n} steps, want one each "
             f"(the token readback)")


def host_sampling_phase(model: str, tok: str, summary: dict) -> None:
    """Sampled ``inference`` (temperature 0.8, top-p 0.9) at full width,
    f32, f32 buffers, with and without ``--host-sampling``: the same tokens
    (a departure only at a near tie, :data:`NEAR_TIE_CDF`); the eager
    host-sampled decode tok/s beside the captured step's."""
    runs = {}
    for host in (False, True):
        gens: list = []
        zero_counts()
        with recorded_generations(gens):
            out = run_cli(["inference", "--model", model, "--tokenizer", tok,
                           "--max-seq-len", str(MAX_SEQ), "--seed", str(SEED),
                           "--buffer-float-type", "f32", "--prompt", PROMPT, "--steps",
                           str(len(PROMPT.encode()) + 1 + 64), "--temperature", "0.8",
                           *(["--host-sampling"] if host else [])])
        runs[host] = dict(launches=read_counts(), prompt=gens[0][0], tokens=gens[0][1].tokens,
                          decode_tok_per_s=stat(out.splitlines(), "Prediction", "tokens/s:"))
    probe = TieProbe(model, tok, "f32", MAX_SEQ)
    try:
        diff = probe(runs[True]["prompt"], runs[True]["tokens"], runs[False]["tokens"],
                     temperature=0.8, topp=0.9, seed=SEED)
    finally:
        probe.close()
    rec = dict(case="host_sampling", tokens_equal=runs[True]["tokens"] == runs[False]["tokens"],
               part=diff, decode_tok_per_s_host=runs[True]["decode_tok_per_s"],
               decode_tok_per_s_device=runs[False]["decode_tok_per_s"],
               launches={"host": runs[True]["launches"], "device": runs[False]["launches"]})
    print(json.dumps(rec), flush=True)
    summary["host_sampling"] = rec
    summary["f32"]["launches"]["host_sampling_inference"] = runs[True]["launches"]
    hold_transcripts("--host-sampling against the device sampler", "f32", diff, 0.8)
    if min(runs[True]["launches"][k] for k in ("K1", "K2", "K3")) <= 0:
        fail(f"--host-sampling: {runs[True]['launches']}")


def cli_rc(argv: list[str]) -> tuple[int, str, float]:
    """``(rc, stdout, seconds)`` of one in-process CLI call."""
    from dllama_tpu_torch.serve import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue(), time.perf_counter() - t0


def integrity_phase(model: str, tok: str, tmp: str, summary: dict) -> None:
    """Weight integrity at full width. ``verify --write`` then ``verify``
    on a symlink to the model in a directory of its own (the other phases
    load it without a manifest): the crc pass's seconds and GB/s, and an
    engine's load time with and without the manifest. Then a copy with one
    byte flipped in the last layer's ``w2``: ``verify`` exits 1 naming it;
    ``inference --verify-weights`` as a user runs it exits non-zero before
    staging; and the constructor that meets the tensor mid-load (after 31
    layers are staged) leaves ``torch.cuda.memory_allocated()`` where it
    was."""
    import shutil

    from dllama_tpu_torch.formats import mfile
    from dllama_tpu_torch.runtime.engine import InferenceEngine
    from dllama_tpu_torch.runtime.weights import WeightIntegrityError

    d = os.path.join(tmp, "integrity")
    os.makedirs(d)
    link, bad = os.path.join(d, "m.m"), os.path.join(d, "bad.m")
    os.symlink(model, link)
    gb = os.path.getsize(model) / 1e9
    rc_write, _, write_s = cli_rc(["verify", "--model", link, "--write"])
    rc_check, out_check, check_s = cli_rc(["verify", "--model", link])
    load = {}
    for name, path in (("with_manifest", link), ("without_manifest", model)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = InferenceEngine(path, tok, device=DEV, max_seq_len=MAX_SEQ)
        torch.cuda.synchronize()
        load[name] = time.perf_counter() - t0
        eng.close()
        torch.cuda.empty_cache()
    with mfile.ModelFile.open(model) as mf:
        key = max(mf.tensors, key=lambda k: mf.tensors[k].offset if k.startswith(
            "block_matmul_w2.") else -1)
        off = mf.tensors[key].offset + mf.tensors[key].n_bytes // 2
    shutil.copyfile(model, bad)
    shutil.copyfile(mfile.manifest_path(link), mfile.manifest_path(bad))
    with open(bad, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0x10]))
    rc_bad, out_bad, _ = cli_rc(["verify", "--model", bad])
    proc = subprocess.run(
        [sys.executable, "-m", "dllama_tpu_torch", "inference", "--model", bad, "--tokenizer",
         tok, "--prompt", "hello", "--steps", "8", "--max-seq-len", str(MAX_SEQ),
         "--verify-weights"], capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    try:
        InferenceEngine(bad, tok, device=DEV, max_seq_len=MAX_SEQ)
        raised = None
    except WeightIntegrityError as e:
        raised = str(e)
    after = torch.cuda.memory_allocated()
    rec = dict(case="integrity", model_gb=gb, write_rc=rc_write, write_s=write_s,
               verify_rc=rc_check, verify_s=check_s, crc_gb_per_s=gb / check_s,
               load_s=load, corrupt_tensor=key, corrupt_verify_rc=rc_bad,
               corrupt_named=f"❌ {key}" in out_bad,
               verify_weights_rc=proc.returncode,
               verify_weights_named=key in proc.stderr and "--verify-weights" in proc.stderr,
               loader_raised=raised, allocated_before=before, allocated_after=after)
    print(json.dumps(rec), flush=True)
    summary["integrity"] = rec
    if (rc_write, rc_check, rc_bad) != (0, 0, 1) or "tensors verified" not in out_check:
        fail(f"verify: rcs {rc_write}, {rc_check}, {rc_bad} (want 0, 0, 1)")
    if not rec["corrupt_named"] or proc.returncode == 0 or not rec["verify_weights_named"]:
        fail(f"corrupt copy: verify names it {rec['corrupt_named']}, inference "
             f"--verify-weights exited {proc.returncode}:\n{proc.stderr[-1500:]}")
    if raised is None or key not in raised or after != before:
        fail(f"the failed constructor: raised {raised!r}, memory_allocated {before} -> "
             f"{after}")
    os.remove(bad)


# ---------------------------------------------------------------------------
# slice 12: teacher-forced eval, the numerics observatory, the memory guard
# ---------------------------------------------------------------------------

# the eval dataset: 8 sequences of 138 .. 702 tokens (the serving mix's
# prompt lengths), uniform over the vocabulary from a seed
EVAL_LENS = [138 + (702 - 138) * i // 7 for i in range(8)]
EVAL_CONFIGS = {"single": [], "dense": ["--batch-slots", str(SLOTS)],
                "paged": ["--batch-slots", str(SLOTS), "--kv-block-size", str(BLOCK)],
                "paged_spec": ["--batch-slots", str(SLOTS), "--kv-block-size", str(BLOCK),
                               "--spec-lookup", str(SPEC_K), "--compare", "single"]}


def write_eval_data(path: str) -> list[list[int]]:
    g = torch.Generator().manual_seed(SEED + 12)
    seqs = [torch.randint(0, VOCAB, (n,), generator=g).tolist() for n in EVAL_LENS]
    with open(path, "w", encoding="utf-8") as f:
        for i, ids in enumerate(seqs):
            f.write(json.dumps({"id": f"s{i}", "tokens": ids}) + "\n")
    return seqs


def _last_json_line(out: str) -> dict:
    return json.loads(next(ln for ln in reversed(out.splitlines()) if ln.startswith("{")))


def eval_phase(model: str, tok: str, tmp: str, summary: dict) -> None:
    """``eval --json`` in one CLI process (:data:`CLI_DRIVER`, counts set to
    0 before each run) in the four configs (:data:`EVAL_CONFIGS`; the
    ``paged_spec`` run also ``--compare single``), f32 exact and bf16 fast,
    f32 sync buffers, at full width: per dtype the four total NLL hexes and
    the per-sequence hexes must be equal, ``--compare`` report no drift,
    and K1 and K3 must launch in every run. bf16 perplexity within 5% of
    f32. Then, in this process, the f32 ``single`` NLLs of the kernel path
    against the same engine on the plain versions called by name
    (``attn_impl``/``quant_impl="xla"``, which launch no kernel): max |Δ|
    within :data:`PARITY_TOL` ``exact`` of max |NLL|."""
    from dataclasses import replace

    from dllama_tpu_torch.formats.quants import F32
    from dllama_tpu_torch.runtime.engine import InferenceEngine

    data = os.path.join(tmp, "eval_8b.jsonl")
    seqs = write_eval_data(data)
    n_scored = sum(len(s) - 1 for s in seqs)
    runs, keys = [], []
    for dtype in ("f32", "bf16"):
        for config, flags in EVAL_CONFIGS.items():
            runs.append(["eval", "--model", model, "--tokenizer", tok, "--data", data, "--json",
                         "--max-seq-len", str(MAX_SEQ), "--compute-dtype", dtype,
                         "--buffer-float-type", "f32", *flags])
            keys.append((dtype, config))
    out = cli_process(runs, timeout=900)
    rec: dict = {"case": "eval", "seqs": len(seqs), "lens": EVAL_LENS, "n_scored": n_scored,
                 "runs": {}}
    hexes: dict = {}
    for (dtype, config), r in zip(keys, out):
        if r["rc"] != 0:
            fail(f"eval {dtype} {config}: rc {r['rc']}\n{r['out'][-2000:]}")
        res = _last_json_line(r["out"])
        if (res["config"] != config or res["n_tokens"] != n_scored or res["partial"]
                or not math.isfinite(res["perplexity"])):
            fail(f"eval {dtype} {config}: {dict((k, res.get(k)) for k in ('config', 'n_tokens', 'partial', 'perplexity'))}")
        if r["launches"]["K1"] == 0 or r["launches"]["K3"] == 0:
            fail(f"eval {dtype} {config}: K1/K3 did not launch: {r['launches']}")
        summary[dtype]["launches"][f"eval_{config}"] = r["launches"]
        hexes.setdefault(dtype, {})[config] = (res["total_nll_hex"],
                                               tuple(e["nll_hex"] for e in res["seqs"]))
        rec["runs"][f"{dtype} {config}"] = dict(
            total_nll_hex=res["total_nll_hex"], perplexity=res["perplexity"],
            eval_tok_per_s=res["eval_tok_per_s"], wall_s=res["wall_s"], launches=r["launches"],
            compare=(dict(config=res["compare"]["config"],
                          total_nll_hex=res["compare"]["total_nll_hex"],
                          parity_drift=res["parity_drift"]) if "compare" in res else None))
        if "compare" in res and (res["parity_drift"] or res["compare"]["total_nll_hex"]
                                 != res["total_nll_hex"]):
            fail(f"eval {dtype} {config} --compare single: parity drift "
                 f"{res['total_nll_hex']} against {res['compare']['total_nll_hex']}")
        print(f"   eval {dtype} {config}: {res['eval_tok_per_s']} tok/s, perplexity "
              f"{res['perplexity']:.6f} ({res['total_nll_hex']}), K1 {r['launches']['K1']} "
              f"K3 {r['launches']['K3']}", flush=True)
    for dtype, by_cfg in hexes.items():
        if len(set(by_cfg.values())) != 1:
            fail(f"eval {dtype}: the four configs' NLL hexes differ: "
                 f"{ {c: h[0] for c, h in by_cfg.items()} }")
    ppl = {d: rec["runs"][f"{d} single"]["perplexity"] for d in ("f32", "bf16")}
    rec["bf16_ppl_rel"] = abs(ppl["bf16"] - ppl["f32"]) / ppl["f32"]
    if rec["bf16_ppl_rel"] > 0.05:
        fail(f"eval: bf16 perplexity {ppl['bf16']} is not within 5% of f32's {ppl['f32']}")
    # the kernel path against the plain versions, on one engine
    eng = InferenceEngine(model, tok, device=DEV, max_seq_len=MAX_SEQ, sync_type=F32)
    try:
        zero_counts()
        kern = [eng.score_nll(s) for s in seqs]
        counts = read_counts()
        eng.cfg = replace(eng.cfg, attn_impl="xla", quant_impl="xla")
        zero_counts()
        plain = [eng.score_nll(s) for s in seqs]
        plain_counts = read_counts()
    finally:
        eng.close()
    total = 0.0
    for k in kern:
        total += float(k.astype("float64").sum())
    err = max(float(abs(k - p).max()) for k, p in zip(kern, plain))
    scale = max(float(abs(p).max()) for p in plain)
    rec["plain"] = dict(max_abs_err=err, max_abs_nll=scale, rel=err / scale,
                        tol=PARITY_TOL["exact"], kernel_launches=counts,
                        plain_launches=plain_counts,
                        in_process_hex_equal=total.hex() == rec["runs"]["f32 single"][
                            "total_nll_hex"])
    print(json.dumps(rec), flush=True)
    summary["eval"] = rec
    if any(plain_counts.values()) or not counts["K1"] or not counts["K3"]:
        fail(f"eval plain check: kernel launches {counts}, plain launches {plain_counts}")
    if err > PARITY_TOL["exact"] * scale:
        fail(f"eval: f32 NLLs of the kernel path are {err:.3g} from the plain versions' "
             f"(max |NLL| {scale:.3g}, tolerance {PARITY_TOL['exact']} of it)")


@contextlib.contextmanager
def api_server(argv: list[str], what: str):
    """The port's ``api`` in process on a thread (port 0): yields ``(url,
    state)``; every failpoint is cleared and the server stopped after."""
    import threading

    from dllama_tpu_torch.runtime import failpoints
    from dllama_tpu_torch.serve import cli

    box: dict = {}
    listening = threading.Event()

    def on_listening(server, state):
        box.update(server=server, state=state)
        listening.set()

    gc.collect()
    torch.cuda.empty_cache()
    th = threading.Thread(target=lambda: box.setdefault(
        "rc", cli.main([*argv, "--host", "127.0.0.1", "--port", "0"],
                       on_listening=on_listening)), daemon=True)
    th.start()
    while not listening.wait(timeout=1.0):
        if not th.is_alive():
            fail(f"{what}: the api server exited before listening")
    try:
        yield f"http://127.0.0.1:{box['server'].server_address[1]}", box["state"]
    finally:
        failpoints.registry().clear()
        box["server"].shutdown()
        th.join(timeout=120)
    if th.is_alive() or box.get("rc") != 0:
        fail(f"{what}: the api server did not stop cleanly ({box.get('rc')})")


CANARY_S = 0.25       # --canary-interval of the numerics phase
PATCH_LAYER = 5       # the layer whose norm the canary check patches in place
CANARY_TOKENS = 192   # tokens a request of the canary's traffic: >= 5 replays at 8 layers


def _body(text: str, max_tokens: int) -> dict:
    return {"messages": [{"role": "user", "content": text}], "max_tokens": max_tokens,
            "temperature": 0}


def _concurrent(url: str, bodies: list[dict]) -> list:
    import threading

    out: list = [None] * len(bodies)
    th = [threading.Thread(target=lambda i=i: out.__setitem__(i, _post(url, bodies[i])))
          for i in range(len(bodies))]
    for t in th:
        t.start()
    for t in th:
        t.join(timeout=600)
    return out


HOLD_S = 2.0  # the scheduler's pause after the victim's first chunk


def poison_round(url: str, state, mode: str, failfast: bool = True) -> dict:
    """``logits:nonfinite`` (``mode``) armed once, then a victim whose
    prompt takes two prefill chunks or more, alone in the scheduler: after
    its first chunk the ``step`` failpoint holds the scheduler for
    :data:`HOLD_S` while three long-prompt neighbours are submitted, so the
    next tick admits them before the victim's last chunk and its first
    decode step, the poisoned dispatch, which the victim has to itself.
    The flight recorder's events must show it: every neighbour admitted
    and none decode-armed before the poison. With fail-fast the victim
    fails 503 naming ``site=batch``; without it the victim completes. The
    neighbours answer 200 and ``dllama_nonfinite_total{site="batch"}``
    moves by one."""
    import threading

    from dllama_tpu_torch.runtime import failpoints, flightrec, telemetry

    reg = telemetry.registry()
    nf0 = reg.counter(telemetry.NONFINITE).total(site="batch")
    adm0 = reg.counter(telemetry.ADMISSIONS).total()
    t0_ns = telemetry.now_ns()
    failpoints.arm("logits", "nonfinite", times=1, mode=mode)
    failpoints.arm("step", "sleep", times=1, delay_s=HOLD_S)
    box: dict = {}
    tag = f"{mode} {'failfast' if failfast else 'count'}"
    victim = threading.Thread(target=lambda: box.update(
        v=_post(url, _body(f"poison {tag}: {PROMPT}", 8))))
    victim.start()
    for _ in range(2000):
        if reg.counter(telemetry.ADMISSIONS).total() > adm0:
            break
        time.sleep(0.005)
    # prompts of their own (no prefix an earlier round left to reuse): each
    # neighbour prefills its whole prompt, four chunks or more
    long = (PROMPT + " ") * 4
    neighbours = _concurrent(url, [_body(f"{tag} round, neighbour {i}: {long}", 8)
                                   for i in range(3)])
    victim.join(timeout=600)
    failpoints.registry().clear()
    status, body = box["v"]
    events = [e for e in flightrec.recorder().snapshot()["events"] if e["t_ns"] >= t0_ns]
    submits = [e["rid"] for e in events if e["event"] == "submit"]
    v_rid, n_rids = submits[0], submits[1:]

    def first(event: str, rid: int, **match) -> int | None:
        return next((e["t_ns"] for e in events if e["event"] == event and e["rid"] == rid
                     and all(e.get(k) == v for k, v in match.items())), None)

    t_poison = (first("retire", v_rid, reason="nonfinite") if failfast
                else first("first_token", v_rid))
    admitted = [first("admit", r) for r in n_rids]
    armed = [first("decode_armed", r) for r in n_rids]
    in_flight = (t_poison is not None and len(n_rids) == 3
                 and all(t is not None and t < t_poison for t in admitted)
                 and all(t is None or t > t_poison for t in armed))
    rec = dict(mode=mode, failfast=failfast, victim_status=status,
               victim_error=body.get("error"), neighbours=[n[0] for n in neighbours],
               nonfinite_batch=reg.counter(telemetry.NONFINITE).total(site="batch") - nf0,
               neighbours_in_flight_at_poison=in_flight)
    victim_ok = (status == 503 and "site=batch" in (body.get("error") or "") if failfast
                 else status == 200)
    if not (victim_ok and in_flight and all(n[0] == 200 for n in neighbours)
            and rec["nonfinite_batch"] == 1):
        fail(f"numerics, logits:{mode}: {rec}")
    return rec


def numerics_phase(model: str, tok: str, summary: dict) -> None:
    """The numerics observatory at full width, on the 8-layer copy since
    slice 14 (its traffic :data:`CANARY_TOKENS` a request, so that the
    canary replays under it at that depth):

    * the paged ``api`` with ``--numerics-failfast --numerics-taps
      --canary-interval`` :data:`CANARY_S`: 8 concurrent requests while the
      canary replays (>= 5 replays under traffic, 0 drift: the kernels are
      deterministic); then a weight patched in place (layer
      :data:`PATCH_LAYER`'s ffn norm ×3) must drift, naming ``layer N
      (mlp_out)``, and its restore replay clean again; then the ``logits``
      failpoint in ``nan`` and ``inf`` modes (:func:`poison_round`), and
      once without fail-fast;
    * the dense ``api`` (``--batch-slots 8``) with ``--numerics-failfast``:
      the same poison rounds;
    * ``inference`` with the failpoint armed: without fail-fast it counts
      ``site=decode`` and finishes, with ``--numerics-failfast`` it raises
      ``NumericsError`` naming ``site=decode``;
    * the single-sequence ``api`` with a canary after every completion;
    * the tripwire's cost per paged step: the host calls (the poison
      selector's failpoint check and the per-row tail over 8 rows) and the
      device time of the poison ``where`` over 8 vocabulary-wide rows."""
    from dllama_tpu_torch.models.llama import _poison_logits
    from dllama_tpu_torch.runtime import failpoints, numerics, telemetry
    from dllama_tpu_torch.runtime.serving import _GeneratorCore

    reg = telemetry.registry()
    reg.reset()
    rec: dict = {"case": "numerics"}
    common = ["--model", model, "--tokenizer", tok, "--max-seq-len", str(MAX_SEQ),
              "--seed", str(SEED), "--temperature", "0", "--numerics-failfast"]
    argv = ["api", *common, "--batch-slots", str(SLOTS), "--kv-block-size", str(BLOCK),
            "--numerics-taps", "--canary-interval", str(CANARY_S)]
    with api_server(argv, "numerics paged api") as (url, state):
        eng = state.engine
        canary = eng.canary
        runs0 = canary.status()["runs"]
        t0 = time.perf_counter()
        traffic = _concurrent(url, [_body(f"{i} {PROMPT}", CANARY_TOKENS)
                                    for i in range(SLOTS)])
        under = dict(seconds=time.perf_counter() - t0,
                     replays=canary.status()["runs"] - runs0,
                     drifts=canary.status()["drifts"],
                     statuses=[t[0] for t in traffic])
        rec["canary_under_traffic"] = under
        if any(s != 200 for s in under["statuses"]) or under["replays"] < 5 \
                or under["drifts"]:
            fail(f"numerics: the canary under traffic: {under}")
        norm = eng.params.layers[PATCH_LAYER].norm_ffn
        orig = norm.clone()
        norm.mul_(3.0)
        for _ in range(400):
            if canary.status()["drifts"]:
                break
            time.sleep(0.05)
        patched = canary.status()["last"]
        norm.copy_(orig)
        runs1 = canary.status()["runs"]
        for _ in range(400):
            if canary.status()["runs"] >= runs1 + 2:
                break
            time.sleep(0.05)
        restored = canary.status()
        rec["canary_patch"] = dict(
            patched=patched, drift_total=reg.counter(telemetry.CANARY_DRIFT).total(),
            restored_last=restored["last"], drifts=restored["drifts"],
            nonfinite_taps=numerics.debug_snapshot(eng)["taps"]["logits"]["nonfinite"])
        want = f"layer {PATCH_LAYER} (mlp_out)"
        if not (patched and patched.get("drift") and patched.get("divergent_layer") == want
                and rec["canary_patch"]["drift_total"] == 1 and restored["drifts"] == 1
                and restored["last"].get("drift") is False):
            fail(f"numerics: the patched-weight canary: {rec['canary_patch']}")
        rec["paged_poison"] = [poison_round(url, state, m) for m in ("nan", "inf")]
        # the default (no --numerics-failfast; the flag sets only this
        # attribute): the poisoned row is counted and its request completes
        eng.nf_failfast = False
        try:
            rec["paged_poison"].append(poison_round(url, state, "nan", failfast=False))
        finally:
            eng.nf_failfast = True
        _, snap = _get_json(url + "/debug/numerics")
        rec["debug_numerics"] = dict(nonfinite_by_site=snap["nonfinite_by_site"],
                                     failfast=snap["failfast"],
                                     canary_runs=snap["canary"]["runs"])
        if not snap["failfast"] or snap["nonfinite_by_site"].get("batch") != 3:
            fail(f"numerics: /debug/numerics {rec['debug_numerics']}")
    argv = ["api", *common, "--batch-slots", str(SLOTS)]
    with api_server(argv, "numerics dense api") as (url, state):
        rec["dense_poison"] = [poison_round(url, state, m) for m in ("nan", "inf")]
    # inference: count without fail-fast, raise with it
    inf = ["inference", "--model", model, "--tokenizer", tok, "--max-seq-len", str(MAX_SEQ),
           "--seed", str(SEED), "--temperature", "0", "--prompt", PROMPT, "--steps",
           str(len(PROMPT.encode()) + 1 + 8)]
    d0 = reg.counter(telemetry.NONFINITE).total(site="decode")
    failpoints.arm("logits", "nonfinite", times=1)
    rc, _, _ = cli_rc(inf)
    counted = reg.counter(telemetry.NONFINITE).total(site="decode") - d0
    failpoints.arm("logits", "nonfinite", times=1, mode="inf")
    try:
        cli_rc([*inf, "--numerics-failfast"])
        raised = None
    except numerics.NumericsError as e:
        raised = str(e)
    finally:
        failpoints.registry().clear()
    rec["inference"] = dict(rc=rc, counted=counted, failfast_error=raised)
    if rc != 0 or counted != 1 or not raised or "site=decode" not in raised:
        fail(f"numerics, inference: {rec['inference']}")
    # the single-sequence api: the canary replays after each completion
    argv = ["api", *common, "--canary-interval", "0.001"]
    with api_server(argv, "numerics single api") as (url, state):
        statuses = [_post(url, _body(f"single {i}", 8))[0] for i in range(3)]
        st = state.engine.canary.status()
        rec["single_api_canary"] = dict(statuses=statuses, runs=st["runs"],
                                        drifts=st["drifts"])
        if statuses != [200] * 3 or st["runs"] < 4 or st["drifts"]:
            fail(f"numerics, single api canary: {rec['single_api_canary']}")
    # the tripwire's cost per paged step
    core = _GeneratorCore.__new__(_GeneratorCore)
    core.eng = type("E", (), {"nf_failfast": True})()
    nf = [0] * SLOTS
    n = 10000
    t0 = time.perf_counter()
    for _ in range(n):
        numerics.poison_code()
        core._handle_nonfinite(list(range(SLOTS)), nf)
    host_us = (time.perf_counter() - t0) / n * 1e6
    logits = torch.randn((SLOTS, VOCAB), device=DEV)
    code = torch.zeros(1, device=DEV)
    dev_ms = Timer()(lambda: _poison_logits(logits, code))
    rec["tripwire_cost"] = dict(host_us_per_step=host_us, device_ms_per_step=dev_ms,
                                rows=SLOTS, note="host clock for the calls alone; "
                                "CUDA events for the poison where over [8, vocab] f32")
    print(json.dumps(rec), flush=True)
    summary["numerics"] = rec


def start_audit(model: str, layers: int) -> dict:
    """``audit --audit-json`` of ``model`` as a background CLI process (host
    only: numpy over every tensor on the host's cores, no card) at the
    lowest CPU priority, so the phases beside it keep their cores; collected
    by :func:`finish_audit`."""
    import atexit

    proc = subprocess.Popen(["nice", "-n", "19", sys.executable, "-m", "dllama_tpu_torch",
                             "audit", "--model", model, "--audit-json"],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    # a failed phase exits the script: the audit must not outlive it
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return {"proc": proc, "t0": time.perf_counter(), "model": os.path.basename(model),
            "layers": layers}


def finish_audit(audit: dict, summary: dict) -> None:
    """Wait for :func:`start_audit`'s process: every tensor of the file
    audited, none non-finite."""
    out, err = audit["proc"].communicate(timeout=600)
    res = _last_json_line(out) if audit["proc"].returncode == 0 else {}
    rec = dict(case="audit", rc=audit["proc"].returncode,
               seconds=time.perf_counter() - audit["t0"], model=audit["model"],
               tensors=res.get("tensors"), nonfinite_tensors=res.get("nonfinite_tensors"),
               min_snr_db=res.get("min_snr_db"))
    print(json.dumps(rec), flush=True)
    summary["audit"] = rec
    if audit["proc"].returncode != 0 or res.get("tensors") != 1 + 9 * audit["layers"] + 2 \
            or res.get("nonfinite_tensors"):
        fail(f"audit: {rec}\n{err[-2000:]}")


HBM_SLOTS = 256           # the dense pool the memory guard must shrink
HBM_WEIGHT_LIMIT = 16000000000  # DLLAMA_HBM_BYTES under which f32 weights must refuse


def hbm_phase(model: str, tok: str, summary: dict) -> None:
    """The device-memory guard at full width, 32 layers:

    * ``--weight-mode f32`` under ``DLLAMA_HBM_BYTES`` =
      :data:`HBM_WEIGHT_LIMIT`: the engine refuses before staging (no
      device memory allocated, no out-of-memory error) and the CLI exits
      non-zero with the guard's message;
    * ``api --batch-slots`` :data:`HBM_SLOTS` ``--max-seq-len 2048`` with an
      f32 cache (~0.54 GB a slot): the pool shrinks to what the card's
      memory (``torch.cuda.mem_get_info``'s total) fits, the shrunk pool
      serves a request, and with ``DLLAMA_HBM_BYTES`` set below the pool's
      need a prompt answers 503 ``queue_full`` and moves
      ``dllama_hbm_admission_rejects_total`` by one."""
    from dllama_tpu_torch.runtime import hbm, telemetry
    from dllama_tpu_torch.runtime.engine import InferenceEngine

    rec: dict = {"case": "hbm"}
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    os.environ["DLLAMA_HBM_BYTES"] = str(HBM_WEIGHT_LIMIT)
    try:
        try:
            InferenceEngine(model, tok, device=DEV, max_seq_len=MAX_SEQ, weight_mode="f32")
            refused = None
        except hbm.HbmBudgetError as e:
            refused = str(e)
        leaked = torch.cuda.memory_allocated() - before
        try:
            rc, out, _ = cli_rc(["inference", "--model", model, "--tokenizer", tok,
                                 "--max-seq-len", str(MAX_SEQ), "--weight-mode", "f32",
                                 "--prompt", "hi", "--steps", "8"])
            cli_msg = out
        except SystemExit as e:
            rc, cli_msg = (e.code if isinstance(e.code, int) else 1), str(e.code)
    finally:
        os.environ.pop("DLLAMA_HBM_BYTES", None)
    rec["weight_refusal"] = dict(limit=HBM_WEIGHT_LIMIT, engine_error=refused,
                                 leaked_bytes=leaked, cli_rc=rc, cli_message=cli_msg[:400])
    if not refused or "refusing to stage" not in refused or leaked != 0 or rc == 0 \
            or "refusing to stage" not in cli_msg:
        fail(f"hbm: --weight-mode f32 under {HBM_WEIGHT_LIMIT} B: {rec['weight_refusal']}")
    reg = telemetry.registry()
    argv = ["api", "--model", model, "--tokenizer", tok, "--max-seq-len", str(MAX_SEQ),
            "--seed", str(SEED), "--temperature", "0", "--batch-slots", str(HBM_SLOTS),
            "--kv-dtype", "f32"]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    with api_server(argv, "hbm dense api") as (url, state):
        gen = state.sched.gen
        up_s = time.perf_counter() - t0
        status, body = _post(url, _body("fits", 8))
        r0 = reg.counter(telemetry.HBM_ADMISSION_REJECTS).total()
        os.environ["DLLAMA_HBM_BYTES"] = str(gen.hbm_need - 1)
        try:
            refused = _post(url, _body("refused", 8))
        finally:
            os.environ.pop("DLLAMA_HBM_BYTES", None)
        rec["dense_fit"] = dict(
            asked=HBM_SLOTS, slots=gen.n_slots, pool_gb=gen.pool_bytes / 1e9,
            need_gb=gen.hbm_need / 1e9, limit_gb=hbm.device_memory_bytes(DEV) / 1e9,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9, startup_s=up_s,
            status=status, completion_tokens=body.get("usage", {}).get("completion_tokens"),
            refused_status=refused[0], refused_code=refused[1].get("code"),
            rejects=reg.counter(telemetry.HBM_ADMISSION_REJECTS).total() - r0)
    d = rec["dense_fit"]
    print(json.dumps(rec), flush=True)
    summary["hbm"] = rec
    if not (0 < d["slots"] < HBM_SLOTS and status == 200 and d["refused_status"] == 503
            and d["refused_code"] == "queue_full" and d["rejects"] == 1):
        fail(f"hbm: the {HBM_SLOTS}-slot dense pool: {d}")


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 13: the fleet tier (router, tenancy, mid-stream resume)
# ---------------------------------------------------------------------------

# --tenant-limits of both replicas: a slot-capped flooder and a weight-4
# light tenant; the metered tenant's token rate is set from its request's
# cost (prompt + max_tokens, charged up front) so that the bucket (2 s of
# rate) holds 1.5 requests: of four sent at once to one replica, the first
# passes and the others run it dry
FLEET_LIMITS = {"flood": {"max_slots": 2}, "light": {"weight": 4.0}}
METERED_BODY = {"messages": [{"role": "user", "content": "metered"}], "max_tokens": 32,
                "temperature": 0}
FLEET_SLO = "ttft_p95_ms=4000,itl_p50_ms=250,shed_rate=0.05"
FLEET_STREAM = 256    # tokens of each stream a replica death interrupts
FLEET_KILL_AFTER = 32  # tokens the client holds before the death
FLEET_ERR_STREAM = 160


def dev_flags() -> list[str]:
    """The CLI's device flag for a child process (the card is its default)."""
    return [] if DEV == "cuda" else ["--device", DEV]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Child:
    """``python -m dllama_tpu_torch ARGV`` as a process of its own from the
    checkout, its output in ``log``; killed at exit if still running."""

    def __init__(self, argv: list[str], log: str, env: dict | None = None):
        import atexit

        self.log = log
        with open(log, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "dllama_tpu_torch", *argv], stdout=f,
                stderr=subprocess.STDOUT, cwd=os.path.dirname(os.path.abspath(__file__)),
                env={**os.environ, **(env or {})})
        atexit.register(lambda: self.proc.poll() is None and self.proc.kill())

    @property
    def pid(self) -> int:
        return self.proc.pid

    def tail(self, n: int = 3000) -> str:
        with open(self.log, errors="replace") as f:
            return f.read()[-n:]

    def wait_ready(self, url: str, what: str, timeout: float = 600) -> float:
        """Poll ``GET url/readyz`` until 200; seconds it took."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout:
            if self.proc.poll() is not None:
                fail(f"{what} exited {self.proc.returncode} before it was ready:\n{self.tail()}")
            try:
                if _get_json(url + "/readyz")[0] == 200:
                    return time.perf_counter() - t0
            except OSError:
                pass
            time.sleep(0.2)
        fail(f"{what} not ready in {timeout:g} s:\n{self.tail()}")

    def stop(self, what: str) -> int:
        """SIGTERM (the api drains, the router stops) and wait."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                fail(f"{what} did not stop on SIGTERM:\n{self.tail()}")
        return self.proc.returncode


def stream_chat(url: str, body: dict, headers: dict | None = None, progress=None) -> dict:
    """One SSE completion, read event by event: the token ids of the
    ``dllama`` stamps with the ledger held (every stamped index advances by
    exactly the ids its chunk carries from the body's ``resume_from`` on: no
    gap, no duplicate), the text, the finish reason, ``[DONE]``, any
    terminal error event, the response's fleet id. ``progress(n_tokens)``
    runs after each stamped chunk."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + "/v1/chat/completions",
                                 data=json.dumps(dict(body, stream=True)).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    out = dict(status=None, tokens=[], text="", finish=None, done=False, gap=None,
               error=None, fleet_id=None, tenant=None)
    t0 = time.perf_counter()
    try:
        r = urllib.request.urlopen(req, timeout=900)
    except urllib.error.HTTPError as e:
        out.update(status=e.code, error=e.read().decode(errors="replace")[:500])
        return out
    with r:
        out.update(status=r.status, fleet_id=r.headers.get("X-Dllama-Request-Id"),
                   tenant=r.headers.get("X-Dllama-Tenant"))
        n = body.get("resume_from", 0)
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if line == "data: [DONE]":
                out["done"] = True
                continue
            obj = json.loads(line[6:])
            if "error" in obj:
                out["error"] = obj["error"]
                continue
            ch = obj["choices"][0]
            out["finish"] = ch.get("finish_reason") or out["finish"]
            out["text"] += (ch.get("delta") or {}).get("content") or ""
            meta = obj.get("dllama")
            if meta is None or meta["index"] == 0:
                continue  # the final chunk, or the prompt echo
            if meta["index"] != n + len(meta["tokens"]) and out["gap"] is None:
                out["gap"] = (n, meta["index"], len(meta["tokens"]))
            n = meta["index"]
            out["tokens"] += meta["tokens"]
            if progress is not None:
                progress(len(out["tokens"]))
    out["wall_s"] = time.perf_counter() - t0
    return out


def get_text(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=120) as r:
        return r.read().decode()


def in_threads(fns: list) -> list:
    """Run the callables concurrently; their results in order."""
    import threading

    out: list = [None] * len(fns)

    def run(i: int) -> None:
        try:
            out[i] = fns[i]()
        except Exception as e:  # noqa: BLE001 — reported by the caller's checks
            out[i] = dict(status=None, error=repr(e), tokens=[])

    ths = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=900)
    return out


def check_stream(what: str, r: dict, n: int) -> None:
    """A client stream that survived: 200, gapless, no duplicate, [DONE],
    finish ``length`` after all ``n`` tokens, no terminal error event."""
    if (r.get("status") != 200 or r.get("gap") is not None or not r.get("done")
            or r.get("error") is not None or r.get("finish") != "length"
            or len(r.get("tokens", [])) != n):
        fail(f"fleet {what}: the stream is not whole: "
             f"{ {k: r.get(k) for k in ('status', 'gap', 'done', 'error', 'finish')} }, "
             f"{len(r.get('tokens', []))} of {n} tokens")


def served_by(router: str, fleet_id: str) -> str | None:
    """The replica of a request's last ``rt_dispatch`` span (``/debug/fleet``)."""
    spans = _get_json(router + "/debug/fleet")[1]["spans"]
    hits = [s for s in spans if s["request_id"] == fleet_id and s["phase"] == "rt_dispatch"]
    return hits[-1]["replica"] if hits else None


def pin_session(router: str, want: str, tag: str, busy_url: str | None = None) -> str:
    """A session id whose first dispatch lands on replica ``want``: a
    one-token request per candidate id, read back from ``/debug/fleet``
    (idle replicas tie and the first wins; with ``busy_url`` a long request
    sent straight to that replica loads it, as the router's probe reads)."""
    import threading

    busy = None
    if busy_url is not None:
        busy = threading.Thread(target=_post, args=(
            busy_url, {"messages": [{"role": "user", "content": "keep busy " * 8}], "max_tokens": 96,
             "temperature": 0, "session_id": f"{tag}-busy"}))
        busy.start()
        time.sleep(1.0)
    try:
        for k in range(12):
            sid = f"{tag}-{k}"
            st, _ = _post(router, {"messages": [{"role": "user", "content": f"pin {sid}"}],
                                   "max_tokens": 1, "temperature": 0, "session_id": sid},
                          {"X-Dllama-Request-Id": f"pin-{sid}"})
            if st == 200 and served_by(router, f"pin-{sid}") == want:
                return sid
        fail(f"fleet: no session of {tag!r} landed on {want}")
    finally:
        if busy is not None:
            busy.join(timeout=600)


def prompt_ids(tokenizer, template, body: dict) -> list[int]:
    """The token ids the api admits for ``body``'s messages."""
    from dllama_tpu_torch.tokenizer.chat import ChatItem

    items = [ChatItem(m.get("role", "user"), m.get("content", "")) for m in body["messages"]]
    prompt = template.generate(items, append_generation_prompt=True)
    return tokenizer.encode(prompt.content, is_start=True, add_special_tokens=True)


def ledger_monotonic(path: str) -> int:
    """Lines of a usage ledger, each tenant's totals never decreasing."""
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    last: dict = {}
    for rec in lines:
        for t, v in rec["tenants"].items():
            for k in ("prefill_tokens", "decode_tokens", "admissions", "sheds", "timeouts"):
                if v[k] < last.get((t, k), 0):
                    fail(f"fleet: usage ledger {os.path.basename(path)}: {t} {k} fell from "
                         f"{last[(t, k)]} to {v[k]}")
                last[(t, k)] = v[k]
    if [r["seq"] for r in lines] != list(range(1, len(lines) + 1)):
        fail(f"fleet: usage ledger {os.path.basename(path)}: seq {[r['seq'] for r in lines]}")
    return len(lines)


def flood_slots(flight: dict) -> list[int]:
    """Per tick of a flight dump, the slots the ``flood`` tenant held."""
    tenant = {e["rid"]: e.get("tenant") for e in flight["events"] if e["event"] == "submit"}
    return [sum(1 for rid in t.get("slots") or [] if rid is not None
                and tenant.get(rid) == "flood") for t in flight["ticks"]]


def span_ms(spans: list, phase: str) -> list[float]:
    return [(s["end_ns"] - s["start_ns"]) / 1e6 for s in spans if s["phase"] == phase]


def router_libcuda(pid: int) -> bool | None:
    """Whether the CUDA driver library is mapped into process ``pid`` (None
    when unreadable)."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            return "libcuda.so" in f.read()
    except OSError:
        return None


def compute_apps() -> list[int]:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return [int(x) for x in out.stdout.split() if x.strip().isdigit()]


def fleet_phase(model: str, tok: str, tmp: str, n_layers: int, summary: dict) -> None:
    """The fleet tier at full width (f32, f32 buffers, paged pools; the
    8-layer copy since slice 14): replica A in process (:func:`api_server`), replica B and the
    router (``--probe-interval 0.2 --max-stream-resumes 1 --slo``) as
    processes of their own, both replicas under :data:`FLEET_LIMITS` with a
    usage ledger. The serving mix routed in two tenants (every request 200,
    both replicas dispatched, greedy transcripts against a direct run on
    A, the router's tenant view the sum of the replicas'); two streams
    interrupted by B's SIGKILL (EOF) and one by a ``step:raise`` on A (the
    terminal error chunk), each resumed gapless on the other replica and
    held to the unbroken run on A; B restarted and readmitted; tenancy
    (``flood`` never above 2 slots, ``light`` waiting less, ``metered``
    shed 429); ``/debug/slo``; ``fleettrace`` over the saved dumps; no CUDA
    context in the router; A's K1-K4 launched. Transcripts that part are
    held to the near-tie rule afterwards (:class:`TieProbe`)."""
    from dllama_tpu_torch.runtime import failpoints, flightrec, telemetry, tenancy
    from dllama_tpu_torch.serve.api import chat_template
    from dllama_tpu_torch.tokenizer.bpe import Tokenizer
    from dllama_tpu_torch.tokenizer.chat import ChatTemplateType

    tokenizer = Tokenizer.load(tok)
    template, _ = chat_template(tokenizer, ChatTemplateType.UNKNOWN)
    cost = len(prompt_ids(tokenizer, template, METERED_BODY)) + METERED_BODY["max_tokens"]
    limits = os.path.join(tmp, "fleet_limits.json")
    with open(limits, "w") as f:
        json.dump({**FLEET_LIMITS,
                   "metered": {"tokens_per_s": 1.5 * cost / tenancy.BURST_S}}, f)
    ledgers = {k: os.path.join(tmp, f"usage_{k}.jsonl") for k in ("A", "B1", "B2")}
    common = ["--model", model, "--tokenizer", tok, "--compute-dtype", "f32",
              "--buffer-float-type", "f32", "--max-seq-len", str(MAX_SEQ), "--seed", str(SEED),
              "--temperature", "0", "--batch-slots", str(SLOTS), "--kv-block-size", str(BLOCK),
              "--tenant-limits", limits]
    port_b = free_port()
    url_b = f"http://127.0.0.1:{port_b}"
    # B believes it owns the card: give it half of it (the memory guard's
    # own override), A takes what the process already holds
    half = str(int(torch.cuda.get_device_properties(0).total_memory // 2)) if DEV == "cuda" else None
    env_b = {"DLLAMA_HBM_BYTES": half} if half else {}

    def start_b(ledger: str) -> Child:
        return Child(["api", *common, *dev_flags(), "--usage-ledger", ledger, "--host",
                      "127.0.0.1", "--port", str(port_b)], os.path.join(tmp, "replica_b.log"),
                     env=env_b)

    rec: dict = {"case": "fleet", "layers": n_layers, "slots": SLOTS, "block_size": BLOCK}
    parts: list = []  # transcript pairs the near-tie rule judges at the end
    # this phase's telemetry, tenants and flight rings alone
    telemetry.registry().reset()
    telemetry.tracer()._ring.clear()
    flightrec.recorder().reset()
    tenancy.reset()
    b = start_b(ledgers["B1"])
    router = None
    gc.collect()
    torch.cuda.empty_cache()
    with api_server(["api", *common, "--usage-ledger", ledgers["A"]], "fleet replica A") as (
            url_a, state_a):
        try:
            name_a, name_b = url_a.removeprefix("http://"), url_b.removeprefix("http://")
            rec["b_ready_s"] = b.wait_ready(url_b, "fleet replica B")
            port_r = free_port()
            url_r = f"http://127.0.0.1:{port_r}"
            router = Child(["router", "--replica", url_a, "--replica", url_b,
                            "--probe-interval", "0.2", "--max-stream-resumes", "1",
                            "--slo", FLEET_SLO, "--host", "127.0.0.1", "--port", str(port_r)],
                           os.path.join(tmp, "router.log"))
            router.wait_ready(url_r, "fleet router", timeout=120)
            t_up = time.perf_counter()
            while any(r["state"] != "up" for r in _get_json(url_r + "/debug/fleet")[1]["replicas"]):
                if time.perf_counter() - t_up > 60:
                    fail(f"fleet: the router never saw both replicas up: "
                         f"{_get_json(url_r + '/debug/fleet')[1]['replicas']}")
                time.sleep(0.2)
            zero_counts()  # A's counts of this phase: from here to the last request

            def rmetric(series: str) -> float:
                return _metric(get_text(url_r + "/metrics"), series)

            # -- the serving mix, routed, in two tenants -------------------
            bodies = serving_bodies()
            tenants = ["team-a" if i % 2 == 0 else "team-b" for i in range(len(bodies))]
            t0 = time.perf_counter()
            routed = in_threads([lambda b_=b_, t=t: stream_chat(url_r, b_, {"X-Dllama-Tenant": t})
                                 for b_, t in zip(bodies, tenants)])
            wall = time.perf_counter() - t0
            bad = [(i, r.get("status"), r.get("error")) for i, r in enumerate(routed)
                   if r.get("status") != 200 or not r.get("tokens") or r.get("gap")
                   or not r.get("done")]
            if bad:
                fail(f"fleet routed mix: {len(bad)} request(s) failed: {bad[:3]}")
            disp = {n: rmetric(f'dllama_router_dispatch_total{{replica="{n}"}}')
                    for n in (name_a, name_b)}
            if min(disp.values()) <= 0:
                fail(f"fleet routed mix: a replica was never dispatched: {disp}")
            spans = _get_json(url_r + "/debug/fleet")[1]["spans"]
            ttft, conn = span_ms(spans, "rt_first_byte"), span_ms(spans, "rt_connect")
            n_tok = sum(len(r["tokens"]) for r in routed)
            rec["routed"] = dict(
                requests=len(bodies), generated_tokens=n_tok, wall_s=wall,
                gen_tok_per_s=n_tok / wall, dispatches=disp,
                router_ttft_ms_p50=statistics.median(ttft) if ttft else None,
                router_connect_ms_p50=statistics.median(conn) if conn else None,
                one_replica_gen_tok_per_s=summary.get("f32", {}).get("serving", {}).get(
                    "gen_tok_per_s"))
            print(f"   fleet routed: {n_tok / wall:.2f} gen tok/s over 2 replicas (one replica, "
                  f"serving phase: {rec['routed']['one_replica_gen_tok_per_s']}), router TTFT "
                  f"p50 {rec['routed']['router_ttft_ms_p50']} ms, connect p50 "
                  f"{rec['routed']['router_connect_ms_p50']} ms", flush=True)
            # the router's tenant view is the sum of the replicas'
            fleet_t = _get_json(url_r + "/debug/fleet/tenants")[1]
            reps_t = [_get_json(u + "/debug/tenants")[1]["tenants"] for u in (url_a, url_b)]
            for t in ("team-a", "team-b"):
                for k in ("decode_tokens", "prefill_tokens", "admissions"):
                    want = sum(rt.get(t, {}).get(k, 0) for rt in reps_t)
                    if fleet_t["tenants"].get(t, {}).get(k) != want or not want:
                        fail(f"fleet /debug/fleet/tenants {t} {k}: "
                             f"{fleet_t['tenants'].get(t, {}).get(k)}, the replicas sum {want}")
            if fleet_t["replicas_joined"] != 2:
                fail(f"fleet /debug/fleet/tenants joined {fleet_t['replicas_joined']} replicas")
            # the same mix directly on A: greedy transcripts equal up to a near tie
            direct = in_threads([lambda b_=b_: stream_chat(url_a, b_) for b_ in bodies])
            same = 0
            for i, (b_, r, d) in enumerate(zip(bodies, routed, direct)):
                if d.get("status") != 200 or d.get("gap"):
                    fail(f"fleet direct mix request {i}: {d.get('status')} {d.get('error')}")
                same += r["tokens"] == d["tokens"]
                if b_.get("temperature", 0.0) <= 0.0 and r["tokens"] != d["tokens"]:
                    parts.append((f"routed mix request {i}", prompt_ids(tokenizer, template, b_),
                                  r["tokens"], d["tokens"], 0.0, 0.9, 0))
            rec["routed"]["equal_to_direct"] = same

            # -- EOF death: SIGKILL B under two streams ---------------------
            gen_a = state_a.sched.gen
            graph0 = (gen_a._graph, gen_a._graph.capture_s, gen_a._verify)
            resumed0 = rmetric('dllama_router_stream_resumes_total{outcome="resumed"}')
            sids = [pin_session(url_r, name_b, f"eof{k}", busy_url=url_a) for k in range(2)]
            eof_bodies = [
                {"messages": [{"role": "user", "content": f"Tell the long story {k}."}],
                 "max_tokens": FLEET_STREAM, "session_id": sid,
                 **({"temperature": 0.0} if k == 0 else
                    {"temperature": 0.9, "top_p": 0.9, "seed": 4242})}
                for k, sid in enumerate(sids)]
            got = [0, 0]
            import threading

            both = threading.Event()

            def progress(k):
                def f(n):
                    got[k] = n
                    if min(got) >= FLEET_KILL_AFTER:
                        both.set()
                return f

            killer_t: dict = {}

            def killer():
                if not both.wait(timeout=600):
                    return
                killer_t["at_tokens"] = list(got)
                b.proc.kill()  # SIGKILL: the sockets close, no [DONE]
                b.proc.wait(timeout=60)
                killer_t["t"] = time.perf_counter()
                # the restart loads while the streams resume on A (the
                # router's half-open backoff readmits it once it answers)
                killer_t["b2"] = start_b(ledgers["B2"])

            kt = threading.Thread(target=killer)
            kt.start()
            eof = in_threads([lambda b_=b_, k=k: stream_chat(url_r, b_, progress=progress(k))
                              for k, b_ in enumerate(eof_bodies)])
            kt.join(timeout=600)
            if "t" not in killer_t:
                fail(f"fleet EOF death: the streams never reached {FLEET_KILL_AFTER} tokens "
                     f"each ({got})")
            b = killer_t["b2"]
            for k, r in enumerate(eof):
                check_stream(f"EOF death stream {k}", r, FLEET_STREAM)
            resumed = rmetric('dllama_router_stream_resumes_total{outcome="resumed"}')
            spans = _get_json(url_r + "/debug/fleet")[1]["spans"]
            rt_resume = [s for s in spans if s["phase"] == "rt_resume"]
            if resumed - resumed0 != 2 or len(rt_resume) < 2:
                fail(f"fleet EOF death: resumes {resumed - resumed0}, rt_resume spans "
                     f"{len(rt_resume)}; want 2")
            if (gen_a._graph, gen_a._graph.capture_s, gen_a._verify) != graph0:
                fail("fleet EOF death: replica A captured a new graph for the resumes")
            unbroken = in_threads([lambda b_=b_: stream_chat(url_a, b_) for b_ in eof_bodies])
            for k, (b_, r, u) in enumerate(zip(eof_bodies, eof, unbroken)):
                check_stream(f"unbroken run {k} on A", u, FLEET_STREAM)
                if r["tokens"] != u["tokens"]:
                    parts.append((f"EOF death stream {k}", prompt_ids(tokenizer, template, b_),
                                  r["tokens"], u["tokens"], b_["temperature"], 0.9,
                                  b_.get("seed", 0)))
            rec["eof"] = dict(killed_at_tokens=killer_t["at_tokens"],
                              resume_ms=[round((s["end_ns"] - s["start_ns"]) / 1e6, 3)
                                         for s in rt_resume],
                              resume_from=[s["resume_from"] for s in rt_resume],
                              equal_to_unbroken=[r["tokens"] == u["tokens"]
                                                 for r, u in zip(eof, unbroken)])

            # -- B restarted (at the kill) and readmitted ---------------------
            b.wait_ready(url_b, "fleet replica B (restarted)")
            t_re = time.perf_counter()
            while rmetric(f'dllama_router_readmits_total{{replica="{name_b}"}}') < 1:
                if time.perf_counter() - t_re > 60:
                    fail("fleet: the router never readmitted the restarted replica B")
                time.sleep(0.2)
            rec["b_restart_to_readmit_s"] = time.perf_counter() - killer_t["t"]
            disp_b0 = rmetric(f'dllama_router_dispatch_total{{replica="{name_b}"}}')

            # -- error-chunk death: step:raise on A mid-stream -------------
            sid = pin_session(url_r, name_a, "err")
            err_body = {"messages": [{"role": "user", "content": "Count the stones slowly."}],
                        "max_tokens": FLEET_ERR_STREAM, "temperature": 0.0, "session_id": sid}
            armed = threading.Event()

            def arm(n):
                if n >= FLEET_KILL_AFTER and not armed.is_set():
                    armed.set()
                    failpoints.registry().arm("step", "raise", times=1)

            crashes0 = telemetry.registry().counter(telemetry.SCHEDULER_CRASHES).total()
            err = stream_chat(url_r, err_body, progress=arm)
            failpoints.registry().clear()
            check_stream("error-chunk death", err, FLEET_ERR_STREAM)
            if telemetry.registry().counter(telemetry.SCHEDULER_CRASHES).total() != crashes0 + 1:
                fail("fleet error-chunk death: A's scheduler did not crash once")
            spans = _get_json(url_r + "/debug/fleet")[1]["spans"]
            rs = [s for s in spans if s["phase"] == "rt_resume"
                  and s["request_id"] == err["fleet_id"]]
            if len(rs) != 1 or rs[0]["replica"] != name_b:
                fail(f"fleet error-chunk death: want one resume on B, got {rs}")
            n_from = rs[0]["resume_from"]
            # the same resume body straight to A: the continuation B computed
            replay = stream_chat(url_a, dict(err_body, resume_from=n_from,
                                             resume_tokens=err["tokens"][:n_from]),
                                 {"X-Dllama-Resume-From": str(n_from)})
            if (replay.get("status") != 200 or replay.get("gap") or not replay.get("done")
                    or len(replay["tokens"]) != FLEET_ERR_STREAM - n_from):
                fail(f"fleet resume replay on A: {replay.get('status')} {replay.get('gap')} "
                     f"{len(replay.get('tokens', []))} tokens")
            if replay["tokens"] != err["tokens"][n_from:]:
                parts.append(("error-chunk continuation, B against A",
                              prompt_ids(tokenizer, template, err_body) + err["tokens"][:n_from],
                              err["tokens"][n_from:], replay["tokens"], 0.0, 0.9, 0))
            unbroken = stream_chat(url_a, err_body)
            check_stream("error-chunk unbroken run on A", unbroken, FLEET_ERR_STREAM)
            if err["tokens"] != unbroken["tokens"]:
                parts.append(("error-chunk death", prompt_ids(tokenizer, template, err_body),
                              err["tokens"], unbroken["tokens"], 0.0, 0.9, 0))
            rec["error_chunk"] = dict(resume_from=n_from,
                                      resume_ms=(rs[0]["end_ns"] - rs[0]["start_ns"]) / 1e6,
                                      equal_to_unbroken=err["tokens"] == unbroken["tokens"],
                                      replay_equal=replay["tokens"] == err["tokens"][n_from:])

            # -- fleettrace over the saved dumps ----------------------------
            dumps = {k: os.path.join(tmp, f"fleet_{k}.json") for k in ("router", "A", "B")}
            for k, u in (("router", url_r + "/debug/fleet"), ("A", url_a + "/debug/flight"),
                         ("B", url_b + "/debug/flight")):
                with open(dumps[k], "w") as f:
                    f.write(get_text(u))
            trace_out = os.path.join(tmp, "fleet_trace.json")
            ft = subprocess.run([sys.executable, "-m", "dllama_tpu_torch", "fleettrace",
                                 "--router-dump", dumps["router"], "--replica-dump",
                                 f"A={dumps['A']}", "--replica-dump", f"B={dumps['B']}",
                                 "--out", trace_out], capture_output=True, text=True,
                                timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
            if ft.returncode != 0 or "⚠️" in ft.stderr:
                fail(f"fleettrace: rc {ft.returncode}\n{ft.stdout[-1500:]}\n{ft.stderr[-1500:]}")
            with open(trace_out) as f:
                trace = json.load(f)
            pids = {e["pid"] for e in trace["traceEvents"] if e.get("ph") == "X"
                    and e.get("cat") == "replica"
                    and e["args"].get("request_id") == err["fleet_id"]}
            if len(pids) != 2:
                fail(f"fleettrace: the error-chunk request's flow crosses {len(pids)} replica "
                     f"track(s), want 2")
            rec["fleettrace"] = dict(events=len(trace["traceEvents"]), **trace["fleetJoin"])

            # -- tenancy -------------------------------------------------------
            flood = [{"messages": [{"role": "user", "content": f"flood request {i} " * 3}],
                      "max_tokens": 24, "temperature": 0} for i in range(24)]
            light = [{"messages": [{"role": "user", "content": f"light request {i}"}],
                      "max_tokens": 24, "temperature": 0} for i in range(4)]
            res = in_threads(
                [lambda b_=b_: _post(url_r, b_, {"X-Dllama-Tenant": "flood"}) for b_ in flood]
                + [lambda b_=b_: _post(url_r, b_, {"X-Dllama-Tenant": "light"})
                   for b_ in light])
            if any(not isinstance(r, tuple) or r[0] != 200 for r in res):
                fail(f"fleet tenancy: not every request 200: "
                     f"{[r[0] if isinstance(r, tuple) else r for r in res]}")
            sid = pin_session(url_r, name_a, "metered")  # anonymous: no budget spent
            metered = [r[0] if isinstance(r, tuple) else r for r in in_threads(
                [lambda: _post(url_r, dict(METERED_BODY, session_id=sid),
                               {"X-Dllama-Tenant": "metered"})] * 4)]
            if sorted(metered) != [200, 429, 429, 429]:
                fail(f"fleet tenancy: metered answers {metered}, want one 200 and three 429")
            views = {"A": _get_json(url_a + "/debug/tenants")[1],
                     "B": _get_json(url_b + "/debug/tenants")[1]}
            sheds = sum(v["tenants"].get("metered", {}).get("sheds", {}).get(
                "tenant_rate_budget", 0) for v in views.values())
            if sheds != metered.count(429):
                fail(f"fleet tenancy: {metered.count(429)} metered 429s, {sheds} "
                     f"tenant_rate_budget sheds on the replicas")
            slots = {"A": flood_slots(flightrec.recorder().snapshot()),
                     "B": flood_slots(_get_json(url_b + "/debug/flight")[1])}
            if max(max(s, default=0) for s in slots.values()) > 2:
                fail(f"fleet tenancy: flood held more than 2 slots: "
                     f"{ {k: max(s, default=0) for k, s in slots.items()} }")
            if max(max(s, default=0) for s in slots.values()) < 2:
                fail("fleet tenancy: flood never reached its 2-slot cap")
            waits, compared = {}, 0
            for k, v in views.items():
                w = {t: v["tenants"].get(t, {}).get("queue_wait_ms", {}) for t in ("flood", "light")}
                waits[k] = {t: w[t].get("p95") for t in w}
                if not (w["light"].get("n") and w["flood"].get("n")):
                    continue
                compared += 1
                if not w["light"]["p95"] < w["flood"]["p95"]:
                    fail(f"fleet tenancy on {k}: light's queue-wait p95 {w['light']['p95']} ms "
                         f"is not below flood's {w['flood']['p95']} ms")
            if not compared:
                fail(f"fleet tenancy: light and flood never shared a replica: {waits}")
            fleet_t = _get_json(url_r + "/debug/fleet/tenants")[1]
            rec["tenancy"] = dict(
                metered=metered, queue_wait_p95_ms=waits,
                flood_max_slots={k: max(s, default=0) for k, s in slots.items()},
                fleet_jain_index=fleet_t.get("fleet_jain_index"),
                replica_jain_index={k: v["fairness"]["jain_index"] for k, v in views.items()})
            print(f"   fleet tenancy: queue-wait p95 {waits}, fleet Jain index "
                  f"{fleet_t.get('fleet_jain_index')}", flush=True)
            if rmetric(f'dllama_router_dispatch_total{{replica="{name_b}"}}') <= disp_b0:
                fail("fleet: no traffic reached the restarted replica B")

            # -- SLO, the router's process, A's kernels ---------------------
            slo = _get_json(url_r + "/debug/slo")[1]
            objs = slo.get("objectives", {})
            if set(objs) != {"ttft_p95_ms", "itl_p50_ms", "shed_rate"} or any(
                    "compliant" not in o or set(o.get("burn", {})) != {"5m", "1h"}
                    for o in objs.values()):
                fail(f"fleet /debug/slo: {slo}")
            rec["slo"] = {k: dict(estimate=o["estimate"], compliant=o["compliant"],
                                  burn=o["burn"], n=o["n"]) for k, o in objs.items()}
            # the card's compute processes: this one (A) and B. In a container
            # nvidia-smi may list them under other pids, so the count is held
            # too, and the router must not even map the CUDA driver library
            apps = compute_apps() if DEV == "cuda" else []
            libcuda = router_libcuda(router.pid)
            rec["compute_apps"] = dict(pids=apps, router_pid=router.pid,
                                       router_maps_libcuda=libcuda)
            if router.pid in apps or len(apps) > 2 or libcuda:
                fail(f"fleet: the card lists {apps} as compute processes, the router (pid "
                     f"{router.pid}) maps libcuda: {libcuda}; it must touch no CUDA")
            launches = read_counts()
        finally:
            failpoints.registry().clear()
            if router is not None:
                router.stop("fleet router")
            rec["b_rc"] = b.stop("fleet replica B")
    rec["ledger_lines"] = {k: ledger_monotonic(p) for k, p in ledgers.items()}
    if not rec["ledger_lines"]["A"] or not rec["ledger_lines"]["B2"]:
        fail(f"fleet: usage ledgers {rec['ledger_lines']}")
    tenancy.reset()  # the process-wide limits and ledger A configured
    rec["launches"] = launches
    summary["f32"]["launches"]["fleet_A"] = launches
    if min(launches[k] for k in ("K1", "K2", "K3", "K4")) <= 0:
        fail(f"fleet: a kernel of replica A's path never launched: {launches}")
    # transcripts that part: the near-tie rule on the spec side's token
    probe = TieProbe(model, tok, "f32", MAX_SEQ)
    try:
        rec["parted"] = []
        for what, prompt, got_t, want_t, temp, topp, seed in parts:
            diff = probe(prompt, got_t, want_t, temperature=temp, topp=topp, seed=seed)
            rec["parted"].append(dict(what=what, **(diff or {})))
            hold_transcripts(f"fleet {what}", "f32", diff, temp)
    finally:
        probe.close()
    print(json.dumps(rec), flush=True)
    summary["fleet"] = rec


# -- slice 14: tiered KV memory and KV migration -----------------------------

TIER_SLOTS = 2          # kvtier: the served sessions run one at a time
TIER_SEQ = 1024         # kvtier --max-seq-len: 64-block tables, a 128-block pool
TIER_HOST = 512         # kvtier --kv-host-blocks: a 512 MiB pinned slab (8 layers, f32)
TIER_SESSIONS = 8       # idle sessions of 500-700 prompt tokens: 2.3x the pool
TIER_TOKENS = 8         # greedy tokens a turn
MIG_TOKENS = 16         # greedy tokens of a migration body
SYNC_HOST = 256         # the 8-layer sync/GB/s check's host blocks (256 MiB pinned)
RATE_RUNS = 5           # timed spill / page-in copy runs of every host chunk


@contextlib.contextmanager
def recorded_step_logits(store: dict):
    """Every paged decode step's logits, by request. The port's own
    ``paged_sampled_step`` runs unchanged; only inside it, the poison hook
    it calls on the last logits (``llama._poison_logits``) also copies its
    output into a static buffer, and ``PagedGenerator.step`` reads the rows
    of the requests it served back after each step, into
    ``store[tuple(prompt ids)] = {"tokens": [...], "logits": [...]}``. The
    step computes what it computed before (same ops, same order), so the
    tokens are the unrecorded run's; the readback (one ``[slots, vocab]``
    copy after a step that already synchronised) is this check's only
    addition. Active before the server starts, so its scheduler captures
    the recording step."""
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.runtime import serving

    bufs: dict = {}
    inside = [False]
    orig_fn, orig_poison, orig_step = (serving.paged_sampled_step, llama._poison_logits,
                                       serving.PagedGenerator.step)

    def poison_fn(logits, poison):
        last = orig_poison(logits, poison)
        if inside[0]:
            key = (last.device, tuple(last.shape))
            if key not in bufs:  # allocated at the capture's first warm-up run
                bufs[key] = torch.empty(last.shape, dtype=last.dtype, device=last.device)
            bufs[key].copy_(last)
            step_fn.last = bufs[key]
        return last

    def step_fn(*args, **kwargs):
        inside[0] = True
        try:
            return orig_fn(*args, **kwargs)
        finally:
            inside[0] = False

    def step(self):
        served = [(i, s, len(s.tokens)) for i, s in enumerate(self.slots) if s is not None]
        n = orig_step(self)
        rows = None
        for i, req, before in served:
            if len(req.tokens) > before:
                if rows is None:
                    rows = step_fn.last.cpu().numpy()
                rec = store.setdefault(tuple(req.prompt_ids), {"tokens": [], "logits": []})
                rec["tokens"].append(req.tokens[before])
                rec["logits"].append(rows[i].copy())
        return n

    serving.paged_sampled_step, llama._poison_logits = step_fn, poison_fn
    serving.PagedGenerator.step = step
    try:
        yield store
    finally:
        serving.paged_sampled_step, llama._poison_logits = orig_fn, orig_poison
        serving.PagedGenerator.step = orig_step


def chat_body(text: str, n: int, system: bool = False, **extra) -> dict:
    msgs = [{"role": "system", "content": SYSTEM}] if system else []
    return {"messages": msgs + [{"role": "user", "content": text}], "max_tokens": n,
            "temperature": 0.0, **extra}


def words_text(seed: int, n_bytes: int, lead: str) -> str:
    """``lead`` then the serving mix's words, ``n_bytes`` long."""
    import random

    rnd = random.Random(seed)
    words = [lead]
    while sum(len(w) + 1 for w in words) < n_bytes:
        words.append(rnd.choice(["alpha", "beta", "gamma", "delta", "river", "stone",
                                 "cloud", "seven", "orbit", "lemon"]))
    return " ".join(words)[:n_bytes]


def tier_sessions() -> list[str]:
    """:data:`TIER_SESSIONS` distinct first turns of 480-680 bytes (one
    token each): sessions apart from their first word on."""
    return [words_text(SEED + 100 + k, 480 + (200 * k) // (TIER_SESSIONS - 1),
                       f"session{k:02d}") for k in range(TIER_SESSIONS)]


def resume_body(text: str, reply: str, k: int) -> dict:
    return {"messages": [{"role": "user", "content": text},
                         {"role": "assistant", "content": reply},
                         {"role": "user", "content": f"And then, in session {k}?"}],
            "max_tokens": TIER_TOKENS, "temperature": 0.0}


def pcie_link() -> str:
    """The host link as ``nvidia-smi -q`` reports it: the PCIe generation
    and the link width, each ``Max`` and ``Current``."""
    out = subprocess.run(["nvidia-smi", "-q"], capture_output=True, text=True, timeout=60)
    found: dict = {}
    section = None
    for line in out.stdout.splitlines():
        key = line.strip()
        if key in ("PCIe Generation", "Link Width"):
            section = key
        elif section and ":" in key:
            name, _, value = (x.strip() for x in key.partition(":"))
            if name in ("Max", "Current"):
                found[f"{section} {name}"] = value
            elif not name.startswith(("Device", "Host")):
                section = None
        else:
            section = None
    return ", ".join(f"{k} {v}" for k, v in found.items()) or "not reported"


def tier_run(model: str, tok: str, extra: list[str], what: str, plan, store: dict) -> dict:
    """One in-process ``api`` (f32, f32 buffers, :data:`TIER_SLOTS` slots,
    block 16, ``--max-seq-len`` :data:`TIER_SEQ`, ``extra``) with every
    paged step's logits recorded into ``store``; ``plan(url, state, tokenizer,
    template)`` drives it and returns its record; K1-K4 launches of the
    plan's requests are added."""
    from dllama_tpu_torch.serve.api import chat_template
    from dllama_tpu_torch.tokenizer.bpe import Tokenizer
    from dllama_tpu_torch.tokenizer.chat import ChatTemplateType

    tokenizer = Tokenizer.load(tok)
    template, _ = chat_template(tokenizer, ChatTemplateType.UNKNOWN)
    argv = ["api", "--model", model, "--tokenizer", tok, "--compute-dtype", "f32",
            "--buffer-float-type", "f32", "--max-seq-len", str(TIER_SEQ), "--seed", str(SEED),
            "--temperature", "0", "--batch-slots", str(TIER_SLOTS), "--kv-block-size",
            str(BLOCK), *extra]
    with recorded_step_logits(store), api_server(argv, what) as (url, state):
        zero_counts()
        rec = plan(url, state, tokenizer, template)
        rec["launches"] = read_counts()
    return rec


def _complete(url: str, body: dict, what: str, headers: dict | None = None) -> dict:
    st, out = _post(url, dict(body, timing=True), headers)
    if st != 200:
        fail(f"{what}: HTTP {st}: {out}")
    return out


def kvtier_phase(model: str, tok: str, tmp: str, n_layers: int, summary: dict) -> None:
    """Tiered KV memory on the 8-layer copy (width is never cut; f32, f32
    buffers; ``api --batch-slots
    2 --kv-block-size 16 --max-seq-len 1024 --kv-host-blocks 512`` in process,
    a 128-block device pool): :data:`TIER_SESSIONS` sessions of 500-700
    prompt tokens, one at a time, idle (their cached KV 2.3x the pool), then
    each resumed with a new turn (the reply and a new user message). Three
    runs of the same sessions: *ref*, the tier off and each session resumed
    right after its first turn (never spilled, the same prefix reuse and so
    the same prefill chunks); *tier*, the idle wave then the resumes, whose
    transcripts and every step's logits must equal *ref*'s bit for bit; and
    *off*, the tier with every spill failing (``spill:raise``: the pool
    drop-evicts, the untiered contract), whose resumes prefill their prefix
    again (held to *ref* by the near-tie rule) — the TTFT it costs against
    *tier*'s page-in. In *tier*: one spilled block's bytes equal its host lane
    and, after page-in, its new device block (``torch.equal``); spill, host
    and page-in counters above 0, no exhaustion, ``pagein_ms`` in the timing
    block; ``pagein:raise:1`` fails only that resume (503) while a bystander
    stream decodes on, and its retry pages in and equals *ref*; the pool's
    address and the captured graph unchanged; K1-K4 launched. Then the same
    byte check on an e4m3 pool, the synchronisations of ticks that spill
    against ticks that do not, and spill / page-in GB/s beside the host
    link."""
    import numpy as np

    from dllama_tpu_torch.runtime import failpoints, flightrec, telemetry
    from dllama_tpu_torch.runtime.kvcache import cache_bits

    texts = tier_sessions()
    firsts = [chat_body(t, TIER_TOKENS) for t in texts]
    rec: dict = {"case": "kvtier", "layers": n_layers, "slots": TIER_SLOTS,
                 "block_size": BLOCK, "max_seq_len": TIER_SEQ, "host_blocks": TIER_HOST,
                 "sessions": TIER_SESSIONS, "host_link": pcie_link(), "card": card_line()}
    stores = {k: {} for k in ("ref", "tier", "off")}
    replies: dict = {}

    def ref_plan(url, state, tokenizer, template):
        gen = state.sched.gen
        rec["pool_blocks"] = gen.pool.n_blocks - 1
        ids = [prompt_ids(tokenizer, template, b) for b in firsts]
        rec["prompt_tokens"] = [len(i) for i in ids]
        rec["idle_kv_over_pool"] = round(
            sum(len(i) - 1 for i in ids) / (rec["pool_blocks"] * BLOCK), 3)
        ttft = []
        for k, (t, b) in enumerate(zip(texts, firsts)):
            replies[k] = _complete(url, b, "kvtier ref")["choices"][0]["message"]["content"]
            ttft.append(_complete(url, resume_body(t, replies[k], k), "kvtier ref")
                        ["timing"]["ttft_ms"])
        return {"resume_ttft_ms": ttft}

    rec["ref"] = tier_run(model, tok, [], "kvtier ref", ref_plan, stores["ref"])
    if rec["idle_kv_over_pool"] < 2.0:
        fail(f"kvtier: the idle sessions' KV is {rec['idle_kv_over_pool']}x the pool, want >= 2")
    resumes = [resume_body(t, replies[k], k) for k, t in enumerate(texts)]

    def tier_plan(url, state, tokenizer, template):
        import threading

        gen = state.sched.gen
        reg = telemetry.registry()
        c0 = {m: reg.counter(m).total() for m in (
            telemetry.KV_SPILL_BLOCKS, telemetry.KV_PAGEIN_BLOCKS,
            telemetry.KV_BLOCK_EXHAUSTION)}
        graph = (gen._graph, gen._graph.capture_s)
        ptr = (gen.pkv.k.data_ptr(), gen.pkv.v.data_ptr())
        ids0 = prompt_ids(tokenizer, template, firsts[0])
        out: dict = {"mirror_kind": gen.mirror.kind}
        for k, b in enumerate(firsts):
            _complete(url, b, "kvtier idle wave")
            if k == 0:  # the watched block: session 0's last full one, its own
                bid = gen.pool.match_prefix(ids0[:-1])[0][-1]
                before = [cache_bits(p)[:, bid].clone() for p in gen.pkv]
        shared = gen.pool.match_prefix(ids0[:-1])[0]
        host = shared[-1]
        if not gen.pool.is_host(host):
            fail(f"kvtier: session 0's block {bid} was not spilled by the idle wave "
                 f"({gen.pool.host_used_blocks()} host blocks used)")
        lane = gen.mirror.lane(host)
        out["spilled_equal_lane"] = all(torch.equal(a.to(b.device), b)
                                        for a, b in zip(lane, before))
        out["host_used_after_wave"] = reg.gauge(telemetry.KV_BLOCKS_HOST_USED).value()
        out["spilled_blocks_after_wave"] = reg.counter(telemetry.KV_SPILL_BLOCKS).total() - c0[
            telemetry.KV_SPILL_BLOCKS]
        # pagein:raise:1 on session 0's resume, a bystander stream decoding
        got: list = []
        started = threading.Event()
        bys = chat_body(words_text(SEED + 99, 300, "bystander"), 96)
        th = threading.Thread(target=lambda: got.append(stream_chat(
            url, bys, progress=lambda n: n >= 8 and started.set())))
        th.start()
        if not started.wait(300):
            fail("kvtier: the bystander stream never decoded 8 tokens")
        failpoints.registry().arm("pagein", "raise", times=1)
        st, body = _post(url, dict(resumes[0], timing=True))
        failpoints.registry().clear()
        th.join(600)
        out["pagein_fault"] = dict(status=st, error=str(body.get("error"))[:160],
                                   bystander_status=got[0]["status"] if got else None,
                                   bystander_tokens=len(got[0]["tokens"]) if got else 0)
        if st != 503 or "PageInError" not in str(body.get("error")):
            fail(f"kvtier pagein:raise: the resume answered {st} {body}, want a 503 "
                 f"PageInError")
        check_stream("kvtier bystander", got[0] if got else {}, 96)
        ttft, pagein = [], []
        for k, b in enumerate(resumes):
            t = _complete(url, b, "kvtier resume")["timing"]
            ttft.append(t["ttft_ms"])
            pagein.append(t.get("pagein_ms"))
            if k == 0:  # session 0's watched block, paged back in
                dev = gen.pool.match_prefix(ids0[:-1])[0][-1]
                out["pagein_equal"] = (not gen.pool.is_host(dev)
                                       and all(torch.equal(cache_bits(p)[:, dev], b)
                                               for p, b in zip(gen.pkv, before)))
        out.update(resume_ttft_ms=ttft, resume_pagein_ms=pagein)
        out["counters"] = {m: reg.counter(m).total() - v for m, v in c0.items()}
        out["graph_unchanged"] = (gen._graph, gen._graph.capture_s) == graph
        out["pool_ptr_unchanged"] = (gen.pkv.k.data_ptr(), gen.pkv.v.data_ptr()) == ptr
        events = flightrec.recorder().snapshot()["events"]
        out["requeues"] = sum(e["event"] == "requeue" for e in events)
        return out

    flightrec.recorder().reset()
    rec["tier"] = tier_run(model, tok, ["--kv-host-blocks", str(TIER_HOST)], "kvtier tier",
                           tier_plan, stores["tier"])
    t = rec["tier"]
    c = t["counters"]
    if not (t["spilled_equal_lane"] and t["pagein_equal"]):
        fail(f"kvtier: a spilled block's bytes are not its host lane's / its paged-in "
             f"block's ({t['spilled_equal_lane']}, {t['pagein_equal']})")
    if (c["dllama_kv_spill_blocks_total"] <= 0 or c["dllama_kv_pagein_blocks_total"] <= 0
            or t["host_used_after_wave"] <= 0 or c["dllama_kv_block_exhaustion_total"]
            or t["requeues"]):
        fail(f"kvtier counters: {c}, host used {t['host_used_after_wave']}, requeues "
             f"{t['requeues']}")
    if not all(p and p > 0 for p in t["resume_pagein_ms"]):
        fail(f"kvtier: a resume without pagein_ms in its timing block: {t['resume_pagein_ms']}")
    if not (t["graph_unchanged"] and t["pool_ptr_unchanged"]):
        fail("kvtier: the pool moved or a graph was captured after warm-up")
    # answers: every resume's transcript and every step's logits as ref's
    keys = [k for k in stores["ref"]]
    diff = [k for k in keys if k not in stores["tier"]
            or stores["tier"][k]["tokens"] != stores["ref"][k]["tokens"]
            or any(not np.array_equal(a, b) for a, b in zip(stores["tier"][k]["logits"],
                                                            stores["ref"][k]["logits"]))]
    rec["tier"]["bitwise_equal"] = f"{len(keys) - len(diff)}/{len(keys)}"
    if diff:
        fail(f"kvtier: {len(diff)} of {len(keys)} requests' transcripts or logits differ "
             f"from the never-spilled run")
    launches = rec["tier"]["launches"]
    summary["f32"]["launches"]["kvtier"] = launches
    if min(launches[k] for k in ("K1", "K2", "K3", "K4")) <= 0:
        fail(f"kvtier: a kernel of the tiered path never launched: {launches}")

    def off_plan(url, state, tokenizer, template):
        reg = telemetry.registry()
        s0 = reg.counter(telemetry.KV_SPILL_BLOCKS).total()
        failpoints.registry().arm("spill", "raise")
        try:
            for b in firsts:
                _complete(url, b, "kvtier spill:raise idle wave")
            ttft = [_complete(url, b, "kvtier spill:raise resume")["timing"]["ttft_ms"]
                    for b in resumes]
        finally:
            failpoints.registry().clear()
        gen = state.sched.gen
        return dict(resume_ttft_ms=ttft, host_used=gen.pool.host_used_blocks(),
                    spilled=reg.counter(telemetry.KV_SPILL_BLOCKS).total() - s0,
                    spill_failed=sum(e["event"] == "spill_failed"
                                     for e in flightrec.recorder().snapshot()["events"]))

    flightrec.recorder().reset()
    rec["off"] = tier_run(model, tok, ["--kv-host-blocks", str(TIER_HOST)],
                          "kvtier spill:raise", off_plan, stores["off"])
    if rec["off"]["host_used"] or rec["off"]["spilled"] or not rec["off"]["spill_failed"]:
        fail(f"kvtier spill:raise: host used {rec['off']['host_used']}, spilled "
             f"{rec['off']['spilled']}, failed spills {rec['off']['spill_failed']}")
    probe = TieProbe(model, tok, "f32", TIER_SEQ)
    try:
        parted = []
        for key in keys:
            got_t = stores["off"].get(key, {}).get("tokens", [])
            d = probe(list(key), got_t, stores["ref"][key]["tokens"])
            if d is not None:
                parted.append(d)
                hold_transcripts("kvtier spill:raise resume against ref", "f32", d)
        rec["off"]["parted"] = parted
    finally:
        probe.close()
    med = lambda xs: statistics.median(xs)  # noqa: E731
    rec["resume_ttft_p50_ms"] = {k: med(rec[k]["resume_ttft_ms"]) for k in ("tier", "off", "ref")}
    # e4m3 bytes, syncs of spilling ticks, GB/s
    rec["f8_bytes_equal"] = f8_tier_bytes(model, tok)
    rec.update(tier_syncs_and_rates(model, tok))
    print(f"   kvtier: resumed TTFT p50 {rec['resume_ttft_p50_ms']['tier']:.1f} ms with the "
          f"tier, {rec['resume_ttft_p50_ms']['off']:.1f} ms prefilled again; spill "
          f"{rec['spill_gb_per_s']:.2f} GB/s, page-in {rec['pagein_gb_per_s']:.2f} GB/s "
          f"(medians of {len(rec['rate_runs']['spill'])} copy runs) "
          f"({rec['host_link']}; {rec['card']})", flush=True)
    print(json.dumps(rec), flush=True)
    summary["kvtier"] = rec
    if not rec["f8_bytes_equal"]:
        fail("kvtier: an e4m3 pool's spilled block is not its host lane's / paged-in bytes")


def f8_tier_bytes(model: str, tok: str) -> bool:
    """The round trip on an e4m3 pool (8 layers, ``--kv-dtype f8``): a
    session's block bytes before pressure, its host lane after the spill,
    its new device block after the page-in, by ``torch.equal``."""
    from dllama_tpu_torch.formats.quants import F32
    from dllama_tpu_torch.runtime.engine import InferenceEngine
    from dllama_tpu_torch.runtime.kvcache import cache_bits
    from dllama_tpu_torch.runtime.serving import PagedGenerator, Request

    eng = InferenceEngine(model, tok, device=DEV, max_seq_len=512, sync_type=F32,
                          temperature=0.0, kv_block_size=BLOCK, kv_dtype="f8",
                          kv_host_blocks=16)
    try:
        gen = PagedGenerator(eng, 2)
        ids = eng.tokenizer.encode(PROMPT)[:200]
        gen.admit(Request(rid=0, prompt_ids=ids, max_tokens=2, stop_on_eos=False), 0)
        while gen.n_active:
            gen.step()
        bid = gen.pool.match_prefix(ids[:-1])[0][3]
        before = [cache_bits(p)[:, bid].clone() for p in gen.pkv]
        if gen.pkv.k.dtype != torch.float8_e4m3fn or not before[0].any():
            return False
        taken = []
        while gen.pool._cached:
            taken.append(gen.pool.alloc())
        host = gen.pool.match_prefix(ids[:-1])[0][3]
        lane_ok = gen.pool.is_host(host) and all(
            torch.equal(a.to(b.device), b) for a, b in zip(gen.mirror.lane(host), before))
        for b in taken[:4]:
            gen.pool.release(b)
        pairs = gen.pool.begin_pagein([host])
        gen.mirror.load(gen.pkv, pairs)
        gen.pool.commit_pagein(pairs)
        dev = pairs[0][1]
        return lane_ok and all(torch.equal(cache_bits(p)[:, dev], b)
                               for p, b in zip(gen.pkv, before))
    finally:
        eng.close()


def tier_syncs_and_rates(model: str, tok: str) -> dict:
    """On the 8-layer copy (Q80 buffers, 2 slots, block 16, ``--max-seq-len
    512``, :data:`SYNC_HOST` host blocks), a scheduler driven tick by tick
    on this thread: the pool filled with idle sessions' cached blocks, two
    requests decoding; synchronisations per tick under
    ``torch.cuda.set_sync_debug_mode("warn")``, split by whether the tick
    spilled (decode growth over a dry free list). Then the mirror's own
    copies timed (synchronised, every host chunk, real pool blocks): spill
    and page-in GB/s (the median of :data:`RATE_RUNS`, each run's beside
    it). The mirror's host slab must be page-locked and exactly the bytes
    of its host blocks."""
    import warnings

    from dllama_tpu_torch.formats.quants import Q80
    from dllama_tpu_torch.runtime import telemetry
    from dllama_tpu_torch.runtime.engine import InferenceEngine
    from dllama_tpu_torch.runtime.kvblocks import SPILL_BATCH
    from dllama_tpu_torch.runtime.serving import BatchScheduler

    eng = InferenceEngine(model, tok, device=DEV, max_seq_len=512, sync_type=Q80,
                          temperature=0.0, kv_block_size=BLOCK, kv_host_blocks=SYNC_HOST)
    out: dict = {}
    try:
        sched = BatchScheduler(eng, 2, _start_thread=False)
        sched.gen.capture()
        gen = sched.gen
        text = eng.tokenizer.encode(PROMPT * 3)
        for k in range(10):  # idle sessions: 2x the pool's blocks
            r = sched.submit(text[7 * k: 7 * k + 180], 2, stop_on_eos=False)
            while not r.done.is_set():
                sched._tick()
        if not gen.pool.host_used_blocks():
            fail("kvtier syncs: the idle sessions spilled nothing")
        for j in range(2):
            sched.submit(text[300 + j: 340 + j], 200, stop_on_eos=False)
        while gen.n_active < 2:
            sched._tick()
        torch.cuda.synchronize()
        spill = telemetry.registry().counter(telemetry.KV_SPILL_BLOCKS)
        per_tick = []
        for _ in range(96):
            s0 = spill.total()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    sched._tick()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            n = sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)
            per_tick.append((spill.total() > s0, n))
        spilling = [n for s, n in per_tick if s]
        other = [n for s, n in per_tick if not s]
        out["sync_ticks"] = dict(spilling=len(spilling), other=len(other),
                                 syncs_spilling=sorted(set(spilling)),
                                 syncs_other=sorted(set(other)))
        if not spilling or not other or max(spilling) > min(other):
            fail(f"kvtier syncs: ticks that spill {spilling}, ticks that do not {other}; a "
                 f"spill must add no synchronisation")
        # the copies alone: every host chunk, real device blocks
        sched.close()
        mirror, pool = gen.mirror, gen.pool
        pool.spill_fn = None  # the allocs below drop-evict: no buffer leaves the count
        mirror.drop_all()
        out["mirror"] = dict(kind=mirror.kind, host_bytes=mirror.host_bytes,
                             pinned=mirror._idle[0].k.is_pinned(),
                             budget_bytes=pool.n_host_blocks * gen._block_bytes)
        if (out["mirror"]["kind"], out["mirror"]["pinned"]) != ("pinned", True) or \
                mirror.host_bytes != out["mirror"]["budget_bytes"]:
            fail(f"kvtier: the host slab is not page-locked or not its blocks' bytes: "
                 f"{out['mirror']}")
        n_chunks = len(mirror._idle)
        devs = [pool.alloc() for _ in range(SPILL_BATCH)]
        hosts = [[10 ** 6 + SPILL_BATCH * c + j for j in range(SPILL_BATCH)]
                 for c in range(n_chunks)]
        nbytes = n_chunks * SPILL_BATCH * gen._block_bytes
        rates = {}
        for rep in range(RATE_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for hs in hosts:
                mirror.store(gen.pkv, devs, hs)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for hs in hosts:
                mirror.load(gen.pkv, list(zip(hs, devs)))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            rates.setdefault("spill", []).append(nbytes / (t1 - t0) / 1e9)
            rates.setdefault("pagein", []).append(nbytes / (t2 - t1) / 1e9)
        out.update(spill_gb_per_s=statistics.median(rates["spill"]),
                   pagein_gb_per_s=statistics.median(rates["pagein"]),
                   rate_bytes=nbytes, rate_runs=rates)
    finally:
        eng.close()
    return out


def mig_bodies() -> tuple[list[dict], list[dict]]:
    """Seven greedy bodies of 400-700 prompt tokens in the serving mix's
    words: three kept for the fallback rounds (a user message alone) and
    four for the routed migration (behind the mix's system message)."""
    kept = [chat_body(words_text(SEED + 200 + i, 420 + 110 * i, f"kept{i}"), MIG_TOKENS)
            for i in range(3)]
    moved = [chat_body(words_text(SEED + 300 + i, 260 + 90 * i, f"moved{i}"), MIG_TOKENS,
                       system=True, session_id=f"kvmig-{i}") for i in range(4)]
    return kept, moved


def kvmigrate_phase(model: str, tok: str, tmp: str, n_layers: int, summary: dict) -> None:
    """KV migration on the 8-layer copy (width is never cut; f32, f32
    buffers, paged pools of 8 slots, block 16). The oracle first: replica D0
    in process serves the seven bodies of :func:`mig_bodies` (each prefix
    computed locally), every step's logits recorded, then stops. Then the
    fleet: P (``--role prefill``) as a process, D (``--role decode``) in
    process with logits recorded, the router (a process, no CUDA). The
    fallback rounds first, straight to D, each with a kept body D never
    saw: a hint naming a port nobody listens on (``peer_death``),
    ``kvwire:raise`` armed on D after the stream's header (``peer_death``),
    the ``kvwire`` short read (``crc``) — each transcript equal to D0's bit
    for bit (D recomputes from nothing, as D0 did, in the same order). Then
    the four routed bodies: P warmed (``rt_prefill``), D named its donor
    (``rt_kv_donor``) and migrating, 4 ``migrated`` and no fallback on D,
    ``kvmigrate_ms`` in the timing block, P never dispatched; D's first-token
    logits within 0.15 max|logit| of D0's, a transcript departure only where
    D0's top-2 margin is below that drift. The bytes: P's ``/v1/kv/export``
    of one body, decoded by the port's ``kvwire.read_stream``, equals D's
    blocks at the ids its ``match_prefix`` returns. K1-K4 launched on D0 and
    on D."""
    import urllib.request

    import numpy as np

    from dllama_tpu_torch.runtime import failpoints, kvwire, telemetry
    from dllama_tpu_torch.runtime.kvcache import cache_bits
    from dllama_tpu_torch.serve.api import chat_template
    from dllama_tpu_torch.tokenizer.bpe import Tokenizer
    from dllama_tpu_torch.tokenizer.chat import ChatTemplateType

    tokenizer = Tokenizer.load(tok)
    template, _ = chat_template(tokenizer, ChatTemplateType.UNKNOWN)
    kept, moved = mig_bodies()
    ids = {id(b): prompt_ids(tokenizer, template, b) for b in kept + moved}
    common = ["--model", model, "--tokenizer", tok, "--compute-dtype", "f32",
              "--buffer-float-type", "f32", "--max-seq-len", str(MAX_SEQ), "--seed", str(SEED),
              "--temperature", "0", "--batch-slots", str(SLOTS), "--kv-block-size", str(BLOCK)]
    rec: dict = {"case": "kvmigrate", "layers": n_layers, "slots": SLOTS, "block_size": BLOCK,
                 "prompt_tokens": [len(ids[id(b)]) for b in kept + moved], "card": card_line()}
    d0: dict = {}
    with recorded_step_logits(d0), api_server(["api", *common], "kvmigrate D0") as (url, _):
        zero_counts()
        for b in kept + moved:
            _complete(url, b, "kvmigrate D0")
        rec["d0_launches"] = read_counts()
    dd: dict = {}
    port_p = free_port()
    url_p = f"http://127.0.0.1:{port_p}"
    p = Child(["api", *common, *dev_flags(), "--role", "prefill", "--host", "127.0.0.1",
               "--port", str(port_p)], os.path.join(tmp, "replica_p.log"))
    router = None
    reg = telemetry.registry()

    def mig_totals() -> dict:
        return {"migrated": reg.counter(telemetry.KVWIRE_MIGRATIONS).total(outcome="migrated"),
                "fallback": reg.counter(telemetry.KVWIRE_MIGRATIONS).total(outcome="fallback"),
                **{r: reg.counter(telemetry.KVWIRE_FALLBACK).total(reason=r)
                   for r in kvwire.FALLBACK_REASONS}}

    try:
        with recorded_step_logits(dd), api_server(["api", *common, "--role", "decode"],
                                                  "kvmigrate D") as (url_d, state_d):
            rec["p_ready_s"] = p.wait_ready(url_p, "kvmigrate replica P")
            port_r = free_port()
            url_r = f"http://127.0.0.1:{port_r}"
            router = Child(["router", "--replica", url_p, "--replica", url_d,
                            "--probe-interval", "0.2", "--host", "127.0.0.1", "--port",
                            str(port_r)], os.path.join(tmp, "router_kv.log"))
            router.wait_ready(url_r, "kvmigrate router", timeout=120)
            name_p = url_p.removeprefix("http://")
            t_up = time.perf_counter()
            while True:
                reps = _get_json(url_r + "/debug/fleet")[1]["replicas"]
                if all(r["state"] == "up" for r in reps) and any(
                        r["replica"] == name_p and r.get("role") == "prefill" for r in reps):
                    break
                if time.perf_counter() - t_up > 60:
                    fail(f"kvmigrate: the router never saw P as an up prefill replica: {reps}")
                time.sleep(0.2)
            zero_counts()
            # -- the fallback rounds, straight to D ------------------------
            dead = free_port()
            orig_check = kvwire.check_geometry

            def arm_after_header(header, expect):
                orig_check(header, expect)
                failpoints.registry().arm("kvwire", "raise", times=1)

            rounds = []
            for i, (why, want) in enumerate((("dead port", "peer_death"),
                                             ("kvwire:raise mid-stream", "peer_death"),
                                             ("kvwire short read", "crc"))):
                body = kept[i]
                peer = f"127.0.0.1:{dead}"
                if i:
                    _complete(url_p, body, "kvmigrate P warm")  # P holds the prefix
                    peer = name_p
                if i == 1:
                    kvwire.check_geometry = arm_after_header
                elif i == 2:
                    failpoints.registry().arm("kvwire", "short_read", times=1)
                t0 = mig_totals()
                try:
                    out = _complete(url_d, body, f"kvmigrate fallback {why}",
                                    {"X-Dllama-KV-Peer": peer})
                finally:
                    kvwire.check_geometry = orig_check
                    failpoints.registry().clear()
                d = {k: v - t0[k] for k, v in mig_totals().items()}
                key = tuple(ids[id(body)])
                equal = dd.get(key, {}).get("tokens") == d0[key]["tokens"]
                rounds.append(dict(round=why, reason=want, counts=d, equal_to_d0=equal,
                                   kvmigrate_ms=out["timing"]["kvmigrate_ms"]))
                if d["fallback"] != 1 or d[want] != 1 or d["migrated"] or not equal:
                    fail(f"kvmigrate fallback {why}: {d}, transcript equal to D0: {equal}")
            rec["fallbacks"] = rounds
            # -- the routed migration --------------------------------------
            # blocks of the byte-checked body D holds already (its own, from
            # the fallback rounds: the template's opening): not ingested
            gen = state_d.sched.gen
            toks = ids[id(moved[-1])][:-1]
            local = len(gen.pool.match_prefix(toks)[0])
            t0 = mig_totals()
            routed = []
            for b in moved:
                out = _complete(url_r, b, "kvmigrate routed")
                routed.append(out["timing"].get("kvmigrate_ms", 0.0))
            d = {k: v - t0[k] for k, v in mig_totals().items()}
            rec["routed"] = dict(counts=d, kvmigrate_ms=routed)
            if d["migrated"] != len(moved) or d["fallback"] or min(routed) <= 0:
                fail(f"kvmigrate routed: {d}, kvmigrate_ms {routed}")
            rec["d_launches"] = read_counts()
            fleet = _get_json(url_r + "/debug/fleet")[1]
            phases = {s["phase"] for s in fleet["spans"]}
            roles = {r["replica"]: r.get("role") for r in fleet["replicas"]}
            rz = _get_json(url_p + "/readyz")[1]
            disp_p = _metric(get_text(url_r + "/metrics"),
                             f'dllama_router_dispatch_total{{replica="{name_p}"}}')
            rec.update(roles=roles, p_kv_prefixes=len(rz.get("kv_prefixes", [])),
                       router_dispatch_p=disp_p,
                       spans={k: sum(s["phase"] == k for s in fleet["spans"])
                              for k in ("rt_prefill", "rt_kv_donor")})
            if (roles.get(name_p) != "prefill" or not rz.get("kv_prefixes") or disp_p
                    or not {"rt_prefill", "rt_kv_donor"} <= phases):
                fail(f"kvmigrate fleet view: roles {roles}, P's kv_prefixes "
                     f"{rz.get('kv_prefixes')}, P dispatched {disp_p}, spans {phases}")
            # -- the bytes: P's export of the last body against D's blocks --
            req = urllib.request.Request(url_p + "/v1/kv/export",
                                         data=json.dumps({"tokens": toks}).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                hdr, blocks = kvwire.read_stream(r, gen.wire_geometry())
            shared = gen.pool.match_prefix(toks)[0]
            dtype = gen.pkv.k.dtype
            same = [all(torch.equal(cache_bits(plane)[:, bid].cpu(),
                                    cache_bits(torch.from_numpy(x).to(dtype)))
                        for plane, x in zip(gen.pkv, (k, v)))
                    for (_, k, v), bid in list(zip(blocks, shared))[local:]]
            rec["bytes"] = dict(exported_blocks=hdr["n_blocks"], matched=len(shared),
                                held_before=local, ingested_equal=sum(same))
            # the gather + readback each export cost P's loop thread (its
            # flight ring's kv_export events): the stall bystanders see
            rec["export_ms"] = [e["ms"] for e in _get_json(url_p + "/debug/flight")[1]["events"]
                                if e["event"] == "kv_export"]
            if (len(shared) < hdr["n_blocks"] or len(same) != hdr["n_blocks"] - local
                    or not same or not all(same)):
                fail(f"kvmigrate bytes: {sum(same)} of {hdr['n_blocks'] - local} ingested "
                     f"blocks equal P's export ({len(shared)} matched, {local} held before)")
    finally:
        failpoints.registry().clear()
        if router is not None:
            router.stop("kvmigrate router")
        rec["p_rc"] = p.stop("kvmigrate replica P")
    # -- the answers: drift of the migrated prefixes -------------------------
    answers = []
    for b in moved:
        key = tuple(ids[id(b)])
        got, want = dd.get(key), d0[key]
        if got is None:
            fail("kvmigrate: D recorded no step of a migrated body")
        scale = float(np.abs(want["logits"][0]).max())
        drift = float(np.abs(got["logits"][0] - want["logits"][0]).max())
        i = next((j for j, (a, c) in enumerate(zip(got["tokens"], want["tokens"])) if a != c),
                 None)
        margin = None
        if i is not None:
            top2 = np.sort(np.asarray(want["logits"][i], np.float64))[-2:]
            margin = float(top2[1] - top2[0])
        answers.append(dict(drift=drift, bound=0.15 * scale, equal=i is None, depart_at=i,
                            d0_top2_margin=margin))
        if drift >= 0.15 * scale:
            fail(f"kvmigrate: first-token drift {drift:.4g} >= 0.15 max|logit| "
                 f"({0.15 * scale:.4g})")
        if i is not None and not margin < drift:
            fail(f"kvmigrate: a migrated transcript departs at token {i}, where D0's top-2 "
                 f"margin {margin:.4g} is not below the first-token drift {drift:.4g}")
    rec["answers"] = answers
    summary["f32"]["launches"]["kvmigrate_D0"] = rec["d0_launches"]
    summary["f32"]["launches"]["kvmigrate_D"] = rec["d_launches"]
    for who in ("d0_launches", "d_launches"):
        if min(rec[who][k] for k in ("K1", "K2", "K3", "K4")) <= 0:
            fail(f"kvmigrate: a kernel of {who[:-9]}'s path never launched: {rec[who]}")
    print(f"   kvmigrate: {len(moved)} migrated, kvmigrate ms {routed}, export ms on P's loop "
          f"thread {rec.get('export_ms')}, first-token drift "
          f"max {max(a['drift'] for a in answers):.4g} (bound "
          f"{min(a['bound'] for a in answers):.4g}), {sum(a['equal'] for a in answers)} of "
          f"{len(moved)} transcripts equal to D0's", flush=True)
    print(json.dumps(rec), flush=True)
    summary["kvmigrate"] = rec


# ---------------------------------------------------------------------------
# slice 15: mixture of experts (Qwen3-30B-A3B) and turbo planes, kernel K5
# ---------------------------------------------------------------------------

# Qwen3-30B-A3B (Qwen/Qwen3-30B-A3B config.json): hidden_size 2048,
# moe_intermediate_size 768, 128 experts, 8 a token, norm_topk_prob true,
# 32 / 4 heads of 128, vocab 151936, rope theta 1e6, rms eps 1e-6,
# max_position_embeddings 40960. Width is never cut; depth 48 -> 8.
MOE_DIM, MOE_HIDDEN, MOE_EXPERTS, MOE_ACTIVE = 2048, 768, 128, 8
MOE_HEADS, MOE_KV_HEADS, MOE_VOCAB = 32, 4, 151936
MOE_ASSETS = ("qwen3_30b_a3b.m", "tok_151936.t")
MOE_SHAPES = [("we1", MOE_DIM, MOE_HIDDEN), ("we3", MOE_DIM, MOE_HIDDEN),
              ("we2", MOE_HIDDEN, MOE_DIM)]  # (name, K, N): one layer's expert dots
# tokens of a K5 case: one decode token, the paged step's 8 slots, a
# 128-token prefill chunk (8 rows a token)
MOE_TOKENS = [("decode", 1), ("paged step", SLOTS), ("128-token chunk", 128),
              ("256-token prompt", 256)]
# a skewed routing of a 128-token chunk: one expert holds MOE_SKEW_TOP of its
# 1024 rows, MOE_SKEW_USED - 1 others share the rest, the other 100 are empty
MOE_SKEW_TOP, MOE_SKEW_USED = 512, 28
# the serving mix cut to 8 requests (the identical greedy pair last)
MOE_PICKS = (0, 1, 2, 3, 4, 5, 14, 15)
# the routing near-tie rule (RouteRecorder.hold): two transcripts of one
# prompt may part only after their routers chose other experts at some
# (position, layer), and in f32 the first such choice must lie at a k-th /
# (k+1)-th router probability gap within this many f32 ulps on one side
ROUTER_TIE_ULPS = 4
# turbo: the 8B wq and w1 at these rows; JAX's drift bounds (tests/test_turbo.py:
# a matmul within 8e-2 (a8) / 5e-2 (a16) of the exact product's RMS;
# tests/test_moe.py: the model's logits within 0.15 of their RMS)
TURBO_SHAPES = [("wq", DIM, HEADS * HEAD_DIM), ("w1", DIM, HIDDEN)]
TURBO_M = (1, 8, 128, 256)
TURBO_MATMUL_DRIFT = {"a8": 8e-2, "a16": 5e-2}
TURBO_MODEL_DRIFT = 0.15
TURBO_STEPS = 32


def write_moe_model(path: str, n_layers: int) -> None:
    """Synthetic Qwen3-30B-A3B-shaped Q40 MoE file, with the header the JAX
    converter writes for ``qwen3_moe`` (``dllama_tpu/convert/hf.py``): arch
    QWEN3 (neox rope), ``moe_intermediate_size`` as ``hidden_dim``,
    ``moe_norm_topk`` from ``norm_topk_prob``. Random Q40 blocks (codes -7..7,
    f16 scales ~0.004) and f32 norms, embedding and router (std 0.02), drawn
    on the card from a seeded generator, the Q40 blocks' bytes assembled
    there; a layer's 384 expert tensors, which have one size each, are one
    draw."""
    from dllama_tpu_torch.formats.mfile import ArchType, HiddenAct, write_header
    from dllama_tpu_torch.formats.quants import Q40

    g = torch.Generator(device=DEV).manual_seed(SEED + 30)

    def f32(n_rows: int, n_cols: int, base: float, scale: float, f) -> None:
        for lo in range(0, n_rows, 8192):
            rows = min(8192, n_rows - lo)
            x = torch.randn((rows, n_cols), generator=g, device=DEV) * scale + base
            f.write(x.cpu().numpy().data)

    def q40(n_weights: int, f) -> None:
        nb = n_weights // 32
        for lo in range(0, nb, 1 << 22):
            n = min(1 << 22, nb - lo)
            # a block: its f16 scale's 2 bytes, then 16 bytes of nibbles 1..15
            scales = (torch.rand(n, generator=g, device=DEV) * 0.004 + 0.002).half()
            lo4, hi4 = (torch.randint(1, 16, (n, 16), generator=g, device=DEV,
                                      dtype=torch.uint8) for _ in range(2))
            blocks = torch.cat([scales.view(torch.uint8).reshape(n, 2), lo4 | (hi4 << 4)], 1)
            f.write(blocks.cpu().numpy().data)

    header = dict(version=0, arch_type=int(ArchType.QWEN3), hidden_act=int(HiddenAct.SILU),
                  dim=MOE_DIM, hidden_dim=MOE_HIDDEN, n_layers=n_layers, n_heads=MOE_HEADS,
                  n_kv_heads=MOE_KV_HEADS, weight_float_type=Q40, seq_len=40960,
                  vocab_size=MOE_VOCAB, n_experts=MOE_EXPERTS, n_active_experts=MOE_ACTIVE,
                  moe_norm_topk=1, rope_theta=1000000, head_dim=HEAD_DIM, norm_epsilon=6)
    q_dim, kv_dim = MOE_HEADS * HEAD_DIM, MOE_KV_HEADS * HEAD_DIM
    with open(path, "wb") as f:
        write_header(f, header)
        f32(MOE_VOCAB, MOE_DIM, 0.0, 1.0, f)  # embedding
        for _ in range(n_layers):
            for out_dim, in_dim in ((q_dim, MOE_DIM), (kv_dim, MOE_DIM), (kv_dim, MOE_DIM),
                                    (MOE_DIM, q_dim)):
                q40(out_dim * in_dim, f)
            f32(MOE_EXPERTS, MOE_DIM, 0.0, 0.02, f)  # block_moe_gate
            q40(3 * MOE_EXPERTS * MOE_DIM * MOE_HIDDEN, f)  # w3, w1, w2 of each expert
            f32(1, HEAD_DIM, 1.0, 0.02, f)  # block_norm_q
            f32(1, HEAD_DIM, 1.0, 0.02, f)  # block_norm_k
            f32(1, MOE_DIM, 1.0, 0.02, f)   # block_norm_0
            f32(1, MOE_DIM, 1.0, 0.02, f)   # block_norm_1
        f32(1, MOE_DIM, 1.0, 0.02, f)       # final_norm
        q40(MOE_VOCAB * MOE_DIM, f)         # final_matmul_logits


def write_moe_assets(tmp: str, n_layers: int) -> tuple[str, str]:
    model, tok = (os.path.join(tmp, n) for n in MOE_ASSETS)
    t0 = time.perf_counter()
    # Qwen3's layout: 151643 regular pieces, <|endoftext|> and the specials after
    write_tokenizer(tok, vocab_size=MOE_VOCAB, n_regular=151643)
    write_moe_model(model, n_layers)
    print(f"📝 synthetic Qwen3-30B-A3B model: {os.path.getsize(model) / 1e9:.2f} GB, "
          f"{n_layers} layers, written in {time.perf_counter() - t0:.1f} s", flush=True)
    return model, tok


def routed_offsets(n_tokens: int, g: torch.Generator) -> tuple[torch.Tensor, int]:
    """A top-8-of-128 routing of ``n_tokens`` tokens (distinct experts a
    token, random): the group offsets of its rows sorted by expert, and the
    number of experts it uses."""
    scores = torch.rand((n_tokens, MOE_EXPERTS), generator=g, device=DEV)
    flat = scores.argsort(dim=1)[:, :MOE_ACTIVE].reshape(-1)
    counts = torch.bincount(flat, minlength=MOE_EXPERTS)
    offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)
    return offsets, int((counts > 0).sum())


def random_expert_planes(K: int, N: int, fast: bool, g: torch.Generator):
    """An expert stack of Q40 planes ``[128, K, N]`` (codes -8..7)."""
    from dllama_tpu_torch.ops.linear import QuantizedWeight

    codes = torch.randint(-8, 8, (MOE_EXPERTS, K, N), generator=g, device=DEV,
                          dtype=torch.int8)
    scales = torch.rand((MOE_EXPERTS, K // 32, N), generator=g, device=DEV) * 0.01 + 0.002
    return QuantizedWeight(scales=scales.to(torch.bfloat16 if fast else torch.float32),
                           codes=codes)


def k5_case(timer: Timer, results: list, *, what: str, mode: str, decoder: str, fast: bool,
            x, we, offsets, used: int, library=None, library_note: str | None = None,
            bit_exact: bool = False, **fields) -> dict:
    """One K5 case: the kernel against its plain version on the same
    inputs (``TOL[mode]`` of max|plain|, or bit for bit) and, on the
    tensor-core kernel, against its twin ``moe_matmul_tc_plain``
    (:data:`TC_TWIN_TOL` of max|twin|, a8 bit for bit), timed with the plain
    version and ``library`` (one PyTorch call, or None); its bound counts the
    planes of the ``used`` groups that hold rows. Rows past the last group
    (an ep shard's rows routed to another shard's experts) are not written
    by K5 and are neither compared nor counted in the bound."""
    from dllama_tpu_torch.ops import moe_matmul as mm

    got = mm.moe_matmul(x, we, offsets, decoder=decoder, fast=fast)
    # the K split and the kernel this launch took
    splits, path = mm.moe_matmul.last_splits, mm.moe_matmul.last_kernel
    want = mm.moe_matmul_plain(x, we, offsets, decoder=decoder, fast=fast)
    twin = (mm.moe_matmul_tc_plain(x, we, offsets, decoder=decoder, fast=fast)
            if path == "tc" else None)
    written = x.shape[0] if offsets is None else int(offsets[-1])
    got, want = got[:written], want[:written]
    twin = None if twin is None else twin[:written]
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    equal = bool(torch.equal(got, want))
    twin_err = twin_scale = None
    if twin is not None:
        twin_err = (got - twin).abs().max().item()
        twin_scale = twin.abs().max().item()
        twin_equal = bool(torch.equal(got, twin))
        del twin
    ms = timer(lambda: mm.moe_matmul(x, we, offsets, decoder=decoder, fast=fast))
    n = timer.n
    timer.n = 5  # the plain version loops over groups on the host
    plain_ms = timer(lambda: mm.moe_matmul_plain(x, we, offsets, decoder=decoder, fast=fast))
    timer.n = n
    lib_ms = timer(library) if library is not None else None
    _, K, N = mm._planes(we, decoder)
    b_ms, b_by = bound("K5", R=written, K=K, N=N, used=used, decoder=decoder, fast=fast,
                       plane_elt=we.element_size() if decoder == "dense" else 4)
    rec = dict(case="moe_matmul", kernel="K5", mode=mode, decoder=decoder, what=what,
               rows=x.shape[0], rows_written=written, K=K, N=N, max_abs_err=err,
               max_abs_ref=scale,
               bit_equal=equal, twin_err=twin_err, twin_ref=twin_scale, path=path,
               splits=splits, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               library_note=library_note if library is not None else None,
               bound_ms=b_ms, bound_by=b_by, **fields)
    print(json.dumps(rec), flush=True)
    results.append(rec)
    if bit_exact and not equal:
        fail(f"K5 {what}: {decoder} differs from its plain version (max|err| {err:.3g}); "
             f"the integer dot must equal it bit for bit")
    if not (err <= TOL[mode] * scale) or not math.isfinite(err):
        fail(f"K5 {what}: max|err| {err:.3g} > {TOL[mode]} x max|y| {scale:.3g}")
    if twin_err is not None:
        if bit_exact and not twin_equal:
            fail(f"K5 {what}: {decoder} differs from its tensor-core twin (max|err| "
                 f"{twin_err:.3g})")
        if not (twin_err <= TC_TWIN_TOL * twin_scale) or not math.isfinite(twin_err):
            fail(f"K5 {what}: max|err| {twin_err:.3g} against the tensor-core twin > "
                 f"{TC_TWIN_TOL} x max|y| {twin_scale:.3g}")
    return rec


def int_mm_library(xq: torch.Tensor, w8: torch.Tensor):
    """``torch._int_mm`` over the same int8 operands (rows padded to what it
    takes: more than 16, a multiple of 8): a8's library yardstick."""
    M = xq.shape[0]
    pad = max(32, -(-M // 8) * 8)
    xp = torch.zeros((pad, xq.shape[1]), dtype=torch.int8, device=DEV)
    xp[:M] = xq
    return lambda: torch._int_mm(xp, w8)


# the grouped yardstick reads 2 bytes a weight and rounds otherwise: not the
# same function as the case it stands beside
GROUPED_MM_NOTE = "torch._grouped_mm over bf16 planes made beforehand (a yardstick)"


def grouped_mm_library(x: torch.Tensor, planes_bf16: torch.Tensor, offsets: torch.Tensor):
    """``torch._grouped_mm`` of the bf16 activations over bf16 expert planes
    made beforehand (None where this PyTorch has none)."""
    if not hasattr(torch, "_grouped_mm"):
        return None
    xb = x.to(torch.bfloat16)
    return lambda: torch._grouped_mm(xb, planes_bf16, offs=offsets[1:])


def skewed_offsets(g: torch.Generator) -> torch.Tensor:
    """A skewed routing of a 128-token chunk (1024 rows): one random expert
    holds :data:`MOE_SKEW_TOP` rows, :data:`MOE_SKEW_USED` - 1 others share
    the rest as evenly as whole rows allow, the other experts are empty."""
    rows = 128 * MOE_ACTIVE
    perm = torch.randperm(MOE_EXPERTS, generator=g, device=DEV)
    n_rest = MOE_SKEW_USED - 1
    rest = torch.full((n_rest,), (rows - MOE_SKEW_TOP) // n_rest, dtype=torch.int64,
                      device=DEV)
    rest[:(rows - MOE_SKEW_TOP) % n_rest] += 1
    counts = torch.zeros(MOE_EXPERTS, dtype=torch.int64, device=DEV)
    counts[perm[0]] = MOE_SKEW_TOP
    counts[perm[1:MOE_SKEW_USED]] = rest
    return torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)


def moe_cases(timer: Timer, results: list) -> None:
    """K5 against its plain version (and, on the tensor cores, its twin) in
    every decoder and regime: the Qwen3-30B-A3B expert dots (w1/w3: K 2048,
    N 768; w2: K 768, N 2048; 128 experts) at 8 (one decode token), 64 (the
    paged step), 1024 (a 128-token chunk) and 2048 rows (a 256-token
    prompt) on Q40 planes, exact and fast, and w1 and w2 under a skewed
    routing (one expert holding 512 of 1024 rows, 100 experts empty); turbo
    expert planes in the gather regime (a8, a16 at 8 rows) and the ragged
    regime (pre-scaled at 64 and 1024 rows); dense expert planes
    (``--weight-mode f32|bf16``) at 64 rows; then the dense turbo linear (one
    group) on the 8B wq and w1 at M = 1, 8, 128 and 256, a8 bit for bit
    against its plain version, its drift from the exact product held to the
    JAX package's bounds, and the derived planes against the same derivation
    on the host, bit for bit."""
    from dllama_tpu_torch.ops import turbo
    from dllama_tpu_torch.ops.linear import dequantize_weight

    g = torch.Generator(device=DEV).manual_seed(SEED + 15)
    for mode in ("exact", "fast"):
        fast = mode == "fast"
        for name, K, N in MOE_SHAPES:
            we = random_expert_planes(K, N, fast, g)
            dq = dequantize_weight(we, torch.bfloat16)  # the grouped yardstick's planes
            routings = [(f"{name} {label} {mode}", routed_offsets(n_tok, g), n_tok, {})
                        for label, n_tok in MOE_TOKENS]
            if name in ("we1", "we2"):
                routings.append((f"{name} skewed {mode}",
                                 (skewed_offsets(g), MOE_SKEW_USED), 128,
                                 {"routing": "skewed"}))
            for what, (offsets, used), n_tok, extra in routings:
                R = n_tok * MOE_ACTIVE
                x = torch.randn((R, K), generator=g, device=DEV).to(
                    torch.bfloat16 if fast else torch.float32)
                # exact on the tensor cores is three bf16 products (x in
                # three parts), as K2's tensor-core path counts it
                k5_case(timer, results, what=what, mode=mode, decoder="q", fast=fast, x=x,
                        we=we, offsets=offsets, used=used,
                        library=grouped_mm_library(x, dq, offsets),
                        library_note=GROUPED_MM_NOTE, weight=name, tokens=n_tok,
                        experts_used=used, **extra)
            del dq
            if name == "we1":
                tw = {a8: turbo.derive_turbo(we, a8=a8) for a8 in (True, False)}
                pre = (tw[False].w8.to(torch.bfloat16)
                       * tw[False].scale.to(torch.bfloat16)[:, None, :])
                for decoder, n_tok in (("a8", 1), ("a16", 1), ("prescaled", SLOTS),
                                       ("prescaled", 128)):
                    if fast != (decoder != "a8"):
                        continue  # a8 once (under "exact": its sums are integers)
                    offsets, used = routed_offsets(n_tok, g)
                    R = n_tok * MOE_ACTIVE
                    x = torch.randn((R, K), generator=g, device=DEV)
                    w = tw[decoder == "a8"]
                    k5_case(timer, results, what=f"turbo {decoder} {name} rows={R}",
                            mode=mode, decoder=decoder, fast=False, x=x, we=w,
                            offsets=offsets, used=used,
                            library=(grouped_mm_library(x, pre, offsets)
                                     if decoder == "prescaled" else None),
                            library_note=GROUPED_MM_NOTE, bit_exact=decoder == "a8",
                            weight=name, tokens=n_tok, experts_used=used)
                del tw, pre
                # dense expert stacks (--weight-mode f32 | bf16) at the paged step
                dt = torch.bfloat16 if fast else torch.float32
                dense = dequantize_weight(we, torch.float32).to(dt)
                offsets, used = routed_offsets(SLOTS, g)
                R = SLOTS * MOE_ACTIVE
                x = torch.randn((R, K), generator=g, device=DEV).to(dt)
                k5_case(timer, results, what=f"dense {name} rows={R} {mode}", mode=mode,
                        decoder="dense", fast=False, x=x, we=dense, offsets=offsets, used=used,
                        library=grouped_mm_library(x, dense, offsets) if fast else None,
                        library_note="torch._grouped_mm over the same bf16 planes",
                        weight=name, tokens=SLOTS, experts_used=used)
                del dense
            del we
            torch.cuda.empty_cache()
    # the dense turbo linear: one group
    for name, K, N in TURBO_SHAPES:
        qw = random_planes(K, N, True, g)
        exact_w = dequantize_weight(qw, torch.float32)
        for a8 in (True, False):
            tw = turbo.derive_turbo(qw, a8=a8)
            tw1 = turbo.TurboWeight(tw.w8[None], tw.scale[None], a8)
            if name == "wq":  # the card's derivation against the host's, bit for bit
                host = turbo.derive_turbo(qw._replace(scales=qw.scales.cpu(),
                                                      codes=qw.codes.cpu()), a8=a8)
                if not (torch.equal(host.w8, tw.w8.cpu())
                        and torch.equal(host.scale, tw.scale.cpu())):
                    fail(f"turbo derivation of {name}: the card's planes differ from the "
                         f"host's")
            dec = "a8" if a8 else "a16"
            w16 = None if a8 else tw.w8.to(torch.bfloat16)  # the a16 yardstick's upcast
            for M in TURBO_M:
                x = torch.randn((M, K), generator=g, device=DEV).to(torch.bfloat16)
                y = turbo.turbo_matmul(x, tw).float()
                ref = x.float() @ exact_w
                drift = ((y - ref).abs().max() / ref.pow(2).mean().sqrt()).item()
                del y, ref
                if a8:
                    xq, _ = turbo.quantize_activations_a8(x)
                    lib, note = int_mm_library(xq, tw.w8), "torch._int_mm, M padded to 32"
                else:
                    lib = lambda x=x: torch.matmul(x, w16)  # noqa: E731
                    note = "torch.matmul over the codes upcast to bf16 beforehand"
                k5_case(timer, results, what=f"turbo {dec} {name} M={M}",
                        mode="exact" if a8 else "fast", decoder=dec, fast=False, x=x,
                        we=tw1, offsets=None, used=1, library=lib, library_note=note,
                        bit_exact=a8, weight=name, M=M,
                        drift_vs_exact=drift, drift_bound=TURBO_MATMUL_DRIFT[dec])
                if not drift < TURBO_MATMUL_DRIFT[dec]:
                    fail(f"turbo {dec} {name} M={M}: drift {drift:.3g} from the exact "
                         f"product >= {TURBO_MATMUL_DRIFT[dec]} of its RMS")
            del tw, tw1, w16
        del qw, exact_w
    torch.cuda.empty_cache()


@contextlib.contextmanager
def engine_spy(on_close=None):
    """Watch every ``InferenceEngine`` a CLI run builds: its load seconds
    (``load_s``: the load and any turbo derivation), the last logits of each
    prefill (the logits the first decode token derives from), and
    ``on_close(engine)`` run before each close, while the weights are there."""
    from dllama_tpu_torch.runtime.engine import InferenceEngine as IE

    box: dict = {"load_s": [], "logits": []}
    init, prefill, close = IE.__init__, IE.prefill, IE.close

    def init_spied(self, *a, **kw):
        init(self, *a, **kw)
        box["load_s"].append(self.load_s)

    def prefill_spied(self, ids):
        last, metrics = prefill(self, ids)
        box["logits"].append(np.asarray(last, dtype=np.float32).copy())
        return last, metrics

    def close_spied(self):
        if on_close is not None and self.params is not None:
            on_close(self)
        close(self)

    IE.__init__, IE.prefill, IE.close = init_spied, prefill_spied, close_spied
    try:
        yield box
    finally:
        IE.__init__, IE.prefill, IE.close = init, prefill, close


def k5_hold(eng, what: str) -> dict:
    """K5 against its plain version per call, on the real inputs of eager
    forwards of ``eng``'s model: a 128-token chunk (1024 rows: the ragged
    regime), one decode token (8 rows: the gather regime) and one token of
    8 sequences (64 rows, the paged step's width: ragged). Every call's
    output is held to ``TOL`` of its plain version's max (a8: bit for bit).
    These launches are checks, so every counter is put back."""
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.ops import moe_matmul as mm
    from dllama_tpu_torch.runtime.kvcache import KVCache

    real, calls = llama.moe_matmul, []
    counts = {fn: fn.launches for fn in _wrappers().values()}

    def recorded(x, we, offsets, *, decoder, fast=False):
        y = real(x, we, offsets, decoder=decoder, fast=fast)
        calls.append((x, we, offsets, decoder, fast, y))
        return y

    cfg = eng.cfg
    g = torch.Generator(device=DEV).manual_seed(SEED + 5)
    llama.moe_matmul = recorded
    try:
        kv = KVCache.create(cfg, dtype=eng.kv_dtype, device=eng.device)
        toks = torch.randint(0, cfg.vocab_size, (1, 129), generator=g, device=DEV)
        llama.forward(eng.params, cfg, toks[:, :128], 0, kv)
        llama.forward(eng.params, cfg, toks[:, 128:], 128, kv)
        del kv
        kv8 = KVCache.create(cfg, batch_size=SLOTS, dtype=eng.kv_dtype, device=eng.device)
        pos = torch.randint(0, MAX_SEQ - 1, (SLOTS,), generator=g, device=DEV)
        llama.forward(eng.params, cfg, toks[:, :SLOTS].reshape(SLOTS, 1), pos, kv8)
        del kv8
    finally:
        llama.moe_matmul = real
    for fn, n in counts.items():
        fn.launches = n
    worst, by_decoder = 0.0, collections.Counter()
    for x, we, offsets, decoder, fast, y in calls:
        want = mm.moe_matmul_plain(x, we, offsets, decoder=decoder, fast=fast)
        mode = "fast" if (fast or decoder in ("a16", "prescaled")
                          or x.dtype == torch.bfloat16) else "exact"
        err, scale = (y - want).abs().max().item(), want.abs().max().item()
        by_decoder[f"{decoder}:{x.shape[0]}"] += 1
        worst = max(worst, err / max(scale, 1e-30))
        if decoder == "a8" and not torch.equal(y, want):
            fail(f"K5 hold {what}: an a8 call differs from its plain version")
        if not err <= TOL[mode] * scale:
            fail(f"K5 hold {what}: a {decoder} call of {x.shape[0]} rows: max|err| "
                 f"{err:.3g} > {TOL[mode]} x max|y| {scale:.3g}")
    rec = dict(case="k5_hold", what=what, calls=len(calls), by_decoder_rows=dict(by_decoder),
               worst_rel_err=worst)
    print(json.dumps(rec), flush=True)
    if not calls:
        fail(f"K5 hold {what}: the forwards made no K5 call")
    return rec


class RouteRecorder:
    """The router's choice at every position the requests of one api run
    pass through, in the server's own arithmetic: each MoE layer's top k + 1
    sorted probabilities and top-k experts, from the eager prefill chunks
    (``_exec_prefill``) and from the captured paged step (the sort outputs
    its capture allocated, read after each replay while :attr:`on`: the
    graph gains no kernel). It also tracks which request's prefill wrote
    each row of every block (commits and copy-on-write copies) and each
    request's block table, so a request's history is the routing of the
    prefills whose KV it reads. Enter :meth:`installed` before the server
    starts, so the step is captured through it, and pass :meth:`attach` as
    ``serve_run(on_gen=...)``."""

    def __init__(self, n_layers: int, k: int):
        self.L, self.k, self.on = n_layers, k, True
        self.ctx = None        # (rid, first position, valid rows) of an eager prefill chunk
        self.layer = 0
        self.bs = 0
        self.captured: list = []   # (probs, idx) of every captured router call
        self.static: list = []     # the server's step graph's, one a layer
        self.prefill: list = []    # (rid, layer, first position, probs, idx)
        self.steps: list = []      # ([(slot, rid, position)], probs [L, S, k+1], idx [L, S, k])
        self.producer: dict = {}   # block -> the rid whose prefill wrote each of its rows
        self.tables: dict = {}     # rid -> its block table at its first decode step

    @contextlib.contextmanager
    def installed(self):
        from dllama_tpu_torch.models import llama

        real = llama._router_sorted

        def recorded(h, gate):
            top, idx = real(h, gate)
            if torch.cuda.is_current_stream_capturing():
                self.captured.append((top, idx))
            elif self.ctx is not None:
                rid, pos0, n = self.ctx
                self.prefill.append((rid, self.layer, pos0, top[0, :n, :self.k + 1].clone(),
                                     idx[0, :n, :self.k].clone()))
                self.layer += 1
            return top, idx

        llama._router_sorted = recorded
        try:
            yield self
        finally:
            llama._router_sorted = real

    def attach(self, gen) -> None:
        self.static = [(t, x) for t, x in self.captured
                       if tuple(t.shape[:2]) == (gen.n_slots, 1)][-self.L:]
        if len(self.static) != self.L:
            fail(f"route record: {len(self.static)} captured router calls of the paged step "
                 f"(want {self.L})")
        self.bs = gen.block_size
        exec_prefill, commit, copy_block = gen._exec_prefill, gen.continue_admit, gen._copy_block
        graph = gen.step_graph()
        replay = graph.replay

        def prefill_recorded(adm, padded):
            n = min(len(padded), len(adm.req.prompt_ids) - 1 - adm.pos)
            self.ctx, self.layer = ((adm.req.rid, adm.pos, n) if self.on else None), 0
            try:
                exec_prefill(adm, padded)
            finally:
                self.ctx = None

        def commit_recorded(adm):
            done = commit(adm)
            if done and not adm.req.score:
                bids = gen._seq_bids[adm.slot]
                for p in range(adm.reused, len(adm.req.prompt_ids) - 1):
                    self.producer.setdefault(bids[p // self.bs],
                                             [None] * self.bs)[p % self.bs] = adm.req.rid
            return done

        def copy_recorded(src, dst):
            copy_block(src, dst)
            self.producer[dst] = list(self.producer.get(src, [None] * self.bs))

        def replay_recorded():
            live = [(i, s.rid, int(gen.pos[i])) for i, s in enumerate(gen.slots)
                    if s is not None]
            replay()
            if self.on:
                for i, rid, _ in live:
                    if rid not in self.tables:
                        self.tables[rid] = gen.tables[i].copy()
                self.steps.append((live, torch.stack([t[:, 0, :self.k + 1]
                                                      for t, _ in self.static]),
                                   torch.stack([x[:, 0, :self.k] for _, x in self.static])))

        gen._exec_prefill, gen.continue_admit = prefill_recorded, commit_recorded
        gen._copy_block, graph.replay = copy_recorded, replay_recorded

    def _producers(self, req) -> list:
        """The rid whose prefill wrote the KV row ``req`` reads at each
        prompt position (None: unknown)."""
        table = self.tables.get(req.rid)
        n = len(req.prompt_ids) - 1
        if table is None:
            return [None] * n
        return [self.producer.get(int(table[p // self.bs]), [None] * self.bs)[p % self.bs]
                for p in range(n)]

    def _rows(self, rids) -> dict:
        """``{rid: {position: {layer: (probs [k+1], experts [k])}}}``."""
        rows: dict = {rid: {} for rid in rids}
        for rid, layer, pos0, top, idx in self.prefill:
            if rid in rows:
                for j, (v, x) in enumerate(zip(top.cpu().numpy(), idx.cpu().numpy())):
                    rows[rid].setdefault(pos0 + j, {})[layer] = (v, x)
        for live, top, idx in self.steps:
            if any(rid in rows for _, rid, _ in live):
                top, idx = top.cpu().numpy(), idx.cpu().numpy()
                for i, rid, pos in live:
                    if rid in rows:
                        for layer in range(self.L):
                            rows[rid].setdefault(pos, {})[layer] = (top[layer, i],
                                                                    idx[layer, i])
        return rows

    def _history(self, req, producers: list, rows: dict) -> dict:
        """``{position: {layer: (probs, experts)}}`` behind ``req``'s
        tokens: the prompt positions from the prefills that wrote the KV it
        reads, the rest from its own decode steps."""
        hist = {p: rows[r][p] for p, r in enumerate(producers)
                if r is not None and p in rows[r]}
        hist.update({p: v for p, v in rows[req.rid].items() if p >= len(producers)})
        return hist

    def gap_ulps(self, v) -> float:
        """The k-th / (k+1)-th probability gap in f32 ulps of the k-th."""
        return float((v[self.k - 1] - v[self.k]) / np.spacing(np.float32(v[self.k - 1])))

    def hold(self, a, b, dtype: str, what: str, tie_rule: bool) -> dict:
        """Requests ``a`` and ``b`` of one prompt, held on their histories
        (:meth:`_history`): where both read KV of the same prefills and
        decode, they must route alike with equal probabilities (the step is
        batch-invariant); their tokens may part only after the first
        (position, layer) where their histories chose other experts, and,
        with ``tie_rule`` in f32, only where that choice lay within
        :data:`ROUTER_TIE_ULPS` of a tie on one side. Every position up to
        the one that gave the parting token is compared. (Without f32 sync
        buffers the rule cannot hold: two prefills of one prefix in other
        chunk widths differ in last ulps, which flip whole Q80 codes at the
        sync points, far from any tie.)"""
        pa, pb = self._producers(a), self._producers(b)
        rows = self._rows({a.rid, b.rid} | {r for r in pa + pb if r is not None})
        ha, hb = self._history(a, pa, rows), self._history(b, pb, rows)
        ta, tb = list(a.tokens), list(b.tokens)
        part = next((j for j, (u, w) in enumerate(zip(ta, tb)) if u != w), None)
        n_prompt = len(a.prompt_ids)
        last = n_prompt - 1 + (part if part is not None else min(len(ta), len(tb)) - 1)
        first, first_value, n_diff, compared, gaps = None, None, 0, 0, []
        for p in sorted(set(ha) & set(hb)):
            if p > last:
                break
            for layer in range(self.L):
                ra, rb = ha[p].get(layer), hb[p].get(layer)
                if ra is None or rb is None:
                    continue
                compared += 1
                gaps.append(self.gap_ulps(ra[0]))
                if first_value is None and not np.array_equal(ra[0], rb[0]):
                    d = np.abs(ra[0].astype(np.float64) - rb[0])
                    first_value = dict(
                        pos=p, layer=layer,
                        region="prompt" if p < n_prompt - 1 else "decode",
                        producers=[pa[p], pb[p]] if p < n_prompt - 1 else None,
                        max_diff_ulps=float(np.max(d / np.spacing(np.maximum(ra[0], rb[0])))))
                if set(ra[1].tolist()) != set(rb[1].tolist()):
                    n_diff += 1
                    if first is None:
                        first = dict(pos=p, layer=layer,
                                     gap_ulps=[self.gap_ulps(ra[0]), self.gap_ulps(rb[0])],
                                     experts_only_a=sorted(set(ra[1].tolist())
                                                           - set(rb[1].tolist())),
                                     experts_only_b=sorted(set(rb[1].tolist())
                                                           - set(ra[1].tolist())))
        rec = dict(case="route_hold", what=what, compute_dtype=dtype, prompt_tokens=n_prompt,
                   tokens=[len(ta), len(tb)], parted_at=part, last_position=last,
                   positions=[len(ha), len(hb)],
                   prompt_rows_of_other_prefills=sum(x != y for x, y in zip(pa, pb)),
                   unknown_producers=[pa.count(None), pb.count(None)],
                   layer_rows_compared=compared, route_differences=n_diff,
                   first_value_difference=first_value, first_difference=first,
                   gap_ulps_min=min(gaps) if gaps else None,
                   gap_ulps_median=statistics.median(gaps) if gaps else None,
                   sites_within_rule=sum(g <= ROUTER_TIE_ULPS for g in gaps),
                   rule_ulps=ROUTER_TIE_ULPS if tie_rule and dtype == "f32" else None)
        print(json.dumps(rec), flush=True)
        if not compared or pa.count(None) or pb.count(None):
            fail(f"{what}: the route record does not cover both requests' histories")
        if first_value is not None and first_value["region"] == "decode":
            # every prompt position routed alike with equal probabilities
            fail(f"{what}: the pair read KV of the same prefills, yet the step computed other "
                 f"router probabilities for them at position {first_value['pos']}, layer "
                 f"{first_value['layer']}")
        if part is None:
            return rec
        if first is None:
            fail(f"{what}: the pair parts at token {part} with the same experts chosen at "
                 f"every position before it")
        elif tie_rule and dtype == "f32" and not min(first["gap_ulps"]) <= ROUTER_TIE_ULPS:
            fail(f"{what}: the pair parts at token {part} after its histories first chose "
                 f"other experts at position {first['pos']}, layer {first['layer']}, gaps "
                 f"{first['gap_ulps']} ulps (not a near tie: > {ROUTER_TIE_ULPS})")
        return rec


def moe_parity(dtype: str) -> dict:
    """2 MoE layers + the head at Qwen3-30B-A3B widths (random Q40 planes),
    the kernel path against the plain path (K1-K3 ``xla``, K5's wrapper
    swapped for its plain version) over a 128-token prefill and 8
    teacher-forced decode steps. Each token's logits lie within
    ``PARITY_TOL`` of max|logit|, or the two paths' routers chose other
    experts at that token or an earlier one; in f32 the first such choice
    must lie within :data:`ROUTER_TIE_ULPS` of a tie on one side (the
    routing near-tie rule)."""
    from dataclasses import replace

    from dllama_tpu_torch.formats.mfile import ArchType, RopeType
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.models.config import ModelConfig
    from dllama_tpu_torch.ops import moe_matmul as mm
    from dllama_tpu_torch.runtime.kvcache import KVCache

    mode = "exact" if dtype == "float32" else "fast"
    cfg = ModelConfig(arch=ArchType.QWEN3, dim=MOE_DIM, hidden_dim=MOE_HIDDEN, n_layers=2,
                      n_heads=MOE_HEADS, n_kv_heads=MOE_KV_HEADS, head_dim=HEAD_DIM,
                      vocab_size=MOE_VOCAB, seq_len=MAX_SEQ, norm_epsilon=1e-6,
                      rope_theta=1e6, rope_type=RopeType.FALCON, n_experts=MOE_EXPERTS,
                      n_active_experts=MOE_ACTIVE, moe_norm_topk=True, compute_dtype=dtype)
    params = llama.init_random_params(cfg, seed=SEED, quantized=True, device=DEV)
    g = torch.Generator(device=DEV).manual_seed(SEED + 3)
    tokens = torch.randint(0, MOE_VOCAB, (1, 136), generator=g, device=DEV)
    real_router, real_k5 = llama._router_sorted, llama.moe_matmul
    counts = {fn: fn.launches for fn in _wrappers().values()}
    outs, routes = {}, {}
    for path, impl in (("kernel", "auto"), ("plain", "xla")):
        c = replace(cfg, attn_impl=impl, quant_impl=impl)
        route: list = []   # per forward call, per layer: (probs [T, k+1], experts [T, k])

        def recorded(h, gate):
            top, idx = real_router(h, gate)
            route.append((top[0, :, :MOE_ACTIVE + 1].float().cpu().numpy(),
                          idx[0, :, :MOE_ACTIVE].cpu().numpy()))
            return top, idx

        llama._router_sorted = recorded
        if path == "plain":
            llama.moe_matmul = mm.moe_matmul_plain
        try:
            kv = KVCache.create(c, dtype=getattr(torch, dtype), device=DEV)
            logits = [llama.forward(params, c, tokens[:, :128], 0, kv)[0][0]]
            for t in range(128, 136):  # teacher-forced decode steps
                logits.append(llama.forward(params, c, tokens[:, t:t + 1], t, kv)[0][0])
        finally:
            llama._router_sorted, llama.moe_matmul = real_router, real_k5
        outs[path] = torch.cat(logits).float()
        # token-major: [token][layer] = (probs, experts)
        per_token = []
        for call in range(len(route) // cfg.n_layers):
            layers = route[call * cfg.n_layers:(call + 1) * cfg.n_layers]
            for j in range(layers[0][0].shape[0]):
                per_token.append([(v[j], x[j]) for v, x in layers])
        routes[path] = per_token
        del kv
    for fn, n in counts.items():  # the check's launches are not the main path's
        fn.launches = n
    rr = RouteRecorder(cfg.n_layers, MOE_ACTIVE)
    err = (outs["kernel"] - outs["plain"]).abs().amax(dim=1).cpu().numpy()
    scale = outs["plain"].abs().max().item()
    first = None
    for t, (ka, pa) in enumerate(zip(routes["kernel"], routes["plain"])):
        for layer, ((va, xa), (vb, xb)) in enumerate(zip(ka, pa)):
            if set(xa.tolist()) != set(xb.tolist()):
                first = dict(token=t, layer=layer, gap_ulps=[rr.gap_ulps(va), rr.gap_ulps(vb)])
                break
        if first is not None:
            break
    beyond = [t for t in range(len(err)) if not err[t] <= PARITY_TOL[mode] * scale]
    excused = [t for t in beyond if first is not None and t >= first["token"]]
    rec = dict(case="moe_parity", mode=mode, layers=2, tokens=len(err),
               max_abs_err=float(err.max()), max_abs_logit=scale, tol=PARITY_TOL[mode],
               tokens_beyond_tol=len(beyond), first_route_difference=first,
               excused_tokens=len(excused))
    print(json.dumps(rec), flush=True)
    if not math.isfinite(scale) or len(excused) < len(beyond):
        fail(f"moe parity {mode}: tokens {[t for t in beyond if t not in excused][:8]} "
             f"past {PARITY_TOL[mode]} x max|logit| {scale:.3g} with the same routing")
    if first is not None and dtype == "float32" and not min(first["gap_ulps"]) <= ROUTER_TIE_ULPS:
        fail(f"moe parity {mode}: the paths first chose other experts at token "
             f"{first['token']}, layer {first['layer']}, gaps {first['gap_ulps']} ulps (not a "
             f"near tie: > {ROUTER_TIE_ULPS})")
    del params, outs
    torch.cuda.empty_cache()
    return rec


def _pair(reqs: list) -> tuple:
    """The identical greedy pair of a :func:`serve_run`: the twin (submitted
    last) and the earlier request of the same prompt."""
    twin = reqs[-1]
    return next(r for r in reqs[:-1] if r.prompt_ids == twin.prompt_ids), twin


def moe_phase(model: str, tok: str, text: str, n_layers: int, summary: dict) -> None:
    """The Qwen3-30B-A3B file through the port's entry points, f32 exact and
    bf16 fast, three engines a numerics: ``inference`` (a 256-token prompt,
    64 greedy steps) through the CLI, whose engine then gives the profiles
    (:func:`engine_profiles`) and the per-call K5 hold (:func:`k5_hold`)
    before it closes; ``perplexity`` (511 tokens) through the CLI; the paged
    ``api --batch-slots 8 --kv-block-size 16`` with the serving mix cut to 8
    requests, whose generator then gives the paged step's profile and (f32)
    the paged tick's synchronisations (:func:`paged_step_syncs`: one). K5
    must launch on every path (counts set to 0 just before each, read just
    after; the checks' own launches are not counted), the api's step must
    replay a graph and capture none while it listens. First the 2-layer
    kernel-against-plain parity (:func:`moe_parity`). The identical greedy
    pair of each api run is held on the server's own router record
    (:class:`RouteRecorder`); in f32 a second api run with f32 sync
    buffers holds it to the routing near-tie rule."""
    out: dict = {"parity": [moe_parity(d) for d in ("float32", "bfloat16")]}
    for dtype in ("f32", "bf16"):
        common = ["--model", model, "--tokenizer", tok, "--compute-dtype", dtype,
                  "--max-seq-len", str(MAX_SEQ), "--seed", str(SEED)]
        launches: dict = {}
        checks: dict = {}

        def after_inference(eng):
            # the checks' launches are not the path's: the counts are put back
            counts = {fn: fn.launches for fn in _wrappers().values()}
            checks.update(engine_profiles(eng, dtype, "moe_"))
            for fn, n in counts.items():
                fn.launches = n
            checks["k5_hold"] = k5_hold(eng, f"moe {dtype}")

        torch.cuda.reset_peak_memory_stats()
        secs, t0 = {}, time.perf_counter()
        with engine_spy(on_close=after_inference) as spy:
            zero_counts()
            run = run_cli(["inference", *common, "--prompt", PROMPT, "--steps",
                           str(len(PROMPT.encode()) + 1 + 64), "--temperature", "0"])
            launches["moe_inference"] = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        secs["inference_and_checks"], t0 = time.perf_counter() - t0, time.perf_counter()
        with engine_spy() as ppl_spy:
            zero_counts()
            ppl_out = run_cli(["perplexity", *common, "--file", text])
            launches["moe_perplexity"] = read_counts()
        secs["perplexity"], t0 = time.perf_counter() - t0, time.perf_counter()
        lines = run.splitlines()
        ppl = _ppl(ppl_out)
        rec = dict(case="moe", compute_dtype=dtype, layers=n_layers,
                   prompt_tokens=int(stat(lines, "Evaluation", "nTokens:")) + 1,
                   generated=int(stat(lines, "Prediction", "nTokens:")),
                   prefill_tok_per_s=stat(lines, "Evaluation", "tokens/s:"),
                   decode_tok_per_s=stat(lines, "Prediction", "tokens/s:"),
                   perplexity=ppl, load_s=spy["load_s"] + ppl_spy["load_s"],
                   peak_gb_inference=peak_gb, **checks)
        out[f"{dtype}_logits"] = spy["logits"][0]

        route = RouteRecorder(n_layers, MOE_ACTIVE)

        def after_serving(url, gen, reqs, replays):
            route.on = False  # the checks' replays and chunks are not the run's
            n_launched = read_counts()  # the api's own launches, before the checks'
            res = {"paged_step_profile": paged_step_profile(model, tok, dtype, gen=gen),
                   "launches": n_launched}
            if dtype == "f32":
                paged_step_syncs(model, tok, res, case="moe_paged_step_syncs", eng=gen.eng)
            return res

        torch.cuda.empty_cache()
        # the twin reuses the pair's prompt blocks, but the prefix index may
        # map a leading block to another request's (the same tokens,
        # prefilled in another chunk width): the pair is held on the
        # routing of the prefills whose KV each reads (RouteRecorder)
        with route.installed():
            srv, reqs = serve_run(model, tok, n_layers, dtype, [], case="moe_serving",
                                  picks=MOE_PICKS, observe=after_serving, hold_twin=False,
                                  on_gen=route.attach)
        rec["route_hold"] = route.hold(*_pair(reqs), dtype, f"moe_serving {dtype}",
                                       tie_rule=False)
        del route
        if dtype == "f32":
            # with f32 sync buffers the histories differ in last ulps only:
            # the routing near-tie rule holds the pair
            route = RouteRecorder(n_layers, MOE_ACTIVE)
            with route.installed():
                _, reqs = serve_run(model, tok, n_layers, dtype, ["--buffer-float-type", "f32"],
                                    case="moe_serving_f32_buffers", picks=MOE_PICKS,
                                    hold_twin=False, on_gen=route.attach)
            rec["route_hold_f32_buffers"] = route.hold(
                *_pair(reqs), dtype, f"moe_serving {dtype} f32 buffers", tie_rule=True)
            del route
        secs["api_and_checks"] = time.perf_counter() - t0
        rec["seconds"] = secs
        obs = srv.pop("observed")
        launches["moe_api"] = obs["launches"]
        rec["paged_step_profile"] = obs["paged_step_profile"]
        if "moe_paged_step_syncs" in obs:
            out["moe_paged_step_syncs"] = obs["moe_paged_step_syncs"]
        rec["serving"] = {k: srv[k] for k in (
            "gen_tok_per_s", "latency_ms_p50", "latency_ms_p95", "ttft_ms_p50",
            "step_ms_median", "steps", "replays", "captures_while_listening", "peak_gb",
            "generated_tokens", "requests", "twin_equal")}
        rec["launches"] = launches
        for prof in ("prefill_profile", "decode_profile", "paged_step_profile"):
            print(json.dumps(rec[prof]), flush=True)
        print(json.dumps({k: v for k, v in rec.items() if not k.endswith("profile")}),
              flush=True)
        summary.setdefault(dtype, {}).setdefault("launches", {}).update(launches)
        out[dtype] = rec
        if rec["generated"] != 64 or rec["prompt_tokens"] < 200:
            fail(f"moe {dtype}: {rec['prompt_tokens']} prompt tokens, {rec['generated']} "
                 f"generated (want >= 200 and 64)")
        if not math.isfinite(ppl) or ppl <= 1.0:
            fail(f"moe {dtype}: perplexity {ppl} is not a finite value above 1")
        for path, kernels in (("moe_inference", ("K1", "K2", "K3", "K5")),
                              ("moe_perplexity", ("K1", "K3", "K5")),
                              ("moe_api", ("K1", "K2", "K3", "K4", "K5"))):
            if min(launches[path][k] for k in kernels) <= 0:
                fail(f"moe {dtype} {path}: a kernel of the path never launched: "
                     f"{launches[path]}")
        if srv["replays"] <= 0 or srv["captures_while_listening"] != 0:
            fail(f"moe {dtype} api: {srv['replays']} graph replays, "
                 f"{srv['captures_while_listening']} captures while listening")
        torch.cuda.empty_cache()
    rel = abs(out["bf16"]["perplexity"] / out["f32"]["perplexity"] - 1.0)
    out["bf16_vs_f32_perplexity"] = rel
    if not rel <= 0.05:
        fail(f"moe: bf16 perplexity differs from f32 by {rel:.3g} (> 5%)")
    if "moe_paged_step_syncs" not in out:
        fail("moe: the paged tick's synchronisations were not counted")
    summary["moe"] = out


def turbo_phase(long_model: str, tok: str, moe_model: str, moe_tok: str,
                summary: dict) -> None:
    """``inference --quant-mode turbo`` and ``turbo16`` (bf16 compute, the
    prompt of the main path, 32 greedy steps) on the 8-layer Llama 3.1 8B
    copy and on the MoE file: every matmul weight requantized on the card
    (its first plane held bit for bit against the same derivation on the
    host), K5 launched and K1/K2 never, the prefill's last logits within
    0.15 of their RMS of the fast run's (the MoE fast run is ``moe_phase``'s
    bf16 run), decode tok/s, and the K5 hold on the turbo model (a8 calls
    bit for bit). ``--quant-mode turbo --weight-mode f32`` is refused
    before anything is loaded."""
    from dllama_tpu_torch.ops import turbo
    from dllama_tpu_torch.runtime.weights import unpack_planes

    out: dict = {}
    derived: list = []

    def check_planes(eng):
        """The engine's first turbo plane against the host's derivation of
        the same file bytes (turbo loads like fast: bf16 scales)."""
        rec = eng.model_file.tensors["block_matmul_q.0"]
        raw = torch.from_numpy(np.frombuffer(eng.model_file.raw("block_matmul_q.0"),
                                             dtype=np.uint8).copy())
        host = turbo.derive_turbo(unpack_planes(raw, rec.float_type, *rec.shape,
                                                torch.bfloat16),
                                  a8=eng.params.layers[0].wq.a8)
        w = eng.params.layers[0].wq
        derived.append(bool(torch.equal(host.w8, w.w8.cpu())
                            and torch.equal(host.scale, w.scale.cpu())))
        out.setdefault("k5_hold", []).append(k5_hold(eng, f"turbo {eng.quant_mode}")
                                             if eng.cfg.is_moe else None)

    for name, model, tk in (("llama31_8b", long_model, tok), ("qwen3_30b_a3b", moe_model,
                                                               moe_tok)):
        common = ["--model", model, "--tokenizer", tk, "--compute-dtype", "bf16",
                  "--max-seq-len", str(MAX_SEQ), "--seed", str(SEED), "--prompt", PROMPT,
                  "--steps", str(len(PROMPT.encode()) + 1 + TURBO_STEPS),
                  "--temperature", "0"]
        moe = summary.get("moe", {})
        base = moe.get("bf16_logits") if name != "llama31_8b" else None
        if base is None:  # the fast run the drift is held against
            with engine_spy() as spy:
                fast = run_cli(["inference", *common, "--quant-mode", "fast"])
            base = spy["logits"][0]
            out[f"{name}_fast_decode_tok_per_s"] = stat(fast.splitlines(), "Prediction",
                                                        "tokens/s:")
        else:
            out[f"{name}_fast_decode_tok_per_s"] = moe["bf16"]["decode_tok_per_s"]
        for mode in ("turbo", "turbo16"):
            with engine_spy(on_close=check_planes) as spy:
                zero_counts()
                run = run_cli(["inference", *common, "--quant-mode", mode])
                launches = read_counts()
            lines = run.splitlines()
            got = spy["logits"][0]
            summary.setdefault("turbo_logits", {})[f"{name}_{mode}"] = got  # moe_tp's base
            drift = float(np.sqrt(np.mean((got - base) ** 2)) / np.sqrt(np.mean(base ** 2)))
            rec = dict(case="turbo", model=name, quant_mode=mode,
                       decode_tok_per_s=stat(lines, "Prediction", "tokens/s:"),
                       prefill_tok_per_s=stat(lines, "Evaluation", "tokens/s:"),
                       load_s=spy["load_s"], logits_drift_vs_fast=drift,
                       drift_bound=TURBO_MODEL_DRIFT, planes_equal_host=derived[-1],
                       launches=launches)
            print(json.dumps(rec), flush=True)
            summary.setdefault("bf16", {}).setdefault("launches", {})[
                f"turbo_{name}_{mode}"] = launches
            out[f"{name}_{mode}"] = rec
            if f"Quant: {mode}" not in run:
                fail(f"turbo {name} {mode}: the banner does not name the mode")
            if not derived[-1]:
                fail(f"turbo {name} {mode}: the derived planes differ from the host's")
            if launches["K5"] <= 0 or launches["K1"] or launches["K2"]:
                fail(f"turbo {name} {mode}: launches {launches} (K5 only for the matmuls)")
            if not drift < TURBO_MODEL_DRIFT:
                fail(f"turbo {name} {mode}: logits drift {drift:.3g} from fast >= "
                     f"{TURBO_MODEL_DRIFT} of their RMS")
            torch.cuda.empty_cache()
    # refused before the load: nothing is opened, no device memory is taken
    from dllama_tpu_torch.serve import cli

    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["inference", "--model", long_model, "--tokenizer", tok, "--prompt", "x",
                      "--steps", "8", "--quant-mode", "turbo", "--weight-mode", "f32"])
        fail("--quant-mode turbo --weight-mode f32 was not refused")
    except ValueError as e:
        refusal = dict(case="turbo_refusal", message=str(e)[:120],
                       seconds=time.perf_counter() - t0,
                       device_bytes_taken=torch.cuda.memory_allocated() - before)
    print(json.dumps(refusal), flush=True)
    if "weight-mode auto" not in refusal["message"] or refusal["device_bytes_taken"]:
        fail(f"turbo refusal: {refusal}")
    out["refusal"] = refusal
    print(json.dumps({k: v for k, v in out.items() if k.endswith("fast_decode_tok_per_s")}),
          flush=True)
    summary["turbo"] = out


# ---------------------------------------------------------------------------
# MoE and turbo planes under tensor and expert parallelism: shards on one card
# ---------------------------------------------------------------------------

MOE_TP = 2
# the shard grids of the K5 cases: (label, ep, tp). Shard (0, 0) of each: a
# tp = 2 shard holds all 128 experts, each's hidden axis halved (w1/w3 K
# 2048, N 384; w2 K 384, N 2048); an ep = 2 x tp = 2 shard 64 of them, the
# rows routed to the other 64 sorted past its last group
MOE_TP_GRIDS = (("tp=2", 1, 2), ("ep=2 x tp=2", 2, 2))
MOE_TP_TOKENS = (("decode", 1), ("paged step", SLOTS), ("128-token chunk", 128))
# the tp = 2 (and ep = 2 x tp = 2) logits against tp = 1's, over max|logit|:
# under f32 sync buffers f32 sums in another order (the dense tp path's
# bounds, TP_LOGIT_TOL); under the CLI's Q80 buffers the shards' last-ulp
# differences flip whole Q80 codes at the sync points (one step of a block's
# absmax / 127), and the flipped codes whole experts: on the synthetic 8-layer
# file 1.2-3.0% of max|logit| over a 256-token forward, 144 routing
# differences, 1.9e-6 under f32 buffers (PERF.md, PR 20)
MOE_TP_LOGIT_TOL = TP_LOGIT_TOL
MOE_TP_Q80_LOGIT_TOL = 0.1
MOE_TP_PPL_TOL = 1e-3      # relative, f32
MOE_TP_STEPS = 64          # greedy tokens of the transcripts
MOE_TP_TURBO_STEPS = 16
MOE_TP_DECODE_STEPS = 8    # teacher-forced decode steps of the ep x tp forward
MOE_TP_API_TOKENS = 24


def moe_tp_cases(timer: Timer, results: list) -> None:
    """K5 at the local shapes one shard of :data:`MOE_TP_GRIDS` gives it on
    the Qwen3-30B-A3B expert dots (w1 and w2; w3 is w1's shape), at 8, 64
    and 1024 rows, exact and fast, against its plain version (and its twin)
    on the written rows; yardstick ``torch._grouped_mm``. The records carry
    ``tp`` and ``ep`` and join the kernels line in rows of their own."""
    from dllama_tpu_torch.ops.linear import QuantizedWeight, dequantize_weight

    g = torch.Generator(device=DEV).manual_seed(SEED + 19)
    H = MOE_HIDDEN // MOE_TP
    for mode in ("exact", "fast"):
        fast = mode == "fast"
        for name, K, N in (("we1", MOE_DIM, H), ("we2", H, MOE_DIM)):
            we = random_expert_planes(K, N, fast, g)
            dq = dequantize_weight(we, torch.bfloat16)
            for label, ep, tp in MOE_TP_GRIDS:
                G = MOE_EXPERTS // ep
                w = QuantizedWeight(scales=we.scales[:G], codes=we.codes[:G], kind=we.kind)
                for tag, n_tok in MOE_TP_TOKENS:
                    offsets, _ = routed_offsets(n_tok, g)
                    offsets = offsets[:G + 1].contiguous()  # shard (0, 0)'s experts
                    used = int((offsets[1:] > offsets[:-1]).sum())
                    x = torch.randn((n_tok * MOE_ACTIVE, K), generator=g, device=DEV).to(
                        torch.bfloat16 if fast else torch.float32)
                    k5_case(timer, results, what=f"{name} {label} shard {tag} {mode}",
                            mode=mode, decoder="q", fast=fast, x=x, we=w, offsets=offsets,
                            used=used, library=grouped_mm_library(x, dq[:G], offsets),
                            library_note=GROUPED_MM_NOTE, weight=name, tokens=n_tok,
                            experts_used=used, tp=tp, ep=ep)
            del we, dq
            torch.cuda.empty_cache()


def moe_tp_engine(model: str, tok: str, dtype: str, tp: int, sync: str = "f32", **kw):
    """An engine of ``model`` as the CLI builds it (greedy; ``sync="q80"``:
    the CLI's default buffers) at ``tp`` shards, all on ``cuda:0``."""
    from dllama_tpu_torch.formats.quants import F32, Q80
    from dllama_tpu_torch.runtime.engine import InferenceEngine

    return InferenceEngine(model, tok, device=DEV, max_seq_len=MAX_SEQ,
                           sync_type=Q80 if sync == "q80" else F32, temperature=0.0, seed=SEED,
                           compute_dtype="bfloat16" if dtype == "bf16" else "float32",
                           tp=tp, tp_devices=[f"{DEV}:0"] * tp if tp > 1 else None, **kw)


@contextlib.contextmanager
def counted_layers(store: dict):
    """``store["layers"]``: the transformer blocks run inside (one
    ``_attn_out_and_ffn`` a layer a forward, every path); with
    ``store["routes"]`` a list, each MoE layer's router output (the top k +
    1 sorted probabilities and the top k experts of every row)."""
    from dllama_tpu_torch.models import llama

    real_layer, real_router = llama._attn_out_and_ffn, llama._router_sorted
    store.setdefault("layers", 0)

    def layer(*a, **kw):
        store["layers"] += 1
        return real_layer(*a, **kw)

    def router(h, gate):
        top, idx = real_router(h, gate)
        if store.get("routes") is not None:
            store["routes"].append((top.reshape(-1, top.shape[-1])[:, :MOE_ACTIVE + 1],
                                    idx.reshape(-1, idx.shape[-1])[:, :MOE_ACTIVE]))
        return top, idx

    llama._attn_out_and_ffn, llama._router_sorted = layer, router
    try:
        yield store
    finally:
        llama._attn_out_and_ffn, llama._router_sorted = real_layer, real_router


def hold_k5_per_shard(what: str, launches: dict, layers: int, per_layer: int) -> None:
    """K5 launched once per shard and layer and projection: ``per_layer``
    launches a block, no more, no fewer."""
    if launches["K5"] != layers * per_layer or not layers:
        fail(f"{what}: {launches['K5']} K5 launches over {layers} layer calls (want "
             f"{per_layer} a layer: once per shard and projection)")


def route_rows(routes: list, spans: list, n_layers: int) -> dict:
    """``{position: {layer: (probs [k + 1], experts)}}`` from the router
    outputs of consecutive forwards whose rows cover ``spans`` (``(first
    position, valid rows)`` a forward; padded rows are dropped)."""
    rows: dict = {}
    for f, (pos0, valid) in enumerate(spans):
        for layer in range(n_layers):
            top, idx = routes[f * n_layers + layer]
            top, idx = top[:valid].float().cpu().numpy(), idx[:valid].cpu().numpy()
            for j in range(valid):
                rows.setdefault(pos0 + j, {})[layer] = (top[j], set(idx[j].tolist()))
    return rows


def eager_greedy(eng, ids: list[int], n: int) -> tuple[list[int], list]:
    """``eng.generate(ids, n)``'s greedy steps at tp = 1 run eagerly (the
    captured step computes the same kernels), recording each step's routing
    and logits: the reference the tp = 2 transcripts are held to."""
    from dllama_tpu_torch.models import llama

    eng.reset()
    eng.prefill(ids[:-1])
    tok, pos, toks, rows = ids[-1], len(ids) - 1, [], []
    for _ in range(n):
        logits, eng.kv = llama.forward(eng.params, eng.cfg,
                                       torch.tensor([[tok]], device=DEV), pos, eng.kv)
        row = logits[0, -1].float()
        tok = int(row.argmax())
        toks.append(tok)
        rows.append(row)
        pos += 1
    return toks, rows


def hold_departure(what: str, dtype: str, n_prompt: int, toks: dict, rows: dict,
                   logits1: list) -> dict:
    """tp = 2's greedy tokens against tp = 1's (f32 buffers): in f32 they may
    part only after the two runs' routers chose other experts at some
    (position, layer) at or before the position that gave the parting
    token, the first such choice within :data:`ROUTER_TIE_ULPS` of a tie on
    one side (the routing near-tie rule), or where tp = 2's token came
    within :data:`NEAR_TIE` of tp = 1's top logit; bf16 is recorded."""
    part = next((i for i, (a, b) in enumerate(zip(toks[1], toks[MOE_TP])) if a != b), None)
    last = n_prompt - 1 + (part if part is not None else len(toks[1]) - 1)
    first, n_diff = None, 0
    for p in sorted(set(rows[1]) & set(rows[MOE_TP])):
        if p > last:
            break
        for layer, (va, ea) in rows[1][p].items():
            vb, eb = rows[MOE_TP][p][layer]
            if ea != eb:
                n_diff += 1
                if first is None:
                    rr = RouteRecorder(1, MOE_ACTIVE)
                    first = dict(pos=p, layer=layer,
                                 gap_ulps=[rr.gap_ulps(va), rr.gap_ulps(vb)])
    margin = (pick_margin(logits1[part].cpu().numpy(), toks[MOE_TP][part])
              if part is not None else None)
    rec = dict(case="moe_tp_transcripts", what=what, compute_dtype=dtype, parted_at=part,
               route_differences=n_diff, first_route_difference=first, margin=margin)
    print(json.dumps(rec), flush=True)
    tie = first is not None and min(first["gap_ulps"]) <= ROUTER_TIE_ULPS
    if dtype == "f32" and part is not None and not tie and not near_tie(margin, 0.0):
        fail(f"{what}: tp = {MOE_TP} parts from tp = 1 at token {part}, where its token stood "
             f"{margin:.3g} from tp = 1's pick (not a near tie), after the routing difference "
             f"{first}")
    return rec


def _drift(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def moe_tp_api(engs: dict, tokenizer, launches: dict, layers: dict) -> dict:
    """The paged ``BatchScheduler`` (8 slots, block 16) at tp = 2 and tp = 1
    over 8 greedy requests that share the serving mix's system prompt, the
    first alone (its prompt blocks register) and the rest together:
    transcripts counted equal, K5 per shard at tp = 2."""
    from dllama_tpu_torch.runtime.serving import BatchScheduler

    prompts = [tokenizer.encode(SYSTEM + f" Question {i}: " + "river stone " * (3 * i),
                                is_start=True) for i in range(TP_API_REQUESTS)]
    runs, rec = {}, {}
    for tp, eng in engs.items():
        sched = BatchScheduler(eng, n_slots=SLOTS)
        try:
            store: dict = {}
            with counted_layers(store):
                zero_counts()
                t0 = time.perf_counter()
                reqs = []
                for batch in (prompts[:1], prompts[1:]):
                    reqs += [sched.submit(p, MOE_TP_API_TOKENS, stop_on_eos=False)
                             for p in batch]
                    for r in reqs:
                        if not r.done.wait(timeout=600) or r.error is not None:
                            fail(f"moe tp api tp={tp}: request {r.rid} failed: {r.error}")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if tp == MOE_TP:
                    launches["moe_tp2_api"] = read_counts()
                    layers["moe_tp2_api"] = store["layers"]
            runs[tp] = [r.tokens for r in reqs]
            rec[f"tp{tp}_gen_tok_per_s"] = sum(len(t) for t in runs[tp]) / wall
            rec[f"tp{tp}_reused_tokens"] = sched.gen.reused_tokens
        finally:
            sched.close()
    rec["transcripts_equal"] = sum(a == b for a, b in zip(runs[MOE_TP], runs[1]))
    rec["first_departures"] = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
                               for a, b in zip(runs[MOE_TP], runs[1])]
    if not rec[f"tp{MOE_TP}_reused_tokens"]:
        fail("moe tp api: the shared system prompt was never reused")
    return rec


def moe_tp_phase(moe_model: str, moe_tok: str, long_model: str, tok: str, text: str,
                 n_layers: int, summary: dict) -> None:
    """MoE models and turbo planes under tensor and expert parallelism, the
    shards on one card, against tp = 1: ``InferenceEngine(tp=2,
    tp_devices=[cuda:0] * 2)`` on the Qwen3-30B-A3B file, f32 and bf16 (the
    expert hidden axis over tp: 768 -> 384). Under f32 sync buffers: the
    prompt's logits against tp = 1's within :data:`MOE_TP_LOGIT_TOL`, 64
    greedy tokens held to tp = 1's (:func:`hold_departure`), eager decode
    device ms and K5's share at tp = 2 and tp = 1; f32: ``perplexity``
    within :data:`MOE_TP_PPL_TOL` relative, the paged scheduler over 8
    requests, and one forward (a 128-token chunk) and 8 teacher-forced
    decode steps under ``{"ep": 2, "tp": 2}`` on ``[cuda:0] * 4`` against
    tp = 1's logits. Under the CLI's Q80 buffers the tp = 2 prompt logits
    against ``moe_phase``'s tp = 1 logits within
    :data:`MOE_TP_Q80_LOGIT_TOL`; bf16: ``--quant-mode turbo`` on the MoE
    file and ``turbo16`` on the 8-layer 8B at tp = 2 against
    ``turbo_phase``'s tp = 1 logits, the same bound. On every path K5
    launches once per shard and layer and projection
    (:func:`hold_k5_per_shard`; counts set to 0 just before each run)."""
    import gc

    card = card_line()
    print(f"🕸️ moe tp path: InferenceEngine(tp={MOE_TP}, tp_devices=[cuda:0] * {MOE_TP}) and "
          f"{{ep: 2, tp: 2}} on [cuda:0] * 4 ({card})", flush=True)
    out: dict = {"card": card}
    moe = summary.get("moe", {})
    for dtype in ("f32", "bf16"):
        launches = summary.setdefault(dtype, {}).setdefault("launches", {})
        layers: dict = {}
        rec = dict(case="moe_tp_path", compute_dtype=dtype, tp=MOE_TP, layers=n_layers)
        kw = {"kv_block_size": BLOCK} if dtype == "f32" else {}
        with engine_spy() as spy:
            engs = {t: moe_tp_engine(moe_model, moe_tok, dtype, t, **kw) for t in (1, MOE_TP)}
        try:
            rec["load_s"] = spy["load_s"]
            tokenizer = engs[1].tokenizer
            ids = tokenizer.encode(PROMPT)
            n_prompt = len(ids)
            engs[1].reset()
            spans = [(i, valid) for i, valid, _ in engs[1]._chunks(n_prompt - 1)]
            spans += [(n_prompt - 1 + j, 1) for j in range(MOE_TP_STEPS)]
            toks, rows = {}, {}
            store: dict = {"routes": []}
            with engine_spy() as spy, counted_layers(store):
                toks[1], logits1 = eager_greedy(engs[1], ids, MOE_TP_STEPS)
                rows[1] = route_rows(store["routes"], spans, n_layers)
                store.update(routes=[], layers=0)
                zero_counts()
                res = engs[MOE_TP].generate(ids, MOE_TP_STEPS, stop_on_eos=False)
                launches["moe_tp2_inference"] = read_counts()
                layers["moe_tp2_inference"] = store["layers"]
                toks[MOE_TP] = res.tokens
                rows[MOE_TP] = route_rows(store["routes"], spans, n_layers)
            logits = spy["logits"]  # tp = 1's prefill, then tp = 2's
            rec["logit_drift"] = _drift(logits[1], logits[0])
            if not rec["logit_drift"] <= MOE_TP_LOGIT_TOL[dtype]:
                fail(f"moe tp {dtype}: the prompt's logits {rec['logit_drift']:.3g} of "
                     f"max|logit| from tp = 1's (> {MOE_TP_LOGIT_TOL[dtype]})")
            rec["transcripts"] = hold_departure(f"moe tp inference {dtype}", dtype, n_prompt,
                                                toks, rows, logits1)
            rec["transcript_equal"] = toks[1] == toks[MOE_TP]
            rec["tp2_prefill_tok_per_s"] = res.eval_tok_per_s
            rec["tp2_decode_tok_per_s"] = res.pred_tok_per_s
            for t, e in engs.items():
                rec[f"tp{t}_eager_decode"] = eager_decode_ms(e, toks[t][-1])
            del logits1
            if dtype == "f32":
                with open(text, encoding="utf-8") as f:
                    ppl_ids = tokenizer.encode(f.read())[:MAX_SEQ]
                ppl = {}
                for t, e in engs.items():
                    e.reset()
                    store = {}
                    with counted_layers(store):
                        zero_counts()
                        t0 = time.perf_counter()
                        ppl[t] = e.perplexity(ppl_ids)
                        torch.cuda.synchronize()
                        if t == MOE_TP:
                            launches["moe_tp2_perplexity"] = read_counts()
                            layers["moe_tp2_perplexity"] = store["layers"]
                    rec[f"tp{t}_perplexity_tok_per_s"] = (len(ppl_ids) - 1) / (
                        time.perf_counter() - t0)
                rec["perplexity"] = ppl
                rec["perplexity_rel"] = abs(ppl[MOE_TP] / ppl[1] - 1.0)
                if not rec["perplexity_rel"] <= MOE_TP_PPL_TOL:
                    fail(f"moe tp f32 perplexity {ppl[MOE_TP]} against tp = 1's {ppl[1]}: "
                         f"{rec['perplexity_rel']:.3g} > {MOE_TP_PPL_TOL}")
                rec["api"] = moe_tp_api(engs, tokenizer, launches, layers)
                rec["ep_tp"] = moe_ep_tp_forward(engs[1], ids, launches, layers)
        finally:
            for e in engs.values():
                e.close()
            engs.clear()
            gc.collect()
            torch.cuda.empty_cache()
        if f"{dtype}_logits" in moe:  # the CLI's Q80 buffers against moe_phase's tp = 1
            with engine_spy() as spy:
                e = moe_tp_engine(moe_model, moe_tok, dtype, MOE_TP, sync="q80")
                try:
                    e.prefill(ids[:-1])
                finally:
                    e.close()
            rec["q80_logit_drift_vs_moe_phase"] = _drift(spy["logits"][0],
                                                         moe[f"{dtype}_logits"])
            if not rec["q80_logit_drift_vs_moe_phase"] <= MOE_TP_Q80_LOGIT_TOL:
                fail(f"moe tp {dtype} Q80 buffers: the prompt's logits "
                     f"{rec['q80_logit_drift_vs_moe_phase']:.3g} of max|logit| from "
                     f"moe_phase's tp = 1 (> {MOE_TP_Q80_LOGIT_TOL})")
        # MoE at tp = 2: the three expert dots on each of the two shards
        for path, n in layers.items():
            hold_k5_per_shard(f"moe tp {dtype} {path}", launches[path], n,
                              3 * 4 if path == "moe_ep2_tp2_forward" else 3 * MOE_TP)
        rec["launches"] = {p: launches[p] for p in layers}
        rec["layer_calls"] = layers
        print(json.dumps(rec), flush=True)
        out[dtype] = rec
    out["turbo"] = moe_tp_turbo(moe_model, moe_tok, long_model, tok, summary)
    summary["moe_tp"] = out


def moe_ep_tp_forward(eng, ids: list[int], launches: dict, layers: dict) -> dict:
    """One forward over a 128-token chunk and :data:`MOE_TP_DECODE_STEPS`
    teacher-forced decode steps (tp = 1's greedy tokens) under
    ``make_mesh({"ep": 2, "tp": 2}, [cuda:0] * 4)`` with ``eng``'s
    parameters cut over the grid, against ``eng``'s tp = 1 forwards (eager
    on both sides): the largest drift over max|logit|, and the ep x tp
    forwards' launches alone."""
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.parallel import sharding
    from dllama_tpu_torch.parallel.api import make_mesh

    plan = make_mesh({"ep": 2, "tp": 2}, [f"{DEV}:0"] * 4)
    params = sharding.tp_params(plan, eng.params)
    kv = sharding.kv_cache_sharding(plan, eng.cfg, dtype=eng.kv_dtype)
    eng.reset()
    worst, pos, chunk = 0.0, 0, (ids * 4)[:128]
    total = collections.Counter()
    for _ in range(1 + MOE_TP_DECODE_STEPS):
        want = eng._forward(chunk, pos)[0].float()
        zero_counts()
        got, kv = llama.forward(params, eng.cfg, torch.tensor([chunk], device=DEV), pos, kv,
                                plan)
        total.update(read_counts())
        got = got[0].float()
        worst = max(worst, ((got - want).abs().max() / want.abs().max()).item())
        pos += len(chunk)
        chunk = [int(want[-1].argmax())]
    launches["moe_ep2_tp2_forward"] = dict(total)
    layers["moe_ep2_tp2_forward"] = (1 + MOE_TP_DECODE_STEPS) * eng.cfg.n_layers
    del params, kv
    rec = dict(grid={"ep": 2, "tp": 2}, shards=4, forwards=1 + MOE_TP_DECODE_STEPS,
               logit_drift=worst)
    if not worst <= MOE_TP_LOGIT_TOL["f32"]:
        fail(f"moe ep x tp f32: logits {worst:.3g} of max|logit| from tp = 1's "
             f"(> {MOE_TP_LOGIT_TOL['f32']})")
    return rec


def moe_tp_turbo(moe_model: str, moe_tok: str, long_model: str, tok: str,
                 summary: dict) -> dict:
    """``--quant-mode turbo`` on the MoE file and ``turbo16`` on the 8-layer
    8B at tp = 2, bf16 (``turbo_phase``'s settings): turbo planes derived
    from the whole Q40 planes and cut like them, K5 for every matmul but
    the dense head (the expert dots and the attention projections, and the
    8B's FFN, on each shard), K1 and K2 never; the prompt's logits against
    ``turbo_phase``'s tp = 1 run (both under the CLI's Q80 buffers) within
    :data:`MOE_TP_Q80_LOGIT_TOL`."""
    import gc

    out: dict = {}
    base = summary.get("turbo_logits", {})
    for name, model, tk, mode, per_layer in (
            ("qwen3_30b_a3b", moe_model, moe_tok, "turbo", (3 + 4) * MOE_TP),
            ("llama31_8b", long_model, tok, "turbo16", 7 * MOE_TP)):
        with engine_spy() as spy:
            eng = moe_tp_engine(model, tk, "bf16", MOE_TP, sync="q80", quant_mode=mode)
            try:
                ids = eng.tokenizer.encode(PROMPT)
                store: dict = {}
                with counted_layers(store):
                    zero_counts()
                    res = eng.generate(ids, MOE_TP_TURBO_STEPS, stop_on_eos=False)
                    launches = read_counts()
            finally:
                eng.close()
                gc.collect()
                torch.cuda.empty_cache()
        rec = dict(case="moe_tp_turbo", model=name, quant_mode=mode, tp=MOE_TP,
                   decode_tok_per_s=res.pred_tok_per_s, prefill_tok_per_s=res.eval_tok_per_s,
                   load_s=spy["load_s"], launches=launches, layer_calls=store["layers"])
        key = f"{name}_{mode}"
        if key in base:
            rec["logit_drift"] = _drift(spy["logits"][0], base[key])
            if not rec["logit_drift"] <= MOE_TP_Q80_LOGIT_TOL:
                fail(f"moe tp turbo {name} {mode}: logits {rec['logit_drift']:.3g} of "
                     f"max|logit| from tp = 1's (> {MOE_TP_Q80_LOGIT_TOL})")
        print(json.dumps(rec), flush=True)
        summary["bf16"]["launches"][f"moe_tp2_turbo_{name}_{mode}"] = launches
        hold_k5_per_shard(f"moe tp turbo {name} {mode}", launches, store["layers"], per_layer)
        if launches["K1"] or launches["K2"]:
            fail(f"moe tp turbo {name} {mode}: launches {launches} (K5 only for the matmuls)")
        out[key] = rec
    return out


def kernels_line(cases: list, e2e: dict) -> dict:
    """One entry per kernel, case group and numerics mode: times summed
    over one layer's seven matmuls and the head (K1 at M=128, K2 at M=1 and
    at the serving M=8, each on Q40 and on Q80 planes; K2 at M=2, 4 and 16
    on wq alone; K2 at M = K + 1 and K1 at M = 8 (K + 1), the verify
    steps' widths, on every shape), or the single-row decode at depth 2047,
    a K + 1-row verify at depth 2043..2047, and at the
    long sp cell's depth / the cold 128-token prefill / a 256-token chunk at
    depth 19000 of the long cell's 32768-row cache / a 128-token chunk at
    depth 1024 / the cold 128-token prefill at head dim 64 (K3), or the
    single-row, 8-row ragged and 8-row full-depth decode at block size 16
    and the 8-row verify step at T = K + 1 (K4, whose
    yardstick ``gather_sdpa_ms`` is two library calls, so ``library_ms`` is
    null), or one decode over a whole 2048-row and a whole 16384-row shard /
    a 64-token chunk on its diagonal (K3s, whose SDPA yardstick returns no
    m/l). K1/K2 entries carry the K split per weight and the code kind,
    K3/K3s/K4 the split-S count, as the launches of the kernel phase took
    them, and every entry its path (``tc``: tensor cores; ``simt``: FP32). Launches are the main paths' counts, per path
    (``inference``, ``perplexity``, ``api``, the sp path's
    ``sp2_*``/``sp1_*`` runs, the fleet's replica A ``fleet_A``). The e4m3-cache entries (K3, K3s under f32
    and bf16 queries, K4 under bf16) count the ``--kv-dtype f8`` paths'
    launches (``f8_*``), the others every other path's; their library
    yardstick upcasts the cache to bf16 first (two calls: ``library_ms``
    null, ``upcast_sdpa_ms`` or ``gather_sdpa_ms`` beside)."""
    src = {"K1": ("dllama_tpu_torch/csrc/quant_matmul.cu",
                  "dllama_tpu/ops/quant_matmul.py:51", "q40_matmul (tile)"),
           "K2": ("dllama_tpu_torch/csrc/quant_matmul.cu",
                  "dllama_tpu/ops/quant_matmul.py:100", "q40_gemv (decode)"),
           "K3": ("dllama_tpu_torch/csrc/flash_attention.cu",
                  "dllama_tpu/ops/flash_attention.py:44", "flash_attention"),
           "K4": ("dllama_tpu_torch/csrc/paged_attention.cu",
                  "dllama_tpu/ops/paged_attention.py:49", "paged_attention"),
           "K3s": ("dllama_tpu_torch/csrc/flash_attention.cu",
                   "dllama_tpu/ops/flash_attention.py:206", "flash_block_stats"),
           "K5": ("dllama_tpu_torch/csrc/moe_matmul.cu",
                  "none (no Pallas kernel: XLA einsum / ragged_dot at "
                  "dllama_tpu/models/llama.py:215-317, dot_general at "
                  "dllama_tpu/ops/turbo.py:152-174)", "moe_matmul (grouped expert matmul)")}
    q40 = lambda c: c["codes"] == "q40"  # noqa: E731
    q80 = lambda c: c["codes"] == "q80"  # noqa: E731
    groups = {
        "K1": [(" M=128", lambda c: c["M"] == 128 and q40(c)),
               (" M=128 Q80 planes", lambda c: c["M"] == 128 and q80(c)),
               (f" M={SLOTS * (SPEC_K + 1)} (paged verify, K={SPEC_K})",
                lambda c: c["M"] == SLOTS * (SPEC_K + 1))],
        "K2": [(" M=1", lambda c: c["M"] == 1 and q40(c)),
               (" M=8 (serving)", lambda c: c["M"] == 8 and q40(c)),
               (" M=2 wq", lambda c: c["M"] == 2), (" M=4 wq", lambda c: c["M"] == 4),
               (" M=16 wq", lambda c: c["M"] == 16),
               (f" M={SPEC_K + 1} (verify, K={SPEC_K})", lambda c: c["M"] == SPEC_K + 1),
               (" M=1 Q80 planes", lambda c: c["M"] == 1 and q80(c)),
               (" M=8 Q80 planes", lambda c: c["M"] == 8 and q80(c))],
        "K3": [(" decode T=1 @2047", lambda c: c["phase"] == "decode"
                and c["start_pos"] == MAX_SEQ - 1 and c["head_dim"] == HEAD_DIM),
               (f" decode T=1 @{LONG_DEPTH} in a {SP_LONG_SEQ}-row cache",
                lambda c: c["start_pos"] == LONG_DEPTH),
               (f" prefill T=256 @{LONG_PREFILL_AT} in a {SP_LONG_SEQ}-row cache",
                lambda c: c["start_pos"] == LONG_PREFILL_AT),
               (" prefill T=128 @0", lambda c: c["phase"] == "prefill"
                and c["start_pos"] == 0 and c["T"] == 128 and c["head_dim"] == HEAD_DIM),
               (" prefill T=128 @0 head_dim 64", lambda c: c["phase"] == "prefill"
                and c["head_dim"] == 64),
               (" prefill T=128 @1024", lambda c: c["phase"] == "prefill"
                and c["start_pos"] == 1024 and c["T"] == 128),
               *[(f" prefill T={T} @{pos} (C7: {T * (HEADS // KV_HEADS)} folded rows)",
                  lambda c, T=T, pos=pos: c["phase"] == "prefill" and c["T"] == T
                  and c["start_pos"] == pos and c["S"] == MAX_SEQ)
                 for T, pos in C7_CHUNKS],
               (f" verify T={SPEC_K + 1} @{MAX_SEQ - 1 - SPEC_K}",
                lambda c: c["phase"] == "verify"),
               (f" ragged decode B={SLOTS} T=1 @2047..0 (dense step)",
                lambda c: c["phase"] == "ragged decode"),
               (f" ragged verify B={SLOTS} T={SPEC_K + 1} @{MAX_SEQ - 1 - SPEC_K}..0 "
                f"(dense verify)", lambda c: c["phase"] == "ragged verify")],
        "K4": [(" decode B=1 @2047 bs=16", lambda c: c["B"] == 1 and c["T"] == 1
                and c["block_size"] == BLOCK),
               (" decode B=8 ragged bs=16 (serving)", lambda c: c["B"] == 8
                and c["block_size"] == BLOCK and c["positions"] == RAGGED),
               (" decode B=8 @2047 bs=16", lambda c: c["B"] == 8
                and c["block_size"] == BLOCK and c["positions"] == [MAX_SEQ - 1] * 8),
               (f" decode B={WIDE_B} ragged bs=16 (single pass)",
                lambda c: c["B"] == WIDE_B),
               (f" verify B=8 T={SPEC_K + 1} ragged, lens 0-{SPEC_K} bs=16",
                lambda c: c["T"] == SPEC_K + 1)],
        "K3s": [(" decode T=1 over a whole 2048-row shard",
                 lambda c: c["phase"] == "decode whole block"),
                (f" decode T=1 over a whole {LONG_SHARD}-row shard",
                 lambda c: c["phase"] == "decode whole 16384-row shard"),
                (" prefill T=64 on the shard's diagonal",
                 lambda c: c["phase"] == "prefill T=64 diagonal"),
                *[(f" prefill T={T} on the shard's diagonal (C7: TQ {T * (HEADS // KV_HEADS)})",
                   lambda c, T=T: c["phase"] == f"prefill T={T} diagonal")
                  for T in (1024, 2048)]],
        "K5": [(f" Q40 experts, {lbl} ({n * MOE_ACTIVE} rows)",
                lambda c, n=n: c["decoder"] == "q" and c["tokens"] == n
                and "routing" not in c) for lbl, n in MOE_TOKENS] + [
               (f" Q40 experts w1 + w2, skewed routing (1024 rows: one expert "
                f"{MOE_SKEW_TOP}, {MOE_EXPERTS - MOE_SKEW_USED} empty)",
                lambda c: c.get("routing") == "skewed")] + [
               (f" turbo experts {d} ({MOE_ACTIVE} rows, gather regime)",
                lambda c, d=d: c["decoder"] == d and "M" not in c) for d in ("a8", "a16")] + [
               (" turbo experts pre-scaled (64 and 1024 rows, ragged regime)",
                lambda c: c["decoder"] == "prescaled"),
               (f" dense experts ({SLOTS * MOE_ACTIVE} rows)",
                lambda c: c["decoder"] == "dense")] + [
               (f" turbo {d} linear, 8B wq + w1 at M = {', '.join(map(str, TURBO_M))}",
                lambda c, d=d: c["decoder"] == d and "M" in c) for d in ("a8", "a16")],
    }
    out = []

    def entry(kname: str, label: str, sel: list, by_path: dict) -> dict:
        b_bytes = sum(c["bound_ms"] for c in sel if c["bound_by"] == "bytes")
        b_ops = sum(c["bound_ms"] for c in sel if c["bound_by"] == "operations")
        return dict(
            name=f"{kname} {src[kname][2]}{label}", route="cuda",
            source=src[kname][0], replaces=src[kname][1],
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(c["max_abs_err"] for c in sel),
            ms=sum(c["ms"] for c in sel), plain_ms=sum(c["plain_ms"] for c in sel),
            bound_ms=b_bytes + b_ops,
            bound_by="bytes" if b_bytes >= b_ops else "operations",
            library_ms=(None if kname == "K4"
                        or any(c["library_ms"] is None for c in sel)
                        else sum(c["library_ms"] for c in sel)))

    # the e4m3-cache cases (modes f8-*) run a subset of each kernel's
    # groups; their launches are the --kv-dtype f8 paths' (``f8_*``)
    rows = [(k, m) for k in ("K1", "K2", "K3", "K4", "K3s", "K5") for m in ATTN_MODES
            if any(c["kernel"] == k and c["mode"] == m and "tp" not in c for c in cases)]
    for kname, mode in rows:
        e2e_dtype = "bf16" if mode.endswith("fast") else "f32"
        ours = [c for c in cases if c["kernel"] == kname and c["mode"] == mode
                and "tp" not in c]
        by_path = {p: n.get(kname, 0) for p, n in e2e[e2e_dtype]["launches"].items()
                   if p.startswith("f8_") == mode.startswith("f8")}
        for suffix, pick in groups[kname]:
            sel = [c for c in ours if pick(c)]
            if not sel and (mode.startswith("f8") or kname == "K5"):
                continue
            rec = entry(kname, f"{suffix} [{mode}]", sel, by_path)
            if mode.startswith("f8"):
                # no one library call reads an e4m3 cache: the yardstick
                # upcasts it to bf16 first (two calls, as K4's gather + SDPA)
                rec["name"] = (f"{kname} {src[kname][2]}{suffix} [e4m3 cache, "
                               f"{'bf16' if mode == 'f8-fast' else 'f32'} queries]")
                rec["library_ms"] = None
                if kname != "K4":
                    rec["upcast_sdpa_ms"] = sum(c["library_ms"] for c in sel)
            # K splits (K1, K2: per weight) and split-S counts (K3, K3s);
            # the path: tensor cores (K1 fast's wgmma, K3/K3s's single
            # pass over bf16) or FP32 SIMT, as each launch took it
            if kname in ("K1", "K2"):
                rec["splits"] = {c["weight"]: c["splits"] for c in sel}
                rec["codes"] = sel[0]["codes"]
            elif kname == "K5":
                rec["decoder"] = sel[0]["decoder"]
                rec["bit_equal"] = all(c["bit_equal"] for c in sel)
                rec["splits"] = sorted({c["splits"] for c in sel})
                twins = [c["twin_err"] for c in sel if c["twin_err"] is not None]
                rec["twin_err"] = max(twins) if twins else None
                if rec["library_ms"] is not None:
                    rec["library_note"] = sel[0]["library_note"]
            else:
                rec["n_splits"] = max(c.get("n_splits", 1) for c in sel)
            rec["path"] = "+".join(sorted({c.get("path", "simt") for c in sel}))
            if kname == "K4":
                rec["gather_sdpa_ms"] = sum(c["gather_sdpa_ms"] for c in sel)
            if kname == "K3s" and not mode.startswith("f8"):
                rec["library_note"] = "SDPA, same block and mask: no m/l returned"
            out.append(rec)
    # the tp = 2 shards' local shapes (:func:`tp_cases`), launches of the tp
    # paths alone
    tp_labels = {"K1": " M=128, summed over the local wq wk wo w1 w2 head",
                 "K2": " M=1, summed over the local wq wk wo w1 w2 head",
                 "K3": f" decode T=1 @2047 + prefill T=128 @0, {HEADS // TP} q / "
                       f"{KV_HEADS // TP} kv heads",
                 "K4": f" decode B=8 ragged bs=16, {HEADS // TP} q / {KV_HEADS // TP} kv heads"}
    for kname, label in tp_labels.items():
        for mode in ("exact", "fast"):
            sel = [c for c in cases if c.get("tp") and c["kernel"] == kname
                   and c["mode"] == mode]
            if not sel:
                continue
            launches = e2e["bf16" if mode == "fast" else "f32"]["launches"]
            by_path = {p: n.get(kname, 0) for p, n in launches.items() if p.startswith("tp")}
            rec = entry(kname, f" tp={TP} shard{label} [{mode}]", sel, by_path)
            rec["tp"] = TP
            rec["path"] = "+".join(sorted({c.get("path", "simt") for c in sel}))
            if kname in ("K1", "K2"):
                rec["splits"] = {c["weight"]: c["splits"] for c in sel}
            else:
                rec["n_splits"] = max(c.get("n_splits", 1) for c in sel)
            out.append(rec)
    # K5 at one shard's shapes of the MoE tp paths (:func:`moe_tp_cases`),
    # launches of those paths alone
    for label, ep, tp in MOE_TP_GRIDS:
        for tag, n_tok in MOE_TP_TOKENS:
            for mode in ("exact", "fast"):
                sel = [c for c in cases if c["kernel"] == "K5" and c.get("tp") == tp
                       and c.get("ep") == ep and c["tokens"] == n_tok and c["mode"] == mode]
                if not sel:
                    continue
                launches = e2e["bf16" if mode == "fast" else "f32"]["launches"]
                by_path = {p: n.get("K5", 0) for p, n in launches.items()
                           if p.startswith(("moe_tp", "moe_ep"))}
                rec = entry("K5", f" Q40 experts w1 + w2, one {label} shard, {tag} "
                                  f"({n_tok * MOE_ACTIVE} rows) [{mode}]", sel, by_path)
                twins = [c["twin_err"] for c in sel if c["twin_err"] is not None]
                rec.update(tp=tp, ep=ep, decoder="q", splits=sorted({c["splits"] for c in sel}),
                           twin_err=max(twins) if twins else None,
                           path="+".join(sorted({c["path"] for c in sel})))
                if rec["library_ms"] is not None:
                    rec["library_note"] = sel[0]["library_note"]
                out.append(rec)
    return {"kernels": out}


def kernel_label(mangled: str) -> str:
    """``name<template arguments>`` out of a mangled kernel name: the
    length-prefixed identifier that ends in ``kernel``, then ``I ... E``."""
    end = mangled.find("kernel") + len("kernel")
    for n in range(len("kernel"), end):
        if mangled[:end - n].endswith(str(n)):
            rest = mangled[end:]
            args = rest[1:rest.find("Ev")] if rest.startswith("I") else ""
            return f"{mangled[end - n:end]}<{args}>"
    return mangled[:90]


def ab_side(tag: str, assets: str, n_layers: int) -> int:
    """One side of an end-to-end A/B of two checkouts on one card: phase 4
    (``inference`` + ``perplexity`` in f32 and bf16 with the prefill and
    decode profiles), the long sp cell at sp = 1 in f32 and bf16 (64
    greedy steps after a 20146-token prompt) and the profiled 8-row paged
    decode step (:func:`paged_step_profile`) in f32 and bf16, on the model
    in ``assets`` (written on the first side). Host-clock rates spread between calls, so compare two checkouts
    inside one call, in turns, from the root of each::

        for side in parent change change parent; do
          (cd $side && python3 $CHANGE/chip_smoke.py --ab $side --assets $DIR)
        done
    """
    os.makedirs(assets, exist_ok=True)
    paths = [os.path.join(assets, n) for n in ASSETS]
    model, tok, text = (paths if all(map(os.path.exists, paths))
                        else write_assets(assets, n_layers))
    e2e: dict = {}
    t0 = time.perf_counter()
    main_path(model, tok, text, n_layers, e2e)
    long_text = PROMPT * (SP_LONG_PROMPT // len(PROMPT.encode()) + 1)
    long = {d: sp_run(model, tok, "engine", dtype=d, sp=1, seq_len=SP_LONG_SEQ,
                      text=long_text, sync="f32", steps=64, ppl=False)
            for d in ("f32", "bf16")}
    out = {"tag": tag, "wall_s": time.perf_counter() - t0,
           "long_sp1_decode": long["f32"]["decode_tok_per_s"],
           "long_sp1_prefill": long["f32"]["prefill_tok_per_s"],
           "long_sp1_bf16_decode": long["bf16"]["decode_tok_per_s"],
           "long_sp1_bf16_prefill": long["bf16"]["prefill_tok_per_s"]}
    for d in ("f32", "bf16"):
        r = e2e[d]
        paged = paged_step_profile(model, tok, d)
        print(json.dumps(paged), flush=True)
        out[d] = dict(decode=r["decode_tok_per_s"], prefill=r["prefill_tok_per_s"],
                      device_ms_per_prefill_chunk=r["prefill_profile"]["device_ms_per_chunk"],
                      device_ms_per_decode_step=r["decode_profile"]["device_ms_per_step"],
                      **{f"paged_step_{k}": paged[k] for k in (
                          "device_ms_per_step", "K2_device_ms_per_step",
                          "K4_device_ms_per_step", "kernels_per_step",
                          "device_busy_share", "wall_ms_per_step")})
    print("AB " + json.dumps(out), flush=True)
    return 0


def late_phases(names, model: str, long_model: str, tok: str, tmp: str, n_layers: int,
                e2e: dict) -> None:
    """The phases of slices 12-14, each timed (eval, numerics, the fleet,
    the KV tier and KV migration on the 8-layer copy ``long_model``, hbm at
    full depth); the audit of ``model`` (host only, at the lowest CPU
    priority) runs beside the others."""
    long_layers = min(LONG_LAYERS, n_layers)
    audit = start_audit(model, n_layers) if "audit" in names else None
    for name, phase in (("eval", lambda: eval_phase(long_model, tok, tmp, e2e)),
                        ("numerics", lambda: numerics_phase(long_model, tok, e2e)),
                        ("hbm", lambda: hbm_phase(model, tok, e2e)),
                        ("fleet", lambda: fleet_phase(long_model, tok, tmp, long_layers, e2e)),
                        ("kvtier", lambda: kvtier_phase(long_model, tok, tmp, long_layers,
                                                        e2e)),
                        ("kvmigrate", lambda: kvmigrate_phase(long_model, tok, tmp,
                                                              long_layers, e2e))):
        if name in names:
            t0 = time.perf_counter()
            phase()
            gc.collect()
            torch.cuda.empty_cache()
            print(f"⏱️ {name} took {time.perf_counter() - t0:.1f} s", flush=True)
    if audit is not None:
        finish_audit(audit, e2e)


def moe_and_turbo(names, long_model: str, tok: str, text: str, tmp: str, n_layers: int,
                  e2e: dict) -> None:
    """Slices 15 and 20's phases, each timed: the Qwen3-30B-A3B file written
    (``n_layers`` deep), then ``moe_phase``, ``turbo_phase`` and
    ``moe_tp_phase``."""
    t0 = time.perf_counter()
    moe_model, moe_tok = write_moe_assets(tmp, n_layers)
    print(f"⏱️ moe model write took {time.perf_counter() - t0:.1f} s", flush=True)
    for name, phase in (("moe", lambda: moe_phase(moe_model, moe_tok, text, n_layers, e2e)),
                        ("turbo", lambda: turbo_phase(long_model, tok, moe_model, moe_tok,
                                                      e2e)),
                        ("moe_tp", lambda: moe_tp_phase(moe_model, moe_tok, long_model, tok,
                                                        text, n_layers, e2e))):
        if name in names:
            t0 = time.perf_counter()
            phase()
            gc.collect()
            torch.cuda.empty_cache()
            print(f"⏱️ {name} took {time.perf_counter() - t0:.1f} s", flush=True)
    os.unlink(moe_model)


def only_phases(names: list[str], n_layers: int) -> int:
    """``--only``: the named phases of slices 12-20 on fresh assets,
    then exit 3 (a development run is never a result). ``moe``, ``turbo``,
    ``moe_tp`` and ``tp`` alone need no 32-layer model."""
    e2e: dict = {"f32": {"launches": {}}, "bf16": {"launches": {}}}
    late = [n for n in names if n not in ("moe", "turbo", "moe_tp", "tp")]
    long_layers = min(LONG_LAYERS, n_layers)
    with tempfile.TemporaryDirectory(prefix="dllama_smoke_") as tmp:
        if late:
            model, tok, text = write_assets(tmp, n_layers)
        else:
            model, tok, text = (os.path.join(tmp, n) for n in ASSETS)
            write_tokenizer(tok)
            with open(text, "w", encoding="utf-8") as f:
                f.write(PROMPT * 2)
        long_model = os.path.join(tmp, f"llama31_8b_{long_layers}l.m")
        write_model(long_model, long_layers)
        if late:
            late_phases(late, model, long_model, tok, tmp, n_layers, e2e)
        if "tp" in names:
            short_model = os.path.join(tmp, f"llama31_8b_{SHORT_LAYERS}l.m")
            write_model(short_model, min(SHORT_LAYERS, n_layers))
            t0 = time.perf_counter()
            tp_phase(short_model, tok, e2e)
            print(f"⏱️ tp path took {time.perf_counter() - t0:.1f} s", flush=True)
        if {"moe", "turbo", "moe_tp"} & set(names):
            moe_and_turbo(names, long_model, tok, text, tmp, long_layers, e2e)
    return 3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="end-to-end depth (width is never cut)")
    ap.add_argument("--ab", metavar="TAG",
                    help="one side of an A/B: only the timed end-to-end phases, on the "
                         "package of the current directory; prints an 'AB' line")
    ap.add_argument("--assets", metavar="DIR",
                    help="with --ab: where the synthetic model is written once and reused")
    ap.add_argument("--only", metavar="PHASES",
                    help="a development run: only these end-to-end phases (comma-separated "
                         "from eval, numerics, hbm, fleet, kvtier, kvmigrate, audit, moe, "
                         "turbo, moe_tp, tp), no kernel cases; prints no result line")
    args = ap.parse_args()
    if args.ab and not args.assets:
        ap.error("--ab needs --assets DIR")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    if args.ab:
        sys.path.insert(0, os.getcwd())
    try:
        from dllama_tpu_torch.ops import cuda_build
    except ImportError as e:
        fail(f"cannot import the port ({e}): run from the root of a checkout")
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    secs = cuda_build.build()
    print(f"🔨 kernels built in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})", flush=True)
    if args.ab:
        return ab_side(args.ab, args.assets, args.layers)
    for name, log in cuda_build.BUILD_LOG.items():
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                print(f"   ptxas [{name}] {kernel_label(ln.split(chr(39))[1])}")
            elif "registers" in ln or "spill" in ln:
                print(f"   ptxas [{name}]   {ln.split(':', 1)[-1].strip()}")

    if args.only:
        return only_phases(args.only.split(","), args.layers)
    cases: list = []
    timer = Timer()
    matmul_cases(timer, cases)
    attention_cases(timer, cases)
    ragged_attention_cases(timer, cases)
    paged_cases(timer, cases)
    ring_cases(timer, cases)
    moe_cases(timer, cases)
    tp_cases(timer, cases)
    t0 = time.perf_counter()
    moe_tp_cases(timer, cases)
    print(f"⏱️ moe tp cases took {time.perf_counter() - t0:.1f} s", flush=True)
    e2e: dict = {"f8": {"cast": f8_cast_check()}}
    guard_cost([])
    del timer
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="dllama_smoke_") as tmp:
        model, tok, text = write_assets(tmp, args.layers)
        # the 8-layer copy that the graphs phase, the serving phase and its
        # paged step profiles, the paged pool's and the dense pool's spec
        # phases, the long sp cell and the later phases run on (LONG_LAYERS:
        # width is never cut)
        long_layers = min(LONG_LAYERS, args.layers)
        long_model = os.path.join(tmp, f"llama31_8b_{long_layers}l.m")
        write_model(long_model, long_layers)
        short_layers = min(SHORT_LAYERS, args.layers)
        short_model = os.path.join(tmp, f"llama31_8b_{short_layers}l.m")
        write_model(short_model, short_layers)
        t0 = time.perf_counter()
        main_path(model, tok, text, args.layers, e2e)
        print(f"⏱️ inference + perplexity took {time.perf_counter() - t0:.1f} s", flush=True)
        e2e["f32"]["profiled_inference"] = profiled_inference(long_model, tok)
        t0 = time.perf_counter()
        graphs_phase(long_model, tok, e2e)
        print(f"⏱️ graphs took {time.perf_counter() - t0:.1f} s", flush=True)
        # on the device: each layer of a bf16 128-token chunk ran K3's
        # tensor-core kernel once; f32 chunks and decode steps never did
        for dtype in ("f32", "bf16"):
            for prof, key, want in (("prefill_profile", "tc_attention_per_chunk",
                                     args.layers if dtype == "bf16" else 0),
                                    ("decode_profile", "tc_attention_per_step", 0)):
                got = e2e[dtype][prof][key]
                if got != want:
                    fail(f"{dtype} {prof}: {got} tensor-core attention kernels per "
                         f"{key.rsplit('_', 1)[-1]} on the device, want {want}")
        t0 = time.perf_counter()
        serving(long_model, tok, long_layers, e2e)
        print(f"⏱️ serving took {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        for dtype in ("f32", "bf16"):
            prof = paged_step_profile(long_model, tok, dtype, ops=True)
            print(json.dumps(prof), flush=True)
            e2e[dtype]["paged_step_profile"] = prof
            torch.cuda.empty_cache()
        print(f"⏱️ paged step profiles took {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        spec_single(long_model, tok, long_layers, e2e)
        print(f"⏱️ spec single took {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        spec_serving(short_model, tok, short_layers, e2e)
        print(f"⏱️ spec serving took {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        dense_serving(long_model, tok, long_layers, e2e)
        print(f"⏱️ dense serving took {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        dense_chunk_spec(long_model, tok, long_layers, e2e)
        print(f"⏱️ dense chunk-4 and spec-4 took {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        single_api(long_model, tok, long_layers, e2e)
        print(f"⏱️ single-sequence api took {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        chat_phase(long_model, tok, tmp, e2e)
        print(f"⏱️ chat took {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        sp_path(long_model, tok, long_layers, e2e, short_model, short_layers)
        print(f"⏱️ sp path took {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        tp_phase(short_model, tok, e2e)
        print(f"⏱️ tp path took {time.perf_counter() - t0:.1f} s", flush=True)
        for name, phase in (
                ("f8 single sequence",
                 lambda: f8_single(long_model, tok, text, long_layers, e2e)),
                ("f8 serving", lambda: f8_serving(long_model, tok, long_layers, e2e)),
                ("f8 sp", lambda: f8_sp(long_model, tok, e2e)),
                ("weight modes", lambda: weight_modes(long_model, tok, long_layers, e2e)),
                ("nbatches", lambda: nbatches_phase(long_model, tok, e2e)),
                ("host sampling", lambda: host_sampling_phase(long_model, tok, e2e)),
                ("weight integrity", lambda: integrity_phase(short_model, tok, tmp, e2e)),
                ("watchdog and failpoints", lambda: watchdog_phase(long_model, tok, e2e)),
                ("paged step syncs", lambda: paged_step_syncs(long_model, tok, e2e)),
                ("instrumentation cost", lambda: obs_cost(e2e))):
            t0 = time.perf_counter()
            phase()
            torch.cuda.empty_cache()
            print(f"⏱️ {name} took {time.perf_counter() - t0:.1f} s", flush=True)
        moe_and_turbo(("moe", "turbo", "moe_tp"), long_model, tok, text, tmp, long_layers, e2e)
        late_phases(("eval", "numerics", "hbm", "fleet", "kvtier", "kvmigrate", "audit"),
                    model, long_model, tok, tmp, args.layers, e2e)
    model_parity({})
    paged_parity({})
    sp_parity({})

    print(f"⏱️ smoke run took {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps(kernels_line(cases, e2e)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
