#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``dllama_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each failing loudly (non-zero exit, no result line):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build the CUDA kernels from ``dllama_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and print the build time and ptxas register use;
3. kernels K1 (Q40 tile matmul), K2 (Q40 decode GEMV, at M = 1 and at the
   serving batch M = 8), K3 (flash attention, with decode at depth 2047 in
   a 2048-row cache, and decode at depth 20145 and a 256-token prefill
   chunk at depth 19000 in a 32768-row cache, the long sp cell at sp = 1)
   and K4 (paged attention) on the card against their plain
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
   decode step;
5. serving at the same width: the port's ``api --batch-slots 8
   --kv-block-size 16`` in process on a free local port, under f32 and
   bf16; 16 concurrent clients (9 share a system message, 2 SSE streams, an
   identical greedy pair whose second request admits while the first
   decodes, half sampled); every request must return 200 with tokens, the
   pair identical text, prefix reuse must happen and K1-K4 must each launch
   (counts set to 0 before each run); tok/s, latencies, step time, the
   column take/put cost and the pool are printed;
6. model parity on the card: 2 layers at 8B widths, the kernel path
   (``attn_impl=auto``, ``quant_impl=auto``) against the plain path (``xla``)
   on the same weights and tokens: a 128-token prefill plus 8 teacher-forced
   decode steps; then ``paged_forward`` over 8 ragged rows through scrambled
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
   a 160-token prefill and 8 decode steps; ``sp_path``: the 32-layer model
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
8. the ``kernels`` JSON line, then the result line
   ``{"ok": true, "device": {...}}`` last.

``--layers N`` cuts the end-to-end depth (default 32, the full model).
``--ab TAG --assets DIR`` runs one side of a same-call A/B of two checkouts
instead (see :func:`ab_side`): phase 4 and the long sp cell at sp = 1 (f32
and bf16) on the
package of the current directory, then an ``AB`` line.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
PEAK_OPS = {"f32": 67e12,     # FP32 outside the tensor cores
            "bf16": 989e12}   # dense bf16 tensor cores
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


def bound(n_bytes: float, n_ops: float, kind: str) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def random_planes(K: int, N: int, fast: bool, g: torch.Generator):
    from dllama_tpu_torch.ops.linear import QuantizedWeight

    codes = torch.randint(-8, 8, (K, N), generator=g, device=DEV, dtype=torch.int8)
    scales = torch.rand((K // 32, N), generator=g, device=DEV) * 0.01 + 0.002
    return QuantizedWeight(scales=scales.to(torch.bfloat16 if fast else torch.float32),
                           codes=codes)


def matmul_cases(timer: Timer, results: list) -> None:
    from dllama_tpu_torch.ops import quant_matmul as qm
    from dllama_tpu_torch.ops.linear import dequantize_weight, linear

    g = torch.Generator(device=DEV).manual_seed(SEED)
    for mode in ("exact", "fast"):
        fast = mode == "fast"
        act = torch.bfloat16 if fast else torch.float32
        for name, K, N in MATMULS_8B:
            w = random_planes(K, N, fast, g)
            wd = dequantize_weight(w, act)  # the library yardstick's operand
            # fast configs load the logits head as a dense bf16 [vocab, dim]
            # matrix (the loader's rule) and run it through ``linear``'s
            # F.linear: time that beside K1/K2 on the same weights
            head_dense = wd.t().contiguous() if fast and name == "head" else None
            # every shape at decode (M = 1), at the serving decode step of 8
            # slots (M = 8) and a 128-token chunk; one shape
            # also at the other widths the main path gives the kernels: K2's
            # multi-row variants (a context-tail chunk) and the 32-, 64- and
            # 256-token prefill chunks (K1 exact's three row tiles)
            widths = [("K2", 1), ("K2", 8), ("K1", 128)]
            if name == "wq":
                widths += [("K2", 4), ("K2", 16), ("K1", 32), ("K1", 64), ("K1", 256)]
            for kname, M in widths:
                fn = qm.q40_gemv if kname == "K2" else qm.q40_matmul
                x = torch.randn((M, K), generator=g, device=DEV).to(act)
                got = fn(x, w, fast=fast).float()
                splits = fn.last_splits  # the K split this launch took
                want = qm.quant_matmul_plain(x, w, fast=fast).float()
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                scale = want.abs().max().item()
                ms = timer(lambda: fn(x, w, fast=fast))
                plain_ms = timer(lambda: qm.quant_matmul_plain(x, w, fast=fast))
                lib_ms = timer(lambda: torch.matmul(x, wd))
                elt = 2 if fast else 4
                n_bytes = K * N + (K // 32) * N * elt + M * K * elt + M * N * 4
                b_ms, b_by = bound(n_bytes, 2.0 * M * K * N, "bf16" if fast else "f32")
                rec = dict(case="matmul", kernel=kname, mode=mode, weight=name, M=M,
                           K=K, N=N, splits=splits, max_abs_err=err, max_abs_ref=scale,
                           ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                           bound_by=b_by)
                if head_dense is not None:
                    rec["dense_head_ms"] = timer(lambda: linear(x, head_dense))
                print(json.dumps(rec), flush=True)
                results.append(rec)
                if not (err <= TOL[mode] * scale) or not math.isfinite(err):
                    fail(f"{kname} {mode} {name} M={M}: max|err| {err:.3g} > "
                         f"{TOL[mode]} x max|y| {scale:.3g}")
            del w, wd, head_dense
    torch.cuda.empty_cache()


def attention_cases(timer: Timer, results: list) -> None:
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
        ("prefill", 128, 0, 64, S),
        ("decode", 1, LONG_DEPTH, HEAD_DIM, SP_LONG_SEQ),
        ("prefill", 256, LONG_PREFILL_AT, HEAD_DIM, SP_LONG_SEQ)]
    for mode in ("exact", "fast"):
        kv_dt = torch.bfloat16 if mode == "fast" else torch.float32
        caches = {(D, rows): [torch.randn((1, KV_HEADS, rows, D), generator=g,
                                          device=DEV).to(kv_dt) for _ in range(2)]
                  for D, rows in ((HEAD_DIM, S), (64, S), (HEAD_DIM, SP_LONG_SEQ))}
        for phase, T, pos, D, rows in cases:
            k, v = caches[(D, rows)]
            q = torch.randn((1, T, HEADS, D), generator=g, device=DEV)
            positions = (pos + torch.arange(T, device=DEV))[None, :]
            got = fa.flash_attention(q, k, v, pos, D)
            n_splits = fa.flash_attention.last_splits  # what this launch took
            path = fa.flash_attention.last_path
            want = attention(q, k, v, positions, D)
            twin = fa.flash_attention_tc_plain(q, k, v, pos, D) if path == "tc" else None
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            err_twin = (got - twin).abs().max().item() if twin is not None else None
            qs = q.transpose(1, 2).to(kv_dt)
            mask = torch.arange(rows, device=DEV)[None, :] <= positions[0][:, None]
            ms = timer(lambda: fa.flash_attention(q, k, v, pos, D))
            plain_ms = timer(lambda: attention(q, k, v, positions, D))
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                qs, k, v, attn_mask=mask, enable_gqa=True))
            visible = sum(pos + t + 1 for t in range(T))  # keys per q head
            elt = k.element_size()
            n_bytes = 2 * T * HEADS * D * 4 + 2 * (pos + T) * KV_HEADS * D * elt
            b_ms, b_by = bound(n_bytes, 4.0 * D * HEADS * visible,
                               "bf16" if path == "tc" else "f32")
            rec = dict(case="attention", kernel="K3", mode=mode, phase=phase, T=T,
                       start_pos=pos, S=rows, head_dim=D, n_splits=n_splits, path=path,
                       max_abs_err=err, max_abs_ref=scale, max_abs_err_twin=err_twin,
                       ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by)
            print(json.dumps(rec), flush=True)
            results.append(rec)
            check_path(f"K3 {mode} {phase} T={T} pos={pos}", mode, n_splits, path)
            if path == "tc":
                if not (err_twin <= TC_TWIN_TOL * scale and err <= TOL["fast"] * scale):
                    fail(f"K3 {mode} {phase} T={T} pos={pos}: max|err| {err_twin:.3g} "
                         f"against the twin, {err:.3g} against f32 (max|out| {scale:.3g})")
            # f32 online softmax vs the one-shot oracle: reordered sums/exps
            elif not (err <= 1e-4 * max(scale, 1.0)) or not math.isfinite(err):
                fail(f"K3 {mode} {phase} T={T} pos={pos}: max|err| {err:.3g}")
            if (n_splits > 1) != (phase == "decode"):
                fail(f"K3 {mode} {phase} T={T} pos={pos}: the launch took n_splits "
                     f"{n_splits}; decode must split, prefill must not")
        del caches
    torch.cuda.empty_cache()


def check_path(what: str, mode: str, n_splits: int, path: str) -> None:
    """A K3/K3s launch's kernel: a single pass over a bf16 cache runs on the
    tensor cores, an f32 cache or a split launch on the SIMT kernel."""
    want = "tc" if mode == "fast" and n_splits == 1 else "simt"
    if path != want:
        fail(f"{what}: the launch took the {path!r} kernel, want {want!r} "
             f"(n_splits {n_splits})")


# ragged decode depths of a full 8-slot batch (deepest at the context cap)
RAGGED = [MAX_SEQ - 1, 1500, 1023, 700, 300, 129, 17, 0]
# (B, T, block size, first query position of each row)
PAGED_CASES = [(1, 1, 16, [MAX_SEQ - 1]), (8, 1, 16, RAGGED),
               (1, 1, 32, [MAX_SEQ - 1]), (8, 1, 32, RAGGED),
               (2, 16, 16, [1000, MAX_SEQ - 16])]


def scrambled_tables(depths: list[int], T: int, bs: int, g: torch.Generator):
    """Block tables ``[B, MAX_SEQ / bs]`` over a pool of just enough blocks:
    each row's blocks at scrambled physical ids, rows 0 and 1 sharing their
    first 4 blocks (a shared prompt prefix), null (0) entries past each
    row's last position. Returns ``(tables, n_blocks)``."""
    M = MAX_SEQ // bs
    need = [(d + T - 1) // bs + 1 for d in depths]
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
    head_dim 128, kv_mul 4, block sizes 16 and 32; decode at B = 1 and 8
    ragged rows, and a 16-token query chunk; f32 and bf16 pools."""
    import torch.nn.functional as F

    from dllama_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=DEV).manual_seed(SEED + 3)
    g_cpu = torch.Generator().manual_seed(SEED + 3)
    for mode in ("exact", "fast"):
        kv_dt = torch.bfloat16 if mode == "fast" else torch.float32
        for B, T, bs, depths in PAGED_CASES:
            tables, n_blocks = scrambled_tables(depths, T, bs, g_cpu)
            kp, vp = (torch.randn((n_blocks, KV_HEADS, bs, HEAD_DIM), generator=g,
                                  device=DEV).to(kv_dt) for _ in range(2))
            q = torch.randn((B, T, HEADS, HEAD_DIM), generator=g, device=DEV)
            positions = (torch.tensor(depths, device=DEV)[:, None]
                         + torch.arange(T, device=DEV)[None, :])
            got = pa.paged_attention(q, kp, vp, tables, positions, HEAD_DIM)
            want = pa.paged_attention_plain(q, kp, vp, tables, positions, HEAD_DIM)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            S = tables.shape[1] * bs
            mask = (torch.arange(S, device=DEV)[None, None, :]
                    <= positions[:, :, None])[:, None]            # [B, 1, T, S]
            qs = q.transpose(1, 2).to(kv_dt)

            def gather_sdpa():
                return F.scaled_dot_product_attention(
                    qs, pa.paged_view(kp, tables), pa.paged_view(vp, tables),
                    attn_mask=mask, enable_gqa=True)

            ms = timer(lambda: pa.paged_attention(q, kp, vp, tables, positions, HEAD_DIM))
            plain_ms = timer(lambda: pa.paged_attention_plain(q, kp, vp, tables,
                                                              positions, HEAD_DIM))
            yard_ms = timer(gather_sdpa)
            keys = sum(d + T for d in depths)           # K/V rows the rows can see
            scored = sum(d + t + 1 for d in depths for t in range(T))
            n_bytes = (2 * keys * KV_HEADS * HEAD_DIM * kp.element_size()
                       + 2 * B * T * HEADS * HEAD_DIM * 4)
            b_ms, b_by = bound(n_bytes, 4.0 * HEAD_DIM * HEADS * scored, "f32")
            rec = dict(case="paged_attention", kernel="K4", mode=mode, B=B, T=T,
                       block_size=bs, positions=depths, max_abs_err=err,
                       max_abs_ref=scale, ms=ms, plain_ms=plain_ms,
                       gather_sdpa_ms=yard_ms,
                       gather_sdpa_note="yardstick only: two library calls "
                                        "(pool[tables] gather + SDPA)",
                       bound_ms=b_ms, bound_by=b_by)
            print(json.dumps(rec), flush=True)
            results.append(rec)
            # f32 online softmax vs the one-shot oracle: reordered sums/exps
            if not (err <= 1e-4 * max(scale, 1.0)) or not math.isfinite(err):
                fail(f"K4 {mode} B={B} T={T} bs={bs}: max|err| {err:.3g}")
            del kp, vp
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: end to end at 8B width
# ---------------------------------------------------------------------------


def write_tokenizer(path: str) -> None:
    """128256 pieces (Llama 3's vocab size): the 256 bytes, printable filler
    pieces that never occur in the prompts (so every prompt byte is one
    token), bos/eos at 128000/128001 and reserved specials after, and a
    chat template string that the api detects as llama3."""
    from dllama_tpu_torch.formats.tfile import TokenizerData, write_tfile

    n_regular = 128000
    vocab = [bytes([b]) for b in range(256)]
    vocab += [b" tok%06d" % i for i in range(n_regular - 256)]
    vocab += [b"<|begin_of_text|>", b"<|end_of_text|>"]
    vocab += [b"<|reserved_%d|>" % i for i in range(VOCAB - len(vocab))]
    write_tfile(path, TokenizerData(
        vocab=vocab, scores=[0.0] * len(vocab), bos_id=n_regular, add_bos=True,
        eos_token_ids=[n_regular + 1], max_token_length=max(map(len, vocab)),
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


def _profiled(fn, n: int) -> tuple[float, list]:
    """Run ``fn`` under ``torch.profiler``: ``(host wall ms, device kernel
    events)``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA]


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
            f"top_ms_per_{unit}": {e.key[:60]: e.self_device_time_total / 1e3 / n
                                   for e in top}}


def engine_profile(model: str, tok: str, dtype: str) -> list[dict]:
    """Where the engine's time goes, under ``torch.profiler`` on one engine:
    two 128-token prefill chunks (at depths 128 and 256, after a warm-up
    chunk at 0), then 16 greedy decode steps (after 4 warm-up steps).
    Device busy share = the kernels' summed device time over the host wall
    time; the rest is the device idling while the host enqueues the eager
    ops."""
    from dllama_tpu_torch.formats.quants import Q80
    from dllama_tpu_torch.runtime.engine import InferenceEngine

    eng = InferenceEngine(model, tok, device=DEV, max_seq_len=MAX_SEQ, sync_type=Q80,
                          compute_dtype="bfloat16" if dtype == "bf16" else "float32",
                          temperature=0.0)
    try:
        ids = eng.tokenizer.encode(PROMPT * 2)
        eng.prefill(ids[:128])
        wall, kernels = _profiled(lambda: [eng.prefill(ids[a:a + 128]) for a in (128, 256)], 2)
        recs = [_profile_rec("prefill_profile", dtype, "chunk", 2, wall, kernels)]
        token = ids[384]
        for _ in range(4):
            token = eng.next_token(token)
        n = 16

        def steps():
            t = token
            for _ in range(n):
                t = eng.next_token(t)

        wall, kernels = _profiled(steps, n)
        recs.append(_profile_rec("decode_profile", dtype, "step", n, wall, kernels))
    finally:
        eng.close()
    return recs


def _wrappers() -> dict:
    from dllama_tpu_torch.ops import flash_attention as fa
    from dllama_tpu_torch.ops import paged_attention as pa
    from dllama_tpu_torch.ops import quant_matmul as qm

    return {"K1": qm.q40_matmul, "K2": qm.q40_gemv, "K3": fa.flash_attention,
            "K4": pa.paged_attention, "K3s": fa.flash_block_stats}


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
        for prof in engine_profile(model, tok, dtype):
            print(json.dumps(prof), flush=True)
            rec[prof["case"]] = prof
        torch.cuda.empty_cache()
    # fast numerics round weights and activations to bf16 but must score the
    # same text about as the exact path does
    rel = abs(summary["bf16"]["perplexity"] / summary["f32"]["perplexity"] - 1.0)
    if not rel <= 0.05:
        fail(f"bf16 perplexity differs from f32 by {rel:.3g} (> 5%)")


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


def serving(model: str, tok: str, n_layers: int, summary: dict) -> None:
    """The port's api in process (``cli.main(["api", ...])`` on a thread,
    port 0) under f32 and bf16: 16 concurrent clients, then the checks
    and the numbers of the run."""
    import threading

    from dllama_tpu_torch.serve import cli

    for dtype in ("f32", "bf16"):
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
            box.update(server=server, gen=gen)
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

            sched.submit, gen.step = submit_recorded, step_timed
            gen._exec_take = timed_sync(gen._exec_take, move_ms["take"])
            gen._exec_put = timed_sync(gen._exec_put, move_ms["put"])
            listening.set()

        argv = ["api", "--model", model, "--tokenizer", tok, "--compute-dtype", dtype,
                "--max-seq-len", str(MAX_SEQ), "--seed", str(SEED), "--temperature", "0",
                "--batch-slots", str(SLOTS), "--kv-block-size", str(BLOCK),
                "--host", "127.0.0.1", "--port", "0"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()  # this run's counts: set to 0 just before it, read just after
        th = threading.Thread(target=lambda: box.setdefault(
            "rc", cli.main(argv, on_listening=on_listening)), daemon=True)
        th.start()
        while not listening.wait(timeout=1.0):
            if not th.is_alive():
                fail(f"serving {dtype}: the api server exited before listening")
        url = f"http://127.0.0.1:{box['server'].server_address[1]}"
        bodies = serving_bodies()
        results: list = [None] * len(bodies)
        a_started = threading.Event()

        def client(i: int) -> None:
            try:
                if i == len(bodies) - 1:  # the twin admits while 14 decodes
                    a_started.wait(timeout=600)
                results[i] = post_chat(url, bodies[i], a_started if i == 14 else None)
            except Exception as e:  # noqa: BLE001 — reported as a failed request below
                results[i] = dict(status=getattr(e, "code", None), error=repr(e))
            finally:
                if i == 14:
                    a_started.set()  # a failed 14 must not hold its twin back

        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=900)
        wall_s = time.perf_counter() - t0
        gen = box["gen"]
        box["server"].shutdown()
        th.join(timeout=120)
        launches = read_counts()
        if th.is_alive() or box.get("rc") != 0:
            fail(f"serving {dtype}: the api server did not stop cleanly")
        bad = [(i, r) for i, r in enumerate(results)
               if r is None or r.get("status") != 200 or not r.get("text")]
        n_tokens = [len(r.tokens) for r in reqs]
        ttft = [(r.t_first_token - r.t_submit) / 1e6 for r in reqs if r.t_first_token]
        lat = sorted(r["latency_ms"] for r in results if r and "latency_ms" in r)
        pool = gen.pool
        rec = dict(case="serving", compute_dtype=dtype, layers=n_layers, slots=SLOTS,
                   block_size=BLOCK, requests=len(bodies), ok=len(bodies) - len(bad),
                   generated_tokens=sum(n_tokens), wall_s=wall_s,
                   gen_tok_per_s=sum(n_tokens) / wall_s,
                   latency_ms_p50=statistics.median(lat) if lat else None,
                   latency_ms_p95=lat[min(len(lat) - 1, int(0.95 * len(lat)))] if lat else None,
                   ttft_ms_p50=statistics.median(ttft) if ttft else None,
                   step_ms_median=statistics.median(step_ms) if step_ms else None,
                   steps=len(step_ms), reused_tokens=gen.reused_tokens,
                   pool_blocks=pool.n_blocks, pool_gb=gen.pool_bytes / 1e9,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   take_ms_median=statistics.median(move_ms["take"]) if move_ms["take"] else None,
                   put_ms_median=statistics.median(move_ms["put"]) if move_ms["put"] else None,
                   takes=len(move_ms["take"]),
                   column_gb=gen.pool_bytes / pool.n_blocks * gen.table_width / 1e9,
                   launches={"api": launches})
        print(json.dumps(rec), flush=True)
        summary.setdefault(dtype, {}).setdefault("launches", {})["api"] = launches
        summary[dtype]["serving"] = rec
        if bad:
            fail(f"serving {dtype}: {len(bad)} request(s) failed: {bad[:3]}")
        if results[14]["text"] != results[15]["text"]:
            fail(f"serving {dtype}: the identical greedy pair differs:\n"
                 f"{results[14]['text']!r}\n{results[15]['text']!r}")
        if gen.reused_tokens <= 0:
            fail(f"serving {dtype}: no prefix reuse happened")
        if min(launches[k] for k in ("K1", "K2", "K3", "K4")) <= 0:
            fail(f"serving {dtype}: a kernel of the path never launched: {launches}")
        del gen
        box.clear()
        torch.cuda.empty_cache()


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
    from dataclasses import replace

    from dllama_tpu_torch.models.llama import forward, init_random_params
    from dllama_tpu_torch.ops import flash_attention as fa
    from dllama_tpu_torch.ops import quant_matmul as qm
    from dllama_tpu_torch.runtime.kvcache import KVCache

    for mode, dtype in (("exact", "float32"), ("fast", "bfloat16")):
        cfg = parity_config(dtype)
        params = init_random_params(cfg, seed=SEED, quantized=True, device=DEV)
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
        torch.cuda.synchronize()
        err = (outs["kernel"] - outs["plain"]).abs().max().item()
        scale = outs["plain"].abs().max().item()
        rec = dict(case="parity", mode=mode, layers=2, max_abs_err=err,
                   max_abs_logit=scale, tol=PARITY_TOL[mode], launches_2_layers=per)
        print(json.dumps(rec), flush=True)
        results[mode] = rec
        if not (err <= PARITY_TOL[mode] * scale) or not math.isfinite(scale):
            fail(f"model parity {mode}: max|err| {err:.3g} > {PARITY_TOL[mode]} "
                 f"x max|logit| {scale:.3g}")
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
              ("decode whole 16384-row shard", 1, LONG_DEPTH, 0, LONG_SHARD)]


def ring_cases(timer: Timer, results: list) -> None:
    """K3s against its plain version (``_block_attn`` around the folded
    layout) at 8B shapes: n_kv 8, kv_mul 4, head_dim 128, a 2048-row and a
    16384-row shard; f32 and bf16 K/V. The library yardstick is SDPA over the same
    block with the same boolean mask; it returns the normalised output, not
    the m and l K3s returns."""
    import torch.nn.functional as F

    from dllama_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=DEV).manual_seed(SEED + 5)
    kv_mul = HEADS // KV_HEADS
    for mode in ("exact", "fast"):
        kv_dt = torch.bfloat16 if mode == "fast" else torch.float32
        blocks = {rows: [torch.randn((1, KV_HEADS, rows, HEAD_DIM), generator=g,
                                     device=DEV).to(kv_dt) for _ in range(2)]
                  for rows in (SHARD, LONG_SHARD)}
        for name, T, q0, kv0, rows in RING_CASES:
            k, v = blocks[rows]
            q_g = torch.randn((1, KV_HEADS, T * kv_mul, HEAD_DIM), generator=g, device=DEV)
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
                    .reshape(1, HEADS, T, HEAD_DIM).to(kv_dt)
            mask = (kv0 + torch.arange(rows, device=DEV))[None, :] \
                <= (q0 + torch.arange(T, device=DEV))[:, None]           # [T, rows]
            ms = timer(lambda: fa.flash_block_stats(q_g, k, v, q0, kv0, HEAD_DIM, T))
            plain_ms = timer(lambda: fa.flash_block_stats_plain(q_g, k, v, q0, kv0,
                                                                HEAD_DIM, T))
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                qs, k, v, attn_mask=mask, enable_gqa=True))
            # the work this data needs: keys up to the newest visible one
            seen = [max(0, min(rows, q0 + t - kv0 + 1)) for t in range(T)]
            n_bytes = (2 * max(seen) * KV_HEADS * HEAD_DIM * k.element_size()
                       + T * HEADS * HEAD_DIM * 4 * 2 + 2 * T * HEADS * 4)
            b_ms, b_by = bound(n_bytes, 4.0 * HEAD_DIM * HEADS * sum(seen),
                               "bf16" if path == "tc" else "f32")
            rec = dict(case="ring_block", kernel="K3s", mode=mode, phase=name, T=T,
                       q_pos0=q0, kv_pos0=kv0, shard_rows=rows,
                       n_splits=n_splits, path=path,
                       max_abs_err=max(e for e, _ in errs.values()),
                       errors={w: dict(max_abs_err=e, max_abs_ref=r)
                               for w, (e, r) in errs.items()},
                       errors_twin=errs_twin and {w: dict(max_abs_err=e, max_abs_ref=r)
                                                  for w, (e, r) in errs_twin.items()},
                       ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       library_note="SDPA with the same mask: normalised output, no m/l",
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
def phase_counts(store: dict):
    """K3s launches split by phase: the engine's ``prefill`` (per chunk) and
    ``next_token`` (per decode step), counted where each returns; and
    ``(n_splits, path)`` of every K3/K3s launch of the prefill, as the
    wrappers take the path from ``_attn_path`` (a parent tree without it
    records none)."""
    from dllama_tpu_torch.ops import flash_attention as fa
    from dllama_tpu_torch.runtime.engine import InferenceEngine

    prefill, next_token = InferenceEngine.prefill, InferenceEngine.next_token
    attn_path = getattr(fa, "_attn_path", None)
    store.update(prefill_chunks=0, prefill_k3s=0, decode_steps=0, decode_k3s=0,
                 prefill_launches=[])
    in_prefill = [False]

    def observed_path(kv_dtype, n_splits):
        path = attn_path(kv_dtype, n_splits)
        if in_prefill[0]:
            store["prefill_launches"].append((n_splits, path))
        return path

    def counted_prefill(self, ids):
        n0 = fa.flash_block_stats.launches
        in_prefill[0] = True
        try:
            last, metrics = prefill(self, ids)
        finally:
            in_prefill[0] = False
        store["prefill_chunks"] += len(metrics)
        store["prefill_k3s"] += fa.flash_block_stats.launches - n0
        return last, metrics

    def counted_next(self, token):
        n0 = fa.flash_block_stats.launches
        out = next_token(self, token)
        store["decode_steps"] += 1
        store["decode_k3s"] += fa.flash_block_stats.launches - n0
        return out

    InferenceEngine.prefill, InferenceEngine.next_token = counted_prefill, counted_next
    if attn_path is not None:
        fa._attn_path = observed_path
    try:
        yield store
    finally:
        InferenceEngine.prefill, InferenceEngine.next_token = prefill, next_token
        if attn_path is not None:
            fa._attn_path = attn_path


def sp_run(model: str, tok: str, via: str, *, dtype: str, sp: int, seq_len: int,
           text: str, sync: str, steps: int, ppl: bool) -> dict:
    """One run of the sp path: ``steps`` greedy tokens after ``text`` (none
    when 0), then ``perplexity`` over it when ``ppl``; through the CLI's
    ``--sp`` (``via="cli"``) or ``InferenceEngine(sp_devices=[cuda:0] * sp)``.
    Counts are set to 0 just before each and read just after it."""
    from dllama_tpu_torch.formats.quants import F32, Q80
    from dllama_tpu_torch.runtime.engine import InferenceEngine

    rec = dict(case="sp_path", via=via, compute_dtype=dtype, sp=sp, max_seq_len=seq_len,
               buffer_float_type=sync)
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)
    phases: dict = {}
    t0 = time.perf_counter()
    with phase_counts(phases):
        if via == "cli":
            common = ["--model", model, "--tokenizer", tok, "--compute-dtype", dtype,
                      "--max-seq-len", str(seq_len), "--seed", str(SEED), "--sp", str(sp),
                      "--buffer-float-type", sync]
            if steps:
                zero_counts()
                out = run_cli(["inference", *common, "--prompt", text, "--steps",
                               str(len(text.encode()) + 1 + steps), "--temperature", "0"])
                rec["launches_inference"] = read_counts()
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
                                  sp=sp, sp_devices=[f"{DEV}:0"] * sp)
            try:
                ids = eng.tokenizer.encode(text)
                if steps:
                    zero_counts()
                    res = eng.generate(ids, steps, stop_on_eos=False)
                    rec["launches_inference"] = read_counts()
                    rec.update(prompt_tokens=len(ids), generated=len(res.tokens),
                               prefill_tok_per_s=res.eval_tok_per_s,
                               decode_tok_per_s=res.pred_tok_per_s, tokens=res.tokens)
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
    rec["k3s_per_prefill_chunk"] = phases["prefill_k3s"] / max(1, phases["prefill_chunks"])
    rec["prefill_chunks"] = phases["prefill_chunks"]
    rec["prefill_launches"] = phases["prefill_launches"]
    rec["prefill_paths"] = dict(collections.Counter(p for _, p in rec["prefill_launches"]))
    print(json.dumps({k: v for k, v in rec.items()
                      if k not in ("tokens", "prefill_launches")}), flush=True)
    torch.cuda.empty_cache()
    return rec


def sp_path(model: str, tok: str, n_layers: int, e2e: dict) -> None:
    """The 32-layer model split in two sequence shards, at sp = 2 and, for
    comparison, sp = 1, in three cells:

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
    over 32 layers, so sp = 2 and sp = 1 would differ by far more than the
    split itself makes them, which the q80 cell records."""
    n_cards = torch.cuda.device_count()
    via = "cli" if n_cards >= 2 else "engine"
    print(f"🕸️ sp path: {'the CLI --sp 2 over ' + str(n_cards) + ' cards' if via == 'cli' else 'InferenceEngine(sp=2, sp_devices=[cuda:0, cuda:0]) on one card'}",
          flush=True)
    short = PROMPT * 10
    long_text = PROMPT * (SP_LONG_PROMPT // len(PROMPT.encode()) + 1)
    # (cell, dtype, sp, seq_len, text, buffers, steps, perplexity, least prompt)
    plan = [("short", d, sp, SP_SEQ, short, "f32", 64, d == "f32", 2300)
            for d in ("f32", "bf16") for sp in (2, 1)]
    plan += [("q80", "f32", sp, SP_SEQ, short, "q80", 0, True, 2300) for sp in (2, 1)]
    plan += [("long", "f32", sp, SP_LONG_SEQ, long_text, "f32", 64, True, SP_LONG_PROMPT)
             for sp in (2, 1)]
    plan += [("long", "bf16", sp, SP_LONG_SEQ, long_text, "f32", 64, True, SP_LONG_PROMPT)
             for sp in (2, 1)]
    runs = {}
    for cell, dtype, sp, seq_len, text, sync, steps, ppl, least in plan:
        t0 = time.perf_counter()
        rec = sp_run(model, tok, via, dtype=dtype, sp=sp, seq_len=seq_len, text=text,
                     sync=sync, steps=steps, ppl=ppl)
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
        if sp > 1 and steps and rec["k3s_per_decode_step"] != n_layers * sp:
            fail(f"sp {cell} {dtype}: {rec['k3s_per_decode_step']} K3s launches per "
                 f"decode step, want {n_layers * sp}")
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


def kernels_line(cases: list, e2e: dict) -> dict:
    """One entry per kernel, case group and numerics mode: times summed
    over one layer's seven matmuls and the head (K1 at M=128, K2 at M=1 and
    at the serving M=8), or the single-row decode at depth 2047 and at the
    long sp cell's depth / the cold 128-token prefill / a 256-token chunk at
    depth 19000 of the long cell's 32768-row cache / a 128-token chunk at
    depth 1024 / the cold 128-token prefill at head dim 64 (K3), or the
    single-row and 8-row ragged decode at block size 16 (K4, whose
    yardstick ``gather_sdpa_ms`` is two library calls, so ``library_ms`` is
    null), or one decode over a whole 2048-row and a whole 16384-row shard /
    a 64-token chunk on its diagonal (K3s, whose SDPA yardstick returns no
    m/l). K1/K2 entries carry the K split per weight, K3/K3s the split-S
    count, as the launches of the kernel phase took them, and every entry its
    path (``tc``: tensor cores; ``simt``: FP32). Launches are the main paths' counts, per path
    (``inference``, ``perplexity``, ``api``, and the sp path's
    ``sp2_*``/``sp1_*`` runs)."""
    src = {"K1": ("dllama_tpu_torch/csrc/quant_matmul.cu",
                  "dllama_tpu/ops/quant_matmul.py:51", "q40_matmul (tile)"),
           "K2": ("dllama_tpu_torch/csrc/quant_matmul.cu",
                  "dllama_tpu/ops/quant_matmul.py:100", "q40_gemv (decode)"),
           "K3": ("dllama_tpu_torch/csrc/flash_attention.cu",
                  "dllama_tpu/ops/flash_attention.py:44", "flash_attention"),
           "K4": ("dllama_tpu_torch/csrc/paged_attention.cu",
                  "dllama_tpu/ops/paged_attention.py:49", "paged_attention"),
           "K3s": ("dllama_tpu_torch/csrc/flash_attention.cu",
                   "dllama_tpu/ops/flash_attention.py:206", "flash_block_stats")}
    groups = {
        "K1": [(" M=128", lambda c: c["M"] == 128)],
        "K2": [(" M=1", lambda c: c["M"] == 1), (" M=8 (serving)", lambda c: c["M"] == 8)],
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
                and c["start_pos"] == 1024 and c["T"] == 128)],
        "K4": [(" decode B=1 @2047 bs=16", lambda c: c["B"] == 1 and c["T"] == 1
                and c["block_size"] == BLOCK),
               (" decode B=8 ragged bs=16 (serving)", lambda c: c["B"] == 8
                and c["block_size"] == BLOCK)],
        "K3s": [(" decode T=1 over a whole 2048-row shard",
                 lambda c: c["phase"] == "decode whole block"),
                (f" decode T=1 over a whole {LONG_SHARD}-row shard",
                 lambda c: c["phase"] == "decode whole 16384-row shard"),
                (" prefill T=64 on the shard's diagonal",
                 lambda c: c["phase"] == "prefill T=64 diagonal")],
    }
    out = []
    for kname in ("K1", "K2", "K3", "K4", "K3s"):
        for mode in ("exact", "fast"):
            e2e_dtype = "f32" if mode == "exact" else "bf16"
            ours = [c for c in cases if c["kernel"] == kname and c["mode"] == mode]
            by_path = {p: n[kname] for p, n in e2e[e2e_dtype]["launches"].items()}
            for suffix, pick in groups[kname]:
                sel = [c for c in ours if pick(c)]
                b_bytes = sum(c["bound_ms"] for c in sel if c["bound_by"] == "bytes")
                b_ops = sum(c["bound_ms"] for c in sel if c["bound_by"] == "operations")
                rec = dict(
                    name=f"{kname} {src[kname][2]}{suffix} [{mode}]", route="cuda",
                    source=src[kname][0], replaces=src[kname][1],
                    launches=sum(by_path.values()), launches_by_path=by_path,
                    max_abs_err=max(c["max_abs_err"] for c in sel),
                    ms=sum(c["ms"] for c in sel), plain_ms=sum(c["plain_ms"] for c in sel),
                    bound_ms=b_bytes + b_ops,
                    bound_by="bytes" if b_bytes >= b_ops else "operations",
                    library_ms=(None if kname == "K4"
                                else sum(c["library_ms"] for c in sel)))
                # K splits (K1, K2: per weight) and split-S counts (K3, K3s);
                # the path: tensor cores (K1 fast's wgmma, K3/K3s's single
                # pass over bf16) or FP32 SIMT, as each launch took it
                if kname in ("K1", "K2"):
                    rec["splits"] = {c["weight"]: c["splits"] for c in sel}
                    rec["path"] = "tc" if kname == "K1" and mode == "fast" else "simt"
                elif kname in ("K3", "K3s"):
                    rec["n_splits"] = max(c["n_splits"] for c in sel)
                    rec["path"] = "+".join(sorted({c["path"] for c in sel}))
                else:
                    rec["path"] = "simt"
                if kname == "K4":
                    rec["gather_sdpa_ms"] = sum(c["gather_sdpa_ms"] for c in sel)
                if kname == "K3s":
                    rec["library_note"] = "SDPA, same block and mask: no m/l returned"
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
    decode profiles) and the long sp cell at sp = 1 in f32 and bf16 (64
    greedy steps after a 20146-token prompt), on the model in ``assets`` (written on the first
    side). Host-clock rates spread between calls, so compare two checkouts
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
        out[d] = dict(decode=r["decode_tok_per_s"], prefill=r["prefill_tok_per_s"],
                      device_ms_per_prefill_chunk=r["prefill_profile"]["device_ms_per_chunk"],
                      device_ms_per_decode_step=r["decode_profile"]["device_ms_per_step"])
    print("AB " + json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="end-to-end depth (width is never cut)")
    ap.add_argument("--ab", metavar="TAG",
                    help="one side of an A/B: only the timed end-to-end phases, on the "
                         "package of the current directory; prints an 'AB' line")
    ap.add_argument("--assets", metavar="DIR",
                    help="with --ab: where the synthetic model is written once and reused")
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

    cases: list = []
    timer = Timer()
    matmul_cases(timer, cases)
    attention_cases(timer, cases)
    paged_cases(timer, cases)
    ring_cases(timer, cases)
    guard_cost([])
    del timer
    torch.cuda.empty_cache()
    e2e: dict = {}
    with tempfile.TemporaryDirectory(prefix="dllama_smoke_") as tmp:
        model, tok, text = write_assets(tmp, args.layers)
        t0 = time.perf_counter()
        main_path(model, tok, text, args.layers, e2e)
        print(f"⏱️ inference + perplexity took {time.perf_counter() - t0:.1f} s", flush=True)
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
        serving(model, tok, args.layers, e2e)
        print(f"⏱️ serving took {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        sp_path(model, tok, args.layers, e2e)
        print(f"⏱️ sp path took {time.perf_counter() - t0:.1f} s", flush=True)
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
