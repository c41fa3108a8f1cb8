"""Pre-staging device-memory budget check — refuse or shrink loudly instead
of running out of memory (the port of the JAX package's ``runtime/hbm.py``).

The reference prints its required-memory estimate before loading
(nn-core.cpp:162-176). Here the engine estimates device bytes before it
stages anything and refuses a model that does not fit with an actionable
error; the batched pools shrink to what fits instead of refusing
(:func:`fit_batch_slots`, :func:`fit_block_pool`), and so does the paged
pool's host spill tier against host DRAM (:func:`fit_host_pool`); and the
submit paths of
both API states refuse a prompt that would push the card past its limit
(:func:`admission_check`, ``runtime/serving.py::check_hbm_admission``).

The estimates are the JAX module's shape algebra with its safety margin:
they catch the 2x-and-worse misfits, they are not byte accounting.

Device memory: ``torch.cuda.mem_get_info``'s total for the engine's card
(the JAX module's ``bytes_limit``), overridden by ``DLLAMA_HBM_BYTES``; every
check stands down under ``DLLAMA_SKIP_HBM_CHECK``. On the CPU the limit is
unknown and every check passes.

Measured bytes: the JAX module cross-checks its estimate against the
compile ledger's per-program ``memory_analysis()`` bytes. The port's
compile ledger (``runtime/introspection.py``) records instead the
allocator's peak (``torch.cuda.max_memory_allocated``) right after each
program's first run at a signature (each prefill width) and after each
graph's capture (the peak then covers the graph's private pool); the
admission guard reads them through ``measured_hbm_bytes``, where the JAX
package's does. As in the JAX module, measurements can only raise the
estimate.
"""

from __future__ import annotations

import os

from .kvcache import padded_cache_len

# dense-equivalent bytes per weight for each on-device representation
# (quantized planes: int8 codes + f32 block scales in exact configs, bf16
# in fast ones — the f32 value is kept as the conservative estimate)
_WEIGHT_BYTES = {
    "q40": 1.125,
    "q80": 1.125,
    "bf16": 2.0,
    "f32": 4.0,
}

# headroom for workspace, temporaries, logits buffers and what the estimate
# cannot see
_MARGIN = 1.15
_FIXED_OVERHEAD = 512 * 1024 * 1024


class HbmBudgetError(RuntimeError):
    """A model or pool whose estimate exceeds the card's memory: refused
    before anything is staged (the CLI prints it as a clean error)."""


def device_memory_bytes(device=None) -> int | None:
    """The device's memory limit, or None when unknown (a CPU device, or no
    usable card). ``DLLAMA_HBM_BYTES`` overrides."""
    env = os.environ.get("DLLAMA_HBM_BYTES")
    if env:
        return int(env)
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.mem_get_info(device)[1])


def _limit(device) -> int | None:
    return None if os.environ.get("DLLAMA_SKIP_HBM_CHECK") else device_memory_bytes(device)


def matmul_weight_count(cfg) -> int:
    """Total matmul-plane weights (the quantized payload); an MoE layer
    counts every expert's three projections and the router."""
    per_layer = cfg.dim * cfg.q_dim + 2 * cfg.dim * cfg.kv_dim + cfg.q_dim * cfg.dim
    if cfg.is_moe:
        per_layer += 3 * cfg.dim * cfg.hidden_dim * cfg.n_experts + cfg.dim * cfg.n_experts
    else:
        per_layer += 3 * cfg.dim * cfg.hidden_dim
    return cfg.n_layers * per_layer + cfg.dim * cfg.vocab_size  # + lm head


def estimate_device_bytes(cfg, *, weight_repr: str, kv_dtype_bytes: int,
                          batch: int = 1, n_shards: int = 1) -> dict:
    """Per-device byte estimate. ``weight_repr`` names the on-device weight
    representation (q40/q80/bf16/f32); ``n_shards`` divides the weight and
    KV payload (the JAX module's mesh sharding: under ``tp`` the engine
    passes ``tp`` over the most shards one device holds, so a device is
    charged the sum over its shards, and ``tp`` shards on one card charge
    it the whole model). The JAX module's ``offload`` comes with host
    offload (not ported)."""
    import torch

    from ..ops.linear import fast_numerics_resolved, turbo_mode
    from .weights import dense_logits_wanted

    wbytes = _WEIGHT_BYTES[weight_repr]
    compute = getattr(cfg, "compute_dtype", "float32") or "float32"
    mode = getattr(cfg, "quant_mode", "auto")
    dense_head = dense_logits_wanted(fast_numerics_resolved(compute, mode))
    # the embedding is stored at the compute dtype (runtime.weights)
    emb_bytes = cfg.vocab_size * cfg.dim * getattr(torch, compute).itemsize
    if wbytes < 2.0 and dense_head:
        # fast configs load the logits head as a dense bf16 matrix: charge
        # the difference
        emb_bytes += int(cfg.vocab_size * cfg.dim * (2.0 - wbytes))
    weights = emb_bytes + int(matmul_weight_count(cfg) * wbytes)
    if turbo_mode(mode) is not None and wbytes < 2.0:
        # the turbo derivation (ops/turbo.py) holds one extra derived int8
        # leaf while its source lives, plus the dense f32 intermediate of
        # the plane being derived: the JAX module's charge (its leaves
        # stack the layers, so its largest leaf bounds the port's per-layer
        # ones from above), which keeps the two estimates equal
        dense_cols = cfg.hidden_dim if dense_head else max(cfg.hidden_dim, cfg.vocab_size)
        largest_leaf = cfg.n_layers * cfg.dim * cfg.hidden_dim * (
            cfg.n_experts if cfg.is_moe else 1)
        weights += largest_leaf + 4 * cfg.dim * dense_cols
    kv = (2 * cfg.n_layers * padded_cache_len(cfg.seq_len) * cfg.kv_dim * batch
          * kv_dtype_bytes)
    need = int(((weights + kv) / max(1, n_shards)) * _MARGIN) + _FIXED_OVERHEAD
    return {"weights_bytes": weights, "kv_bytes": kv, "need_per_device": need}


def fit_batch_slots(cfg, n_slots: int, *, weight_repr: str, kv_dtype_bytes: int,
                    device=None, n_shards: int = 1) -> tuple[int, dict]:
    """Largest slot-pool size ``<= n_slots`` whose estimate fits the
    device limit: a dense pool that would not fit shrinks instead of
    failing. Returns ``(n_fit, estimate)``; ``n_fit == 0`` when even one
    slot does not fit (the caller refuses)."""
    limit = _limit(device)
    n = max(1, n_slots)
    while n >= 1:
        # +1: the engine's batch-1 cache stays allocated beside the pool
        est = estimate_device_bytes(cfg, weight_repr=weight_repr,
                                    kv_dtype_bytes=kv_dtype_bytes, batch=n + 1,
                                    n_shards=n_shards)
        if limit is None or est["need_per_device"] <= limit:
            return n, est
        n -= 1
    return 0, est


def estimate_block_pool_bytes(cfg, n_blocks: int, block_size: int,
                              kv_dtype_bytes: int) -> int:
    """Device bytes of a paged KV block pool ``[L, n_blocks, n_kv,
    block_size, hd]`` ×2 (K and V)."""
    return 2 * cfg.n_layers * n_blocks * cfg.kv_dim * block_size * kv_dtype_bytes


def fit_block_pool(cfg, n_blocks: int, *, block_size: int, min_blocks: int,
                   weight_repr: str, kv_dtype_bytes: int,
                   device=None, n_shards: int = 1) -> tuple[int, dict]:
    """Largest paged block-pool size ``<= n_blocks`` whose estimate fits the
    device limit — the paged twin of :func:`fit_batch_slots`: blocks are the
    admission currency, so the pool shrinks block by block. The base charge
    keeps the engine's batch-1 cache. Returns ``(n_fit, estimate)``;
    ``n_fit == 0`` when even ``min_blocks`` (one full sequence + the null
    block) does not fit."""
    limit = _limit(device)
    base = estimate_device_bytes(cfg, weight_repr=weight_repr, kv_dtype_bytes=kv_dtype_bytes,
                                 batch=1, n_shards=n_shards)

    def est_for(k: int) -> dict:
        pool = estimate_block_pool_bytes(cfg, k, block_size, kv_dtype_bytes)
        est = dict(base)
        est["kv_pool_bytes"] = pool
        est["need_per_device"] = (base["need_per_device"]
                                  + int(pool / max(1, n_shards) * _MARGIN))
        return est

    n = max(min_blocks, n_blocks)
    est = est_for(n)
    if limit is None or est["need_per_device"] <= limit:
        return n, est
    est = est_for(min_blocks)
    if est["need_per_device"] > limit:  # even the floor does not fit
        return 0, est
    # the estimate grows with the block count: bisect for the largest
    # fitting size (lo always fits, hi never does)
    lo, hi = min_blocks, n
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if est_for(mid)["need_per_device"] <= limit:
            lo = mid
        else:
            hi = mid
    return lo, est_for(lo)


def host_memory_bytes() -> int | None:
    """Total host DRAM, or None when the platform won't say.
    ``DLLAMA_HOST_KV_BYTES`` overrides with an explicit KV-tier budget (the
    JAX module's own override, kept for containers whose cgroup limit the
    sysconf number can't see)."""
    env = os.environ.get("DLLAMA_HOST_KV_BYTES")
    if env:
        return int(env)
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError, AttributeError):
        return None


# the host KV mirror may take at most this share of host DRAM when the
# budget comes from the sysconf total (weights, the OS and the runtime need
# the rest); an explicit DLLAMA_HOST_KV_BYTES is taken as-is
_HOST_KV_FRACTION = 0.5


def fit_host_pool(cfg, n_blocks: int, *, block_size: int, kv_dtype_bytes: int) -> int:
    """Largest host-tier mirror pool ``<= n_blocks`` that fits the host DRAM
    budget — the host twin of :func:`fit_block_pool`, sized block by block
    with the same :func:`estimate_block_pool_bytes`. Returns the fitted
    count (0 = tier off); an unknown host capacity grants the request as
    is. The mirror stores spilled blocks in ``kvblocks.SPILL_BATCH``-wide
    chunks, so a grant of at least one batch rounds DOWN to a batch
    multiple (a sub-batch lane could never carry a full spill); a sub-batch
    grant is kept (its mirror holds at most one chunk)."""
    from .kvblocks import SPILL_BATCH

    n = max(0, n_blocks)
    if n == 0:
        return 0
    limit = host_memory_bytes()
    if limit is not None:
        if not os.environ.get("DLLAMA_HOST_KV_BYTES"):
            limit = int(limit * _HOST_KV_FRACTION)
        per_block = max(1, estimate_block_pool_bytes(cfg, 1, block_size, kv_dtype_bytes))
        n = min(n, limit // per_block)
    if n >= SPILL_BATCH:
        n = (n // SPILL_BATCH) * SPILL_BATCH
    return n


def estimate_prefill_temp_bytes(cfg, tokens: int) -> int:
    """Coarse temporaries estimate for a ``tokens``-wide prefill chunk the
    engine has not dispatched yet: per-layer activations (residual stream,
    QKV, FFN hidden) plus the logits rows, all f32. Once the chunk has run,
    its measured bytes supersede it (:func:`admission_check`)."""
    act = tokens * (3 * cfg.dim + 2 * cfg.hidden_dim + cfg.q_dim + 2 * cfg.kv_dim)
    return int((act + tokens * cfg.vocab_size) * 4)


def admission_check(*, need_bytes: int, measured_bytes: dict[str, int], extra_bytes: int,
                    what: str, device=None) -> tuple[bool, str]:
    """The admission guard's verdict for one would-be admission:
    ``need_bytes`` (the staging-time estimate) is cross-checked against the
    measured per-program bytes (evidence can only raise the estimate), plus
    ``extra_bytes`` for a program the admission would run for the first
    time. Returns ``(ok, reason)``; always ok when the device limit is
    unknown or ``DLLAMA_SKIP_HBM_CHECK`` is set."""
    limit = _limit(device)
    if limit is None:
        return True, ""
    measured_peak = max(measured_bytes.values(), default=0)
    need = max(need_bytes, measured_peak) + extra_bytes
    if need <= limit:
        return True, ""
    gb = 1024 ** 3
    src = "measured per-program bytes" if measured_peak > need_bytes else "estimate"
    return False, (
        f"HBM admission guard: {what} needs ~{need / gb:.2f} GB per device ({src}"
        + (f" + ~{extra_bytes / gb:.2f} GB for a prefill width not run yet"
           if extra_bytes else "")
        + f") but the device reports {limit / gb:.2f} GB — refusing the admission "
        f"instead of risking an out-of-memory failure mid-step (shrink the prompt, "
        f"lower --batch-slots/--max-seq-len, or set DLLAMA_SKIP_HBM_CHECK=1)")


def check_budget(need_per_device: int, what: str, device=None) -> int | None:
    """Raise a clean, actionable error when the estimate exceeds the device
    limit. Returns the limit (None = unknown, check skipped). Bypass with
    ``DLLAMA_SKIP_HBM_CHECK=1``."""
    limit = _limit(device)
    if limit is not None and need_per_device > limit:
        gb = 1024 ** 3
        raise HbmBudgetError(
            f"{what} needs ~{need_per_device / gb:.1f} GB per device but the device "
            f"reports {limit / gb:.1f} GB — refusing to stage. Quantize (Q40), shrink "
            f"--max-seq-len, use a smaller --weight-mode, or set DLLAMA_SKIP_HBM_CHECK=1 "
            f"to override.")
    return limit
