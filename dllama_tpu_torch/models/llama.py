"""Llama 2/3/3.1 and Qwen3 forward, dense and mixture-of-experts (the port
of the JAX package's ``models/llama.py``, single-device path).

The per-layer graph is the reference's (buildLlmNet, src/llm.cpp:226-443):
[rms_norm, q/k/v matmuls, (qwen3 per-head q/k norms), rope, KV append,
causal GQA attention, wo matmul + residual] + [rms_norm, w1/w3, silu·up, w2
matmul + residual], with the Q80 fake-quant casts at the reference's sync
points when ``cfg.sync_q80`` is on. The JAX package scans a stacked layer
axis inside one jitted program; here a Python loop walks a list of layers
and each op launches eagerly. Tensor parallelism runs with the parameters
of ``parallel.sharding.tp_params`` and a cache split over kv heads under a
``tp`` plan: the matmuls through their shards
(:class:`~dllama_tpu_torch.ops.linear.ShardedWeight`) and attention per
shard (:func:`_tp_rows` and the sharded K3/K4 wrappers), MoE expert
stacks over an ``(ep, tp)`` grid (:func:`_moe_ffn`, the JAX package's
``shard_map`` of ``_moe_ffn_sparse``), every other op on the lead; weight
offload is not ported. The
numerics observatory's activation taps (:func:`forward_with_taps`,
``runtime/numerics.py``) ride the dense forward;
every single-sequence and batched step takes the tripwire's poison selector
(:func:`_poison_logits`) and returns each row's non-finite logits count.
On the card the engine and the paged generator replay a decode step
captured as a CUDA graph (:mod:`dllama_tpu_torch.runtime.graphs`),
the counterpart of the JAX package's one jitted program per step: the steps
here take positions as device tensors and read nothing back to the host.

Kernels on this path: K1/K2 through :func:`~dllama_tpu_torch.ops.linear.linear`
(``cfg.quant_impl``, ``cfg.quant_mode``; K5 for turbo planes) and K3 through
:func:`~dllama_tpu_torch.ops.flash_attention.flash_attention`
(``cfg.attn_impl``); the dense slot pool's ragged steps
(:func:`ragged_sampled_step`, :func:`ragged_verify_step`) are :func:`forward`
over ``n_slots`` rows with a start position each, K3 reading its per-row
position table. The paged family (:func:`paged_forward`,
:func:`paged_sampled_step`, :func:`paged_verify_step`) serves continuous
batching over the block pool
and attends through K4
(:func:`~dllama_tpu_torch.ops.paged_attention.paged_attention`, the same
``cfg.attn_impl`` gate). Under a mesh plan with ``sp > 1`` the dense path
attends through :func:`~dllama_tpu_torch.parallel.ring.sp_attention` over a
:class:`~dllama_tpu_torch.runtime.kvcache.ShardedKVCache` (kernel K3s on
the card) instead of K3. :func:`gather_kv_blocks` and
:func:`scatter_kv_blocks` move whole pool blocks (the host KV tier's spill
and page-in, the KV wire's export and ingest): plain tensor copies, as in the
JAX package.

Mixture of experts (Mixtral, Qwen3-MoE): a layer's FFN is the top-k router
(:func:`_moe_router`) and the sparse expert FFN (:func:`_moe_sparse_local`)
at the one FFN site, :func:`_attn_out_and_ffn`, so every path above runs
MoE with no code of its own. The expert dots keep the JAX package's two
regimes and their threshold (:data:`_MOE_GATHER_MAX_ROWS`), whose numerics
differ: on the CPU their plain versions literally (the per-row gather and
``einsum``; the sort and per-group loop), on the card both through K5
(:func:`~dllama_tpu_torch.ops.moe_matmul.moe_matmul`) over rows sorted by
expert with device-side group offsets, each regime's plane decoder, nothing
read back.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F

from ..formats.mfile import ArchType, HiddenAct
from ..ops.attention import attention
from ..ops.flash_attention import flash_attention, flash_attention_sharded
from ..ops.linear import (Q40_CODES, Q80_CODES, QuantizedWeight, Weight, dequantize_weight,
                          fake_quant_q80, linear)
from ..ops.moe_matmul import moe_matmul
from ..ops.norms import rms_norm, rms_norm_per_head
from ..ops.paged_attention import (paged_attention, paged_attention_plain,
                                   paged_attention_sharded)
from ..parallel.ring import sp_attention
from ..parallel.sharding import kv_heads
from ..runtime import numerics as _numerics
from ..runtime.kvcache import cache_bits, to_cache, update_layer
from .config import ModelConfig
from .rope import apply_rope, build_rope_cache


@dataclass
class LayerParams:
    """One transformer block's weights (dense ``[out, in]``, Q40/Q80 planes
    or turbo planes, K-major ``[in, out]``)."""

    wq: Weight  # [q_dim, dim]
    wk: Weight  # [kv_dim, dim]
    wv: Weight  # [kv_dim, dim]
    wo: Weight  # [dim, q_dim]
    w1: Weight | None  # [hidden_dim, dim] (gate; None for MoE layers)
    w2: Weight | None  # [dim, hidden_dim] (down)
    w3: Weight | None  # [hidden_dim, dim] (up)
    norm_att: torch.Tensor  # [dim]
    norm_ffn: torch.Tensor  # [dim]
    norm_q: torch.Tensor | None = None  # [head_dim] (qwen3)
    norm_k: torch.Tensor | None = None
    # MoE (None for dense models): the router and the expert stacks, IN-major
    # like the JAX package's (a stacked QuantizedWeight / TurboWeight with
    # planes [E, in, out], or a dense tensor [E, in, out])
    moe_gate: torch.Tensor | None = None  # [E, dim] f32
    we1: Weight | None = None  # [E, dim, hidden_dim] (gate)
    we2: Weight | None = None  # [E, hidden_dim, dim] (down)
    we3: Weight | None = None  # [E, dim, hidden_dim] (up)


@dataclass
class Params:
    embedding: torch.Tensor  # [vocab, dim], stored at the compute dtype
    layers: list[LayerParams]
    final_norm: torch.Tensor  # [dim]
    logits: Weight  # [vocab, dim]
    # cos/sin rope tables [seq_len, head_dim/2] f32 on the params' device
    rope: tuple[torch.Tensor, torch.Tensor]


def _use_flash(cfg: ModelConfig, q: torch.Tensor) -> bool:
    """The attention choice of the JAX package's ``_use_flash``: ``xla`` =
    the oracle; ``flash`` = the kernel wrapper; ``auto`` = the kernel wrapper
    on a CUDA tensor (which launches K3 or raises on shapes it cannot take,
    never the oracle) and the oracle on a CPU tensor."""
    if cfg.attn_impl not in ("auto", "xla", "flash"):
        raise ValueError(f"attn_impl must be auto|xla|flash, got {cfg.attn_impl!r}")
    if cfg.attn_impl == "xla":
        return False
    return cfg.attn_impl == "flash" or q.device.type == "cuda"


def _hidden_act(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.hidden_act == HiddenAct.SILU:
        return F.silu(x)
    return F.gelu(x, approximate="tanh")  # reference gelu_F32, nn-cpu-ops.cpp:1133


def _lin(cfg: ModelConfig, x: torch.Tensor, w: Weight) -> torch.Tensor:
    """:func:`linear` under the config's implementation and quant mode."""
    return linear(x, w, impl=cfg.quant_impl, quant_mode=cfg.quant_mode)


def _fq(cfg: ModelConfig):
    return fake_quant_q80 if cfg.sync_q80 else (lambda a: a)


def _attn_qkv(cfg: ModelConfig, x: torch.Tensor, lp: LayerParams,
              cos: torch.Tensor, sin: torch.Tensor, positions, fq):
    """Attention prologue: pre-norm, QKV projections, optional qk-norm,
    rope. Returns post-rope ``q [B, T, n_heads, hd]``, ``k/v [B, T, n_kv, hd]``."""
    B, T, _ = x.shape
    h = fq(rms_norm(x, lp.norm_att, cfg.norm_epsilon))
    q = _lin(cfg, h, lp.wq).reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = _lin(cfg, h, lp.wk).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = _lin(cfg, h, lp.wv).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    if cfg.uses_qk_norm:
        q = rms_norm_per_head(q, lp.norm_q, cfg.norm_epsilon)
        k = rms_norm_per_head(k, lp.norm_k, cfg.norm_epsilon)
    q = apply_rope(q, cos, sin, positions, cfg.rope_type)
    k = apply_rope(k, cos, sin, positions, cfg.rope_type)
    return q, k, v


def _tap_stat(x: torch.Tensor) -> torch.Tensor:
    """Activation stats of one numerics-observatory tap site as a float64
    ``[4]`` tensor in ``numerics.TAP_STATS`` order: rms and abs-max over the
    FINITE lanes (a NaN must show in the non-finite count, not poison the
    statistics), the non-finite lane count, and the relative Q80 roundtrip
    error the sync casts would apply at this boundary (0 when the trailing
    axis is not block-divisible; the JAX package's
    ``parallel.qcollectives.q80_roundtrip_error``)."""
    xf = x.float()
    finite = torch.isfinite(xf)
    nf = (~finite).sum()
    xz = torch.where(finite, xf, torch.zeros_like(xf))
    rms = torch.sqrt(torch.mean(torch.square(xz)))
    absmax = torch.amax(torch.abs(xz))
    if x.shape[-1] % 32 == 0:
        err = fake_quant_q80(xz) - xz
        q80e = torch.sqrt(torch.mean(torch.square(err))) / (rms + 1e-12)
    else:
        q80e = torch.zeros((), device=x.device)
    return torch.stack([rms.double(), absmax.double(), nf.double(), q80e.double()])


def _attn_out_and_ffn(cfg: ModelConfig, x: torch.Tensor, att: torch.Tensor,
                      lp: LayerParams, fq, taps: list | None = None) -> torch.Tensor:
    """Layer epilogue: output projection + residual, then the ffn half.
    With ``taps`` (a list) the ``attn_out`` stats (after the attention
    residual) and ``mlp_out`` stats (after the ffn residual) are appended."""
    B, T, _ = x.shape
    x = x + fq(_lin(cfg, fq(att.reshape(B, T, cfg.q_dim)), lp.wo))
    if taps is not None:
        taps.append(_tap_stat(x))
    # the ffn half (reference ff segment, llm.cpp:369-439; MoE is new)
    h = fq(rms_norm(x, lp.norm_ffn, cfg.norm_epsilon))
    if cfg.is_moe:
        x = x + fq(_moe_ffn(cfg, h, lp))
    else:
        gate = _hidden_act(cfg, _lin(cfg, h, lp.w1))
        up = _lin(cfg, h, lp.w3)
        x = x + fq(_lin(cfg, fq(gate * up), lp.w2))
    if taps is not None:
        taps.append(_tap_stat(x))
    return x


# ---------------------------------------------------------------------------
# Mixture of experts (the JAX package's models/llama.py:175-426)
# ---------------------------------------------------------------------------

# Up to this many (token, expert) rows the JAX package gathers each row's
# expert planes (the decode regime); above it it sorts rows into ragged
# groups. The regimes' numerics differ (turbo planes compute another
# function in each), so the port keeps both and the threshold.
_MOE_GATHER_MAX_ROWS = 32


def _router_sorted(h: torch.Tensor, gate: torch.Tensor):
    """Every expert's router probability, sorted: softmax over the f32
    expert logits (a true f32 product: :func:`linear` runs an f32 dense
    weight at the "highest" precision, never TF32), in ``lax.top_k``'s order
    (descending, ties to the lower expert index: a stable descending sort).
    Returns ``(probs [..., E] f32, idx [..., E] int64)``."""
    logits = linear(h.float(), gate.float())
    probs = torch.softmax(logits, dim=-1)
    return torch.sort(probs, dim=-1, descending=True, stable=True)


def _moe_router(cfg: ModelConfig, h: torch.Tensor, gate: torch.Tensor):
    """Top-k routing: the k largest router probabilities
    (:func:`_router_sorted`), then renormalized to sum to 1
    (``cfg.moe_norm_topk``) or kept raw. Returns ``(weights [..., k] f32,
    idx [..., k] int64)``."""
    top, idx = _router_sorted(h, gate)
    top, idx = top[..., :cfg.n_active_experts], idx[..., :cfg.n_active_experts]
    if cfg.moe_norm_topk:
        top = top / torch.sum(top, dim=-1, keepdim=True)
    return top, idx


def _experts_dense(we, x: torch.Tensor, rows: torch.Tensor | None = None,
                   quant_mode: str = "auto") -> torch.Tensor:
    """Dense ``[..., in, out]`` planes of an expert stack, optionally gathered
    at ``rows`` along the expert axis first (the quantized planes are
    gathered, then expanded). Q40/Q80 planes dequantize at bf16 when fast
    (the mode, or bf16 scales), else at ``x``'s dtype; turbo planes as the
    bf16 product ``bf16(w8) * bf16(scale)``; dense planes as they are."""
    from ..ops.linear import _fast_mode
    from ..ops.turbo import TurboWeight

    if isinstance(we, QuantizedWeight):
        if rows is not None:
            we = QuantizedWeight(scales=we.scales[rows], codes=we.codes[rows], kind=we.kind)
        fast = _fast_mode(x, quant_mode) or we.scales.dtype == torch.bfloat16
        return dequantize_weight(we, torch.bfloat16 if fast else x.dtype)
    if isinstance(we, TurboWeight):
        w8 = we.w8 if rows is None else we.w8[rows]
        scale = we.scale if rows is None else we.scale[rows]
        return w8.to(torch.bfloat16) * scale[..., None, :].to(torch.bfloat16)
    return we if rows is None else we[rows]


def _expert_gather_dot(x: torch.Tensor, we, rows: torch.Tensor,
                       quant_mode: str = "auto") -> torch.Tensor:
    """``y[n] = x[n] @ plane(rows[n])``, the decode regime's per-row expert
    dot, literally (the plain version: the card runs this regime through
    K5). ``x [N, D]``; f32 ``[N, out]``. Turbo planes run their integer dot
    (a8, exact sums) or bf16 times int8 (a16), the scale in the epilogue."""
    from ..ops.turbo import TurboWeight, quantize_activations_a8

    if isinstance(we, TurboWeight):
        w8, scale = we.w8[rows], we.scale[rows]        # [N, D, out], [N, out]
        if we.a8:
            xq, sx = quantize_activations_a8(x)
            acc = torch.einsum("nd,ndh->nh", xq.double(), w8.double())  # exact
            return acc.float() * sx * scale
        acc = torch.einsum("nd,ndh->nh", x.to(torch.bfloat16).float(), w8.float())
        return acc * scale
    w = _experts_dense(we, x, rows, quant_mode)
    return torch.einsum("nd,ndh->nh", x.to(w.dtype).float(), w.float())


def _moe_ffn_dense(cfg: ModelConfig, h: torch.Tensor, lp: LayerParams) -> torch.Tensor:
    """All-experts FFN, gate-weighted: O(E) work, exact and simple — the
    oracle the tests hold the sparse path against (the JAX package's
    ``moe_impl="dense"``; the port has no switch to it)."""
    weights, idx = _moe_router(cfg, h, lp.moe_gate)
    one_hot = F.one_hot(idx, cfg.n_experts).float()                 # [B, T, k, E]
    gates = torch.einsum("btke,btk->bte", one_hot, weights)
    ht = h.to(getattr(torch, cfg.compute_dtype))

    def mm(eq, a, b, *rest):
        dt = torch.promote_types(a.dtype, b.dtype)
        return torch.einsum(eq, a.to(dt), b.to(dt), *(r.to(dt) for r in rest))

    we1 = _experts_dense(lp.we1, ht, quant_mode=cfg.quant_mode)
    we2 = _experts_dense(lp.we2, ht, quant_mode=cfg.quant_mode)
    we3 = _experts_dense(lp.we3, ht, quant_mode=cfg.quant_mode)
    h1 = mm("btd,edh->bteh", ht, we1)
    h3 = mm("btd,edh->bteh", ht, we3)
    a = _hidden_act(cfg, h1) * h3
    y = mm("bteh,ehd,bte->btd", a, we2, gates.to(ht.dtype))
    return y.to(h.dtype)


def _expert_decoder(we, x_dtype: torch.dtype, quant_mode: str, gather: bool):
    """K5's plane decoder for one projection in one regime, and its ``fast``
    flag and the dtype the regime casts the next projection's activations
    to: the JAX package's ``_experts_dense`` / ``_expert_gather_dot`` rules
    (Q40/Q80: bf16 dequant when fast or the activations are bf16; turbo:
    the integer or bf16 x int8 dot in the gather regime, the pre-scaled bf16
    planes in the ragged regime)."""
    from ..ops.linear import fast_numerics_resolved
    from ..ops.turbo import TurboWeight

    if isinstance(we, QuantizedWeight):
        fast = (fast_numerics_resolved("bfloat16" if x_dtype == torch.bfloat16
                                       else "float32", quant_mode)
                or we.scales.dtype == torch.bfloat16)
        wdt = torch.bfloat16 if fast else x_dtype
        return "q", wdt == torch.bfloat16, wdt
    if isinstance(we, TurboWeight):
        if gather:
            return ("a8" if we.a8 else "a16"), False, torch.bfloat16
        return "prescaled", False, torch.bfloat16
    return "dense", False, we.dtype


def _moe_sparse_local(cfg: ModelConfig, x: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor, we1, we2, we3, e_lo: int = 0,
                      e_local: int | None = None) -> torch.Tensor:
    """Sparse MoE over the experts ``[e_lo, e_lo + e_local)`` (all of them by
    default) of the stacks ``we1/we2/we3`` (this shard's: ``e_local``
    experts, any slice of the hidden axis): ``x [N, D]``, ``idx/weights [N,
    k]``; one row per (token, k), O(k) experts of work a token. Returns the
    sum over k ``[N, D]`` at ``x``'s dtype, a partial when the stacks are a
    shard's (the JAX package casts its shards' partials so too).

    The JAX package's two regimes: at ``N * k <= 32`` rows each row gathers
    its expert's planes (:func:`_expert_gather_dot`), above that rows are
    sorted by expert into ragged groups. On a CPU tensor each regime runs
    its plain version literally (the ragged one through K5's wrapper, whose
    plain version is the per-group loop). On the card both regimes sort the
    rows (a stable ``torch.sort``), count each expert's rows with
    ``scatter_add_`` (``bincount`` would synchronise), take the offsets by
    ``cumsum`` and run K5 with the regime's decoder; rows are unsorted,
    scaled by their router weight and summed over k. Nothing is read back,
    so the step replays as a CUDA graph.

    Rows routed to another shard's experts contribute 0, as in the JAX
    package (which clamps them to local expert 0 with weight 0): here they
    sort past the last group, which K5 does not write, and a ``torch.where``
    zeroes them (an unwritten row times a weight of 0 could be NaN); the
    CPU gather regime computes them at local expert 0 and zeroes them the
    same way."""
    N, k = idx.shape
    qm = cfg.quant_mode
    e_local = cfg.n_experts if e_local is None else e_local
    flat_e = idx.reshape(N * k)
    flat_w = weights.reshape(N * k)
    valid = None
    if e_lo != 0 or e_local != cfg.n_experts:
        flat_e = flat_e - e_lo
        valid = (flat_e >= 0) & (flat_e < e_local)
        flat_e = torch.where(valid, flat_e, e_local)  # past the last group
    x_rep = x[torch.arange(N * k, device=x.device) // k]  # a row per (token, k)
    gather = N * k <= _MOE_GATHER_MAX_ROWS

    if gather and x.device.type == "cpu":
        rows = flat_e if valid is None else torch.where(valid, flat_e, 0)
        h1 = _expert_gather_dot(x_rep, we1, rows, qm)
        h3 = _expert_gather_dot(x_rep, we3, rows, qm)
        a = (_hidden_act(cfg, h1) * h3).to(x.dtype)
        y = _expert_gather_dot(a, we2, rows, qm)
    else:
        order = torch.sort(flat_e, stable=True).indices   # group rows by expert
        counts = torch.zeros(e_local + 1, dtype=torch.int32, device=x.device)
        counts.scatter_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
        offsets = torch.cat([counts.new_zeros(1),
                             torch.cumsum(counts[:e_local], 0, dtype=torch.int32)])
        xs = x_rep[order]

        def dot(inp, we):
            dec, fast, _ = _expert_decoder(we, inp.dtype, qm, gather)
            return moe_matmul(inp, we, offsets, decoder=dec, fast=fast)

        h1, h3 = dot(xs, we1), dot(xs, we3)
        # the gather regime casts the activations to x's dtype, the ragged
        # one to the dtype of we2's dense planes
        cast = x.dtype if gather else _expert_decoder(we2, xs.dtype, qm, gather)[2]
        ys = dot((_hidden_act(cfg, h1) * h3).to(cast), we2)
        y = torch.empty_like(ys).index_copy_(0, order, ys)   # unsort to [N * k]
    y = y * flat_w[:, None]
    if valid is not None:
        y = torch.where(valid[:, None], y, torch.zeros((), dtype=y.dtype, device=y.device))
    return torch.sum(y.reshape(N, k, -1), dim=1).to(x.dtype)


def _moe_ffn(cfg: ModelConfig, h: torch.Tensor, lp: LayerParams) -> torch.Tensor:
    """Mixture-of-experts SwiGLU FFN, the sparse path (the JAX package's
    ``moe_impl="sparse"``): O(k) experts a token. ``h [B, T, D]``.

    With the expert stacks over an ``(ep, tp)`` grid
    (:class:`~dllama_tpu_torch.ops.linear.ExpertShards`, the JAX package's
    ``shard_map`` of ``_moe_ffn_sparse``): the router runs on the lead over
    the whole activations, as at tp = 1; each shard ``(i, j)`` runs the local
    dispatch of :func:`_moe_sparse_local` over its experts and its slice of
    the hidden axis (the activation is elementwise over it, so each shard's
    ``act(h1) * h3`` is exact), on its device, K5 once a projection; the
    shards' partials come back to the lead and are summed in f32 in rank
    order (the port's f32 wire), and the sum is cast after it, as
    :func:`~dllama_tpu_torch.ops.linear.merge_shards` does. A hidden axis
    that does not divide by tp runs the dense oracle instead, as the JAX
    package's ``_moe_ffn`` does."""
    from ..ops.linear import ExpertShards, _merge_span, _note_merge

    B, T, D = h.shape
    sharded = isinstance(lp.we1, ExpertShards)
    if sharded and lp.we1.oracle:
        return _moe_ffn_dense(cfg, h, replace(lp, we1=lp.we1.shards[0], we2=lp.we2.shards[0],
                                              we3=lp.we3.shards[0]))
    weights, idx = _moe_router(cfg, h, lp.moe_gate)
    dt = getattr(torch, cfg.compute_dtype)
    x = h.to(dt).reshape(B * T, D)
    idx2, w2 = idx.reshape(B * T, -1), weights.to(dt).reshape(B * T, -1)
    if not sharded:
        y = _moe_sparse_local(cfg, x, idx2, w2, lp.we1, lp.we2, lp.we3)
        return y.reshape(B, T, D).to(h.dtype)
    ep, shards = lp.we1.ep, len(lp.we1.shards)
    e_local = cfg.n_experts // ep
    with _merge_span():
        ins = [tuple(t.to(_expert_device(we)) for t in (x, idx2, w2)) for we in lp.we1.shards]
    parts = [_moe_sparse_local(cfg, *a, w1, w2_, w3, (s * ep // shards) * e_local, e_local)
             for s, (a, w1, w2_, w3) in enumerate(zip(ins, lp.we1.shards, lp.we2.shards,
                                                       lp.we3.shards))]
    with _merge_span():
        y = parts[0].to(x.device, torch.float32)
        for p in parts[1:]:
            y = y + p.to(x.device, torch.float32)
    _note_merge("sum", [t for a in ins[1:] for t in a], parts[1:])
    return y.to(dt).reshape(B, T, D).to(h.dtype)


def _expert_device(we) -> torch.device:
    from ..parallel.sharding import _expert_plane

    return _expert_plane(we).device


def _sp(plan) -> bool:
    return plan is not None and plan.axis_size("sp") > 1


def _tp(plan) -> bool:
    return plan is not None and plan.axis_size("tp") > 1


def _tp_rows(cfg: ModelConfig, k_caches: list, v_caches: list, k: torch.Tensor,
             v: torch.Tensor):
    """Each tp shard's ``(k cache, v cache, k rows, v rows)``: its kv heads
    (``parallel.sharding.kv_heads``) of the new rows ``k/v [B, T, n_kv, hd]``
    on the lead, moved to the shard's device, for the caller to append."""
    tp = len(k_caches)
    for j, (kc, vc) in enumerate(zip(k_caches, v_caches)):
        hs = kv_heads(cfg, tp, j)
        yield kc, vc, k[:, :, hs].to(kc.device), v[:, :, hs].to(kc.device)


def _scatter_rows(k_pool: torch.Tensor, v_pool: torch.Tensor, blk: torch.Tensor,
                  off: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write ``k/v [B, T, n_kv, hd]`` into this layer's pool cells ``(blk,
    off)`` (``index_put_``), on the pool's device."""
    blk, off = blk.to(k_pool.device), off.to(k_pool.device)
    cache_bits(k_pool)[blk, :, off] = cache_bits(to_cache(k, k_pool.dtype))
    cache_bits(v_pool)[blk, :, off] = cache_bits(to_cache(v, v_pool.dtype))


def _layer_step(cfg: ModelConfig, x: torch.Tensor, lp: LayerParams,
                k_cache, v_cache, cos: torch.Tensor, sin: torch.Tensor,
                start_pos, positions, plan=None, taps: list | None = None):
    """One transformer block. ``x: [B, T, dim]``; this layer's caches are
    head-major ``[B, n_kv, S, hd]`` and are written in place. Under a plan
    with ``sp > 1`` they are the per-shard lists ``[B, n_kv, S_l, hd]`` and
    the sequence-parallel attention both appends and attends. Under a plan
    with ``tp > 1`` they are the per-shard lists ``[B, n_kv_l, S, hd]`` of a
    cache split over kv heads: each shard appends its heads and attends its
    q heads (K3 per shard), and the matmuls run per shard through
    ``lp``'s :class:`~dllama_tpu_torch.ops.linear.ShardedWeight`s; every
    other op runs on the lead, over whole activations, so the Q80 casts
    quantize the same blocks as at tp = 1. ``taps``: see
    :func:`_attn_out_and_ffn`."""
    fq = _fq(cfg)
    q, k, v = _attn_qkv(cfg, x, lp, cos, sin, positions, fq)
    if _sp(plan):
        att = sp_attention(plan, q, k_cache, v_cache, k, v, _position_tensor(positions, q),
                           start_pos, cfg.head_dim, attn_impl=cfg.attn_impl)
        return _attn_out_and_ffn(cfg, x, att, lp, fq, taps)
    if _tp(plan):
        for kc, vc, kj, vj in _tp_rows(cfg, k_cache, v_cache, k, v):
            update_layer(kc, vc, kj, vj, start_pos)
        att = flash_attention_sharded(
            q, k_cache, v_cache, start_pos, cfg.head_dim,
            None if _use_flash(cfg, q) else _position_tensor(positions, q))
        return _attn_out_and_ffn(cfg, x, att, lp, fq, taps)
    update_layer(k_cache, v_cache, k, v, start_pos)
    if _use_flash(cfg, q):
        att = flash_attention(q, k_cache, v_cache, start_pos, cfg.head_dim)
    else:
        att = attention(q, k_cache, v_cache, _position_tensor(positions, q),
                        cfg.head_dim)
    return _attn_out_and_ffn(cfg, x, att, lp, fq, taps)


def _position_tensor(positions, q: torch.Tensor) -> torch.Tensor:
    """``[B, T]`` positions from a table slice (uniform rows) or tensor."""
    if isinstance(positions, slice):
        B, T = q.shape[:2]
        return torch.arange(positions.start, positions.stop,
                            device=q.device).expand(B, T)
    return positions


def rope_tables(cfg: ModelConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    cos, sin = build_rope_cache(cfg)
    return (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            start_pos: int | torch.Tensor, kv, plan=None) -> tuple[torch.Tensor, object]:
    """Full forward: ``tokens [B, T]`` at absolute ``start_pos`` → float32
    logits ``[B, T, vocab]``; ``kv`` is updated in place and returned.

    ``start_pos`` is an int (all rows at one position) or an int tensor
    ``[B]`` of per-row positions. With a ``plan`` of ``sp > 1`` (the JAX
    package's ``use_plan``), ``kv`` is a
    :class:`~dllama_tpu_torch.runtime.kvcache.ShardedKVCache` and
    everything but attention runs on the plan's lead device, where
    ``params`` and ``tokens`` live. With a plan of ``tp > 1``, ``params``
    comes from ``parallel.sharding.tp_params`` (or the loader under the
    plan) and ``kv`` is a
    :class:`~dllama_tpu_torch.runtime.kvcache.HeadShardedKVCache`: the
    matmuls and attention run per shard, the rest on the lead.

    Under :func:`~dllama_tpu_torch.runtime.numerics.collecting_taps` (see
    :func:`forward_with_taps`) the return gains the taps dict as a third
    element; otherwise no tap code runs.
    """
    collect = _numerics.taps_active()
    B, T = tokens.shape
    x = params.embedding[tokens].to(getattr(torch, cfg.compute_dtype))
    cos, sin = params.rope
    if torch.is_tensor(start_pos):
        positions = start_pos.to(x.device).long()[:, None] + torch.arange(
            T, device=x.device)[None, :]
    else:
        positions = slice(int(start_pos), int(start_pos) + T)
    layer_taps: list | None = [] if collect else None
    for l, lp in enumerate(params.layers):
        k_l, v_l = kv.layer(l)
        x = _layer_step(cfg, x, lp, k_l, v_l, cos, sin, start_pos, positions, plan,
                        layer_taps)
    x = rms_norm(x, params.final_norm, cfg.norm_epsilon)
    final_stat = _tap_stat(x) if collect else None
    if cfg.sync_q80:  # final cast before the logits matmul (llm.cpp:445-486)
        x = fake_quant_q80(x)
    logits = _lin(cfg, x, params.logits).float()
    if collect:
        taps = {"attn_out": torch.stack(layer_taps[0::2]),
                "mlp_out": torch.stack(layer_taps[1::2]),
                "final_norm": final_stat, "logits": _tap_stat(logits)}
        return logits, kv, taps
    return logits, kv


def forward_with_taps(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                      start_pos, kv, plan=None):
    """:func:`forward` with the numerics observatory's activation taps
    collected: returns ``((logits, taps), kv)``, ``taps`` the per-site stats
    (``attn_out``/``mlp_out`` ``[L, 4]``, ``final_norm``/``logits`` ``[4]``,
    each row in ``numerics.TAP_STATS`` order; see :func:`_tap_stat` and
    ``numerics.taps_to_host``). The taps only read the activations: the
    logits are the untapped forward's, bit for bit."""
    with _numerics.collecting_taps():
        logits, kv, taps = forward(params, cfg, tokens, start_pos, kv, plan)
    return (logits, taps), kv


def _poison_logits(logits: torch.Tensor, poison) -> torch.Tensor:
    """Inject the tripwire's poison into the logits on the device: 0 = clean
    passthrough, 1 = NaN, 2 = +Inf (``numerics.POISON_CODES``); codes >= 3
    belong to the JAX package's ``wire`` failpoint and pass through clean.
    ``poison`` is a Python float (a clean 0.0 launches nothing) or a device
    scalar, which a captured step reads at every replay."""
    if not torch.is_tensor(poison):
        if poison == 0.0:
            return logits
        poison = torch.full((), float(poison), device=logits.device)
    p = poison.reshape(())
    # built on the device from the selector (no host tensor: a captured
    # step may copy nothing from the host)
    val = torch.full_like(p, float("nan")).masked_fill(p >= 2.0, float("inf"))
    hit = (p > 0.0) & (p < 3.0)
    return torch.where(hit, val.to(logits.dtype), logits)


def greedy_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                start_pos, kv, plan=None, poison=0.0
                ) -> tuple[torch.Tensor, torch.Tensor, object]:
    """Forward + argmax of the last position (the JAX package's
    ``greedy_step_guarded``): next token ids ``[B]``, the non-finite lane
    count of each row's decode-step logits ``[B]`` (after ``poison``,
    :func:`_poison_logits`), and the cache."""
    logits, kv = forward(params, cfg, tokens, start_pos, kv, plan)
    last = _poison_logits(logits[:, -1, :], poison)
    return torch.argmax(last, dim=-1), _nonfinite_rows(last), kv


def verify_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                start_pos, kv, plan=None, poison=0.0
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, object]:
    """Speculative greedy verify: ONE forward over ``tokens [B, K+1]`` (the
    real next input followed by K drafted tokens) at positions
    ``start_pos..start_pos+K``. ``preds[:, t]`` is the greedy argmax after
    consuming ``tokens[:, :t+1]`` and ``n_acc [B]`` the longest draft
    prefix the model agrees with (``tokens[:, i+1] == preds[:, i]``); the
    caller emits ``preds[:, :n_acc+1]``, what ``n_acc + 1`` sequential
    :func:`greedy_step` calls would produce, for one pass over the weights.

    Rows written for rejected drafts sit at positions past the committed
    point, invisible to the causal mask, and the next dispatch's writes
    start where they start. Returns ``(n_acc, preds, nonfinite, kv)``
    (int64; ``nonfinite [B]`` counts the non-finite lanes of all K+1 logits
    rows after ``poison``, every one of which can become an emitted token:
    the JAX package's ``verify_step_guarded``)."""
    logits, kv = forward(params, cfg, tokens, start_pos, kv, plan)
    logits = _poison_logits(logits, poison)
    preds = torch.argmax(logits, dim=-1)                 # [B, K+1]
    ok = (tokens[:, 1:] == preds[:, :-1]).long()
    return torch.cumprod(ok, dim=-1).sum(dim=-1), preds, _nonfinite_rows(logits), kv


def sampled_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 start_pos, kv, temperature, topp, coin, plan=None, poison=0.0
                 ) -> tuple[torch.Tensor, torch.Tensor, object]:
    """Forward + temperature/top-p sample of the last position; the host
    steps its xorshift* RNG and passes the coin in. Returns ``(token [B],
    nonfinite [B], kv)`` as :func:`greedy_step` does."""
    from ..ops.sampling import sampled_token

    logits, kv = forward(params, cfg, tokens, start_pos, kv, plan)
    last = _poison_logits(logits[:, -1, :], poison)
    return sampled_token(last, temperature, topp, coin), _nonfinite_rows(last), kv


def scan_decode(step1, token: torch.Tensor, start_pos, kv, n_steps: int, coins=None):
    """The multi-step decode loop shared by the chunked variants (the JAX
    package's ``_scan_decode_guarded``, a ``lax.scan``; here a Python loop):
    feeds each picked token into the next forward on the device, with
    nothing read back. ``step1(tokens_2d, pos, kv[, coin])`` is the
    single-step function returning ``(token, nonfinite, kv)``; ``start_pos``
    an int or a ``[B]`` tensor; ``coins`` indexed along axis 0
    (``[n_steps]`` or ``[n_steps, B]``). Returns ``(tokens [B, n_steps],
    nonfinite [B], kv)``, the per-row non-finite counts summed over the
    chunk."""
    toks = []
    nf = torch.zeros(token.shape, dtype=torch.int32, device=token.device)
    for i in range(n_steps):
        if coins is None:
            token, nf_i, kv = step1(token[:, None], start_pos + i, kv)
        else:
            token, nf_i, kv = step1(token[:, None], start_pos + i, kv, coins[i])
        nf = nf + nf_i
        toks.append(token)
    return torch.stack(toks, dim=1), nf, kv


def greedy_steps(params: Params, cfg: ModelConfig, token: torch.Tensor, start_pos,
                 kv, n_steps: int, plan=None, poison=0.0
                 ) -> tuple[torch.Tensor, torch.Tensor, object]:
    """``n_steps`` greedy decode steps with the tokens fed back on the
    device and one readback per chunk (by the caller); bit-identical to
    ``n_steps`` :func:`greedy_step` calls. ``token: [B]`` seeds the chunk;
    the caller truncates at EOS. Returns ``(tokens, nonfinite, kv)``
    (:func:`scan_decode`); ``poison`` applies to every step."""
    return scan_decode(lambda t, p, kv: greedy_step(params, cfg, t, p, kv, plan, poison),
                       token, start_pos, kv, n_steps)


def sampled_steps(params: Params, cfg: ModelConfig, token: torch.Tensor, start_pos,
                  kv, temperature, topp, coins, n_steps: int, plan=None, poison=0.0
                  ) -> tuple[torch.Tensor, torch.Tensor, object]:
    """The temperature > 0 twin of :func:`greedy_steps`: ``coins
    [n_steps]`` are the host xorshift draws of the whole chunk (the host
    rewinds its RNG to the count kept after EOS truncation).

    Also the ragged chunked step of the dense slot pool (the JAX package's
    ``BatchedGenerator.step_chunk``): everything broadcasts over rows —
    ``token``/``start_pos [B]``, per-row ``temperature``/``topp [B]``
    (rows at temperature <= 0 take the argmax) and ``coins [n_steps, B]``.
    Returns ``(tokens, nonfinite, kv)``."""
    return scan_decode(
        lambda t, p, kv, c: sampled_step(params, cfg, t, p, kv, temperature, topp, c, plan,
                                         poison),
        token, start_pos, kv, n_steps, coins=coins)


def ragged_sampled_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                        pos_vec: torch.Tensor, kv, temps, topps, coins, poison=0.0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense slot pool's ragged decode step (the JAX package's
    ``sampled_step_guarded`` over ragged rows): one :func:`forward` of
    ``tokens [B, 1]`` at per-row positions ``pos_vec [B]`` over the slot
    pool's cache, then per-row on-device sampling (rows with ``temps <= 0``
    take the argmax). Returns ``(token [B], nonfinite [B])``, the second the
    non-finite lane count of each row's logits after ``poison``
    (:func:`_poison_logits`). The cache is updated in place."""
    from ..ops.sampling import sampled_token

    logits, _ = forward(params, cfg, tokens, pos_vec, kv)
    last = _poison_logits(logits[:, -1, :], poison)
    return sampled_token(last, temps, topps, coins), _nonfinite_rows(last)


def ragged_verify_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                       pos_vec: torch.Tensor, kv, temps, topps, coins, poison=0.0
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dense slot pool's speculative verify step (the JAX package's
    ``ragged_verify_step``): ONE :func:`forward` over ragged rows ``tokens
    [B, K+1]`` at per-row positions ``pos_vec [B]``. Greedy rows (``temps
    <= 0``) accept the longest draft prefix their argmax agrees with, as
    :func:`verify_step` does; sampled rows spend their one coin on the
    position-0 logits and accept nothing, so their tokens and coin streams
    equal the plain ragged step's. Returns ``(n_acc [B], preds [B, K+1],
    nonfinite [B])`` (the non-finite lanes of each row's K+1 logits rows);
    the caller emits ``preds[b, : n_acc[b] + 1]``. The cache is updated in
    place; rows written for rejected drafts sit past the committed point."""
    from ..ops.sampling import sampled_token

    logits, _ = forward(params, cfg, tokens, pos_vec, kv)
    logits = _poison_logits(logits, poison)
    preds = torch.argmax(logits, dim=-1)                 # [B, K+1]
    ok = (tokens[:, 1:] == preds[:, :-1]).long()
    n_acc = torch.cumprod(ok, dim=-1).sum(dim=-1)
    temps = torch.as_tensor(temps, device=logits.device)
    n_acc = torch.where(temps <= 0.0, n_acc, torch.zeros_like(n_acc))
    first = sampled_token(logits[:, 0], temps, topps, coins)
    preds = torch.cat([first[:, None], preds[:, 1:]], dim=1)  # greedy rows: first == argmax
    return n_acc, preds, _nonfinite_rows(logits)


def nll_from_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position negative log-likelihood ``logsumexp(logits) - logits[target]``
    for ``logits [B, T, vocab]`` float32 and ``targets [B, T]``."""
    m = torch.amax(logits, dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    picked = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return lse - picked


def prefill_nll(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                targets: torch.Tensor, start_pos, kv, plan=None
                ) -> tuple[torch.Tensor, object]:
    """Teacher-forced prefill: per-position NLL ``[B, T]`` plus the cache."""
    logits, kv = forward(params, cfg, tokens, start_pos, kv, plan)
    return nll_from_logits(logits, targets), kv


# ---------------------------------------------------------------------------
# Paged program family (runtime/kvblocks.py): the continuous-batching decode
# step reaches each row's context through a block table over the pool
# ---------------------------------------------------------------------------


def _paged_layer_step(cfg: ModelConfig, x: torch.Tensor, lp: LayerParams,
                      k_pool, v_pool, cos: torch.Tensor, sin: torch.Tensor,
                      positions: torch.Tensor, tables: torch.Tensor,
                      write_lens: torch.Tensor | None = None, plan=None) -> torch.Tensor:
    """One transformer block over the paged cache. ``k_pool/v_pool
    [n_blocks, n_kv, bs, hd]`` is this layer's slice of the pool, written in
    place; ``tables [B, M]`` (int64) maps each row's logical block to a
    physical block (0 = the null block). The new K/V rows scatter into
    their (block, offset) cells — inactive rows carry all-null tables, so
    their ride-along writes land in block 0; the only duplicate targets are
    there, whose contents are never read unmasked, so ``index_put_``
    without ``accumulate`` is safe — then K4 (or its plain gather + oracle)
    attends through the table. With ``write_lens [B]`` (the ragged verify
    step) lane ``t`` of row ``b`` is a real input only while ``t <=
    write_lens[b]``: the lanes past it carry padding, and their writes go
    to the null block, since the host allocated blocks only up to ``pos +
    write_lens``. ``positions`` may pass the context (see
    :func:`paged_forward`): the rope rows and the block-table entry are
    read at the clamped position (XLA clamps out-of-range gathers, torch
    raises), the attention mask takes the position itself. Under a plan
    with ``tp > 1`` the pools are the per-shard lists ``[n_blocks, n_kv_l,
    bs, hd]`` of a pool split over kv heads: every shard scatters its heads
    into the same cells and runs K4 on its q heads, through the one table."""
    fq = _fq(cfg)
    inside = positions.clamp(max=cos.shape[0] - 1)
    q, k, v = _attn_qkv(cfg, x, lp, cos, sin, inside, fq)
    bs = (k_pool[0] if _tp(plan) else k_pool).shape[2]
    blk = torch.gather(tables, 1, (positions // bs).clamp_(max=tables.shape[1] - 1))  # [B, T]
    if write_lens is not None:
        lane = torch.arange(positions.shape[1], device=blk.device)[None, :]
        blk = torch.where(lane <= write_lens[:, None], blk, torch.zeros_like(blk))
    off = positions % bs
    if _tp(plan):
        for kp, vp, kj, vj in _tp_rows(cfg, k_pool, v_pool, k, v):
            _scatter_rows(kp, vp, blk, off, kj, vj)
        att = paged_attention_sharded(q, k_pool, v_pool, tables, positions, cfg.head_dim,
                                      kernel=_use_flash(cfg, q))
        return _attn_out_and_ffn(cfg, x, att, lp, fq)
    _scatter_rows(k_pool, v_pool, blk, off, k, v)
    if _use_flash(cfg, q):
        att = paged_attention(q, k_pool, v_pool, tables, positions, cfg.head_dim)
    else:
        att = paged_attention_plain(q, k_pool, v_pool, tables, positions, cfg.head_dim)
    return _attn_out_and_ffn(cfg, x, att, lp, fq)


def paged_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  pos_vec: torch.Tensor, pkv, tables: torch.Tensor,
                  write_lens: torch.Tensor | None = None, plan=None
                  ) -> tuple[torch.Tensor, object]:
    """Full forward over the paged pool: ``tokens [B, T]`` at per-row
    ``pos_vec [B]`` through block ``tables [B, max_blocks]``. Returns
    float32 logits ``[B, T, vocab]`` and the pool
    (:class:`~dllama_tpu_torch.runtime.kvblocks.PagedKVCache`), updated in
    place. An inactive row may carry its previous occupant's stale
    position, up to ``seq_len``, and a verify row's padded lanes may reach
    past the context: their writes land in the null block and their outputs
    are never read, and :func:`_paged_layer_step` clamps the gathers they
    make as the JAX package's XLA gathers do. ``write_lens [B]``: see
    :func:`_paged_layer_step`. With a ``plan`` of ``tp > 1``, ``pkv`` is a
    :class:`~dllama_tpu_torch.runtime.kvblocks.ShardedPagedKVCache`."""
    if _numerics.taps_active():
        raise ValueError("numerics taps are unsupported on the paged KV path (taps run "
                         "on the engine's prefill and the canary)")
    B, T = tokens.shape
    x = params.embedding[tokens].to(getattr(torch, cfg.compute_dtype))
    cos, sin = params.rope
    positions = (pos_vec.to(x.device).long()[:, None]
                 + torch.arange(T, device=x.device)[None, :])
    tables = tables.to(x.device).long()
    if write_lens is not None:
        write_lens = write_lens.to(x.device).long()
    for l, lp in enumerate(params.layers):
        k_l, v_l = pkv.layer(l)
        x = _paged_layer_step(cfg, x, lp, k_l, v_l, cos, sin, positions, tables,
                              write_lens, plan)
    x = rms_norm(x, params.final_norm, cfg.norm_epsilon)
    if cfg.sync_q80:
        x = fake_quant_q80(x)
    logits = _lin(cfg, x, params.logits).float()
    return logits, pkv


def block_ids(ids, device) -> torch.Tensor:
    """Host block ids as an int64 index tensor on ``device``. On a card the
    ids go through page-locked memory with a non-blocking copy (the caching
    host allocator holds the staging block until the copy has run), so
    naming blocks never synchronises the host with the card."""
    t = torch.tensor(list(ids), dtype=torch.long)
    device = torch.device(device)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def gather_kv_blocks(pkv, ids) -> tuple[torch.Tensor, torch.Tensor]:
    """Physical blocks ``ids`` (host ints) out of the pool as one contiguous
    chunk per plane, ``(k, v)`` each ``[L, len(ids), n_kv, bs, hd]``: one
    ``index_select`` a plane. The device side of a KV-tier spill and of a
    KV-wire export. The chunk is the pool's :func:`cache_bits` (an e4m3
    pool moves as its bytes), a new tensor, so the pool may reuse the
    source blocks right after."""
    idx = block_ids(ids, pkv.k.device)
    return (cache_bits(pkv.k).index_select(1, idx),
            cache_bits(pkv.v).index_select(1, idx))


def scatter_kv_blocks(pkv, chunk_k: torch.Tensor, chunk_v: torch.Tensor, ids) -> None:
    """Write a chunk ``[L, len(ids), n_kv, bs, hd]`` (the pool's
    :func:`cache_bits` dtype) into the pool at physical blocks ``ids``
    (host ints), IN PLACE: the captured decode graphs replay against the
    pool's storage, so the pool is never rebound. Lanes a caller does not
    want name the null block (id 0), whose contents are value-invisible.
    The device side of a KV-tier page-in and of a KV-wire ingest."""
    idx = block_ids(ids, pkv.k.device)
    cache_bits(pkv.k).index_copy_(1, idx, chunk_k.to(pkv.k.device, non_blocking=True))
    cache_bits(pkv.v).index_copy_(1, idx, chunk_v.to(pkv.v.device, non_blocking=True))


def _nonfinite_rows(logits: torch.Tensor) -> torch.Tensor:
    """Per-row count of non-finite lanes: ``[B, ...] -> [B]`` int32."""
    bad = ~torch.isfinite(logits)
    return bad.reshape(bad.shape[0], -1).sum(dim=1).to(torch.int32)


def paged_sampled_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                       pos_vec: torch.Tensor, pkv, tables: torch.Tensor,
                       temps, topps, coins, poison=0.0, plan=None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The paged ragged decode step of continuous batching: one
    :func:`paged_forward` for every slot, then per-row on-device sampling
    (rows with ``temps <= 0`` take the argmax). Returns ``(token [B],
    nonfinite [B])``: the non-finite lane count of each row's logits, so a
    poisoned request can be failed without touching the rest of the batch
    (after ``poison``, :func:`_poison_logits`). The pool is updated in
    place."""
    from ..ops.sampling import sampled_token

    logits, _ = paged_forward(params, cfg, tokens, pos_vec, pkv, tables, plan=plan)
    last = _poison_logits(logits[:, -1, :], poison)
    return sampled_token(last, temps, topps, coins), _nonfinite_rows(last)


def paged_verify_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                      pos_vec: torch.Tensor, pkv, tables: torch.Tensor,
                      lens: torch.Tensor, temps, topps, acoins, fcoins, poison=0.0,
                      plan=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The paged speculative verify step of continuous batching: one
    :func:`paged_forward` over ``tokens [B, K+1]`` (each row: its committed
    next token and its proposer's drafts, padded past the row's ``lens
    [B]`` draft length) with writes past ``lens`` sent to the null block,
    then :func:`~dllama_tpu_torch.runtime.speculative.spec_decide` (greedy
    rows: the longest draft prefix the argmax agrees with; sampled rows:
    exact-match verify with one coin per position, ``acoins [B, K]`` and
    ``fcoins [B]``). Returns ``(n_acc [B], out [B, K+1], nonfinite [B])``,
    the last the non-finite lanes of each row's K+1 logits rows (every one
    can become an emitted token); the caller emits ``out[b, : n_acc[b] +
    1]``. The pool is updated in place.

    Every write lands at or past the row's committed ``pos`` in blocks the
    slot owns alone (the generator asserts it), so rejected lanes need no
    device rollback: the host's table and position bookkeeping rolls them
    back, and the next dispatch's writes start where they start."""
    from ..runtime.speculative import spec_decide

    logits, _ = paged_forward(params, cfg, tokens, pos_vec, pkv, tables, write_lens=lens,
                              plan=plan)
    logits = _poison_logits(logits, poison)
    n_acc, out = spec_decide(logits, tokens.to(logits.device).long(), lens, temps, topps,
                             acoins, fcoins)
    return n_acc, out, _nonfinite_rows(logits)


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------


def _dense(a, device) -> torch.Tensor:
    """A dense numpy leaf as a tensor of the same dtype (a bfloat16 numpy
    array goes through float32, which holds it exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a copy: leaves may be read-only


def from_jax_params(tree, cfg: ModelConfig, device="cpu") -> Params:
    """The port's :class:`Params` from the JAX package's ``Params`` tree with
    numpy leaves (``jax.tree_util.tree_map(np.asarray, params)``).

    Stacked ``[L, ...]`` leaves split per layer. A weight leaf carrying
    ``scales``/``codes`` planes stays quantized in its K-major layout, with
    the scales stored bf16 under bf16 compute (as the loader stores them —
    the same values a fast-mode dequant rounds to); dense leaves keep their
    dtype; the embedding is stored at the compute dtype. The JAX planes do
    not record their code range, so each weight's kind is read from its
    codes: Q80 when any code lies outside Q40's [-8, 7], else Q40 (a nibble
    decode is exact for codes in that range). MoE layers carry the router
    and the expert stacks (``[L, E, in, out]`` leaves split per layer); a
    leaf carrying ``w8``/``scale`` planes becomes a
    :class:`~dllama_tpu_torch.ops.turbo.TurboWeight` with its ``a8``.
    Duck-typed: nothing of the JAX package is imported."""
    from ..ops.linear import fast_numerics_resolved
    from ..ops.turbo import TurboWeight

    scale_dtype = (torch.bfloat16 if fast_numerics_resolved(cfg.compute_dtype, cfg.quant_mode)
                   else torch.float32)

    def weight(w, l=None) -> Weight | None:
        pick = (lambda a: np.asarray(a)) if l is None else (lambda a: np.asarray(a)[l])
        if w is None:
            return None
        if hasattr(w, "w8"):
            return TurboWeight(_dense(pick(w.w8), device), _dense(pick(w.scale), device).float(),
                               bool(w.a8))
        if hasattr(w, "codes"):
            codes = pick(w.codes)
            q80 = codes.size and (codes.min() < -8 or codes.max() > 7)
            return QuantizedWeight(
                scales=_dense(pick(w.scales), device).to(scale_dtype),
                codes=_dense(codes, device), kind=Q80_CODES if q80 else Q40_CODES)
        return _dense(pick(w), device)

    def vec(a, l=None) -> torch.Tensor:
        a = np.asarray(a) if l is None else np.asarray(a)[l]
        return _dense(a, device).float()

    lay = tree.layers
    qwen3 = cfg.arch == ArchType.QWEN3
    layers = [
        LayerParams(
            wq=weight(lay.wq, l), wk=weight(lay.wk, l), wv=weight(lay.wv, l),
            wo=weight(lay.wo, l), w1=weight(lay.w1, l), w2=weight(lay.w2, l),
            w3=weight(lay.w3, l),
            norm_att=vec(lay.norm_att, l), norm_ffn=vec(lay.norm_ffn, l),
            norm_q=vec(lay.norm_q, l) if qwen3 else None,
            norm_k=vec(lay.norm_k, l) if qwen3 else None,
            moe_gate=vec(lay.moe_gate, l) if cfg.is_moe else None,
            we1=weight(lay.we1, l), we2=weight(lay.we2, l), we3=weight(lay.we3, l))
        for l in range(cfg.n_layers)
    ]
    return Params(
        embedding=vec(tree.embedding).to(getattr(torch, cfg.compute_dtype)),
        layers=layers,
        final_norm=vec(tree.final_norm),
        logits=weight(tree.logits),
        rope=rope_tables(cfg, device),
    )


def init_random_params(cfg: ModelConfig, seed: int = 0, scale: float = 0.02,
                       quantized: bool = False, device="cpu",
                       codes_kind: str = "q40") -> Params:
    """Random params for tests and the on-card parity check (shape-identical
    to a loaded model). Quantized planes are drawn directly as random codes
    and scales on ``device`` from a seeded generator (no host quantization,
    so full-width models build in seconds): Q40 codes in [-7, 7], or with
    ``codes_kind="q80"`` Q80 codes in [-127, 127]; dense weights are normal
    draws. MoE configs get a router and expert stacks ``[E, in, out]``
    (dense ones at the compute dtype, as the loader keeps them)."""
    from ..ops.linear import fast_numerics_resolved

    g = torch.Generator(device=device).manual_seed(seed)
    fast = fast_numerics_resolved(cfg.compute_dtype, cfg.quant_mode)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=device) * scale

    def mk(out, in_, n_experts=0) -> Weight:
        lead = (n_experts,) if n_experts else ()
        if not quantized:
            if n_experts:  # IN-major expert planes at the compute dtype
                return rand(*lead, in_, out).to(getattr(torch, cfg.compute_dtype))
            return rand(out, in_)
        # codes in [-c, c], mean 0 like quantized zero-mean weights (a
        # uniform draw over [-8, 7] has mean -0.5, a common-mode bias that
        # each matmul multiplies by ~0.5 * scale * K and the layers compound)
        c = 127 if codes_kind == "q80" else 7
        codes = torch.randint(-c, c + 1, (*lead, in_, out), generator=g, device=device,
                              dtype=torch.int8)
        # code std is sqrt(c (c + 1) / 3), ~4.32 (Q40) or ~73.6 (Q80): scale
        # the blocks so weights keep std ~scale
        scales = (torch.rand((*lead, in_ // 32, out), generator=g, device=device)
                  * 0.5 + 0.75) * (scale / (73.6 if c == 127 else 4.32))
        return QuantizedWeight(
            scales=scales.to(torch.bfloat16 if fast else torch.float32), codes=codes,
            kind=codes_kind)

    qwen3 = cfg.arch == ArchType.QWEN3
    moe, E = cfg.is_moe, cfg.n_experts
    layers = [
        LayerParams(
            wq=mk(cfg.q_dim, cfg.dim), wk=mk(cfg.kv_dim, cfg.dim),
            wv=mk(cfg.kv_dim, cfg.dim), wo=mk(cfg.dim, cfg.q_dim),
            w1=None if moe else mk(cfg.hidden_dim, cfg.dim),
            w2=None if moe else mk(cfg.dim, cfg.hidden_dim),
            w3=None if moe else mk(cfg.hidden_dim, cfg.dim),
            norm_att=1.0 + rand(cfg.dim), norm_ffn=1.0 + rand(cfg.dim),
            norm_q=1.0 + rand(cfg.head_dim) if qwen3 else None,
            norm_k=1.0 + rand(cfg.head_dim) if qwen3 else None,
            moe_gate=rand(E, cfg.dim) if moe else None,
            we1=mk(cfg.hidden_dim, cfg.dim, E) if moe else None,
            we2=mk(cfg.dim, cfg.hidden_dim, E) if moe else None,
            we3=mk(cfg.hidden_dim, cfg.dim, E) if moe else None)
        for _ in range(cfg.n_layers)
    ]
    logits = mk(cfg.vocab_size, cfg.dim)
    if quantized and fast:  # fast configs keep a dense bf16 head (loader rule)
        from ..ops.linear import dequantize_weight

        logits = dequantize_weight(logits, torch.bfloat16).t().contiguous()
    return Params(
        embedding=rand(cfg.vocab_size, cfg.dim).to(getattr(torch, cfg.compute_dtype)),
        layers=layers,
        final_norm=1.0 + rand(cfg.dim),
        logits=logits,
        rope=rope_tables(cfg, device),
    )
