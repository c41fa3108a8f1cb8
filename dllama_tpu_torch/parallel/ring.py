"""Sequence-parallel attention: ring attention for prefill, a flash-decoding
merge for decode (the port of the JAX package's ``parallel/ring.py``).

The KV cache's sequence axis is split over the ``sp`` devices of a
:class:`~dllama_tpu_torch.parallel.api.MeshPlan`: shard ``j`` holds cache
rows ``[j * S_l, (j + 1) * S_l)`` on ``devices[j]``, so the context a model
can hold grows with the number of devices. One process drives every shard
(the JAX package's single-controller model); where the JAX package runs a
``shard_map`` with collectives, the port loops over the shards:

* **Ring (prefill, ``T % sp == 0 and T > 1``):** query shard ``j`` holds
  rows ``[j * T/sp, (j + 1) * T/sp)`` and folds the KV blocks in the JAX
  ring's order: step ``r`` uses block ``src = (j - r) mod sp``. The
  ``ppermute`` of a block becomes ``Tensor.to(devices[j])``: a peer copy
  between cards, a no-op on one card.
* **Merge (decode, and any other T):** every shard attends the replicated
  queries against its own block; the ``pmax``/``psum`` log-sum-exp merge
  becomes a gather of the block statistics to the lead device, reduced in
  shard order.

Each (query shard, KV block) pair runs kernel K3s
(:func:`~dllama_tpu_torch.ops.flash_attention.flash_block_stats`) or its
plain version ``ops/flash_attention.py::_block_attn``, which lives beside
its kernel's wrapper; the combine algebra is the JAX package's
line for line. The step's new K/V rows are computed on the lead device and
copied into the shard whose range holds their absolute position (the JAX
all-gather plus a dropping scatter).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from ..ops.flash_attention import _block_attn, flash_block_stats
from ..runtime.kvcache import cache_bits, to_cache

if TYPE_CHECKING:
    from .api import MeshPlan

AXIS = "sp"
NEG_INF = float("-inf")


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t.to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# Block math (shared by ring and merge paths). All in float32.
# ---------------------------------------------------------------------------


def _combine(m, l, acc, bm, bl, bacc):
    """Fold block stats ``(bm, bl, bacc)`` into the running ``(m, l, acc)``.

    Safe for fully-masked blocks (all stats stay 0 / -inf, no NaNs)."""
    m_new = torch.maximum(m, bm)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    alpha = torch.exp(m - m_safe)       # -inf - 0 → 0, never NaN
    beta = torch.exp(bm - m_safe)
    l_new = l * alpha + bl * beta
    acc_new = acc * alpha[..., None] + bacc * beta[..., None]
    return m_new, l_new, acc_new


def _finish(acc, l, dtype):
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# KV cache append into the sequence shards (reference OP_SHIFT)
# ---------------------------------------------------------------------------


def _append_kv(k_shards, v_shards, new_k: torch.Tensor, new_v: torch.Tensor,
               start_pos) -> None:
    """Write the step's rows ``new_k/new_v [B, T, n_kv, hd]`` (lead device)
    into the shards ``[B, n_kv, S_l, hd]``, in place: row ``t`` lands in the
    shard whose range holds ``start_pos + t``; the part of the step outside
    a shard is dropped there (JAX: ``mode="drop"``). ``start_pos`` is an int
    or a ``[B]`` tensor (each row appends at its own depth)."""
    T = new_k.shape[1]
    s_local = k_shards[0].shape[2]
    rows = ([(b, p) for b, p in enumerate(start_pos.tolist())]
            if torch.is_tensor(start_pos) else [(slice(None), int(start_pos))])
    k_rows = cache_bits(to_cache(new_k.transpose(1, 2), k_shards[0].dtype))  # [B, n_kv, T, hd]
    v_rows = cache_bits(to_cache(new_v.transpose(1, 2), v_shards[0].dtype))
    for j, (ks, vs) in enumerate(zip(k_shards, v_shards)):
        ks, vs = cache_bits(ks), cache_bits(vs)
        base = j * s_local
        for b, p in rows:
            lo, hi = max(p, base), min(p + T, base + s_local)
            if lo < hi:  # the copy from the lead device to the shard's
                ks[b, :, lo - base:hi - base] = k_rows[b, :, lo - p:hi - p]
                vs[b, :, lo - base:hi - base] = v_rows[b, :, lo - p:hi - p]


# ---------------------------------------------------------------------------
# The two attention paths
# ---------------------------------------------------------------------------


def _kernel_block_stats(qg, k, v, q_pos0, kv_pos0: int, head_dim: int):
    """One KV block through K3s, results in ring layout.

    ``qg: [B, Tl, n_kv, kv_mul, hd]`` → fold GQA into kernel query rows
    (``[B, n_kv, Tl*kv_mul, hd]``, row = t*kv_mul + m — the layout
    ops.flash_attention uses), call the stats kernel, unfold."""
    B, Tl, n_kv, kv_mul, hd = qg.shape
    q_hm = qg.permute(0, 2, 1, 3, 4).reshape(B, n_kv, Tl * kv_mul, hd)
    acc, m, l = flash_block_stats(q_hm, k, v, q_pos0, kv_pos0, head_dim, Tl)
    acc = acc.reshape(B, n_kv, Tl, kv_mul, hd).permute(0, 2, 1, 3, 4)
    m = m.reshape(B, n_kv, Tl, kv_mul).permute(0, 2, 1, 3)
    l = l.reshape(B, n_kv, Tl, kv_mul).permute(0, 2, 1, 3)
    return acc, m, l


def _block_stats(qg, k, v, q_pos0, q_positions, kv_pos0: int, head_dim: int,
                 use_kernel: bool):
    """Block ``[kv_pos0, kv_pos0 + S_l)`` against queries at ``q_positions
    [B, Tl]`` (``q_pos0`` = their first position): K3s, or the einsum."""
    if use_kernel:
        # positions are affine within each batch row (start + t), so the
        # row's first position determines the kernel's causal mask
        return _kernel_block_stats(qg, k, v, q_pos0, kv_pos0, head_dim)
    kv_pos = kv_pos0 + torch.arange(k.shape[2], device=qg.device)
    mask = kv_pos[None, None, :] <= q_positions[:, :, None]
    return _block_attn(qg, k, v, mask, head_dim)


def _ring_attention(plan: "MeshPlan", qg, k_shards, v_shards, q_positions,
                    start_pos, head_dim: int, use_kernel: bool):
    """Ring pass: query shard ``j`` folds every KV block in the JAX ring's
    order into an online softmax. Returns each query shard's ``(acc, l)``
    on its own device."""
    n_sp = plan.axis_size(AXIS)
    B, T, n_kv, kv_mul, hd = qg.shape
    t_local = T // n_sp
    s_local = k_shards[0].shape[2]
    outs = []
    for j, dev in enumerate(plan.devices):
        rows = slice(j * t_local, (j + 1) * t_local)
        qg_j = _to(qg[:, rows], dev)
        pos_j = _to(q_positions[:, rows], dev)
        q_pos0 = (_to(start_pos, dev) if torch.is_tensor(start_pos)
                  else int(start_pos)) + j * t_local
        m = torch.full((B, t_local, n_kv, kv_mul), NEG_INF, device=dev)
        l = torch.zeros((B, t_local, n_kv, kv_mul), device=dev)
        acc = torch.zeros((B, t_local, n_kv, kv_mul, hd), device=dev)
        for r in range(n_sp):
            # after r forward rotations this block originated on shard j - r
            src = (j - r) % n_sp
            bacc, bm, bl = _block_stats(qg_j, _to(k_shards[src], dev),
                                        _to(v_shards[src], dev), q_pos0, pos_j,
                                        src * s_local, head_dim, use_kernel)
            m, l, acc = _combine(m, l, acc, bm, bl, bacc)
        outs.append((acc, l))
    return outs


def _merge_attention(plan: "MeshPlan", qg, k_shards, v_shards, q_positions,
                     start_pos, head_dim: int, use_kernel: bool):
    """Flash-decoding pass: every shard attends the replicated queries over
    its own block; the statistics gather to the lead device and merge by
    log-sum-exp, in shard order. Returns ``(acc, l)`` on the lead device."""
    s_local = k_shards[0].shape[2]
    lead = plan.lead
    stats = []
    for j, dev in enumerate(plan.devices):
        q_pos0 = _to(start_pos, dev) if torch.is_tensor(start_pos) else int(start_pos)
        acc, m, l = _block_stats(_to(qg, dev), k_shards[j], v_shards[j], q_pos0,
                                 _to(q_positions, dev), j * s_local, head_dim,
                                 use_kernel)
        stats.append((_to(acc, lead), _to(m, lead), _to(l, lead)))
    gm = stats[0][1]
    for _, m, _ in stats[1:]:
        gm = torch.maximum(gm, m)
    gm_safe = torch.where(torch.isfinite(gm), gm, 0.0)
    l_sum = acc_sum = None
    for acc, m, l in stats:
        scale = torch.exp(m - gm_safe)            # 0 for -inf locals, no NaN
        l_sum = l * scale if l_sum is None else l_sum + l * scale
        part = acc * scale[..., None]
        acc_sum = part if acc_sum is None else acc_sum + part
    return acc_sum, l_sum


# ---------------------------------------------------------------------------
# Public wrapper
# ---------------------------------------------------------------------------


def sp_supported(plan: "MeshPlan", q_shape, kv_shape) -> bool:
    """Whether sequence-parallel attention covers these shapes: ``kv_shape``
    is the whole cache's ``[B, n_kv, S, hd]``, split in ``sp`` equal shards."""
    sp = plan.axis_size(AXIS)
    if sp <= 1:
        return False
    B, T, H, hd = q_shape
    n_kv, S = kv_shape[1], kv_shape[2]
    return S % sp == 0 and H % n_kv == 0 and kv_shape[0] == B and kv_shape[3] == hd


def _kernel_eligible(attn_impl: str, q: torch.Tensor) -> bool:
    """Whether the blocks run K3s: ``xla`` never (the plain einsum); ``flash``
    always (its wrapper runs the plain version on a CPU tensor); ``auto`` on
    a CUDA tensor, where K3s launches or raises — never the einsum."""
    if attn_impl not in ("auto", "xla", "flash"):
        raise ValueError(f"attn_impl must be auto|xla|flash, got {attn_impl!r}")
    if attn_impl == "xla":
        return False
    return attn_impl == "flash" or q.device.type == "cuda"


def sp_attention(plan: "MeshPlan", q: torch.Tensor, k_shards, v_shards,
                 new_k: torch.Tensor, new_v: torch.Tensor, positions: torch.Tensor,
                 start_pos, head_dim: int, attn_impl: str = "auto") -> torch.Tensor:
    """Sequence-parallel KV append + causal GQA attention.

    Args:
      q:         [B, T, n_heads, hd]  (post-rope, lead device)
      k/v_shards: per shard ``[B, n_kv, S_l, hd]`` on ``plan.devices[j]``,
                 written in place
      new_k/v:   [B, T, n_kv, hd]     this step's rows (post-rope, time-major)
      positions: [B, T]               absolute position of each query row
      start_pos: int or [B] tensor    absolute position of row 0
      attn_impl: per-block compute — 'auto' (K3s on a CUDA tensor, the
                 einsum on a CPU tensor), 'flash' (the K3s wrapper always),
                 'xla' (the einsum)

    Returns ``att [B, T, n_heads, hd]`` on the lead device."""
    n_sp = plan.axis_size(AXIS)
    B, T, H, hd = q.shape
    kv_shape = (k_shards[0].shape[0], k_shards[0].shape[1],
                sum(s.shape[2] for s in k_shards), k_shards[0].shape[3])
    if (len(k_shards) != n_sp or len(v_shards) != n_sp
            or any(s.shape != k_shards[0].shape for s in (*k_shards, *v_shards))
            or not sp_supported(plan, q.shape, kv_shape)):
        raise ValueError(
            f"sp_attention: q={tuple(q.shape)} over {len(k_shards)} shards of "
            f"{tuple(k_shards[0].shape)} is not covered by sp={n_sp} (needs "
            f"equal shards, one per device; tp/dp are not ported)")
    use_kernel = _kernel_eligible(attn_impl, q)
    _append_kv(k_shards, v_shards, new_k, new_v, start_pos)
    n_kv = kv_shape[1]
    # the grouped queries keep the compute dtype: K3s reads them as f32, and
    # bf16 ones let a single pass over an e4m3 shard take the tensor cores
    qg = q.reshape(B, T, n_kv, H // n_kv, hd)
    if T % n_sp == 0 and T > 1:
        outs = _ring_attention(plan, qg, k_shards, v_shards, positions, start_pos,
                               head_dim, use_kernel)
        out = torch.cat([_to(_finish(acc, l, q.dtype), plan.lead) for acc, l in outs],
                        dim=1)
    else:
        acc, l = _merge_attention(plan, qg, k_shards, v_shards, positions, start_pos,
                                  head_dim, use_kernel)
        out = _finish(acc, l, q.dtype)
    return out.reshape(B, T, H, hd)
