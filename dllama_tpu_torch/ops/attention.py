"""Causal GQA attention over a preallocated KV cache — the semantics oracle
(the port of the JAX package's ``ops/attention.py``) and the plain PyTorch
version of kernel K3 (:mod:`dllama_tpu_torch.ops.flash_attention`).

Semantics match the reference's OP_MULTIHEAD_ATT (reference: multiheadAtt_F32,
src/nn/nn-cpu-ops.cpp:751-786): per head, scores ``q·k / sqrt(head_dim)`` over
cache positions ``0..pos``, float32 softmax, weighted V sum; GQA via the
``kv_mul`` head-group factor; masking by position replaces the loop bound.
"""

from __future__ import annotations

import math

import torch


def attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
              positions: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Attend ``q: [B, T, n_heads, head_dim]`` over cached
    ``k/v: [B, n_kv_heads, S, head_dim]`` (head-major, see runtime.kvcache).

    ``positions: [B, T]`` is the absolute position of each query row; cache
    entries at ``s <= position`` are visible.
    """
    B, T, n_heads, _ = q.shape
    n_kv = k_cache.shape[1]
    S = k_cache.shape[2]
    kv_mul = n_heads // n_kv

    qg = q.reshape(B, T, n_kv, kv_mul, head_dim).float()
    scores = torch.einsum("btkmh,bksh->btkms", qg, k_cache.float())
    scores = scores / math.sqrt(head_dim)
    mask = (torch.arange(S, device=q.device)[None, None, :]
            <= positions[:, :, None])  # [B, T, S]
    scores = scores.masked_fill(~mask[:, :, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("btkms,bksh->btkmh", probs, v_cache.float())
    return out.reshape(B, T, n_heads, head_dim).to(q.dtype)
