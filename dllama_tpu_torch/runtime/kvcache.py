"""Preallocated dense KV cache (the port of the JAX package's
``runtime/kvcache.py``).

One stacked tensor pair ``[n_layers, batch, n_kv_heads, S, head_dim]`` —
head-major, so the trailing ``(S, head_dim)`` slab of each (batch, head) is
what attention reads without a transpose. The JAX cache is updated
functionally and donated; here :func:`update_layer` writes the new rows in
place, which saves the copy.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple

import torch

if TYPE_CHECKING:
    from ..models.config import ModelConfig

# physical cache rows round up to this (the flash kernel's KV tiling in the
# JAX package) — rows past the logical seq_len are never written or attended
CACHE_ALIGN = 128


def padded_cache_len(seq_len: int) -> int:
    """Physical cache rows for a logical ``seq_len`` cap."""
    return -(-seq_len // CACHE_ALIGN) * CACHE_ALIGN


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, n_kv_heads, S, head_dim]
    v: torch.Tensor

    @classmethod
    def create(cls, cfg: "ModelConfig", batch_size: int = 1,
               dtype=torch.float32, device="cpu") -> "KVCache":
        shape = (cfg.n_layers, batch_size, cfg.n_kv_heads,
                 padded_cache_len(cfg.seq_len), cfg.head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))

    @property
    def seq_len(self) -> int:
        """PHYSICAL cache rows (>= the config's logical seq_len cap)."""
        return self.k.shape[3]

    @property
    def batch_size(self) -> int:
        return self.k.shape[1]


def update_layer(k_layer: torch.Tensor, v_layer: torch.Tensor, new_k: torch.Tensor,
                 new_v: torch.Tensor, start_pos: int | torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Write ``new_k/new_v: [B, T, n_kv, hd]`` at ``start_pos`` (OP_SHIFT),
    in place, into ``k_layer/v_layer: [B, n_kv, S, hd]``; returns them.

    ``start_pos`` is an int (every row at the same position — the
    single-sequence engine) or an int tensor ``[B]`` (per-row positions)."""
    T = new_k.shape[1]
    nk = new_k.transpose(1, 2).to(k_layer.dtype)  # [B, n_kv, T, hd]
    nv = new_v.transpose(1, 2).to(v_layer.dtype)
    if not torch.is_tensor(start_pos):
        p = int(start_pos)
        k_layer[:, :, p:p + T] = nk
        v_layer[:, :, p:p + T] = nv
        return k_layer, v_layer
    for b, p in enumerate(start_pos.tolist()):
        k_layer[b, :, p:p + T] = nk[b]
        v_layer[b, :, p:p + T] = nv[b]
    return k_layer, v_layer
