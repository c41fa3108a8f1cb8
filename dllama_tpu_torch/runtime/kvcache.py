"""Preallocated dense KV cache (the port of the JAX package's
``runtime/kvcache.py``).

One stacked tensor pair ``[n_layers, batch, n_kv_heads, S, head_dim]`` —
head-major, so the trailing ``(S, head_dim)`` slab of each (batch, head) is
what attention reads without a transpose. The JAX cache is updated
functionally and donated; here :func:`update_layer` writes the new rows in
place, which saves the copy.

:class:`ShardedKVCache` is the same cache split along ``S`` over the ``sp``
devices of a mesh (the JAX package's ``kv_cache_sharding`` with the ``seq``
axis, ``parallel/sharding.py:126``): one such pair per shard, each holding
``S / sp`` rows on its own device; ``parallel/ring.py`` writes and reads it.
:class:`HeadShardedKVCache` splits it over kv heads instead, one
:class:`KVCache` per ``tp`` shard (the same function's ``kv_heads`` axis).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple

import torch

if TYPE_CHECKING:
    from ..models.config import ModelConfig

F8 = torch.float8_e4m3fn
# e4m3fn's largest finite value is 448 and the next step up would be 480:
# a value past their midpoint rounds out of range, which the JAX package's
# cast (XLA's and ml_dtypes') turns into NaN, as it does inf and NaN
F8_NAN_ABOVE = 464.0


def to_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to a cache dtype. For e4m3 these are the JAX package's
    bits: round to nearest even in range, NaN (with ``x``'s sign) where
    ``|x| > 464`` or ``x`` is inf or NaN. PyTorch's own cast saturates
    those to ±448, so only its in-range results are kept. Elementwise on
    the device: a CUDA graph can hold it."""
    if dtype != F8:
        return x.to(dtype)
    xf = x.float()
    bits = xf.to(F8).view(torch.uint8)
    nan = torch.signbit(xf).to(torch.uint8) * 0x80 | 0x7F
    return torch.where(xf.abs() <= F8_NAN_ABOVE, bits, nan).view(F8)


def cache_bits(t: torch.Tensor) -> torch.Tensor:
    """An e4m3 cache tensor viewed as its ``uint8`` bytes (others as they
    are): the view every cache write and row copy moves, bit-exact."""
    return t.view(torch.uint8) if t.dtype == F8 else t


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

    def layer(self, l: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Layer ``l``'s ``[B, n_kv, S, hd]`` caches."""
        return self.k[l], self.v[l]

    def zero_(self) -> None:
        self.k.zero_()
        self.v.zero_()


class ShardedKVCache(NamedTuple):
    """The cache split along ``S`` in ``sp`` shards: ``k[j]``/``v[j]`` of shape
    ``[L, B, n_kv_heads, S_l, head_dim]`` on ``devices[j]`` hold rows
    ``[j * S_l, (j + 1) * S_l)``; each is contiguous, so a layer slice goes
    straight to the kernel."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]

    @classmethod
    def create(cls, cfg: "ModelConfig", devices, batch_size: int = 1,
               dtype=torch.float32) -> "ShardedKVCache":
        rows, sp = padded_cache_len(cfg.seq_len), len(devices)
        if rows % sp != 0:
            raise ValueError(f"cache rows {rows} not divisible by sp={sp} "
                             f"(adjust --max-seq-len)")
        shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, rows // sp, cfg.head_dim)
        return cls(k=[torch.zeros(shape, dtype=dtype, device=d) for d in devices],
                   v=[torch.zeros(shape, dtype=dtype, device=d) for d in devices])

    @property
    def seq_len(self) -> int:
        """PHYSICAL cache rows over all shards."""
        return sum(t.shape[3] for t in self.k)

    @property
    def batch_size(self) -> int:
        return self.k[0].shape[1]

    def layer(self, l: int) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        """Layer ``l``'s per-shard ``[B, n_kv, S_l, hd]`` caches."""
        return [t[l] for t in self.k], [t[l] for t in self.v]

    def zero_(self) -> None:
        for t in (*self.k, *self.v):
            t.zero_()


class HeadShardedKVCache(NamedTuple):
    """The cache split over kv heads in ``tp`` shards: ``shards[j]`` is a
    :class:`KVCache` ``[L, B, n_kv_l, S, head_dim]`` on ``devices[j]`` holding
    the heads ``parallel.sharding.kv_heads(cfg, tp, j)`` (``n_kv_l`` is
    ``n_kv_heads / tp``, or 1 under KV replication)."""

    shards: list[KVCache]

    @classmethod
    def create(cls, cfg: "ModelConfig", devices, batch_size: int = 1,
               dtype=torch.float32) -> "HeadShardedKVCache":
        from ..parallel.sharding import local_kv_heads

        n_kv = local_kv_heads(cfg, len(devices))
        shape = (cfg.n_layers, batch_size, n_kv, padded_cache_len(cfg.seq_len), cfg.head_dim)
        return cls([KVCache(k=torch.zeros(shape, dtype=dtype, device=d),
                            v=torch.zeros(shape, dtype=dtype, device=d)) for d in devices])

    def layer(self, l: int) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        """Layer ``l``'s per-shard ``[B, n_kv_l, S, hd]`` caches."""
        return [s.k[l] for s in self.shards], [s.v[l] for s in self.shards]

    def zero_(self) -> None:
        for s in self.shards:
            s.zero_()


def update_layer(k_layer: torch.Tensor, v_layer: torch.Tensor, new_k: torch.Tensor,
                 new_v: torch.Tensor, start_pos: int | torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Write ``new_k/new_v: [B, T, n_kv, hd]`` at ``start_pos`` (OP_SHIFT),
    in place, into ``k_layer/v_layer: [B, n_kv, S, hd]``; returns them.

    ``start_pos`` is an int (every row at the same position — the
    single-sequence engine) or an int tensor ``[B]`` (per-row positions, or
    the ``[1]`` device position of a captured decode step). The tensor form
    scatters along ``S`` on the device, never reading the positions back to
    the host, so a CUDA graph can hold it; it writes the same values."""
    T = new_k.shape[1]
    nk = cache_bits(to_cache(new_k.transpose(1, 2), k_layer.dtype))  # [B, n_kv, T, hd]
    nv = cache_bits(to_cache(new_v.transpose(1, 2), v_layer.dtype))
    kb, vb = cache_bits(k_layer), cache_bits(v_layer)
    if not torch.is_tensor(start_pos):
        p = int(start_pos)
        kb[:, :, p:p + T] = nk
        vb[:, :, p:p + T] = nv
        return k_layer, v_layer
    B, n_kv, _, hd = nk.shape
    rows = (start_pos.to(device=k_layer.device, dtype=torch.long)[:, None]
            + torch.arange(T, device=k_layer.device)[None, :])       # [B, T]
    idx = rows[:, None, :, None].expand(B, n_kv, T, hd)
    kb.scatter_(2, idx, nk)
    vb.scatter_(2, idx, nv)
    return k_layer, v_layer
