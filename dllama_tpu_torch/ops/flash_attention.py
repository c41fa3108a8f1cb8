"""Kernel K3: causal GQA flash attention over the dense head-major cache.

Replaces the JAX package's ``ops/flash_attention.py::_kernel`` (stats=False;
``pallas_call`` at :154 through ``_call`` :128 and ``flash_attention`` :181).
The CUDA kernel is ``csrc/flash_attention.cu``; its header has the note on
what bounds it on the H100 (bytes at decode, FP32 operations on long
prefills) and how the design meets that: online softmax with the running
max/sum in registers, K/V tiles staged once per 16 query rows, and a KV walk
that stops at the newest visible position.

:func:`flash_attention` runs the position-masked oracle
(:func:`dllama_tpu_torch.ops.attention.attention`, its plain version) on a
CPU tensor, and on a CUDA tensor launches the kernel or raises.
``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .attention import attention
from .cuda_build import check, load

MAX_TQ = 2048                # folded query rows per (batch, kv head)
HEAD_DIMS = (64, 128)        # head dims the kernel is instantiated for


def supports(q_shape: tuple[int, ...], n_kv: int, s: int) -> bool:
    """Whether the kernel covers these shapes."""
    B, T, n_heads, D = q_shape
    return (D in HEAD_DIMS and n_heads % n_kv == 0
            and T * (n_heads // n_kv) <= MAX_TQ and s > 0)


def fold_queries(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """``q [B, T, n_heads, D]`` → the kernel's f32 ``[B, n_kv, T*kv_mul, D]``:
    GQA groups folded into query rows, row ``r = t * kv_mul + m`` at
    position ``start_pos + r // kv_mul``."""
    B, T, n_heads, D = q.shape
    kv_mul = n_heads // n_kv
    return (q.reshape(B, T, n_kv, kv_mul, D).permute(0, 2, 1, 3, 4)
             .reshape(B, n_kv, T * kv_mul, D).float().contiguous())


def unfold_output(out: torch.Tensor, T: int, n_heads: int) -> torch.Tensor:
    """Inverse of :func:`fold_queries`: ``[B, n_kv, T*kv_mul, D]`` →
    ``[B, T, n_heads, D]``."""
    B, n_kv, _, D = out.shape
    return (out.reshape(B, n_kv, T, n_heads // n_kv, D).permute(0, 2, 1, 3, 4)
               .reshape(B, T, n_heads, D))


def _lib():
    lib = getattr(_lib, "cached", None)
    if lib is None:
        lib = load("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dlt_flash_attention.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                            ctypes.c_float, i, p]
        lib.dlt_flash_attention.restype = i
        _lib.cached = lib
    return lib


def flash_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                    start_pos: int | torch.Tensor, head_dim: int) -> torch.Tensor:
    """Causal GQA attention: ``q [B, T, n_heads, D]`` over head-major caches
    ``k/v [B, n_kv, S, D]``; query row positions are ``start_pos + t``, with
    ``start_pos`` an int or an int tensor ``[B]`` (ragged rows)."""
    B, T, n_heads, D = q.shape
    n_kv, S = k_cache.shape[1], k_cache.shape[2]
    if q.device.type == "cpu":
        base = (start_pos[:, None] if torch.is_tensor(start_pos)
                else torch.full((B, 1), int(start_pos)))
        positions = (base + torch.arange(T)[None, :]).expand(B, T)
        return attention(q, k_cache, v_cache, positions, head_dim)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not supports(tuple(q.shape), n_kv, S):
        raise ValueError(f"flash_attention: q={tuple(q.shape)}, S={S} not supported "
                         f"(head_dim in {HEAD_DIMS}, T*kv_mul <= {MAX_TQ})")
    if k_cache.dtype not in (torch.float32, torch.bfloat16) or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"flash_attention: cache dtype {k_cache.dtype} not supported")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous() or t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and "
                             f"16-byte aligned on {q.device}")
    kv_mul = n_heads // n_kv
    q_g = fold_queries(q, n_kv)
    out = torch.empty_like(q_g)
    if torch.is_tensor(start_pos):
        pos = start_pos.to(device=q.device, dtype=torch.int32).contiguous()
        pos_ptr, pos_scalar = pos.data_ptr(), 0
    else:
        pos_ptr, pos_scalar = None, int(start_pos)
    lib = _lib()
    rc = lib.dlt_flash_attention(
        q_g.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        pos_ptr, pos_scalar, B, n_kv, T * kv_mul, S, D, kv_mul,
        1.0 / math.sqrt(head_dim), int(k_cache.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention.launches += 1
    check(lib, rc, "flash_attention")
    return unfold_output(out, T, n_heads).to(q.dtype)


flash_attention.launches = 0
