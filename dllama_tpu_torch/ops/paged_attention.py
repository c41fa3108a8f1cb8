"""Kernel K4: causal GQA attention over the paged block pool.

Replaces the JAX package's ``ops/paged_attention.py::_kernel`` (kernel
:49, ``pallas_call`` :182 through ``paged_ragged_attention`` :132). The
Pallas kernel assembles each (batch row, KV head)'s whole logical cache in
VMEM and runs one softmax, so that it is bit-identical to the gather plus
oracle on the TPU. The CUDA kernel (``csrc/paged_attention.cu``) instead
walks the row's block table with an online softmax: each 32-key tile reads
``tables[b, s // bs]`` for its keys and copies their K/V rows with 16-byte
``cp.async`` into a three-deep shared-memory ring (a block's ``[bs, hd]``
tile is contiguous in the pool), two tiles in flight while one is scored,
and the walk stops at the newest position any query row of the tile can
see, so unallocated tail entries — and the many null entries behind an
inactive row's stale position — are never loaded.

What bounds it on the H100: the visible KV bytes (decode reads each
visible K/V row once for ``kv_mul`` query rows). One block per (row, KV
head, query tile) gives decode only 8 blocks at B = 1 and 64 at B = 8, so
the key walk is split across blocks (split-S, flash-decoding):
:func:`_paged_splits` picks the count from the shapes alone, each block
takes its range of whole 32-key tiles from its row's own position read on
the device (:func:`~dllama_tpu_torch.ops.flash_attention._split_ranges`,
K3's rule), and K3's combine kernel merges the partial ``(acc, m, l)`` in
split order.

:func:`paged_attention` runs :func:`paged_attention_plain` (the gather +
oracle, its plain version) on a CPU tensor, and on a CUDA tensor launches
the kernel or raises. The pool is f32, bf16 or float8 e4m3 (``--kv-dtype
f8``), widened exactly to f32 as it is read. ``paged_attention.launches`` counts kernel launches
(one per call, split or not), ``moved_bytes`` and ``ops`` every call's bytes
and operations (``ops/cost.py``, keys counted to the block table's reach:
the positions stay on the device), and ``paged_attention.last_splits`` holds the
``n_splits`` of the last launch (1: single pass).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .attention import attention
from .cost import count, launch_cost
from .cuda_build import SMS, check, load, on_card
from .flash_attention import (CACHE_KINDS, _attn_splits, _split_scratch, fold_queries,
                              unfold_output)

MAX_TQ = 512    # folded query rows (T * kv_mul) per (batch row, KV head)
MAX_HEAD_DIM = 128
# split-S rule (K3's :func:`_attn_splits` with K4's limits): a grid of
# fewer (b, head, query tile) blocks than two per SM (which K3's limits,
# a quarter of the SMs, would leave unsplit at B = 8) splits into about
# four blocks per SM, each split walking at least two 32-key tiles of the
# table's reach. Four, not two: a serving batch's rows are ragged, and its
# deepest row sets the time, so its splits must be short; blocks of a
# short row's empty splits load nothing and finish at once (a sweep of the
# split count at B = 8, PERF.md §6)
_SPLIT_MAX_BLOCKS = 2 * SMS - 1
_SPLIT_TARGET_BLOCKS = 4 * SMS


def supports(q_shape: tuple[int, ...], n_kv: int, block_size: int) -> bool:
    """The CUDA kernel's own limits: head dims that are a multiple of 8 up
    to 128 (16-byte loads of bf16 rows, shared-memory tiles), block sizes
    that are a multiple of 8, at most :data:`MAX_TQ` folded query rows."""
    B, T, n_heads, D = q_shape
    return (n_heads % n_kv == 0 and D % 8 == 0 and 0 < D <= MAX_HEAD_DIM
            and block_size % 8 == 0 and 0 < T * (n_heads // n_kv) <= MAX_TQ)


def _paged_splits(B: int, n_kv: int, TQ: int, S: int) -> int:
    """Blocks per (b, kv head, query tile) for a K4 launch over tables whose
    reach is ``S = M * bs`` keys: 1 (single pass) or the split-S count.
    Depends on the shapes only, so positions that advance on the device
    never change the grid. Each block's key range is
    :func:`~dllama_tpu_torch.ops.flash_attention._split_ranges` of its
    row's newest visible key."""
    return _attn_splits(B, n_kv, TQ, S, _SPLIT_MAX_BLOCKS, _SPLIT_TARGET_BLOCKS)


def paged_view(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """The dense head-major logical cache of every row: ``pool [n_blocks,
    n_kv, bs, hd]`` gathered through ``tables [B, M]`` →
    ``[B, n_kv, M * bs, hd]``."""
    B, M = tables.shape
    _, n_kv, bs, hd = pool.shape
    g = pool[tables.long()]                    # [B, M, n_kv, bs, hd]
    return g.transpose(1, 2).reshape(B, n_kv, M * bs, hd)


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables: torch.Tensor,
                          positions: torch.Tensor, head_dim: int) -> torch.Tensor:
    """The plain PyTorch version of K4: the gather (``pool[tables]``) and
    the position-masked oracle over it — what the JAX package's
    ``_paged_layer_step`` runs when its kernel gate is off."""
    return attention(q, paged_view(k_pool, tables), paged_view(v_pool, tables),
                     positions, head_dim)


def _lib():
    lib = getattr(_lib, "cached", None)
    if lib is None:
        lib = load("paged_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dlt_paged_attention.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                                            ctypes.c_float, i, p, i, p]
        lib.dlt_paged_attention.restype = i
        _lib.cached = lib
    return lib


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    tables: torch.Tensor, positions: torch.Tensor,
                    head_dim: int) -> torch.Tensor:
    """Causal GQA attention of ``q [B, T, n_heads, hd]`` over this layer's
    pool ``k/v_pool [n_blocks, n_kv, bs, hd]`` through block ``tables
    [B, M]`` (0 = the null block) at absolute ``positions [B, T]`` (affine
    per row: query row ``r`` of the GQA fold sees logical columns
    ``s <= positions[b, 0] + r // kv_mul``)."""
    B, T, n_heads, D = q.shape
    n_blocks, n_kv, bs, _ = k_pool.shape
    M = tables.shape[1]
    # the positions stay on the device: a call counts the table's reach
    cost = lambda: launch_cost(  # noqa: E731
        "K4", T=T, heads=n_heads, kv_heads=n_kv, head_dim=D, q_elt=q.element_size(),
        kv_elt=k_pool.element_size(), depths=[M * bs - T] * B, rows=M * bs)
    if q.device.type == "cpu":
        count(paged_attention, cost())
        return paged_attention_plain(q, k_pool, v_pool, tables, positions, head_dim)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    if not supports(tuple(q.shape), n_kv, bs):
        raise ValueError(
            f"paged_attention: q={tuple(q.shape)}, n_kv={n_kv}, block size {bs} "
            f"not supported (head_dim % 8 == 0 and <= {MAX_HEAD_DIM}, block size "
            f"% 8 == 0, T*kv_mul <= {MAX_TQ})")
    if k_pool.dtype not in CACHE_KINDS or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"paged_attention: pool dtype {k_pool.dtype} not supported")
    if D % (16 // k_pool.element_size()):
        raise ValueError(f"paged_attention: head dim {D} is not a whole number of "
                         f"16-byte chunks of a {k_pool.dtype} row")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if not t.is_contiguous() or t.device != q.device or t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} must be contiguous and "
                             f"16-byte aligned on {q.device}")
    kv_mul = n_heads // n_kv
    q_g = fold_queries(q, n_kv)
    out = torch.empty_like(q_g)
    tbl = tables.to(device=q.device, dtype=torch.int32).contiguous()
    pos0 = positions[:, 0].to(device=q.device, dtype=torch.int32).contiguous()
    TQ = T * kv_mul
    n_splits = _paged_splits(B, n_kv, TQ, M * bs)
    part_ptr, _part = _split_scratch(n_splits, B * n_kv * TQ, D, q.device)
    lib = _lib()
    with on_card(q.device):  # the launch goes to q's card
        rc = lib.dlt_paged_attention(
            q_g.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
            tbl.data_ptr(), pos0.data_ptr(), B, n_kv, TQ, D, n_blocks, bs, M,
            kv_mul, 1.0 / math.sqrt(head_dim), CACHE_KINDS[k_pool.dtype],
            part_ptr, n_splits, torch.cuda.current_stream(q.device).cuda_stream)
    paged_attention.launches += 1
    count(paged_attention, cost())
    paged_attention.last_splits = n_splits
    check(lib, rc, "paged_attention")
    return unfold_output(out, T, n_heads).to(q.dtype)


paged_attention.launches = 0
paged_attention.moved_bytes = 0.0
paged_attention.ops = 0.0
paged_attention.last_splits = 0


def paged_attention_sharded(q: torch.Tensor, k_pools: list[torch.Tensor],
                            v_pools: list[torch.Tensor], tables: torch.Tensor,
                            positions: torch.Tensor, head_dim: int, *,
                            kernel: bool = True) -> torch.Tensor:
    """Tensor-parallel paged attention: shard ``j`` of ``tp = len(k_pools)``
    attends q heads ``[j * H / tp, (j + 1) * H / tp)`` of ``q [B, T, H, hd]``
    over its own pool ``[n_blocks, n_kv_l, bs, hd]`` (the kv heads those q
    heads read), through the one set of block ``tables``: one
    :func:`paged_attention` (K4) a shard on the shard's device, or with
    ``kernel=False`` its plain version by name. The JAX package has no
    sharded paged kernel (under a plan it takes the gather and the oracle,
    ``dllama_tpu/ops/paged_attention.py:112-130``); the outputs are the same
    function of the same heads, concatenated on ``q``'s device."""
    fn = paged_attention if kernel else paged_attention_plain
    tp = len(k_pools)
    hl = q.shape[2] // tp
    outs = []
    for j, (kp, vp) in enumerate(zip(k_pools, v_pools)):
        d = kp.device
        att = fn(q[:, :, j * hl:(j + 1) * hl].to(d), kp, vp, tables.to(d), positions.to(d),
                 head_dim)
        outs.append(att.to(q.device))
    return torch.cat(outs, dim=2)
