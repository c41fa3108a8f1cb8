"""Kernels K3 and K3s: causal GQA flash attention over the dense head-major
cache, and its block-statistics mode for sequence-parallel attention.

Replaces the JAX package's ``ops/flash_attention.py::_kernel`` (stats=False;
``pallas_call`` at :154 through ``_call`` :128 and ``flash_attention`` :181).
The CUDA kernel is ``csrc/flash_attention.cu``; its header has the note.
Decode reads each visible K/V row once, so it is bound by bytes; long
prefills by FP32 operations. Online softmax keeps the running max/sum in
registers, K/V tiles are staged once per 16 query rows with the next tile's
loads in flight, and the walk stops at the newest visible position. When the
unsplit grid would leave most of the card idle (decode and short verifies:
8 blocks at B = 1), the keys are split across blocks (split-S, or
flash-decoding): :func:`_attn_splits` picks the count from the shapes alone,
each block takes its range of whole 32-key tiles from the depth it reads on
the device (:func:`_split_ranges` is the same rule), and a second small
kernel merges the partial ``(acc, m, l)`` in split order.

:func:`flash_attention` runs the position-masked oracle
(:func:`dllama_tpu_torch.ops.attention.attention`, its plain version) on a
CPU tensor, and on a CUDA tensor launches the kernel or raises.
``flash_attention.launches`` counts kernel launches (one per call, split or
not), ``moved_bytes`` and ``ops`` every call's bytes and operations
(``ops/cost.py``; a launch whose positions are on the device counts the
whole cache), and ``flash_attention.last_splits`` holds the ``n_splits`` of the last
launch (1: single pass).

K3s (:func:`flash_block_stats`) replaces the JAX package's
``flash_block_stats`` (``ops/flash_attention.py:206``, the same ``_kernel``
with ``stats=True``): one mid-sequence KV block, the unnormalised
``(acc, m, l)`` of every folded query row, for the ring and merge combines
of :mod:`dllama_tpu_torch.parallel.ring`. It is the same CUDA kernel in its
stats mode, with the same split rule; its plain version is
:func:`_block_attn`, which the ring's plain path calls directly
(:func:`flash_block_stats_plain` folds around it).
``flash_block_stats.launches`` counts its launches, and
``flash_block_stats.last_splits`` holds the last launch's ``n_splits``.

Two paths on the card, chosen by :func:`_attn_path` from the cache dtype,
the split count and the queries' dtype, and recorded as ``last_path`` on
each wrapper: a single pass over a bf16 cache (prefill chunks, K3s's ring
blocks), or over a float8 e4m3 cache (``--kv-dtype f8``) under bf16
queries, runs on the tensor cores (``"tc"``: bf16 ``mma.sync`` scores and
``P V`` from a TMA ring, an e4m3 tile widened to bf16 in shared memory
first, f32 online softmax, ``P`` rounded to bf16 before ``P V``); f32
caches, e4m3 caches under f32 queries (widened exactly to f32 as the tiles
are staged, so the queries are never rounded) and split launches run the
FP32 SIMT kernel (``"simt"``). The tensor-core
path's rounding is written plainly in :func:`flash_block_stats_tc_plain`
and :func:`flash_attention_tc_plain`, which the CPU tests and
``chip_smoke.py`` hold it against; the CPU dispatch stays on the f32
oracle.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .attention import attention
from .cost import count, launch_cost
from .cuda_build import SMS, check, load, on_card

# the kernels index folded query rows (B * n_kv * TQ) and cache rows (B *
# n_kv * S) in 32-bit ints; nothing else depends on TQ (shared memory is
# per tile, the grid tiles the rows), so any prefill chunk the engine can
# pick fits (T * kv_mul = 8192 at --nbatches 2048 on an 8B model)
MAX_ROWS = 2**31 - 1
HEAD_DIMS = (64, 128)        # head dims the kernel is instantiated for
BQ, BS = 16, 32              # query rows per block, keys per tile (csrc)
# split-S rule: split only a grid of at most a quarter of the SMs' worth of
# (b, head, query tile) blocks (decode and short verifies; prefill chunks of
# 64 tokens and more keep the single pass), into about two blocks per SM,
# each walking at least two 32-key tiles of the cache
_SPLIT_MAX_BLOCKS = SMS // 4
_SPLIT_TARGET_BLOCKS = 2 * SMS
_SPLIT_MIN_TILES = 2
TC_BQ, TC_BS = 64, 64        # the tensor-core path's query rows per block, keys per tile


def _rows_fit(B: int, n_kv: int, TQ: int, S: int) -> bool:
    """Whether the folded query rows and the cache rows of a launch have
    32-bit indices."""
    return B * n_kv * TQ <= MAX_ROWS and B * n_kv * S <= MAX_ROWS


def supports(q_shape: tuple[int, ...], n_kv: int, s: int) -> bool:
    """Whether the kernel covers these shapes."""
    B, T, n_heads, D = q_shape
    return (D in HEAD_DIMS and n_heads % n_kv == 0 and s > 0
            and _rows_fit(B, n_kv, T * (n_heads // n_kv), s))


def supports_block_stats(q_g_shape: tuple[int, ...], t: int,
                         block_shape: tuple[int, ...]) -> bool:
    """Whether K3s covers folded queries ``q_g_shape = (B, n_kv, TQ, D)`` of
    ``t`` positions over a KV block of ``block_shape = (B, n_kv, S, D)``."""
    B, n_kv, TQ, D = q_g_shape
    S = block_shape[2]
    return (D in HEAD_DIMS and t > 0 and TQ % t == 0 and S > 0
            and block_shape[1] == n_kv and _rows_fit(B, n_kv, TQ, S))


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


def _attn_splits(B: int, n_kv: int, TQ: int, S: int, max_blocks: int = _SPLIT_MAX_BLOCKS,
                 target_blocks: int = _SPLIT_TARGET_BLOCKS) -> int:
    """Blocks per (b, kv head, query tile) for a K3/K3s launch (or K4's,
    with its own ``max_blocks``/``target_blocks``) over ``S`` keys: 1 (single
    pass) when the grid has more than ``max_blocks`` blocks, else the
    split-S count that brings it to about ``target_blocks``, each split
    walking at least two 32-key tiles. Depends on the shapes only, so
    positions that advance on the device never change the grid."""
    blocks = -(-TQ // BQ) * n_kv * B
    if blocks > max_blocks:
        return 1
    return max(1, min(-(-target_blocks // blocks), -(-S // BS) // _SPLIT_MIN_TILES))


# the C entries' cache kinds (csrc/flash_attention.cu, csrc/paged_attention.cu)
CACHE_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}


def _attn_path(kv_dtype: torch.dtype, n_splits: int,
               q_dtype: torch.dtype = torch.float32) -> str:
    """The kernel a K3/K3s launch takes: ``"tc"`` (tensor cores) for a
    single pass over a bf16 cache, or over an e4m3 cache under bf16 queries
    (rounding them to bf16 changes nothing); ``"simt"`` (FP32) for an f32
    cache, an e4m3 cache under f32 queries, or a split launch. Depends on
    the dtypes and the shapes only: the C entries
    (``csrc/flash_attention.cu::use_tc``) choose the same way, as their
    kernels allow no other, and the wrappers record it as ``last_path``."""
    tc_cache = kv_dtype == torch.bfloat16 or (kv_dtype == torch.float8_e4m3fn
                                              and q_dtype == torch.bfloat16)
    return "tc" if tc_cache and n_splits == 1 else "simt"


def _split_ranges(newest: int, n_splits: int) -> list[tuple[int, int]]:
    """The kernel's key ranges: split ``s`` walks keys ``[lo, hi)`` of a
    query tile whose newest visible local slot is ``newest`` (negative:
    nothing visible). Whole 32-key tiles, covering ``[0, newest]`` once;
    some ranges are empty when there are fewer tiles than splits."""
    n_tiles = 0 if newest < 0 else newest // BS + 1
    return [(s * n_tiles // n_splits * BS, (s + 1) * n_tiles // n_splits * BS)
            for s in range(n_splits)]


def _split_scratch(n_splits: int, rows: int, D: int, device: torch.device):
    """Pass 1's f32 partials (acc, then m, then l of every split), or None
    for a single pass: ``(pointer, keep-alive tensor)``."""
    if n_splits == 1:
        return None, None
    part = torch.empty(n_splits * rows * (D + 2), dtype=torch.float32, device=device)
    return part.data_ptr(), part


def _lib():
    lib = getattr(_lib, "cached", None)
    if lib is None:
        lib = load("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dlt_flash_attention.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                            ctypes.c_float, i, i, p, i, p]
        lib.dlt_flash_attention.restype = i
        lib.dlt_flash_block_stats.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                              i, ctypes.c_float, i, i, p, i, p]
        lib.dlt_flash_block_stats.restype = i
        _lib.cached = lib
    return lib


def flash_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                    start_pos: int | torch.Tensor, head_dim: int) -> torch.Tensor:
    """Causal GQA attention: ``q [B, T, n_heads, D]`` over head-major caches
    ``k/v [B, n_kv, S, D]``; query row positions are ``start_pos + t``, with
    ``start_pos`` an int or an int tensor ``[B]`` (ragged rows)."""
    B, T, n_heads, D = q.shape
    n_kv, S = k_cache.shape[1], k_cache.shape[2]
    # device positions are not read back: their call counts the whole cache
    cost = lambda: launch_cost(  # noqa: E731
        "K3", T=T, heads=n_heads, kv_heads=n_kv, head_dim=D, q_elt=q.element_size(),
        kv_elt=k_cache.element_size(), rows=S,
        depths=[S - T] * B if torch.is_tensor(start_pos) else [int(start_pos)] * B,
        path=_attn_path(k_cache.dtype, _attn_splits(B, n_kv, T * (n_heads // n_kv), S),
                        q.dtype))
    if q.device.type == "cpu":
        count(flash_attention, cost())
        base = (start_pos[:, None] if torch.is_tensor(start_pos)
                else torch.full((B, 1), int(start_pos)))
        positions = (base + torch.arange(T)[None, :]).expand(B, T)
        return attention(q, k_cache, v_cache, positions, head_dim)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not supports(tuple(q.shape), n_kv, S):
        raise ValueError(f"flash_attention: q={tuple(q.shape)}, S={S} not supported "
                         f"(head_dim in {HEAD_DIMS}, B*n_kv*T*kv_mul and B*n_kv*S "
                         f"<= {MAX_ROWS})")
    _check_cache("flash_attention", q.device, k_cache, v_cache)
    kv_mul = n_heads // n_kv
    q_g = fold_queries(q, n_kv)
    out = torch.empty_like(q_g)
    pos_ptr, pos_scalar, _pos = _positions(start_pos, q.device)
    TQ = T * kv_mul
    n_splits = _attn_splits(B, n_kv, TQ, S)
    path = _attn_path(k_cache.dtype, n_splits, q.dtype)
    part_ptr, _part = _split_scratch(n_splits, B * n_kv * TQ, D, q.device)
    lib = _lib()
    with on_card(q.device):
        rc = lib.dlt_flash_attention(
            q_g.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            pos_ptr, pos_scalar, B, n_kv, TQ, S, D, kv_mul,
            1.0 / math.sqrt(head_dim), CACHE_KINDS[k_cache.dtype],
            int(q.dtype == torch.bfloat16), part_ptr, n_splits,
            torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention.launches += 1
    count(flash_attention, cost())
    flash_attention.last_splits = n_splits
    flash_attention.last_path = path
    check(lib, rc, "flash_attention")
    return unfold_output(out, T, n_heads).to(q.dtype)


flash_attention.launches = 0
flash_attention.moved_bytes = 0.0
flash_attention.ops = 0.0
flash_attention.last_splits = 0
flash_attention.last_path = ""


def _on(t, device: torch.device):
    """``t`` on ``device`` when it is a tensor (a start position may be an
    int)."""
    return t.to(device) if torch.is_tensor(t) else t


def flash_attention_sharded(q: torch.Tensor, k_caches: list[torch.Tensor],
                            v_caches: list[torch.Tensor], start_pos: int | torch.Tensor,
                            head_dim: int, positions: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Tensor-parallel attention over a cache split by kv heads (the JAX
    package's ``flash_attention_sharded``, its ``shard_map`` of the kernel):
    shard ``j`` of ``tp = len(k_caches)`` attends q heads ``[j * H / tp, (j +
    1) * H / tp)`` of ``q [B, T, H, D]`` (on the lead device) over its own
    ``[B, n_kv_l, S, D]`` caches, which hold the kv heads those q heads read
    (``parallel.sharding.kv_heads``): one :func:`flash_attention` (K3) a
    shard at the shard's local shapes, on the shard's device. Attention is
    independent across heads, so nothing is summed: the outputs are
    concatenated on ``q``'s device. With ``positions [B, T]`` each shard
    runs the plain oracle instead (the ``attn_impl`` choice of
    ``models/llama.py::_use_flash``)."""
    tp = len(k_caches)
    hl = q.shape[2] // tp
    outs = []
    for j, (kc, vc) in enumerate(zip(k_caches, v_caches)):
        qj = q[:, :, j * hl:(j + 1) * hl].to(kc.device)
        if positions is None:
            att = flash_attention(qj, kc, vc, _on(start_pos, kc.device), head_dim)
        else:
            att = attention(qj, kc, vc, positions.to(kc.device), head_dim)
        outs.append(att.to(q.device))
    return torch.cat(outs, dim=2)


def _check_cache(what: str, device: torch.device, k: torch.Tensor, v: torch.Tensor) -> None:
    if k.dtype not in CACHE_KINDS or v.dtype != k.dtype:
        raise ValueError(f"{what}: cache dtype {k.dtype} not supported")
    for name, t in (("k", k), ("v", v)):
        if not t.is_contiguous() or t.device != device or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} cache must be contiguous and "
                             f"16-byte aligned on {device}")


def _positions(start_pos, device: torch.device):
    """``(pointer, scalar, keep-alive tensor)`` of a start position: an int
    rides as the scalar, a ``[B]`` tensor as an int32 table on the device."""
    if torch.is_tensor(start_pos):
        pos = start_pos.to(device=device, dtype=torch.int32).contiguous()
        return pos.data_ptr(), 0, pos
    return None, int(start_pos), None


def _block_attn(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor, head_dim: int):
    """Unnormalized block attention; the plain version of K3s (the JAX
    package's ``parallel/ring.py::_block_attn``).

    ``qg: [B, T, n_kv, kv_mul, hd]`` grouped queries (read as f32), ``k/v: [B, n_kv,
    S, hd]`` (head-major cache block), ``mask: [B, T, S]`` True where
    visible. Returns ``(acc [B,T,n_kv,kv_mul,hd], m [B,T,n_kv,kv_mul],
    l [same])``; a fully masked row gives ``acc = 0``, ``l = 0``,
    ``m = -inf`` with no NaN (the ``m_safe`` clamp)."""
    scores = torch.einsum("btkmh,bksh->btkms", qg.float(), k.float())
    scores = scores / math.sqrt(head_dim)
    mask_b = mask[:, :, None, None, :]
    scores = torch.where(mask_b, scores, float("-inf"))
    m = torch.amax(scores, dim=-1)                     # [B,T,k,mul]; may be -inf
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(mask_b, torch.exp(scores - m_safe[..., None]), 0.0)
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("btkms,bksh->btkmh", p, v.float())
    return acc, m, l


def flash_block_stats_plain(q_g: torch.Tensor, k_block: torch.Tensor,
                            v_block: torch.Tensor, q_pos0: int | torch.Tensor,
                            kv_pos0: int, head_dim: int, t: int):
    """K3s's plain version: :func:`_block_attn` (the f32 einsum with the
    ``-inf`` mask and the ``m_safe`` clamp) around the kernel's GQA-folded
    layout. Same arguments and results as :func:`flash_block_stats`."""
    B, n_kv, TQ, D = q_g.shape
    kv_mul = TQ // t
    S = k_block.shape[2]
    dev = q_g.device
    base = (q_pos0.to(dev).long()[:, None] if torch.is_tensor(q_pos0)
            else torch.full((B, 1), int(q_pos0), device=dev))
    q_positions = base + torch.arange(t, device=dev)[None, :]           # [B, t]
    kv_pos = kv_pos0 + torch.arange(S, device=dev)
    mask = kv_pos[None, None, :] <= q_positions[:, :, None]             # [B, t, S]
    qg = q_g.float().reshape(B, n_kv, t, kv_mul, D).permute(0, 2, 1, 3, 4)
    acc, m, l = _block_attn(qg, k_block, v_block, mask, head_dim)
    return (acc.permute(0, 2, 1, 3, 4).reshape(B, n_kv, TQ, D),
            m.permute(0, 2, 1, 3).reshape(B, n_kv, TQ),
            l.permute(0, 2, 1, 3).reshape(B, n_kv, TQ))


def flash_block_stats(q_g: torch.Tensor, k_block: torch.Tensor, v_block: torch.Tensor,
                      q_pos0: int | torch.Tensor, kv_pos0: int, head_dim: int, t: int):
    """Unnormalised attention of GQA-folded queries over one KV block (K3s).

    ``q_g [B, n_kv, TQ = t * kv_mul, D]`` (f32, or bf16 under bf16
    compute: read as f32, its dtype picks the path), row ``r`` at absolute
    position ``q_pos0 + r // kv_mul`` (``q_pos0`` an int or a ``[B]``
    tensor); ``k/v_block [B, n_kv, S_l, D]`` f32, bf16 or e4m3 holding positions
    ``[kv_pos0, kv_pos0 + S_l)`` (f8 e4m3 too). Returns ``(acc [B, n_kv, TQ, D],
    m [B, n_kv, TQ], l [B, n_kv, TQ])``, all f32; a row that sees nothing of
    the block gets exactly ``acc = 0``, ``l = 0``, ``m = -inf``."""
    B, n_kv, TQ, D = q_g.shape
    S = k_block.shape[2]
    cost = lambda: launch_cost(  # noqa: E731
        "K3s", T=t, heads=n_kv * (TQ // t), kv_heads=n_kv, head_dim=D, B=B,
        q_elt=q_g.element_size(), kv_elt=k_block.element_size(),
        # device positions: the whole block
        seen=([S] * t if torch.is_tensor(q_pos0)
              else [max(0, min(S, int(q_pos0) + i - kv_pos0 + 1)) for i in range(t)]),
        path=_attn_path(k_block.dtype, _attn_splits(B, n_kv, TQ, S), q_g.dtype))
    if q_g.device.type == "cpu":
        count(flash_block_stats, cost())
        return flash_block_stats_plain(q_g, k_block, v_block, q_pos0, kv_pos0, head_dim, t)
    if q_g.device.type != "cuda":
        raise ValueError(f"flash_block_stats: unsupported device {q_g.device}")
    if not supports_block_stats(tuple(q_g.shape), t, tuple(k_block.shape)):
        raise ValueError(f"flash_block_stats: q_g={tuple(q_g.shape)}, t={t}, "
                         f"block={tuple(k_block.shape)} not supported "
                         f"(head_dim in {HEAD_DIMS}, B*n_kv*TQ and B*n_kv*S "
                         f"<= {MAX_ROWS})")
    _check_cache("flash_block_stats", q_g.device, k_block, v_block)
    q_dtype = q_g.dtype
    c = cost()  # of the queries as given
    q_g = q_g.float().contiguous()
    acc = torch.empty_like(q_g)
    m = torch.empty((B, n_kv, TQ), dtype=torch.float32, device=q_g.device)
    l = torch.empty_like(m)
    pos_ptr, pos_scalar, _pos = _positions(q_pos0, q_g.device)
    n_splits = _attn_splits(B, n_kv, TQ, S)
    path = _attn_path(k_block.dtype, n_splits, q_dtype)
    part_ptr, _part = _split_scratch(n_splits, B * n_kv * TQ, D, q_g.device)
    lib = _lib()
    with on_card(q_g.device):
        rc = lib.dlt_flash_block_stats(
            q_g.data_ptr(), k_block.data_ptr(), v_block.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), pos_ptr, pos_scalar, int(kv_pos0), B, n_kv, TQ,
            S, D, TQ // t, 1.0 / math.sqrt(head_dim),
            CACHE_KINDS[k_block.dtype], int(q_dtype == torch.bfloat16), part_ptr, n_splits,
            torch.cuda.current_stream(q_g.device).cuda_stream)
    flash_block_stats.launches += 1
    count(flash_block_stats, c)
    flash_block_stats.last_splits = n_splits
    flash_block_stats.last_path = path
    check(lib, rc, "flash_block_stats")
    return acc, m, l


flash_block_stats.launches = 0
flash_block_stats.moved_bytes = 0.0
flash_block_stats.ops = 0.0
flash_block_stats.last_splits = 0
flash_block_stats.last_path = ""


def flash_block_stats_tc_plain(q_g: torch.Tensor, k_block: torch.Tensor,
                               v_block: torch.Tensor, q_pos0: int | torch.Tensor,
                               kv_pos0: int, head_dim: int, t: int):
    """The tensor-core path's rounding written plainly (K3s's arguments and
    results, :func:`flash_block_stats`): queries rounded to bf16 once, keys
    walked in the kernel's 64-key tiles from local slot 0 with the online
    softmax in f32, and each tile's ``p`` (against the running max) rounded
    to bf16 before ``p V``; ``l`` sums the unrounded ``p``. Not on the main
    path: the tests and ``chip_smoke.py`` hold the kernel against it."""
    B, n_kv, TQ, D = q_g.shape
    kv_mul = TQ // t
    S = k_block.shape[2]
    dev = q_g.device
    base = (q_pos0.to(dev).long()[:, None] if torch.is_tensor(q_pos0)
            else torch.full((B, 1), int(q_pos0), device=dev))
    limit = (base - kv_pos0 + torch.arange(TQ, device=dev)[None, :] // kv_mul).clamp(max=S - 1)
    q = q_g.to(torch.bfloat16).float()
    scale = 1.0 / math.sqrt(head_dim)
    m = torch.full((B, n_kv, TQ), float("-inf"), device=dev)
    l = torch.zeros((B, n_kv, TQ), device=dev)
    acc = torch.zeros((B, n_kv, TQ, D), device=dev)
    newest = int(limit.max())
    for s0 in range(0, newest + 1 if newest >= 0 else 0, TC_BS):
        k = k_block[:, :, s0:s0 + TC_BS].float()
        v = v_block[:, :, s0:s0 + TC_BS].float()
        keys = s0 + torch.arange(k.shape[2], device=dev)
        vis = keys[None, None, :] <= limit[:, :, None]                  # [B, TQ, n]
        s = torch.einsum("bkrd,bksd->bkrs", q, k) * scale
        s = torch.where(vis[:, None], s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(torch.isfinite(m_new), m_new, 0.0)         # -inf rows: p = 0
        p = torch.exp(s - m_use[..., None])
        corr = torch.exp(m - m_use)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkrs,bksd->bkrd", p.to(torch.bfloat16).float(), v)
        m = m_new
    return acc, m, l


def flash_attention_tc_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                             start_pos: int | torch.Tensor, head_dim: int) -> torch.Tensor:
    """:func:`flash_attention`'s arguments and result, with the tensor-core
    path's rounding (:func:`flash_block_stats_tc_plain` over the whole
    cache, then ``acc / l``)."""
    B, T, n_heads, D = q.shape
    n_kv = k_cache.shape[1]
    acc, _, l = flash_block_stats_tc_plain(fold_queries(q, n_kv), k_cache, v_cache,
                                           start_pos, 0, head_dim, T)
    out = acc / torch.where(l > 0, l, 1.0)[..., None]
    return unfold_output(out, T, n_heads).to(q.dtype)
