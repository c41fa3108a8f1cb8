"""Q40 dequantizing matmul: kernels K1 (prefill tile) and K2 (decode GEMV).

``y[..., N] = x[..., K] @ (codes[K, N] * repeat(scales[K/32, N], 32 along K))``

* **K1** :func:`q40_matmul` — replaces the JAX package's
  ``ops/quant_matmul.py::_kernel`` (the (N/bn, K/bk)-tiled Pallas kernel,
  ``pallas_call`` at :293). Exact mode is bound by FP32 operations: a
  block owns 128 weight columns and up to 128 rows (a whole 128-token
  chunk), each thread an 8x8 register micro-tile fed by 16-byte shared
  loads, K in 32-row stages (one Q40 block) with the next stage in flight
  (x by ``cp.async``, codes in registers) during the current one's FMAs, and
  the same split-K rule as fast mode for narrow N. Fast mode is
  bound by the weight bytes at the prefill widths, the bf16 operation bound
  close behind at M = 128: a block owns 256 weight columns for up to 128
  rows and streams each weight byte once through a TMA-fed ring of 64-row
  stages; the codes are dequantized straight into the A registers of a
  swapped ``wgmma`` product (``y^T = W^T x^T``). In both modes narrow N
  takes a K split across blocks (:func:`_matmul_splits`), summed in split
  order.
* **K2** :func:`q40_gemv` — replaces ``_decode_kernel`` (the single-pass
  decode GEMV, ``pallas_call`` at :208) for ``M <= FUSED_MAX_M``. Bound:
  bytes (one pass over the planes). Design: neighbouring threads on
  neighbouring N columns for coalesced code loads, K split across the warps
  of a block (reduced in shared memory) and, for narrow N, across blocks.

Both live in ``csrc/quant_matmul.cu`` (see its header for the full note).
Each wrapper runs :func:`quant_matmul_plain` — the plain PyTorch version of
the same function — on a CPU tensor, and on a CUDA tensor launches its
kernel or raises. ``launches`` on each wrapper counts kernel launches, and
``last_splits`` holds the K split of its last launch (1: none).

Unlike the JAX package, where ``auto`` reached the decode kernel only under
``DLLAMA_TPU_QUANT_KERNEL=fused``, ``M <= 16`` on CUDA always takes K2.
"""

from __future__ import annotations

import ctypes

import torch

from ..formats.quants import Q40_BLOCK_SIZE
from .cuda_build import SMS, check, load, on_card
from .linear import QuantizedWeight, dequantize_weight

# widest dispatch that counts as the decode regime (the JAX package's
# FUSED_MAX_M): single steps and short verifies take K2, wider ones K1
FUSED_MAX_M = 16
_GEMV_BN = 128         # N columns per K2 block (csrc: GEMV_BN)
_GEMV_WARPS = 8        # warps per K2 block, each taking one Q40 block per step
# K2 blocks resident at once on the H100: 132 SMs x 2 blocks of 256 threads
# at the M = 1 kernel's ~128 registers. A grid just above it runs a second,
# mostly idle wave, so the K split rounds the block count down to it.
_RESIDENT_BLOCKS = 264
# K1 fast tile (csrc: FT_*): 256 weight columns and a slab of up to 128
# activation rows per block, K in 64-row stages; one block per SM (its
# shared-memory ring), so a split grid aims at the SMs in one wave
_TILE_N = 256
_TILE_M = 128
_STAGE_K = 64
# each K split walks at least 8 stages (512 rows of K): fewer give the
# pipeline no time to fill, and the f32 partials ([splits, M, N]) outgrow the
# weight bytes the split saves (at M = 128, 4 * M bytes a column per split
# against 1.06 * K_split)
_MIN_SPLIT_STAGES = 8
# K1 exact tile (csrc: XT_*): 128 weight columns and 32, 64 or 128
# activation rows per block (:func:`_exact_tile_m`), K in 32-row stages (one
# Q40 block each); each K split walks at least 8 stages (256 rows of K,
# 2 * 128 * 256 * 128 operations a block against 2 * 4 * 128 * 128 bytes of
# partials to write and sum)
_EXACT_TILE_N = 128
_EXACT_STAGE_K = Q40_BLOCK_SIZE
_EXACT_MIN_SPLIT_STAGES = 8


def supports(x_shape: tuple[int, ...], w: QuantizedWeight, *, fast: bool = False) -> bool:
    """Whether K1 covers these shapes: any M, K a whole number of blocks;
    the fast tile also needs ``N % 16 == 0`` (its TMA copies rows of codes
    whose pitch must be a multiple of 16 bytes)."""
    K = x_shape[-1]
    return (w.codes.dim() == 2 and w.in_features == K
            and K % Q40_BLOCK_SIZE == 0 and not (fast and w.out_features % 16))


def supports_decode(x_shape: tuple[int, ...], w: QuantizedWeight) -> bool:
    """Whether K2 covers these shapes: M <= 16 and 4-column groups of N."""
    M = 1
    for d in x_shape[:-1]:
        M *= d
    return (supports(x_shape, w) and 0 < M <= FUSED_MAX_M
            and w.out_features % 4 == 0)


def quant_matmul_plain(x: torch.Tensor, w: QuantizedWeight, *,
                       fast: bool) -> torch.Tensor:
    """The plain PyTorch version of K1 and K2 (the JAX package's XLA
    dequant+dot): exact = f32 dequant and f32 matmul; fast = bf16 dequant
    and bf16 activations, whose products are exact in f32, summed in f32.
    Returns ``x.dtype``."""
    *lead, K = x.shape
    if fast:
        wd = dequantize_weight(w, torch.bfloat16).float()
        xf = x.to(torch.bfloat16).float()
    else:
        wd = dequantize_weight(w, torch.float32)
        xf = x.float()
    y = torch.matmul(xf.reshape(-1, K), wd)
    return y.reshape(*lead, w.out_features).to(x.dtype)


def _lib():
    lib = getattr(_lib, "cached", None)
    if lib is None:
        lib = load("quant_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dlt_q40_gemv.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.dlt_q40_gemv.restype = i
        lib.dlt_q40_matmul.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.dlt_q40_matmul.restype = i
        _lib.cached = lib
    return lib


def _cuda_operands(x: torch.Tensor, w: QuantizedWeight, fast: bool, what: str):
    """Cast/flatten the operands the way the kernel takes them and check
    what it cannot take: ``(x2d, scales, M, K, N)``."""
    *lead, K = x.shape
    N = w.out_features
    act = torch.bfloat16 if fast else torch.float32
    x2d = x.reshape(-1, K).to(act).contiguous()
    scales = w.scales.to(act).contiguous()
    codes = w.codes
    if not supports(tuple(x.shape), w):
        raise ValueError(f"{what}: shapes x={tuple(x.shape)} codes="
                         f"{tuple(codes.shape)} are not supported")
    for name, t in (("x", x2d), ("codes", codes), ("scales", scales)):
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")
    if codes.dtype != torch.int8:
        raise ValueError(f"{what}: codes must be int8, got {codes.dtype}")
    return x2d, scales, x2d.shape[0], K, N


def _gemv_splits(K: int, N: int) -> int:
    """K splits across blocks so that narrow N still fills the card in one
    wave; each split gives every warp of a block at least one Q40 block."""
    nkb = K // Q40_BLOCK_SIZE
    col_blocks = -(-N // _GEMV_BN)
    want = _RESIDENT_BLOCKS // col_blocks
    if want <= 1 or nkb <= _GEMV_WARPS:
        return 1
    per = max(_GEMV_WARPS, -(-nkb // want))
    per = -(-per // _GEMV_WARPS) * _GEMV_WARPS
    return -(-nkb // per)


def _exact_tile_m(M: int) -> int:
    """Rows of K1's exact tile: the least of 32, 64 and 128 that holds M
    (128 for wider calls, in several row tiles)."""
    return 32 if M <= 32 else 64 if M <= 64 else 128


def _matmul_splits(M: int, K: int, N: int, *, fast: bool = True) -> int:
    """K splits across blocks for K1's tile (fast or exact): a grid of
    fewer (N, M) tiles than SMs takes more blocks along K, each split a
    whole number of stages (64 rows fast, one 32-row Q40 block exact) and
    at least 8 of them; the partial rows are summed in split order."""
    if fast:
        tiles = -(-N // _TILE_N) * -(-M // _TILE_M)
        stage, least = _STAGE_K, _MIN_SPLIT_STAGES
    else:
        tiles = -(-N // _EXACT_TILE_N) * -(-M // _exact_tile_m(M))
        stage, least = _EXACT_STAGE_K, _EXACT_MIN_SPLIT_STAGES
    n_stages = -(-K // stage)
    if tiles >= SMS:
        return 1
    per = max(least, -(-n_stages // (SMS // tiles)))
    return -(-n_stages // per)


def q40_gemv(x: torch.Tensor, w: QuantizedWeight, *, fast: bool) -> torch.Tensor:
    """K2: decode-width (M <= 16) Q40 matmul; returns ``x.dtype``."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w, fast=fast)
    if x.device.type != "cuda":
        raise ValueError(f"q40_gemv: unsupported device {x.device}")
    if not supports_decode(tuple(x.shape), w):
        raise ValueError(f"q40_gemv: shapes x={tuple(x.shape)} codes="
                         f"{tuple(w.codes.shape)} need M <= {FUSED_MAX_M}, "
                         f"K % 32 == 0 and N % 4 == 0")
    x2d, scales, M, K, N = _cuda_operands(x, w, fast, "q40_gemv")
    splits = _gemv_splits(K, N)
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
            if splits > 1 else y)
    lib = _lib()
    with on_card(x.device):  # the launch goes to x's card
        rc = lib.dlt_q40_gemv(x2d.data_ptr(), w.codes.data_ptr(), scales.data_ptr(),
                              y.data_ptr(), part.data_ptr(), M, K, N, splits,
                              int(fast), torch.cuda.current_stream(x.device).cuda_stream)
    q40_gemv.launches += 1
    q40_gemv.last_splits = splits
    check(lib, rc, "q40_gemv")
    return y.reshape(*x.shape[:-1], N).to(x.dtype)


q40_gemv.launches = 0
q40_gemv.last_splits = 0


def q40_matmul(x: torch.Tensor, w: QuantizedWeight, *, fast: bool) -> torch.Tensor:
    """K1: tiled Q40 matmul for any M (the prefill widths); returns ``x.dtype``.
    Raises for shapes that :func:`supports` refuses (in fast mode
    ``N % 16 != 0`` too)."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w, fast=fast)
    if x.device.type != "cuda":
        raise ValueError(f"q40_matmul: unsupported device {x.device}")
    if fast and not supports(tuple(x.shape), w, fast=True):
        raise ValueError(f"q40_matmul: codes {tuple(w.codes.shape)}: the fast tile "
                         f"needs N % 16 == 0")
    x2d, scales, M, K, N = _cuda_operands(x, w, fast, "q40_matmul")
    splits = _matmul_splits(M, K, N, fast=fast)
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
            if splits > 1 else y)
    lib = _lib()
    with on_card(x.device):
        rc = lib.dlt_q40_matmul(x2d.data_ptr(), w.codes.data_ptr(), scales.data_ptr(),
                                y.data_ptr(), part.data_ptr(), M, K, N, splits, int(fast),
                                torch.cuda.current_stream(x.device).cuda_stream)
    q40_matmul.launches += 1
    q40_matmul.last_splits = splits
    check(lib, rc, "q40_matmul")
    return y.reshape(*x.shape[:-1], N).to(x.dtype)


q40_matmul.launches = 0
q40_matmul.last_splits = 0


def quant_matmul(x: torch.Tensor, w: QuantizedWeight, *, fast: bool) -> torch.Tensor:
    """``y[..., N] = x[..., K] @ dequant(w)``: K2 for ``M <= FUSED_MAX_M``,
    K1 otherwise (each its plain version on a CPU tensor)."""
    M = x.numel() // x.shape[-1]
    if M <= FUSED_MAX_M:
        return q40_gemv(x, w, fast=fast)
    return q40_matmul(x, w, fast=fast)
