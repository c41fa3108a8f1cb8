"""Grouped expert matmul: kernel K5 (``csrc/moe_matmul.cu``).

``y[r, :] = x[r, :] @ W[g(r)]`` over rows sorted by group: group ``g`` owns
rows ``offsets[g]:offsets[g + 1]`` of ``x`` and ``y``, ``offsets`` an int32
``[G + 1]`` tensor on the device (``None``: one group of every row), ``W`` a
stack of ``G`` K-major planes ``[G, K, N]`` of one of the weight reprs. The
mixture-of-experts FFN (``models/llama.py::_moe_sparse_local``) calls it
once per projection, one group per expert; the turbo dense linear
(``ops/turbo.py::turbo_matmul``) with one group.

K5 replaces no Pallas kernel. The JAX package computes the expert dots in
XLA (``models/llama.py:215-317``: ``jnp.einsum`` over gathered planes at up
to ``_MOE_GATHER_MAX_ROWS`` (token, expert) rows, one ``lax.ragged_dot`` a
projection above) and the turbo matmul in XLA (``ops/turbo.py:152-174``).
Those are static-shaped ops; the port's steps replay CUDA graphs, which
cannot read group sizes back to the host, and PyTorch has no grouped matmul
over these planes that takes device-side offsets (``csrc/moe_matmul.cu``
has the full note: bound, design).

Decoders (``decoder=``), the JAX package's numerics of each regime:

* ``"q"``: Q40/Q80 block planes (:class:`~dllama_tpu_torch.ops.linear.QuantizedWeight`
  stacks): ``fast`` = bf16 dequant ``bf16(code * bf16(scale))`` and bf16
  activations, else f32 dequant and f32 activations;
* ``"dense"``: dense planes (a tensor ``[G, K, N]``), activations cast to
  the planes' dtype;
* ``"a8"`` / ``"a16"``: turbo planes (:class:`~dllama_tpu_torch.ops.turbo.TurboWeight`)
  by the integer dot / bf16 times int8, the scale in the epilogue (the
  gather regime and the dense turbo matmul);
* ``"prescaled"``: turbo planes as the JAX ragged regime's dense rhs,
  ``bf16(bf16(w8) * bf16(scale))``, bf16 activations.

Every product is exact in f32 where the JAX package's is, every sum f32
(int32 for ``a8``, exact), so the kernel differs from the plain version
(:func:`moe_matmul_plain`, the per-group loop of the JAX ragged regime)
only in the order of its f32 sums; ``a8`` equals it bit for bit. The
wrapper runs the plain version on a CPU tensor and on a CUDA tensor
launches K5 or raises. ``moe_matmul.launches`` counts launches;
``last_splits`` holds the K split of the last one (:func:`_moe_splits`; 1:
none).
"""

from __future__ import annotations

import ctypes

import torch

from ..formats.quants import Q40_BLOCK_SIZE
from .cuda_build import SMS, check, load, on_card
from .linear import QuantizedWeight, dequantize_weight

DECODERS = ("q", "dense", "a8", "a16", "prescaled")
_BN = 128  # columns a block (csrc: BN)
_KC = 256  # K rows of a shared-memory chunk, the unit of a K split (csrc: KC)
# the C entry's decoder codes (csrc/moe_matmul.cu: enum Dec)
_DEC_Q_F32, _DEC_Q_BF16, _DEC_D_F32, _DEC_D_BF16, _DEC_A8, _DEC_A16, _DEC_PRE = range(7)


def _planes(we, decoder: str):
    """``(G, K, N)`` of an expert stack, checked against the decoder."""
    from .turbo import TurboWeight

    want = {"q": QuantizedWeight, "dense": torch.Tensor}.get(decoder, TurboWeight)
    if decoder not in DECODERS or not isinstance(we, want):
        raise ValueError(f"moe_matmul: decoder {decoder!r} does not read a "
                         f"{type(we).__name__} stack")
    plane = we.codes if decoder == "q" else we if decoder == "dense" else we.w8
    if plane.dim() != 3:
        raise ValueError(f"moe_matmul: planes must be [G, K, N], got {tuple(plane.shape)}")
    return plane.shape


def _group_bounds(offsets: torch.Tensor | None, G: int, R: int) -> list[int]:
    if offsets is None:
        return [0, R]
    b = [int(v) for v in offsets.tolist()]
    if len(b) != G + 1:
        raise ValueError(f"moe_matmul: {len(b)} offsets for {G} groups")
    return b


def moe_matmul_plain(x: torch.Tensor, we, offsets: torch.Tensor | None, *,
                     decoder: str, fast: bool = False) -> torch.Tensor:
    """The plain version of K5: the JAX package's ragged regime literally,
    one dense product per group over its rows (the group sizes read back to
    the host). Returns f32 ``[R, N]``."""
    G, K, N = _planes(we, decoder)
    R = x.shape[0]
    b = _group_bounds(offsets, G, R)
    y = torch.zeros((R, N), dtype=torch.float32, device=x.device)
    if decoder == "a8":
        from .turbo import quantize_activations_a8

        xq, sx = quantize_activations_a8(x)
    for g in range(G):
        lo, hi = b[g], b[g + 1]
        if hi <= lo:
            continue
        if decoder == "q":
            dt = torch.bfloat16 if fast else torch.float32
            wd = dequantize_weight(QuantizedWeight(scales=we.scales[g], codes=we.codes[g],
                                                   kind=we.kind), dt).float()
            y[lo:hi] = x[lo:hi].to(dt).float() @ wd
        elif decoder == "dense":
            y[lo:hi] = x[lo:hi].to(we.dtype).float() @ we[g].float()
        elif decoder == "a8":
            acc = xq[lo:hi].double() @ we.w8[g].double()  # exact integer sums
            y[lo:hi] = acc.float() * sx[lo:hi] * we.scale[g]
        elif decoder == "a16":
            y[lo:hi] = (x[lo:hi].to(torch.bfloat16).float() @ we.w8[g].float()) * we.scale[g]
        else:  # prescaled: the bf16 product of bf16(w8) and bf16(scale)
            wd = (we.w8[g].to(torch.bfloat16)
                  * we.scale[g].to(torch.bfloat16)[None, :]).float()
            y[lo:hi] = x[lo:hi].to(torch.bfloat16).float() @ wd
    return y


def _lib():
    lib = getattr(_lib, "cached", None)
    if lib is None:
        lib = load("moe_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dlt_moe_matmul.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        lib.dlt_moe_matmul.restype = i
        _lib.cached = lib
    return lib


def _operands(x: torch.Tensor, we, decoder: str, fast: bool):
    """``(x, sx, planes, scales, dec, scale_bf16)`` as the C entry takes
    them: activations cast (or quantized) for the decoder."""
    if decoder == "q":
        if we.codes.dtype != torch.int8:
            raise ValueError(f"moe_matmul: codes must be int8, got {we.codes.dtype}")
        if we.scales.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"moe_matmul: scales must be f32 or bf16, got {we.scales.dtype}")
        if we.scales.dtype == torch.bfloat16 and not fast:
            raise ValueError("moe_matmul: bf16 scales take the fast decoder")
        xin = x.to(torch.bfloat16 if fast else torch.float32)
        return (xin, None, we.codes, we.scales, _DEC_Q_BF16 if fast else _DEC_Q_F32,
                int(we.scales.dtype == torch.bfloat16))
    if decoder == "dense":
        if we.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"moe_matmul: dense planes must be f32 or bf16, got {we.dtype}")
        dec = _DEC_D_F32 if we.dtype == torch.float32 else _DEC_D_BF16
        return x.to(we.dtype), None, we, None, dec, 0
    if we.w8.dtype != torch.int8 or we.scale.dtype != torch.float32:
        raise ValueError("moe_matmul: turbo planes must be int8 with f32 scales")
    if decoder == "a8":
        from .turbo import quantize_activations_a8

        xq, sx = quantize_activations_a8(x)
        return xq, sx.reshape(-1).contiguous(), we.w8, we.scale, _DEC_A8, 0
    return (x.to(torch.bfloat16), None, we.w8, we.scale,
            _DEC_A16 if decoder == "a16" else _DEC_PRE, 0)


def _moe_splits(R: int, K: int, N: int, G: int) -> tuple[int, int]:
    """``(splits, k_split)``: K splits across blocks when the blocks that can
    hold rows (``N / 128`` column tiles times at most ``min(R, G)`` groups;
    the host does not know how many groups the routing filled) would leave
    SMs idle, each split a run of whole 256-row chunks; their sums are added
    in split order by a second kernel."""
    chunks = -(-K // _KC)
    active = -(-N // _BN) * min(R, G)
    if active >= SMS or chunks <= 1:
        return 1, chunks * _KC
    per = -(-chunks // min(chunks, -(-SMS // active)))
    return -(-chunks // per), per * _KC


def moe_matmul(x: torch.Tensor, we, offsets: torch.Tensor | None, *, decoder: str,
               fast: bool = False) -> torch.Tensor:
    """K5: ``x [R, K]`` (rows sorted by group) against the stack ``we`` with
    int32 ``offsets [G + 1]`` on ``x``'s device (or ``None`` for one group);
    returns f32 ``[R, N]``. The plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return moe_matmul_plain(x, we, offsets, decoder=decoder, fast=fast)
    if x.device.type != "cuda":
        raise ValueError(f"moe_matmul: unsupported device {x.device}")
    G, K, N = _planes(we, decoder)
    R = x.shape[0]
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"moe_matmul: x {tuple(x.shape)} against planes [{G}, {K}, {N}]")
    if K % Q40_BLOCK_SIZE or N % 4:
        raise ValueError(f"moe_matmul: needs K % 32 == 0 and N % 4 == 0, got K={K}, N={N}")
    if offsets is None and G != 1:
        raise ValueError("moe_matmul: offsets are required for more than one group")
    if offsets is not None and (offsets.dtype != torch.int32 or offsets.numel() != G + 1):
        raise ValueError(f"moe_matmul: offsets must be int32 [{G + 1}], got "
                         f"{offsets.dtype} {tuple(offsets.shape)}")
    xin, sx, planes, scales, dec, sbf16 = _operands(x, we, decoder, fast)
    xin = xin.contiguous()
    for name, t in (("x", xin), ("sx", sx), ("planes", planes), ("scales", scales),
                    ("offsets", offsets)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"moe_matmul: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"moe_matmul: {name} must be contiguous and 16-byte aligned")
    splits, k_split = _moe_splits(R, K, N, G)
    y = torch.empty((R, N), dtype=torch.float32, device=x.device)
    # the splits' raw sums (int32 for a8, f32 otherwise: 4 bytes either way)
    part = (torch.empty((splits, R, N), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    lib = _lib()
    with on_card(x.device):
        rc = lib.dlt_moe_matmul(ptr(xin), ptr(sx), ptr(planes), ptr(scales), ptr(offsets),
                                y.data_ptr(), ptr(part), R, K, N, G, splits, k_split, dec,
                                sbf16, torch.cuda.current_stream(x.device).cuda_stream)
    moe_matmul.launches += 1
    moe_matmul.last_splits = splits
    check(lib, rc, "moe_matmul")
    return y


moe_matmul.launches = 0
moe_matmul.last_splits = 0
