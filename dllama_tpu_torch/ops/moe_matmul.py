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
only in the order of its f32 sums; ``a8`` equals it bit for bit.

Two kernels, picked by the decoder alone (:func:`_moe_kernel`, the C
entry's ``takes_tc``): dense f32 planes take the FP32 SIMT kernel, every
other decoder the tensor cores (``mma.sync``, a row budget of
:data:`_ROWS` rows a slice, :func:`_row_slices`). The tensor-core kernel
forms its A operand per decoder (:func:`tc_operand`) and, in exact mode,
applies each Q40 block's scale once to the block's f32 sum;
:func:`moe_matmul_tc_plain` writes that arithmetic out plainly (the twin
the kernel is held against on the card; nothing on the main path calls
it). The wrapper runs the plain version on a CPU tensor and on a CUDA
tensor launches K5 or raises. ``moe_matmul.launches`` counts launches (one
a call, whichever kernel ran), ``moved_bytes`` and ``ops`` every call's
bytes and operations (``ops/cost.py``, every group counted: the offsets
stay on the device); ``last_splits`` holds the K split of the
last one (:func:`_moe_splits`; 1: none), ``last_kernel`` its kernel
(``"tc"`` or ``"simt"``).
"""

from __future__ import annotations

import ctypes

import torch

from ..formats.quants import Q40_BLOCK_SIZE
from .cost import count, launch_cost
from .cuda_build import SMS, check, load, on_card
from .linear import QuantizedWeight, dequantize_weight
from .quant_matmul import _codes_arg, q40_gemv_tc_exact_plain

DECODERS = ("q", "dense", "a8", "a16", "prescaled")
_BN = 128  # columns a block, both kernels (csrc: BN, TC_BN)
_KC = 256  # K rows of the unit of a K split (csrc: KC)
_ROWS = 64  # the tensor-core kernel's row budget: rows a slice (csrc: TC_ROWS)
# the tensor-core kernel's resident blocks: two an SM (one round of the grid)
_TC_ROUND = 2 * SMS
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


def _a8_rows(x: torch.Tensor, sx: torch.Tensor | None):
    """The a8 decoder's ``(codes, row scales)``: ``x`` quantized per row
    (:func:`~dllama_tpu_torch.ops.turbo.quantize_activations_a8`), or, with
    ``sx``, ``x`` itself as the int8 codes of a row quantized already (a
    tensor-parallel shard's columns of the whole row's codes)."""
    if sx is None:
        from .turbo import quantize_activations_a8

        return quantize_activations_a8(x)
    if x.dtype != torch.int8 or sx.dtype != torch.float32 or sx.numel() != x.shape[0]:
        raise ValueError(f"moe_matmul: a8 codes must be int8 with one f32 scale a row, got "
                         f"{x.dtype} {tuple(x.shape)} and {sx.dtype} {tuple(sx.shape)}")
    return x, sx.reshape(-1, 1)


def moe_matmul_plain(x: torch.Tensor, we, offsets: torch.Tensor | None, *,
                     decoder: str, fast: bool = False,
                     sx: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of K5: the JAX package's ragged regime literally,
    one dense product per group over its rows (the group sizes read back to
    the host). Rows past the last group's stay 0. Returns f32 ``[R, N]``."""
    G, K, N = _planes(we, decoder)
    R = x.shape[0]
    b = _group_bounds(offsets, G, R)
    y = torch.zeros((R, N), dtype=torch.float32, device=x.device)
    if decoder == "a8":
        xq, sx = _a8_rows(x, sx)
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


def _moe_kernel(dec: int) -> str:
    """The kernel a C decoder code takes, by the decoder alone: the FP32
    SIMT kernel for dense f32 planes, the tensor cores for every other
    (``csrc/moe_matmul.cu::takes_tc``, the same rule)."""
    return "simt" if dec == _DEC_D_F32 else "tc"


def _row_slices(n_rows: int) -> list[tuple[int, int, int]]:
    """The tensor-core kernel's slices of a group of ``n_rows`` rows:
    ``(first row, rows, n8 tiles)``, each slice at most :data:`_ROWS` rows
    and the least number of 8-row tiles (1, 2, 4 or 8) that holds it. Each
    slice streams the group's plane tile once."""
    out = []
    for lo in range(0, n_rows, _ROWS):
        n = min(_ROWS, n_rows - lo)
        out.append((lo, n, next(t for t in (1, 2, 4, 8) if 8 * t >= n)))
    return out


def _tc_items(R: int, G: int) -> int:
    """The tensor-core grid's rows (``csrc/moe_matmul.cu::tc_items``): with
    one group its ``R / 64`` slices, else ``min(G, R) + R // 64``; at least
    the number of work items (:func:`_row_slices` of every group) any
    routing of ``R`` rows over ``G`` groups makes."""
    return -(-R // _ROWS) if G == 1 else min(G, R) + R // _ROWS


def tc_operand(we, g: int, decoder: str, fast: bool = False) -> torch.Tensor:
    """The A operand of group ``g`` ``[K, N]`` as the tensor-core kernel
    forms it: bf16 for the bf16 products (exact ``q`` and ``a16``: the codes,
    exact in bf16; fast ``q``: ``bf16(code * bf16(scale))``; ``prescaled``:
    ``bf16(bf16(w8) * bf16(scale))``; bf16 ``dense``: the plane), int8 for
    ``a8``. Dense f32 planes take the SIMT kernel and have none."""
    _planes(we, decoder)
    if decoder == "q":
        if not fast:
            return we.codes[g].to(torch.bfloat16)
        return dequantize_weight(QuantizedWeight(scales=we.scales[g], codes=we.codes[g],
                                                 kind=we.kind), torch.bfloat16)
    if decoder == "dense":
        if we.dtype != torch.bfloat16:
            raise ValueError(f"moe_matmul: {we.dtype} dense planes take the SIMT kernel")
        return we[g]
    if decoder == "a8":
        return we.w8[g]
    if decoder == "a16":
        return we.w8[g].to(torch.bfloat16)
    return we.w8[g].to(torch.bfloat16) * we.scale[g].to(torch.bfloat16)[None, :]


def moe_matmul_tc_plain(x: torch.Tensor, we, offsets: torch.Tensor | None, *,
                        decoder: str, fast: bool = False) -> torch.Tensor:
    """The plain version of the tensor-core kernel's arithmetic (the twin it
    is held against on the card), group by group and slice by slice
    (:func:`_row_slices`): the A operand of :func:`tc_operand` against the
    activations as the kernel reads them. Exact ``q``: K2 exact's
    tensor-core arithmetic (:func:`~dllama_tpu_torch.ops.quant_matmul.q40_gemv_tc_exact_plain`)
    on each group: each f32 activation as three bf16 parts, their products
    with the codes summed in f32 over one Q40 block, the block's f32 scale
    applied once to that sum (``sum_b s_b * sum_{k in b} x_k * code_k``
    instead of :func:`moe_matmul_plain`'s ``sum_k x_k * (code_k * s_b)``);
    ``a8``: exact integer sums, ``acc * sx * scale``; ``a16``: f32 sums
    times the column scale; the rest bf16 activations against A with f32
    sums. Returns f32 ``[R, N]``."""
    G, K, N = _planes(we, decoder)
    R = x.shape[0]
    b = _group_bounds(offsets, G, R)
    y = torch.zeros((R, N), dtype=torch.float32, device=x.device)
    if decoder == "a8":
        from .turbo import quantize_activations_a8

        xq, sx = quantize_activations_a8(x)
    for g in range(G):
        if b[g + 1] <= b[g]:
            continue
        a = tc_operand(we, g, decoder, fast)
        for first, n, _ in _row_slices(b[g + 1] - b[g]):
            rows = slice(b[g] + first, b[g] + first + n)
            if decoder == "q" and not fast:
                y[rows] = q40_gemv_tc_exact_plain(
                    x[rows], QuantizedWeight(scales=we.scales[g], codes=we.codes[g],
                                             kind=we.kind))
            elif decoder == "a8":
                acc = xq[rows].double() @ a.double()  # exact integer sums
                y[rows] = acc.float() * sx[rows] * we.scale[g]
            else:
                acc = x[rows].to(torch.bfloat16).float() @ a.float()
                y[rows] = acc * we.scale[g] if decoder == "a16" else acc
    return y


def _lib():
    lib = getattr(_lib, "cached", None)
    if lib is None:
        lib = load("moe_matmul")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dlt_moe_matmul.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        lib.dlt_moe_matmul.restype = i
        _lib.cached = lib
    return lib


def _operands(x: torch.Tensor, we, decoder: str, fast: bool, sx: torch.Tensor | None = None):
    """``(x, sx, planes, scales, dec, scale_bf16, q80)`` as the C entry
    takes them: activations cast (or quantized) for the decoder; ``q80``:
    the codes are any int8 (Q80 and turbo planes; Q40 codes are decoded as
    nibbles)."""
    if decoder == "q":
        if we.codes.dtype != torch.int8:
            raise ValueError(f"moe_matmul: codes must be int8, got {we.codes.dtype}")
        if we.scales.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"moe_matmul: scales must be f32 or bf16, got {we.scales.dtype}")
        if we.scales.dtype == torch.bfloat16 and not fast:
            raise ValueError("moe_matmul: bf16 scales take the fast decoder")
        xin = x.to(torch.bfloat16 if fast else torch.float32)
        return (xin, None, we.codes, we.scales, _DEC_Q_BF16 if fast else _DEC_Q_F32,
                int(we.scales.dtype == torch.bfloat16), _codes_arg(we))
    if decoder == "dense":
        if we.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"moe_matmul: dense planes must be f32 or bf16, got {we.dtype}")
        dec = _DEC_D_F32 if we.dtype == torch.float32 else _DEC_D_BF16
        return x.to(we.dtype), None, we, None, dec, 0, 1
    if we.w8.dtype != torch.int8 or we.scale.dtype != torch.float32:
        raise ValueError("moe_matmul: turbo planes must be int8 with f32 scales")
    if decoder == "a8":
        xq, sx = _a8_rows(x, sx)
        return xq, sx.reshape(-1).contiguous(), we.w8, we.scale, _DEC_A8, 0, 1
    return (x.to(torch.bfloat16), None, we.w8, we.scale,
            _DEC_A16 if decoder == "a16" else _DEC_PRE, 0, 1)


def _moe_splits(R: int, K: int, N: int, G: int, kernel: str = "tc") -> tuple[int, int]:
    """``(splits, k_split)``: K splits across blocks, each split a run of
    whole 256-row chunks; their raw sums are added in split order by a
    second kernel. The blocks that can hold rows are ``N / 128`` column
    tiles times at most ``min(R, G)`` groups for the SIMT kernel (the host
    does not know how many groups the routing filled), times the grid's
    work items (:func:`_tc_items`) for the tensor cores. The SIMT kernel
    splits while those blocks would leave SMs idle. The tensor-core kernel
    fills one round of resident blocks (:data:`_TC_ROUND`) when they fit in
    one, aims at about four rounds when they take one to two (so that the
    last round does not run nearly empty), and does not split beyond; and
    only as far as the splits' raw sums stay under a quarter of the weight
    bytes the call reads (``splits * R * N * 4 <= min(R, G) * K * N / 4``).
    The thresholds are what an H100 80GB HBM3 at 700 W timed best among 1,
    2, 3, 4 and 8 splits (PERF.md §6)."""
    chunks = -(-K // _KC)
    if R <= 0:
        return 1, chunks * _KC
    if kernel == "simt":
        active = -(-N // _BN) * min(R, G)
        if active >= SMS or chunks <= 1:
            return 1, chunks * _KC
        want = -(-SMS // active)
    else:
        active = -(-N // _BN) * _tc_items(R, G)
        if active <= _TC_ROUND:
            want = _TC_ROUND // active
        elif active < 2 * _TC_ROUND:
            want = -(-4 * _TC_ROUND // active)
        else:
            return 1, chunks * _KC
        want = min(want, max(1, min(R, G) * K // (16 * R)))
    per = -(-chunks // max(1, min(chunks, want)))
    return -(-chunks // per), per * _KC


def moe_matmul(x: torch.Tensor, we, offsets: torch.Tensor | None, *, decoder: str,
               fast: bool = False, sx: torch.Tensor | None = None) -> torch.Tensor:
    """K5: ``x [R, K]`` (rows sorted by group) against the stack ``we`` with
    int32 ``offsets [G + 1]`` on ``x``'s device (or ``None`` for one group);
    returns f32 ``[R, N]``. Rows past ``offsets[G]`` belong to no group and
    are not written. ``sx`` (a8 only): ``x`` is int8 codes quantized
    already, with these row scales. The plain version on a CPU tensor."""
    if sx is not None and decoder != "a8":
        raise ValueError(f"moe_matmul: row scales come with the a8 decoder, not {decoder!r}")
    G, K, N = _planes(we, decoder)
    R = x.shape[0]
    # the offsets stay on the device: every group that can hold a row counts
    cost = lambda: launch_cost(  # noqa: E731
        "K5", R=R, K=K, N=N, used=min(G, R) if offsets is not None else 1, decoder=decoder,
        fast=fast, plane_elt=we.element_size() if decoder == "dense" else 4)
    if x.device.type == "cpu":
        count(moe_matmul, cost())
        return moe_matmul_plain(x, we, offsets, decoder=decoder, fast=fast, sx=sx)
    if x.device.type != "cuda":
        raise ValueError(f"moe_matmul: unsupported device {x.device}")
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"moe_matmul: x {tuple(x.shape)} against planes [{G}, {K}, {N}]")
    if K % Q40_BLOCK_SIZE or N % 4:
        raise ValueError(f"moe_matmul: needs K % 32 == 0 and N % 4 == 0, got K={K}, N={N}")
    if offsets is None and G != 1:
        raise ValueError("moe_matmul: offsets are required for more than one group")
    if offsets is not None and (offsets.dtype != torch.int32 or offsets.numel() != G + 1):
        raise ValueError(f"moe_matmul: offsets must be int32 [{G + 1}], got "
                         f"{offsets.dtype} {tuple(offsets.shape)}")
    xin, sx, planes, scales, dec, sbf16, q80 = _operands(x, we, decoder, fast, sx)
    xin = xin.contiguous()
    for name, t in (("x", xin), ("sx", sx), ("planes", planes), ("scales", scales),
                    ("offsets", offsets)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"moe_matmul: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"moe_matmul: {name} must be contiguous and 16-byte aligned")
    kernel = _moe_kernel(dec)
    splits, k_split = _moe_splits(R, K, N, G, kernel)
    y = torch.empty((R, N), dtype=torch.float32, device=x.device)
    # the splits' raw sums (int32 for a8, f32 otherwise: 4 bytes either way)
    part = (torch.empty((splits, R, N), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    lib = _lib()
    with on_card(x.device):
        rc = lib.dlt_moe_matmul(ptr(xin), ptr(sx), ptr(planes), ptr(scales), ptr(offsets),
                                y.data_ptr(), ptr(part), R, K, N, G, splits, k_split, dec,
                                sbf16, q80, torch.cuda.current_stream(x.device).cuda_stream)
    moe_matmul.launches += 1
    count(moe_matmul, cost())
    moe_matmul.last_splits = splits
    moe_matmul.last_kernel = kernel
    check(lib, rc, "moe_matmul")
    return y


moe_matmul.launches = 0
moe_matmul.moved_bytes = 0.0
moe_matmul.ops = 0.0
moe_matmul.last_splits = 0
moe_matmul.last_kernel = ""
