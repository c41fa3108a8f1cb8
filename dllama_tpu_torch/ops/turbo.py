"""Turbo quant mode: per-column int8 planes with the scales in the epilogue
(the port of the JAX package's ``ops/turbo.py``).

At load (``--quant-mode turbo|turbo16``) every Q40/Q80 plane is requantized
to **per-column int8**: ``w8[k, n] = round(dense[k, n] / scale[n])``,
``scale[n] = colmax / 127``, the same ~1 byte a weight, no per-element
scale left in the matmul. The arithmetic is the JAX package's as XLA runs
it, so the derived planes equal its bit for bit: XLA turns the division by
the constant 127 into a product with its f32 reciprocal (:data:`_INV127`),
the division by ``scale`` stays an f32 division, rounding is half to even.

* ``a8`` (``turbo``) quantizes the activations per row to int8
  (:func:`quantize_activations_a8`) and sums ``s8 x s8`` products in int32,
  with one ``acc * sx * scale[n]`` f32 product per output element;
* ``a16`` (``turbo16``) keeps bf16 activations: bf16 times the int8 code
  (exact in f32), f32 sums, ``acc * scale[n]`` in the epilogue.

The a8/a16 choice rides on the weight (:class:`TurboWeight`), fixed when it
was derived. On a CUDA tensor :func:`turbo_matmul` launches kernel K5
(:func:`~dllama_tpu_torch.ops.moe_matmul.moe_matmul`, the grouped expert
matmul, with one group); on a CPU tensor it runs its plain version
(:func:`turbo_matmul_plain`). Turbo is opt-in and never the default: the
per-column requantization of 4-bit block codes adds bounded drift.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .linear import QuantizedWeight, dequantize_weight

# 1/127 rounded to f32: ``x / 127`` under XLA is ``x * _INV127``
_INV127 = float(np.float32(1.0 / 127.0))


class TurboWeight(NamedTuple):
    """Per-column-requantized int8 weight, K-major like QuantizedWeight.

    ``w8``: int8 ``[..., in, out]``; ``scale``: f32 ``[..., out]`` with
    ``dense[k, n] ~= w8[k, n] * scale[n]``; ``a8``: whether the matmul
    quantizes activations to int8, fixed when the weight was derived.
    Leading axes stack experts (``[E, in, out]``)."""

    w8: torch.Tensor
    scale: torch.Tensor
    a8: bool = True

    @property
    def out_features(self) -> int:
        return self.w8.shape[-1]

    @property
    def in_features(self) -> int:
        return self.w8.shape[-2]


def _derive_one(qw: QuantizedWeight) -> tuple[torch.Tensor, torch.Tensor]:
    """One ``[K, N]`` plane (f32 or bf16 scales) -> ``(w8, scale)``."""
    dense = dequantize_weight(qw, torch.float32)  # [K, N]
    amax = torch.amax(torch.abs(dense), dim=-2)   # [N]
    scale = torch.where(amax > 0.0, amax * _INV127, torch.ones_like(amax))
    w8 = torch.clamp(torch.round(dense / scale[None, :]), -127, 127).to(torch.int8)
    return w8, scale


def derive_turbo(qw: QuantizedWeight, a8: bool = True) -> TurboWeight:
    """Requantize a Q40/Q80 weight (``[K, N]`` or an expert stack ``[E, K,
    N]``) to a :class:`TurboWeight`. A stack converts one plane at a time
    into preallocated outputs, so the dense f32 intermediate is one plane."""
    if qw.codes.dim() == 2:
        w8, scale = _derive_one(qw)
        return TurboWeight(w8, scale, a8)
    lead = qw.codes.shape[:-2]
    K, N = qw.codes.shape[-2:]
    codes = qw.codes.reshape(-1, K, N)
    scales = qw.scales.reshape(-1, *qw.scales.shape[-2:])
    w8 = torch.empty(codes.shape, dtype=torch.int8, device=codes.device)
    scale = torch.empty((codes.shape[0], N), dtype=torch.float32, device=codes.device)
    for i in range(codes.shape[0]):
        w8[i], scale[i] = _derive_one(QuantizedWeight(scales=scales[i], codes=codes[i],
                                                      kind=qw.kind))
    return TurboWeight(w8.reshape(*lead, K, N), scale.reshape(*lead, N), a8)


# the matmul weights of a layer, in the loader's order
_LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "we1", "we2", "we3")


def turbo_layer(lp, a8: bool = True):
    """Convert every QuantizedWeight leaf of one layer's ``LayerParams`` to a
    TurboWeight, in place, one leaf at a time: each field is rebound to its
    derived weight as soon as it lands, which drops the source planes, so
    the conversion holds at most one extra leaf at once (what
    ``runtime/hbm.py`` charges). The loader derives each layer so before it
    cuts it over tp shards (``runtime/weights.py``): a plane's column scales
    come from its whole columns. Returns ``lp``."""
    for name in _LAYER_WEIGHTS:
        w = getattr(lp, name)  # rebinding drops the previous leaf's source
        if isinstance(w, QuantizedWeight):
            setattr(lp, name, derive_turbo(w, a8=a8))
    return lp


def turbo_params(params, a8: bool = True):
    """:func:`turbo_layer` over every layer of ``params``, then the head.
    Returns ``params``; the caller treats the quantized tree as consumed."""
    for lp in params.layers:
        turbo_layer(lp, a8)
    if isinstance(params.logits, QuantizedWeight):
        params.logits = derive_turbo(params.logits, a8=a8)
    return params


def quantize_activations_a8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 activation quantization (the Q80 idea at row
    granularity): ``(xq int8, sx f32 [..., 1])`` with ``x ~= xq * sx``. The
    one implementation of the a8 prologue, shared by the dense turbo matmul
    and the MoE expert dots."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    sx = torch.where(amax > 0.0, amax * _INV127, torch.ones_like(amax))
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def turbo_matmul_plain(x: torch.Tensor, w: TurboWeight) -> torch.Tensor:
    """The plain version of :func:`turbo_matmul` (the JAX package's
    ``dot_general`` pair): a8 sums the int8 products in float64 (exact, as
    the int32 sums of the kernel and of XLA are: no sum reaches 2^31, and
    float64 holds every integer below 2^53; CUDA has no int64 matmul), then
    ``acc * sx * scale``; a16 multiplies bf16 activations by the codes in
    f32 (exact products), sums in f32 and scales. Returns ``x.dtype``."""
    *lead, K = x.shape
    x2 = x.reshape(-1, K)
    if w.a8:
        xq, sx = quantize_activations_a8(x2)
        acc = torch.matmul(xq.double(), w.w8.double())
        out = acc.float() * sx * w.scale
    else:
        acc = torch.matmul(x2.to(torch.bfloat16).float(), w.w8.float())
        out = acc * w.scale
    return out.reshape(*lead, w.out_features).to(x.dtype)


def turbo_matmul_q8(xq: torch.Tensor, sx: torch.Tensor, w: TurboWeight) -> torch.Tensor:
    """The a8 product of activations quantized already (``xq`` int8 ``[...,
    K]``, ``sx`` f32 ``[..., 1]`` from :func:`quantize_activations_a8`):
    ``acc * sx * scale``, f32. A tensor-parallel col split quantizes the whole
    row once and gives each shard its columns of ``xq`` with the row's
    ``sx`` (``ops/linear.py::linear_sharded``). K5 with one group on a CUDA
    tensor, exact integer sums in float64 on a CPU tensor."""
    *lead, K = xq.shape
    q2, s2 = xq.reshape(-1, K), sx.reshape(-1, 1)
    if xq.device.type == "cpu":
        out = torch.matmul(q2.double(), w.w8.double()).float() * s2 * w.scale
    else:
        from .moe_matmul import moe_matmul

        stack = TurboWeight(w.w8[None], w.scale[None], w.a8)
        out = moe_matmul(q2, stack, None, decoder="a8", sx=s2)
    return out.reshape(*lead, w.out_features)


def turbo_matmul(x: torch.Tensor, w: TurboWeight) -> torch.Tensor:
    """``y[..., N] = x[..., K] @ (w8 * scale)`` without a per-element
    dequant: K5 with one group on a CUDA tensor (a8: the ``__dp4a`` integer
    dot; a16: bf16 times int8), the plain version on a CPU tensor. Returns
    ``x.dtype``."""
    if x.device.type == "cpu":
        return turbo_matmul_plain(x, w)
    from .moe_matmul import moe_matmul

    *lead, K = x.shape
    stack = TurboWeight(w.w8[None], w.scale[None], w.a8)
    y = moe_matmul(x.reshape(-1, K), stack, None, decoder="a8" if w.a8 else "a16")
    return y.reshape(*lead, w.out_features).to(x.dtype)
