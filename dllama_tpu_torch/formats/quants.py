"""Q40 / Q80 block quantization codecs (host side, numpy).

The port's own copy of the JAX package's ``formats/quants.py`` (the port
imports nothing of that package). Wire-compatible with the reference formats
(reference: src/nn/nn-quants.hpp:56-72, converter/writer.py:29-74):

* **Q40** — blocks of 32 weights stored as 18 bytes: one float16 scale ``d``
  followed by 16 bytes of 4-bit codes. Byte ``j`` holds element ``j`` in its low
  nibble and element ``j+16`` in its high nibble; the dequantized value is
  ``(nibble - 8) * d``. The scale is ``signed_absmax / -8``.
* **Q80** — blocks of 32 values stored as 34 bytes: one float16 scale
  ``d = absmax/127`` followed by 32 int8 codes; value is ``code * d``.

Only the portable numpy codecs are kept; the device-side unpack into the
K-major planes lives in :mod:`dllama_tpu_torch.runtime.weights`. Stored
scales clamp to the finite f16 range, so finite input always dequantizes
finite.
"""

from __future__ import annotations

import numpy as np

QUANT_BLOCK_SIZE = 32  # every block-quantized format shares this granularity
Q40_BLOCK_SIZE = QUANT_BLOCK_SIZE
Q80_BLOCK_SIZE = QUANT_BLOCK_SIZE
Q40_BLOCK_BYTES = 2 + Q40_BLOCK_SIZE // 2  # f16 scale + 16 nibble bytes = 18
Q80_BLOCK_BYTES = 2 + Q80_BLOCK_SIZE  # f16 scale + 32 int8 = 34

# NnFloatType values (reference: src/nn/nn-quants.hpp:55-61)
F32 = 0
F16 = 1
Q40 = 2
Q80 = 3

FLOAT_TYPE_NAMES = {F32: "f32", F16: "f16", Q40: "q40", Q80: "q80"}

_F16_MAX = 65504.0  # largest finite float16 (scale saturation bound)


def tensor_bytes(float_type: int, n: int) -> int:
    """On-disk byte size of an ``n``-element tensor of the given float type."""
    if float_type == F32:
        return 4 * n
    if float_type == F16:
        return 2 * n
    if float_type in (Q40, Q80):
        if n % QUANT_BLOCK_SIZE:
            raise ValueError(f"{n} elements do not fill whole 32-blocks")
        per = Q40_BLOCK_BYTES if float_type == Q40 else Q80_BLOCK_BYTES
        return (n // QUANT_BLOCK_SIZE) * per
    raise ValueError(f"unsupported float type {float_type}")


def quantize_q40(x: np.ndarray) -> bytes:
    """Quantize flat float32 ``x`` to Q40 wire bytes (converter/writer.py:29-53):
    scale is the signed max-magnitude value divided by -8; codes are
    ``floor(x/d + 8.5)`` clipped to [0, 15]."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    assert x.ndim == 1 and x.size % Q40_BLOCK_SIZE == 0, x.shape
    g = x.reshape(-1, Q40_BLOCK_SIZE)
    gmax = g.max(axis=1)
    gmin = g.min(axis=1)
    d = np.where(-gmin > gmax, gmin, gmax) / -8.0
    d16 = np.clip(d, -_F16_MAX, _F16_MAX).astype(np.float16)
    inv = np.where(d != 0, np.divide(1.0, d, where=d != 0), 0.0).astype(np.float32)
    q = np.clip(np.floor(g * inv[:, None] + 8.5), 0, 15).astype(np.uint8)
    return pack_q40(d16, q.astype(np.int8) - 8)


def pack_q40(scales_f16: np.ndarray, codes: np.ndarray) -> bytes:
    """Q40 wire bytes from ``scales_f16 [nblocks]`` and centered codes
    ``int8 [nblocks, 32]`` in [-8, 7] — the inverse of :func:`unpack_q40`."""
    q = (codes.astype(np.int16) + 8).astype(np.uint8)
    half = Q40_BLOCK_SIZE // 2
    return q40_blocks(scales_f16, (q[:, :half] & 0xF) | ((q[:, half:] & 0xF) << 4))


def q40_blocks(scales_f16: np.ndarray, nibbles: np.ndarray) -> bytes:
    """Q40 wire bytes from ``scales_f16 [nblocks]`` and the already packed
    nibble bytes ``uint8 [nblocks, 16]`` (byte ``j`` = element ``j`` low,
    element ``j + 16`` high, both offset by 8)."""
    out = np.empty((nibbles.shape[0], Q40_BLOCK_BYTES), dtype=np.uint8)
    out[:, 0:2] = np.ascontiguousarray(
        scales_f16, dtype=np.float16).view(np.uint8).reshape(-1, 2)
    out[:, 2:] = nibbles
    return out.tobytes()


def unpack_q40(buf, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Split Q40 wire bytes into ``(scales_f16[nblocks], codes_i8[nblocks, 32])``
    with codes centered to [-8, 7]."""
    assert n % Q40_BLOCK_SIZE == 0, n
    nblocks = n // Q40_BLOCK_SIZE
    raw = np.frombuffer(buf, dtype=np.uint8,
                        count=nblocks * Q40_BLOCK_BYTES).reshape(nblocks, Q40_BLOCK_BYTES)
    scales = raw[:, 0:2].copy().view(np.float16).reshape(-1)
    packed = raw[:, 2:]
    lo = (packed & 0x0F).astype(np.int8) - 8  # elements 0..15
    hi = (packed >> 4).astype(np.int8) - 8  # elements 16..31
    return scales, np.concatenate([lo, hi], axis=1)


def dequantize_q40(buf, n: int) -> np.ndarray:
    """Dequantize ``n`` elements of Q40 wire bytes to float32."""
    scales, q = unpack_q40(buf, n)
    return (q.astype(np.float32) * scales[:, None].astype(np.float32)).reshape(-1)


def quantize_q80(x: np.ndarray) -> bytes:
    """Quantize flat float32 ``x`` to Q80 wire bytes (converter/writer.py:55-74):
    ``d = absmax/127``, codes are half-to-even ``round(x/d)``."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    assert x.ndim == 1 and x.size % Q80_BLOCK_SIZE == 0, x.shape
    g = x.reshape(-1, Q80_BLOCK_SIZE)
    amax = np.abs(g).max(axis=1)
    d = (amax / 127.0).astype(np.float32)
    d16 = np.clip(d, 0.0, _F16_MAX).astype(np.float16)
    inv = np.where(d != 0, np.divide(1.0, d, where=d != 0), 0.0).astype(np.float32)
    q = np.round(g * inv[:, None]).astype(np.int8)
    out = np.zeros((g.shape[0], Q80_BLOCK_BYTES), dtype=np.uint8)
    out[:, 0:2] = d16.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.tobytes()


def unpack_q80(buf, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Split Q80 wire bytes into ``(scales_f16[nblocks], codes_i8[nblocks, 32])``."""
    assert n % Q80_BLOCK_SIZE == 0, n
    nblocks = n // Q80_BLOCK_SIZE
    raw = np.frombuffer(buf, dtype=np.uint8,
                        count=nblocks * Q80_BLOCK_BYTES).reshape(nblocks, Q80_BLOCK_BYTES)
    scales = raw[:, 0:2].copy().view(np.float16).reshape(-1)
    return scales, raw[:, 2:].view(np.int8).copy()


def dequantize_q80(buf, n: int) -> np.ndarray:
    """Dequantize ``n`` elements of Q80 wire bytes to float32."""
    scales, q = unpack_q80(buf, n)
    return (q.astype(np.float32) * scales[:, None].astype(np.float32)).reshape(-1)


def encode_tensor(x: np.ndarray, float_type: int) -> bytes:
    """On-disk bytes of a float32 tensor in ``float_type`` (the .m tensor
    writer shared by the test fixtures and ``chip_smoke.py``)."""
    flat = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if float_type == F32:
        return flat.tobytes()
    if float_type == F16:
        return flat.astype(np.float16).tobytes()
    if float_type == Q40:
        return quantize_q40(flat)
    if float_type == Q80:
        return quantize_q80(flat)
    raise ValueError(f"unsupported float type {float_type}")
