"""RoPE frequency caches and application.

The port of the JAX package's ``models/rope.py``. Numerically matches the
reference's precomputed-cache approach (reference: fullfillRopeLlamaCache /
fullfillRopeFalconCache, src/nn/nn-core.cpp:329-370; apply kernels
ropeLlama_F32 / ropeFalcon_F32, src/nn/nn-cpu-ops.cpp:836-878):

* **llama style** — adjacent interleaved pairs ``(x[2j], x[2j+1])`` within each
  head, frequency ``theta^(-2j/head_dim)``;
* **llama3.1** — llama pairing with Meta's wavelength-banded frequency scaling
  (scaleFrequencyLlama3, nn-core.cpp:313-327);
* **falcon (neox) style** — half-split pairs ``(x[j], x[j + head_dim/2])``,
  same frequencies. Used by Qwen3.

The cos/sin tables are built in numpy exactly as the JAX package builds them,
so both frameworks rotate by bit-identical angles.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..formats.mfile import RopeType
from .config import ModelConfig


def _scale_frequency_llama3(freq: np.ndarray, cfg: ModelConfig) -> np.ndarray:
    """Meta's llama3.1 rope scaling (reference: nn-core.cpp:313-327)."""
    wave_len = 2.0 * np.pi / freq
    high_freq_wavelen = cfg.rope_scaling_orig_max_seq_len / cfg.rope_scaling_high_freq_factor
    low_freq_wavelen = cfg.rope_scaling_orig_max_seq_len / cfg.rope_scaling_low_freq_factor
    smooth = (cfg.rope_scaling_orig_max_seq_len / wave_len - cfg.rope_scaling_low_freq_factor) / (
        cfg.rope_scaling_high_freq_factor - cfg.rope_scaling_low_freq_factor)
    smoothed = (1.0 - smooth) * freq / cfg.rope_scaling_factor + smooth * freq
    return np.where(wave_len < high_freq_wavelen, freq,
                    np.where(wave_len > low_freq_wavelen,
                             freq / cfg.rope_scaling_factor, smoothed))


@functools.lru_cache(maxsize=16)
def build_rope_cache(cfg: ModelConfig) -> tuple[np.ndarray, np.ndarray]:
    """cos/sin caches of shape ``[seq_len, head_dim // 2]`` in float32
    (host numpy, memoized per config)."""
    half = cfg.head_dim // 2
    j = np.arange(half, dtype=np.float32)
    freqs = 1.0 / np.power(cfg.rope_theta, 2.0 * j / cfg.head_dim, dtype=np.float32)
    if cfg.rope_type == RopeType.LLAMA3_1 and cfg.rope_scaling_factor != 1.0:
        freqs = _scale_frequency_llama3(freqs.astype(np.float64), cfg).astype(np.float32)
    pos = np.arange(cfg.seq_len, dtype=np.float32)[:, None]
    angles = pos * freqs[None, :]
    return np.cos(angles), np.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor | slice, rope_type: RopeType) -> torch.Tensor:
    """Rotate ``x: [B, T, n_heads, head_dim]`` at ``positions``: a ``[B, T]``
    index tensor, or a ``slice`` of the tables when every row sits at the
    same positions (no index tensor to build on the hot path). ``cos/sin``
    are the ``[seq_len, head_dim/2]`` tables on ``x``'s device."""
    c = cos[positions]
    s = sin[positions]
    if c.dim() == 2:  # slice: [T, half] -> broadcast over batch
        c, s = c[None], s[None]
    c = c[:, :, None, :]  # broadcast over heads
    s = s[:, :, None, :]
    xf = x.float()  # rotate in f32, cast back (parity + no promotion)
    if rope_type in (RopeType.LLAMA, RopeType.LLAMA3_1):
        x0 = xf[..., 0::2]
        x1 = xf[..., 1::2]
        r0 = x0 * c - x1 * s
        r1 = x0 * s + x1 * c
        return torch.stack([r0, r1], dim=-1).reshape(x.shape).to(x.dtype)
    if rope_type == RopeType.FALCON:
        half = x.shape[-1] // 2
        x0 = xf[..., :half]
        x1 = xf[..., half:]
        r0 = x0 * c - x1 * s
        r1 = x0 * s + x1 * c
        return torch.cat([r0, r1], dim=-1).to(x.dtype)
    raise ValueError(f"unsupported rope type {rope_type}")
