"""RMS normalization ops (the port of the JAX package's ``ops/norms.py``).

Numerically matches the reference's two-step INV_RMS + RMS_NORM pipeline
(reference: invRms_F32, src/nn/nn-cpu-ops.cpp:112-142; rmsNormForward,
:1000-1049): ``inv = 1/sqrt(mean(x^2) + eps)``, ``y = x * inv * w``, with the
reduction in float32 regardless of the compute dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalize over the trailing axis."""
    xf = x.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * weight.float()).to(x.dtype)


def rms_norm_per_head(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Qwen3's per-head q/k norm: ``x: [..., n_heads, head_dim]``, shared
    ``weight: [head_dim]`` (reference: llm.cpp:285-309)."""
    return rms_norm(x, weight, eps)
