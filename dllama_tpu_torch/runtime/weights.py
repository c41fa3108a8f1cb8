"""Weight loader: ``.m`` tensors → device parameters (the port of the JAX
package's ``runtime/weights.py`` ``load_params`` and its streaming loader).

Each tensor is read once from the memory-mapped file and shipped to the
device as raw bytes; Q40/Q80 blocks are unpacked there into the K-major
planes of :class:`~dllama_tpu_torch.ops.linear.QuantizedWeight` (codes int8
``[in, out]``, scales ``[in/32, out]``), so the host never holds more than
one tensor's bytes and the unpack/transpose runs at device speed. Layout and
numerics follow the JAX loader:

* Q40/Q80 matmul weights stay quantized; scales are f32 in exact configs
  and bf16 in fast configs (fast numerics round the dequant to bf16 anyway);
* the logits head follows the dense-vs-quantized rule (:func:`dense_logits_wanted`):
  fast configs hold it as a dense bf16 ``[vocab, dim]`` matrix, exact
  configs keep the Q40 planes;
* dense (F32/F16) weights load as f32 ``[out, in]``;
* the embedding is stored at the compute dtype (it is only ever read as
  ``embedding[tokens].to(compute_dtype)``), norms as f32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats.mfile import ArchType, ModelFile
from ..formats.quants import (F16, F32, Q40, Q40_BLOCK_BYTES, Q80, Q80_BLOCK_BYTES,
                              QUANT_BLOCK_SIZE)
from ..models.config import ModelConfig
from ..models.llama import LayerParams, Params, rope_tables
from ..ops.linear import (Q40_CODES, Q80_CODES, QuantizedWeight, dequantize_weight,
                          fast_numerics_resolved)


def dense_logits_wanted(fast_numerics: bool) -> bool:
    """Whether the logits head loads as a resident dense bf16 matrix: fast
    configs trade ``vocab*dim`` extra bytes for a dense head; exact configs
    keep the quantized head (their goldens are tied to the f32 dequant)."""
    return fast_numerics


def _raw(mf: ModelFile, key: str, device) -> torch.Tensor:
    """A tensor's on-disk bytes as a uint8 tensor on ``device``."""
    buf = np.frombuffer(mf.raw(key), dtype=np.uint8)
    return torch.from_numpy(buf.copy()).to(device)


def unpack_planes(raw: torch.Tensor, float_type: int, out_dim: int, in_dim: int,
                  scale_dtype) -> QuantizedWeight:
    """Q40/Q80 wire bytes (``uint8`` on any device, out-major blocks) → the
    K-major planes, computed where ``raw`` lives; ``kind`` records the
    file's type, so that Q80 codes are never read as Q40 nibbles."""
    nb = in_dim // QUANT_BLOCK_SIZE
    per = Q40_BLOCK_BYTES if float_type == Q40 else Q80_BLOCK_BYTES
    blocks = raw.view(out_dim, nb, per)
    scales = blocks[..., :2].contiguous().view(torch.float16).reshape(out_dim, nb)
    payload = blocks[..., 2:]
    if float_type == Q40:
        lo = (payload & 0x0F).to(torch.int8) - 8  # elements 0..15 of the block
        hi = (payload >> 4).to(torch.int8) - 8    # elements 16..31
        codes = torch.cat([lo, hi], dim=-1)
    else:
        codes = payload.contiguous().view(torch.int8)
    return QuantizedWeight(
        scales=scales.t().to(scale_dtype).contiguous(),
        codes=codes.reshape(out_dim, in_dim).t().contiguous(),
        kind=Q40_CODES if float_type == Q40 else Q80_CODES)


class _Loader:
    def __init__(self, mf: ModelFile, cfg: ModelConfig, device):
        self.mf, self.cfg, self.device = mf, cfg, device
        self.fast = fast_numerics_resolved(cfg.compute_dtype)
        self.scale_dtype = torch.bfloat16 if self.fast else torch.float32

    def f32(self, key: str, dtype=torch.float32) -> torch.Tensor:
        rec = self.mf.tensors[key]
        if rec.float_type != F32:
            raise ValueError(f"{key}: expected F32, file has type {rec.float_type}")
        return _raw(self.mf, key, self.device).view(torch.float32).reshape(
            rec.shape).to(dtype)

    def matmul(self, key: str, *, force_dense=None):
        """One matmul weight: Q40/Q80 → planes (or dense ``force_dense``
        dtype ``[out, in]``), F32/F16 → dense f32 ``[out, in]``."""
        rec = self.mf.tensors[key]
        out_dim, in_dim = rec.shape
        if rec.float_type in (Q40, Q80):
            qw = unpack_planes(_raw(self.mf, key, self.device), rec.float_type,
                               out_dim, in_dim,
                               self.scale_dtype if force_dense is None else torch.float32)
            if force_dense is None:
                return qw
            # f32 dequant of the f16 scales, then the target dtype: the JAX
            # loader's dense head (tensor_f32_rows(...).astype(dtype))
            return dequantize_weight(qw, torch.float32).to(force_dense).t().contiguous()
        raw = _raw(self.mf, key, self.device)
        if rec.float_type == F32:
            w = raw.view(torch.float32)
        elif rec.float_type == F16:
            w = raw.view(torch.float16).float()
        else:
            raise ValueError(f"{key}: unsupported weight type {rec.float_type}")
        return w.reshape(out_dim, in_dim).to(force_dense or torch.float32)


def load_params(mf: ModelFile, cfg: ModelConfig, device="cpu") -> Params:
    """Build device parameters from an open ``.m`` file."""
    h = mf.header
    ld = _Loader(mf, cfg, device)
    head_dense = torch.bfloat16 if dense_logits_wanted(ld.fast) else None
    qwen3 = h.arch_type == ArchType.QWEN3
    layers = [
        LayerParams(
            wq=ld.matmul(f"block_matmul_q.{l}"), wk=ld.matmul(f"block_matmul_k.{l}"),
            wv=ld.matmul(f"block_matmul_v.{l}"), wo=ld.matmul(f"block_matmul_wo.{l}"),
            w1=ld.matmul(f"block_matmul_w1.{l}"), w2=ld.matmul(f"block_matmul_w2.{l}"),
            w3=ld.matmul(f"block_matmul_w3.{l}"),
            norm_att=ld.f32(f"block_norm_0.{l}"), norm_ffn=ld.f32(f"block_norm_1.{l}"),
            norm_q=ld.f32(f"block_norm_q.{l}") if qwen3 else None,
            norm_k=ld.f32(f"block_norm_k.{l}") if qwen3 else None)
        for l in range(h.n_layers)
    ]
    return Params(
        embedding=ld.f32("embedding", dtype=getattr(torch, cfg.compute_dtype)),
        layers=layers,
        final_norm=ld.f32("final_norm"),
        logits=ld.matmul("final_matmul_logits", force_dense=head_dense),
        rope=rope_tables(cfg, device),
    )
