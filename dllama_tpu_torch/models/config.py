"""Model configuration — the runtime view of a .m header.

The port's own copy of the JAX package's ``models/config.py`` on one
device: it carries everything the forward needs (reference: LlmHeader,
src/llm.hpp:42-71), the mixture-of-experts header fields, plus the
execution choices that have no reference equivalent (compute dtype,
attention and quant-matmul implementation, the quant mode, the MoE compute,
Q80 sync parity).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..formats.mfile import ArchType, HiddenAct, ModelHeader, RopeType


@dataclass(frozen=True)
class ModelConfig:
    arch: ArchType
    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab_size: int
    seq_len: int
    norm_epsilon: float
    rope_theta: float
    rope_type: RopeType
    rope_scaling_factor: float = 1.0
    rope_scaling_low_freq_factor: float = 0.0
    rope_scaling_high_freq_factor: float = 0.0
    rope_scaling_orig_max_seq_len: int = 0
    hidden_act: HiddenAct = HiddenAct.SILU
    n_experts: int = 0
    n_active_experts: int = 0
    # renormalize the selected top-k router weights to sum to 1 (HF
    # norm_topk_prob; Mixtral, and Qwen3-MoE with norm_topk_prob true); False
    # keeps the raw softmax probabilities
    moe_norm_topk: bool = True

    # execution choices (no reference equivalent):
    compute_dtype: str = "float32"  # "float32" for parity, "bfloat16" for speed
    # attention implementation, with the JAX package's meaning: "auto" = the
    # K3 flash kernel on a CUDA tensor when the shapes fit, the position-
    # masked oracle otherwise; "xla" = always the oracle (the plain
    # version); "flash" = always the kernel wrapper (its plain version on a
    # CPU tensor), failing loudly where the shapes do not fit
    attn_impl: str = "auto"
    # Q40 matmul implementation, the config twin of the JAX package's
    # DLLAMA_TPU_QUANT_KERNEL=auto|xla: "auto" = kernels K1/K2 on a CUDA
    # tensor, "xla" = the plain dequant+matmul version
    quant_impl: str = "auto"
    # Q80 activation-sync parity: reproduce the reference's Q80 cast points
    # (llm.cpp:258-265 casts) via fake-quantization
    sync_q80: bool = False
    # quantized-matmul numerics (--quant-mode), the config twin of the JAX
    # package's DLLAMA_TPU_QUANT_MODE, which the port does not read: "exact"
    # = f32 dequant and sums; "fast" = bf16 dequant and operands, f32 sums;
    # "turbo" / "turbo16" = per-column int8 planes (ops/turbo.py, a8 / a16);
    # "auto" = fast iff the compute dtype is bfloat16
    quant_mode: str = "auto"

    @property
    def q_dim(self) -> int:
        return self.head_dim * self.n_heads

    @property
    def kv_dim(self) -> int:
        return self.head_dim * self.n_kv_heads

    @property
    def kv_mul(self) -> int:
        """GQA group size (reference: multiheadAtt_F32 kvMul, nn-cpu-ops.cpp:756)."""
        return self.n_heads // self.n_kv_heads

    @property
    def uses_qk_norm(self) -> bool:
        """Qwen3 applies per-head RMS norm to q/k before rope (llm.cpp:285-309)."""
        return self.arch == ArchType.QWEN3

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @classmethod
    def from_header(cls, h: ModelHeader, compute_dtype: str = "float32") -> "ModelConfig":
        from ..formats.quants import Q80

        return cls(
            sync_q80=h.sync_type == Q80,
            arch=h.arch_type,
            dim=h.dim,
            hidden_dim=h.hidden_dim,
            n_layers=h.n_layers,
            n_heads=h.n_heads,
            n_kv_heads=h.n_kv_heads,
            head_dim=h.head_dim,
            vocab_size=h.vocab_size,
            seq_len=h.seq_len,
            norm_epsilon=h.norm_epsilon,
            rope_theta=h.rope_theta,
            rope_type=h.rope_type,
            rope_scaling_factor=h.rope_scaling_factor,
            rope_scaling_low_freq_factor=h.rope_scaling_low_freq_factor,
            rope_scaling_high_freq_factor=h.rope_scaling_high_freq_factor,
            rope_scaling_orig_max_seq_len=h.rope_scaling_orig_max_seq_len,
            hidden_act=h.hidden_act,
            n_experts=h.n_experts,
            n_active_experts=h.n_active_experts,
            moe_norm_topk=bool(h.moe_norm_topk),
            compute_dtype=compute_dtype,
        )
