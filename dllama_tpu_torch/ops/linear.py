"""Linear/matmul ops over dense or Q40/Q80-quantized weights, and the Q80
activation fake-quantization (the port of the JAX package's ``ops/linear.py``).

Q40 and Q80 weights stay in the block domain as two device planes in the JAX
package's K-major layout (:class:`QuantizedWeight`), and the matmul
dequantizes on the fly: on a CUDA tensor through the hand-written kernels of
:mod:`dllama_tpu_torch.ops.quant_matmul` (K1 for prefill widths, K2 for
decode widths), on a CPU tensor through their plain PyTorch version.

Numerics follow the JAX package's exact/fast split, chosen by the config's
``quant_mode`` (``--quant-mode``; :func:`fast_numerics_resolved`): *exact*
is f32 dequant, f32 products and sums (parity with the reference goldens;
bf16 activations are upcast to f32, as the JAX package's tiled kernel does);
*fast* is bf16 dequant and operands, f32 accumulation; ``auto`` is fast iff
the activations are bfloat16 (``--compute-dtype bf16``). Scales stored in
bf16 were written by a fast-mode load and force fast numerics whatever the
mode (an "exact" f32 dequant over bf16 scales would be fake exactness).
``turbo``/``turbo16`` load like fast, then every quantized plane is
requantized to per-column int8 (:mod:`dllama_tpu_torch.ops.turbo`), and
:func:`linear` dispatches a :class:`~dllama_tpu_torch.ops.turbo.TurboWeight`
first. The JAX package reads the mode from ``DLLAMA_TPU_QUANT_MODE`` at each
call; the port reads no environment variable for it: the mode is an explicit
argument, fixed in the config when the engine is built.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import NamedTuple, Union

import torch
import torch.nn.functional as F

from ..formats.quants import Q40_BLOCK_SIZE, Q80_BLOCK_SIZE


# the code kinds of :class:`QuantizedWeight` planes: what range the int8
# codes span, which the kernels must know (a Q40 kernel reads only a code's
# low nibble)
Q40_CODES, Q80_CODES = "q40", "q80"


class QuantizedWeight(NamedTuple):
    """Q40 or Q80 weight as K-major planes (the JAX package's layout).

    ``scales``: ``[in // 32, out]`` block scales, float32 in exact configs,
    bfloat16 in fast configs. ``codes``: int8 ``[in, out]``: centered 4-bit
    codes in [-8, 7] for Q40 planes, 8-bit codes in [-127, 127] for Q80
    planes. Logical value: ``w[o, i] = codes[i, o] * scales[i // 32, o]``.
    ``kind`` records which (:data:`Q40_CODES` or :data:`Q80_CODES`): the plain
    version multiplies the codes whatever their range, the kernels decode a
    code byte by its kind.
    """

    scales: torch.Tensor
    codes: torch.Tensor
    kind: str = Q40_CODES

    @property
    def out_features(self) -> int:
        return self.codes.shape[-1]

    @property
    def in_features(self) -> int:
        return self.codes.shape[-2]


class ShardedWeight(NamedTuple):
    """A matmul weight over ``tp`` shards (``parallel/sharding.py``): shard
    ``j``'s dense matrix or planes on its device, in rank order. ``split``
    names the axis that was cut: ``"out"`` (a row split, the reference's
    sliceRowMatmul: wq, wk, wv, w1, w3 and the logits head; each shard
    computes its output features, concatenated), ``"in"`` (a col split,
    sliceColMatmul: wo and w2; each shard multiplies its input features into
    an f32 partial, summed in rank order) or ``""`` (replicated: a dim that
    does not divide; every shard holds the whole weight, one copy per
    distinct device)."""

    shards: tuple
    split: str


class ExpertShards(NamedTuple):
    """An MoE layer's expert stack ``[E, in, out]`` over an ``(ep, tp)``
    grid (``parallel/sharding.py::shard_experts``): ``shards`` in rank
    order, ep-major, each on its device; ``ep`` rows, row ``i`` holding
    experts ``[i * E / ep, (i + 1) * E / ep)``, and ``len(shards) / ep``
    shards a row, each its slice of the expert hidden axis (one shard a row
    when the hidden axis is not cut). Every shard's partial of the FFN is
    summed in rank order (``models/llama.py::_moe_ffn``). ``oracle``: the
    hidden axis does not divide by tp, so the layer runs the dense
    all-experts oracle over the one whole stack on the lead, as the JAX
    package's ``_moe_ffn`` does."""

    shards: tuple
    ep: int
    oracle: bool = False


# a weight of any repr: dense, Q40/Q80 planes, a turbo plane
# (:class:`~dllama_tpu_torch.ops.turbo.TurboWeight`, not named here: turbo
# imports this module) or any of them over tp shards or an (ep, tp) grid
Weight = Union[torch.Tensor, QuantizedWeight, ShardedWeight, ExpertShards]


def dequantize_weight(w: QuantizedWeight, dtype=torch.float32) -> torch.Tensor:
    """Expand Q40 planes to a dense K-major ``[in, out]`` tensor. The product
    is taken in ``dtype`` (a bf16 dequant rounds ``code * scale`` to bf16)."""
    scales = torch.repeat_interleave(w.scales.to(dtype), Q40_BLOCK_SIZE, dim=-2)
    return w.codes.to(dtype) * scales


# --quant-mode values (the JAX package's DLLAMA_TPU_QUANT_MODE values)
QUANT_MODES = ("auto", "exact", "fast", "turbo", "turbo16")


def fast_numerics_resolved(compute_dtype: str, quant_mode: str = "auto") -> bool:
    """The exact/fast resolution of a config (the JAX package's rule, keyed
    on ``quant_mode`` instead of its environment variable): ``exact`` never,
    ``fast`` and the turbo modes always (turbo loads like fast: bf16 scales
    feed the derivation, dense head), ``auto`` iff ``compute_dtype`` is
    bfloat16. Decides the stored scale dtype, the dense-vs-quantized logits
    head and each matmul's numerics."""
    if quant_mode == "exact":
        return False
    if quant_mode in ("fast", "turbo", "turbo16"):
        return True
    return str(compute_dtype) == "bfloat16"


def turbo_mode(quant_mode: str) -> str | None:
    """``"a8"`` / ``"a16"`` when ``quant_mode`` selects turbo numerics, else
    None. Opt-in only: never resolved from ``auto``."""
    return {"turbo": "a8", "turbo16": "a16"}.get(quant_mode)


def quant_mode_label(quant_mode: str, activations_bf16: bool) -> str:
    """The resolved mode for diagnostics (the banner): the mode itself, or
    ``auto(fast)`` / ``auto(exact)``, by the rule :func:`linear` dispatches
    with."""
    if quant_mode != "auto":
        return quant_mode
    return f"auto({'fast' if activations_bf16 else 'exact'})"


def _fast_mode(x: torch.Tensor, quant_mode: str = "auto") -> bool:
    """Per-call resolution from the live activation (the same rule)."""
    return fast_numerics_resolved(
        "bfloat16" if x.dtype == torch.bfloat16 else "float32", quant_mode)


def linear(x: torch.Tensor, w: Weight, *, impl: str = "auto",
           quant_mode: str = "auto") -> torch.Tensor:
    """``y[..., out] = x[..., in] @ w.T`` with a dense, Q40/Q80 or turbo weight.

    Dense weights use the reference's on-disk ``[out, in]`` orientation; Q40
    planes are K-major ``[in, out]``. ``impl`` is the model config's
    ``quant_impl``: ``"auto"`` routes Q40 weights to the kernel wrapper
    (:func:`~dllama_tpu_torch.ops.quant_matmul.quant_matmul`, which runs the
    kernel on a CUDA tensor and the plain version on a CPU tensor), ``"xla"``
    calls the plain version by name on any device. ``quant_mode`` is the
    config's (:func:`fast_numerics_resolved`); a
    :class:`~dllama_tpu_torch.ops.turbo.TurboWeight` carries its own a8/a16
    choice, fixed when it was derived.
    """
    from .turbo import TurboWeight, turbo_matmul  # lazy: turbo imports this module

    if isinstance(w, ShardedWeight):
        return linear_sharded(x, w, impl=impl, quant_mode=quant_mode)
    if isinstance(w, TurboWeight):
        return turbo_matmul(x, w).to(x.dtype)
    if isinstance(w, QuantizedWeight):
        from .quant_matmul import quant_matmul, quant_matmul_plain

        fast = _fast_mode(x, quant_mode) or w.scales.dtype == torch.bfloat16
        # exact numerics take f32 activations (the JAX tiled kernel's upcast)
        xin = x if fast else x.float()
        if impl == "xla":
            return quant_matmul_plain(xin, w, fast=fast).to(x.dtype)
        if impl != "auto":
            raise ValueError(f"quant_impl must be auto|xla, got {impl!r}")
        return quant_matmul(xin, w, fast=fast).to(x.dtype)
    # dense weight: a plain matrix product (cuBLAS on the card)
    w = w.to(x.dtype)
    precision = torch.get_float32_matmul_precision()
    if x.dtype != torch.float32 or not x.is_cuda or precision == "highest":
        return F.linear(x, w)
    # exact mode is f32 products: never TF32, whatever the process set
    # (scoped to this call, so a CUDA graph captures the f32 kernel)
    torch.set_float32_matmul_precision("highest")
    try:
        return F.linear(x, w)
    finally:
        torch.set_float32_matmul_precision(precision)


def _weight_device(w) -> torch.device:
    from .turbo import TurboWeight

    if isinstance(w, QuantizedWeight):
        return w.codes.device
    return w.w8.device if isinstance(w, TurboWeight) else w.device


# the tp merges' instruments (runtime/profiling.py): every merge adds what it
# moves between rank 0 (x's device) and the other ranks to MERGES, whether
# or not the ranks share a card; under a profiler capture its copies and
# sums run inside a ``tp_merge`` range, which the Eval/Sync split reads as
# sync time
MERGE_SPAN = "tp_merge"
MERGES = {"n": 0, "sent_bytes": 0, "recv_bytes": 0, "by_kind": {}}
_annotate = [False]


def annotate_merges(on: bool) -> None:
    """Wrap every merge's copies and sums in a ``tp_merge`` profiler range
    (on during a capture only: a range costs a dispatcher call)."""
    _annotate[0] = bool(on)


def _merge_span():
    return torch.profiler.record_function(MERGE_SPAN) if _annotate[0] else nullcontext()


def _note_merge(kind: str, sent: list[torch.Tensor], recv: list[torch.Tensor]) -> None:
    """Count one merge: ``sent`` went from rank 0 to the other ranks,
    ``recv`` came back (host arithmetic on shapes)."""
    sb = sum(t.numel() * t.element_size() for t in sent)
    rb = sum(t.numel() * t.element_size() for t in recv)
    MERGES["n"] += 1
    MERGES["sent_bytes"] += sb
    MERGES["recv_bytes"] += rb
    MERGES["by_kind"][kind] = MERGES["by_kind"].get(kind, 0) + rb


def merge_shards(x: torch.Tensor, w: ShardedWeight, full, partial) -> torch.Tensor:
    """The tensor-parallel product of ``x [..., K]`` (on the lead device)
    and ``w``, merged on ``x``'s device, as the JAX package's ``shard_map``
    merges it: ``full(xs, shard)`` is one shard's product, ``partial(xs,
    shard)`` one shard's f32 partial of a col split. A row split runs
    ``full`` on every shard and concatenates the outputs; a col split cuts
    ``x``'s features to each shard's rows and sums the partials in rank
    order (the reference's merge-add), leaving the cast to the caller; a
    replicated weight runs ``full`` once, on the lead's copy. Each shard's
    input goes to its device and its output comes back to ``x``'s with
    ``.to``, which does nothing for shards on ``x``'s own device. The
    copies and the concatenation or sum are the merge (:data:`MERGES`,
    :data:`MERGE_SPAN`); the shards' products are not."""
    if w.split == "":
        return full(x, w.shards[0])
    if w.split not in ("out", "in"):
        raise ValueError(f"ShardedWeight.split must be out|in|'', got {w.split!r}")
    k = x.shape[-1] // len(w.shards)
    with _merge_span():
        xs = [(x if w.split == "out" else x[..., j * k:(j + 1) * k]).to(_weight_device(s))
              for j, s in enumerate(w.shards)]
    outs = [(full if w.split == "out" else partial)(xj, s) for xj, s in zip(xs, w.shards)]
    with _merge_span():
        if w.split == "out":
            y = torch.cat([o.to(x.device) for o in outs], dim=-1)
        else:
            y = outs[0].to(x.device)
            for o in outs[1:]:
                y = y + o.to(x.device)
    _note_merge("concat" if w.split == "out" else "sum", xs[1:], outs[1:])
    return y


def linear_sharded(x: torch.Tensor, w: ShardedWeight, *, impl: str = "auto",
                   quant_mode: str = "auto") -> torch.Tensor:
    """:func:`linear` over a tensor-parallel weight (:func:`merge_shards`):
    quantized shards through
    :func:`~dllama_tpu_torch.ops.quant_matmul.quant_matmul_sharded` (K1 or
    K2 once per shard at its local shapes), turbo ones through
    :func:`~dllama_tpu_torch.ops.turbo.turbo_matmul` (K5 once per shard), dense
    ones through the plain matrix product, a col split's partials in f32
    (exact products of the shard's operands) and cast to ``x.dtype`` after
    the sum. Turbo a8 quantizes the activations once, on the lead, over the
    whole row, as the JAX package's GSPMD dot does: every shard takes its
    columns of the codes and the row's one scale."""
    from .turbo import TurboWeight, quantize_activations_a8, turbo_matmul, turbo_matmul_q8

    s0 = w.shards[0]
    if isinstance(s0, TurboWeight):
        if s0.a8:
            xq, sx = quantize_activations_a8(x)

            def q8(q, s):
                return turbo_matmul_q8(q, sx.to(q.device), s)

            y = merge_shards(xq, w, q8, q8)
        else:
            y = merge_shards(x, w, lambda xs, s: turbo_matmul(xs, s),
                             lambda xs, s: turbo_matmul(xs.float(), s))
        return y.to(x.dtype)
    if isinstance(s0, QuantizedWeight):
        from .quant_matmul import quant_matmul_sharded

        if impl not in ("auto", "xla"):
            raise ValueError(f"quant_impl must be auto|xla, got {impl!r}")
        fast = _fast_mode(x, quant_mode) or s0.scales.dtype == torch.bfloat16
        xin = x if fast else x.float()
        return quant_matmul_sharded(xin, w, fast=fast, plain=impl == "xla").to(x.dtype)
    return merge_shards(x, w, lambda xs, s: linear(xs, s),
                        lambda xs, s: linear(xs.float(), s.float())).to(x.dtype)


def _q80_blocks(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Q80 block quantization of the trailing axis, the codes kept as f32
    values: ``(codes [..., n/32, 32], d [..., n/32, 1])``. ``d = absmax/127``
    (unrounded f32) divides; codes round half-to-even; an all-zero block
    has ``d = 0`` and codes 0."""
    *lead, n = x.shape
    if n % Q80_BLOCK_SIZE:
        raise ValueError(f"trailing dim {n} is not a multiple of {Q80_BLOCK_SIZE}")
    g = x.float().reshape(*lead, n // Q80_BLOCK_SIZE, Q80_BLOCK_SIZE)
    d = torch.amax(torch.abs(g), dim=-1, keepdim=True) / 127.0
    inv = torch.nan_to_num(torch.reciprocal(d), posinf=0.0)  # 1/0 -> 0
    return torch.round(g * inv), d


def q80_quantize_planes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Q80 block quantization of the trailing axis: int8 codes
    ``[..., n/32, 32]`` (in [-127, 127]) + f16 scales ``[..., n/32, 1]``."""
    codes, d = _q80_blocks(x)
    return codes.to(torch.int8), d.to(torch.float16)


def q80_dequant(codes: torch.Tensor, scales: torch.Tensor, shape) -> torch.Tensor:
    """The dequant pairing :func:`q80_quantize_planes`: f32 multiply of the
    int8 codes by the f16-rounded scales."""
    return (codes.float() * scales.float()).reshape(shape)


def fake_quant_q80(x: torch.Tensor) -> torch.Tensor:
    """Q80 quantize→dequantize of the trailing axis — the reference runtime's
    quantizeF32toQ80 + dequantizeQ80toF32 at its sync points (code from the
    unrounded f32 scale, dequant with the f16-rounded one; half-to-even like
    the x86 build the goldens came from). The codes stay f32 (they are whole
    numbers, so the int8 round trip of :func:`q80_quantize_planes` would not
    change them): fewer ops at each of a layer's six sync points."""
    codes, d = _q80_blocks(x)
    return (codes * d.to(torch.float16).float()).reshape(x.shape).to(x.dtype)
