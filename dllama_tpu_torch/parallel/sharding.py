"""Tensor-parallel layout of the parameters and the KV cache (the port of
the JAX package's ``parallel/sharding.py``).

Under a ``tp`` plan (``parallel/api.py``) every matmul weight is cut as the
reference's slicers cut it, and as the JAX package's ``param_shardings``
lays it out:

* row splits (wq, wk, wv, w1, w3, the logits head; sliceRowMatmul,
  nn-core.cpp:207-217) cut the OUTPUT features;
* col splits (wo, w2; sliceColMatmul, nn-core.cpp:219-230) cut the INPUT
  features; each shard's partial sums are merged by an add
  (``ops/linear.py::merge_shards``);
* norms, the embedding and the rope tables stay whole on the lead device,
  where the activations live between the sharded ops, so they are placed
  once.

Q40/Q80 planes are K-major: a row split cuts ``N`` of the codes and of the
scales, a col split ``K`` of the codes and ``K / 32`` rows of the scales.
Turbo planes (``w8 [K, N]``, ``scale [N]``, derived from the whole plane
before the cut) cut ``N`` of both in a row split, ``K`` of ``w8`` in a col
split, where every shard keeps the whole ``scale``.
A dim that does not divide by ``tp`` leaves the weight whole on every shard,
one copy per distinct device (the JAX package's ``sharding_for``
degradation rule; a col split also needs ``K / 32`` to divide, and is never
rounded).

The KV cache shards over kv heads like sliceKvCache (nn-core.cpp:198-205):
shard ``j`` holds kv heads ``kv_heads(cfg, tp, j)``. With ``tp >
n_kv_heads`` (``tp % n_kv_heads == 0``, KV replication, which the reference
lacks) the JAX package keeps the whole cache on every device and each
device reads the one head its q heads map to; the port's shard holds just
that head.

An MoE layer's expert stacks (``[E, in, out]``, any repr; the layout of
each repr's planes is stated once, in :func:`map_expert_weight`) are cut
over the plan's ``(ep, tp)`` grid as the JAX package's
``param_shardings`` and ``_moe_ffn_sparse`` cut them: ``E`` over ``ep``,
the expert hidden axis over ``tp`` (``out`` of we1/we3, ``in`` of we2), the
router whole on the lead (:func:`shard_experts`). The JAX fallbacks hold
letter for letter: ``E % ep != 0`` leaves the experts uncut over ``ep``,
and the hidden axis stays whole when ``hidden % tp != 0`` or, with
quantized planes, ``(hidden / 32) % tp != 0``; then the partials are summed
over ``ep`` alone.
"""

from __future__ import annotations

from dataclasses import replace
from typing import TYPE_CHECKING

import torch

from ..formats.quants import QUANT_BLOCK_SIZE
from ..ops.linear import ExpertShards, QuantizedWeight, ShardedWeight
from ..ops.turbo import TurboWeight
from .api import MeshPlan

if TYPE_CHECKING:
    from ..models.config import ModelConfig
    from ..models.llama import LayerParams, Params

# the split of each matmul weight (LayerParams field, or "logits")
ROW_SPLIT = ("wq", "wk", "wv", "w1", "w3", "logits")
COL_SPLIT = ("wo", "w2")


def validate_tp(cfg: "ModelConfig", tp: int) -> None:
    """The tp divisibility rules, with the JAX package's messages
    (reference: asserts nn-core.cpp:200-221 and the n_nodes <= n_kv_heads
    cap, app.cpp:232-234, widened by KV replication)."""
    if cfg.n_heads % tp != 0:
        raise ValueError(f"n_heads {cfg.n_heads} not divisible by tp={tp}")
    if cfg.hidden_dim % tp != 0:
        raise ValueError(f"hidden_dim {cfg.hidden_dim} not divisible by tp={tp}")
    if cfg.vocab_size % tp != 0:
        raise ValueError(f"vocab_size {cfg.vocab_size} not divisible by tp={tp}")
    if cfg.n_kv_heads % tp != 0 and tp % cfg.n_kv_heads != 0:
        raise ValueError(
            f"tp={tp} incompatible with n_kv_heads={cfg.n_kv_heads}: needs "
            f"either n_kv_heads % tp == 0 or tp % n_kv_heads == 0 (replication)")


def validate_ep(cfg: "ModelConfig", ep: int) -> None:
    """Expert-parallel divisibility, with the JAX package's messages."""
    if not cfg.is_moe:
        raise ValueError("ep axis requires an MoE model (n_experts > 0)")
    if cfg.n_experts % ep != 0:
        raise ValueError(f"n_experts {cfg.n_experts} not divisible by ep={ep}")


def tp_ok(cfg: "ModelConfig", tp: int) -> bool:
    try:
        validate_tp(cfg, tp)
        return True
    except ValueError:
        return False


def default_tp(cfg: "ModelConfig", n_devices: int, sp: int = 1) -> int:
    """The JAX engine's tp when ``--tp`` is absent: the largest power of two
    that fits the devices left after ``sp`` and that the shapes accept."""
    tp = 1
    while sp * tp * 2 <= n_devices and tp_ok(cfg, tp * 2):
        tp *= 2
    return tp


def kv_heads(cfg: "ModelConfig", tp: int, j: int) -> slice:
    """The kv heads shard ``j`` of ``tp`` holds: its ``n_kv_heads / tp``, or
    under KV replication the one head its q heads ``[j * H / tp, (j + 1) *
    H / tp)`` read (the JAX package's ``(j * H/tp) // (H/n_kv)``)."""
    n_kv = cfg.n_kv_heads
    if n_kv % tp == 0:
        n = n_kv // tp
        return slice(j * n, (j + 1) * n)
    g = (j * (cfg.n_heads // tp)) // (cfg.n_heads // n_kv)
    return slice(g, g + 1)


def local_kv_heads(cfg: "ModelConfig", tp: int) -> int:
    return cfg.n_kv_heads // tp if cfg.n_kv_heads % tp == 0 else 1


def _splits(w, split: str, tp: int) -> bool:
    """Whether ``w`` can be cut along ``split`` (``"out"`` or ``"in"``) into
    ``tp`` shards."""
    if isinstance(w, QuantizedWeight):
        K, N = w.codes.shape[-2:]
        if split == "out":
            return N % tp == 0
        return K % tp == 0 and w.scales.shape[-2] % tp == 0
    if isinstance(w, TurboWeight):
        return w.w8.shape[-1 if split == "out" else -2] % tp == 0
    return w.shape[0 if split == "out" else 1] % tp == 0  # dense [out, in]


def _cut(w, split: str, j: int, tp: int):
    """Shard ``j``'s slice of ``w``, a new contiguous tensor per plane."""
    if isinstance(w, QuantizedWeight):
        if split == "out":
            n = w.codes.shape[-1] // tp
            return QuantizedWeight(scales=w.scales[:, j * n:(j + 1) * n].contiguous(),
                                   codes=w.codes[:, j * n:(j + 1) * n].contiguous(),
                                   kind=w.kind)
        k, kb = w.codes.shape[-2] // tp, w.scales.shape[-2] // tp
        return QuantizedWeight(scales=w.scales[j * kb:(j + 1) * kb].contiguous(),
                               codes=w.codes[j * k:(j + 1) * k].contiguous(), kind=w.kind)
    if isinstance(w, TurboWeight):
        if split == "out":
            n = w.w8.shape[-1] // tp
            return TurboWeight(w.w8[:, j * n:(j + 1) * n].contiguous(),
                               w.scale[j * n:(j + 1) * n].contiguous(), w.a8)
        k = w.w8.shape[-2] // tp
        return TurboWeight(w.w8[j * k:(j + 1) * k].contiguous(), w.scale, w.a8)
    if split == "out":
        n = w.shape[0] // tp
        return w[j * n:(j + 1) * n].contiguous()
    k = w.shape[1] // tp
    return w[:, j * k:(j + 1) * k].contiguous()


def _to(w, device):
    if isinstance(w, QuantizedWeight):
        return QuantizedWeight(scales=w.scales.to(device), codes=w.codes.to(device),
                               kind=w.kind)
    if isinstance(w, TurboWeight):
        return TurboWeight(w.w8.to(device), w.scale.to(device), w.a8)
    return w.to(device)


def shard_weight(plan: MeshPlan, w, split: str) -> ShardedWeight:
    """One matmul weight over the plan's ``tp`` shards (see the module
    docstring): cut along ``split`` when its dims divide, else whole on
    every shard, placed once per distinct device."""
    tp, devs = plan.axis_size("tp"), plan.devices
    if _splits(w, split, tp):
        return ShardedWeight(tuple(_to(_cut(w, split, j, tp), devs[j]) for j in range(tp)),
                             split)
    placed: dict = {}
    return ShardedWeight(tuple(placed.setdefault(d, _to(w, d)) for d in devs), "")


def map_expert_weight(we, in_axis, out_axis, f):
    """Rebuild an expert-stack weight by applying ``f(leaf, plane_axes)`` to
    each leaf, where ``plane_axes`` name the leaf's PLANE dims (the leading
    ``E`` axis is the caller's): the one statement of each repr's expert
    plane layout (the JAX package's ``map_expert_weight``). Q40/Q80: codes
    ``[E, in, out]`` and scales ``[E, in/32, out]`` (the block axis follows
    the in axis); turbo: ``w8 [E, in, out]`` and ``scale [E, out]``; dense:
    ``[E, in, out]``."""
    if isinstance(we, QuantizedWeight):
        return QuantizedWeight(scales=f(we.scales, (in_axis, out_axis)),
                               codes=f(we.codes, (in_axis, out_axis)), kind=we.kind)
    if isinstance(we, TurboWeight):
        return TurboWeight(f(we.w8, (in_axis, out_axis)), f(we.scale, (out_axis,)), we.a8)
    return f(we, (in_axis, out_axis))


def _expert_plane(we):
    """The ``[E, in, out]`` plane of an expert stack that carries its shape."""
    if isinstance(we, QuantizedWeight):
        return we.codes
    return we.w8 if isinstance(we, TurboWeight) else we


def expert_grid(plan: MeshPlan, lp: "LayerParams") -> tuple[int, int] | None:
    """``(ep, tp)`` the layer's expert stacks are cut into under ``plan``, by
    the JAX package's ``_moe_ffn`` and ``_moe_ffn_sparse`` rules: ``None``
    when ``hidden % tp != 0`` (the dense all-experts oracle runs, on whole
    stacks); ``E % ep != 0`` leaves the experts whole over ``ep``; the hidden
    axis is cut over ``tp`` unless ``we2``'s planes are quantized and
    ``(hidden / 32) % tp != 0`` (a scale plane's block axis must split with
    its codes)."""
    E, _, hidden = _expert_plane(lp.we1).shape
    ep, tp = plan.axis_size("ep"), plan.axis_size("tp")
    if hidden % tp != 0:
        return None
    if E % ep != 0:
        ep = 1
    if isinstance(lp.we2, QuantizedWeight) and (hidden // QUANT_BLOCK_SIZE) % tp != 0:
        tp = 1
    return ep, tp


def shard_experts(plan: MeshPlan, we, grid: tuple[int, int] | None,
                  hid_on_out: bool) -> ExpertShards:
    """One expert stack over the ``(ep, tp)`` ``grid`` of :func:`expert_grid`:
    shard ``(i, j)`` holds experts ``[i * E / ep, (i + 1) * E / ep)`` and its
    ``hidden / tp`` slice of the hidden axis (``out`` of we1/we3 when
    ``hid_on_out``, ``in`` of we2), on the plan's device ``(i, j)``. A
    ``None`` grid keeps the whole stack on the lead, for the oracle."""
    if grid is None:
        return ExpertShards((_to(we, plan.lead),), 1, oracle=True)
    ep, tp = grid
    devs, row = plan.shards, plan.axis_size("tp")

    def cut(i, j):
        def f(leaf, axes):
            e = leaf.shape[0] // ep
            idx = [slice(i * e, (i + 1) * e)]
            for d, a in enumerate(axes, start=1):
                n = leaf.shape[d] // tp
                idx.append(slice(j * n, (j + 1) * n) if a == "hidden" else slice(None))
            return leaf[tuple(idx)].contiguous().to(devs[i * row + j])
        return f

    in_ax, out_ax = (None, "hidden") if hid_on_out else ("hidden", None)
    return ExpertShards(tuple(map_expert_weight(we, in_ax, out_ax, cut(i, j))
                              for i in range(ep) for j in range(tp)), ep)


def shard_layer(plan: MeshPlan, lp: "LayerParams") -> "LayerParams":
    """A layer's weights over the plan's shards: the dense matmuls over the
    ``tp`` shards (whole on the lead at tp = 1), an MoE layer's expert stacks
    over the ``(ep, tp)`` grid (:func:`shard_experts`); the norms and the
    router stay on the lead."""
    cut = {}
    if plan.axis_size("tp") > 1:
        cut = {f: shard_weight(plan, getattr(lp, f), "out" if f in ROW_SPLIT else "in")
               for f in (*ROW_SPLIT[:-1], *COL_SPLIT) if getattr(lp, f) is not None}
    if lp.moe_gate is not None:
        grid = expert_grid(plan, lp)
        cut.update(we1=shard_experts(plan, lp.we1, grid, True),
                   we2=shard_experts(plan, lp.we2, grid, False),
                   we3=shard_experts(plan, lp.we3, grid, True))
    return replace(lp, **cut)


def tp_params(plan: MeshPlan, params: "Params") -> "Params":
    """``params`` (on the plan's lead device) with every matmul weight a
    :class:`~dllama_tpu_torch.ops.linear.ShardedWeight`: what the model
    functions take under the plan. The loader shards layer by layer
    (``runtime/weights.py``) instead, so that one whole layer at most is
    resident twice."""
    logits = params.logits
    if plan.axis_size("tp") > 1:
        logits = shard_weight(plan, logits, "out")
    return replace(params, layers=[shard_layer(plan, lp) for lp in params.layers],
                   logits=logits)


def shard_params(plan: MeshPlan, params: "Params") -> list["Params"]:
    """One ``Params`` per shard: shard ``j``'s slice of every matmul weight
    (the data of the JAX package's ``shard_params`` on device ``j``), the
    norms and the embedding the lead's, shared. ``params`` may already be
    sharded (:func:`tp_params`)."""
    if not isinstance(params.logits, ShardedWeight):
        params = tp_params(plan, params)
    fields = (*ROW_SPLIT[:-1], *COL_SPLIT)
    return [replace(params,
                    layers=[replace(lp, **{f: getattr(lp, f).shards[j] for f in fields
                                           if getattr(lp, f) is not None})
                            for lp in params.layers],
                    logits=params.logits.shards[j])
            for j in range(plan.axis_size("tp"))]


def kv_cache_sharding(plan: MeshPlan, cfg: "ModelConfig", batch_size: int = 1,
                      dtype=torch.float32):
    """The dense cache split over kv heads: one
    :class:`~dllama_tpu_torch.runtime.kvcache.KVCache` ``[L, B,
    local_kv_heads, S, hd]`` per shard, on its device; at tp = 1 (an ``ep``
    plan alone) one whole cache on the lead."""
    from ..runtime.kvcache import HeadShardedKVCache, KVCache

    if plan.axis_size("tp") == 1:
        return KVCache.create(cfg, batch_size=batch_size, dtype=dtype, device=plan.lead)
    return HeadShardedKVCache.create(cfg, plan.devices, batch_size=batch_size, dtype=dtype)


def paged_kv_sharding(plan: MeshPlan, cfg: "ModelConfig", n_blocks: int, block_size: int,
                      dtype=torch.float32):
    """The paged block pool split over kv heads: one
    :class:`~dllama_tpu_torch.runtime.kvblocks.PagedKVCache` ``[L, n_blocks,
    local_kv_heads, block_size, hd]`` per shard, under one block allocator
    and one set of block tables."""
    from ..runtime.kvblocks import ShardedPagedKVCache

    return ShardedPagedKVCache.create(cfg, plan.devices, n_blocks, block_size, dtype=dtype)
