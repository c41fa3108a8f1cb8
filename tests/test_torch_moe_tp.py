"""Mixture-of-experts models and turbo planes under tensor and expert
parallelism: the port against the JAX package on the CPU, shards on
``[cpu] * n`` in the port, the tier-1 conftest's virtual host devices under
``make_mesh`` in JAX.

- Layout: every port shard of every expert stack equals, bit for bit, the
  data of the matching device's shard of JAX ``shard_params`` (Q40, Q80,
  dense f32/bf16, turbo a8/a16 stacks; ``{"ep": 4}``, ``{"ep": 2, "tp": 2}``,
  ``{"tp": 4}``), and so do the turbo shards of a dense layer's row and col
  splits.
- The mesh: ``make_mesh`` lays out ``{"ep": e, "tp": t}`` ep-major as
  JAX's does, ``axis_size`` answers as JAX's, and ``sp`` with ``tp`` or
  ``ep``, ``dp`` and ``pp`` are refused.
- ``validate_ep`` gives the JAX function's messages; the fallbacks (E not
  divisible by ep, a hidden axis not divisible by tp, a quantized we2 whose
  block axis does not divide) pick the JAX package's path.
- ``_moe_ffn`` under each mesh of ``tests/test_moe.py`` and ``{"ep": 4}``,
  in both regimes (6 and 40 tokens), against JAX's sharded ``_moe_ffn`` and
  the port's dense oracle; on Q40 and turbo a8 stacks too (the gather
  regime quantizes each shard's slice of the activation, as JAX's
  ``shard_map`` does). Tolerance: 1e-5 of max|y| (f32 sums in another
  order), JAX's own 2e-5 / 2e-6 against the oracle.
- The turbo linear at tp = 2 (a8 and a16, a row and a col split) against
  JAX's GSPMD dot: a8 row splits bit for bit, col splits within 1e-6 of
  max|y| (the shards' f32 partials are summed after the epilogue; JAX sums
  int32), a16 within 1e-6.
- ``InferenceEngine(tp=2)`` on a tiny Q40 MoE file (hidden 128, so the
  expert hidden axis is cut) and under ``quant_mode="turbo"`` on a tiny
  dense file, against the JAX engine at tp = 2: prefill logits within 1e-4,
  greedy transcripts token for token, perplexity within 1e-5 relative, the
  turbo shards (derived whole, then cut) bit for bit against its; the
  paged scheduler at tp = 2 on the MoE file token-exact against the JAX
  solo engine; ``inference --tp 2`` and ``api --tp 2`` through the CLI.
- C8: MoE paged serving under prefix sharing. A twin pair of identical
  greedy requests, whose first block the prefix index maps to a block that
  another request prefilled at another chunk width, through the port's
  paged ``BatchScheduler`` and the JAX one, in the same admission order,
  under the CLI's Q80 sync buffers: the same chunk widths, the same reuse
  and the same transcripts token for token."""

from __future__ import annotations

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats import mfile as jax_mfile
from dllama_tpu.formats import quants, tfile
from dllama_tpu.models import llama as jax_llama
from dllama_tpu.models.config import ModelConfig as JaxConfig
from dllama_tpu.ops.linear import QuantizedWeight as JaxQW
from dllama_tpu.ops.linear import quantize_weight_q40
from dllama_tpu.ops.turbo import derive_turbo as jax_derive_turbo
from dllama_tpu.ops.turbo import turbo_matmul as jax_turbo_matmul
from dllama_tpu.parallel import use_plan
from dllama_tpu.parallel import sharding as jax_sharding
from dllama_tpu.parallel.api import make_mesh as jax_make_mesh
from dllama_tpu.runtime import serving as jax_serving
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu.runtime.engine import _tp_ok as jax_tp_ok
from dllama_tpu.runtime.kvcache import KVCache as JaxKVCache
from dllama_tpu.serve import cli as jax_cli
from dllama_tpu_torch.formats import mfile
from dllama_tpu_torch.models import llama
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.ops.linear import ExpertShards, ShardedWeight, linear
from dllama_tpu_torch.ops.moe_matmul import moe_matmul
from dllama_tpu_torch.ops.turbo import TurboWeight
from dllama_tpu_torch.parallel import sharding
from dllama_tpu_torch.parallel.api import make_mesh
from dllama_tpu_torch.runtime import serving
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.serving import BatchScheduler
from dllama_tpu_torch.serve import cli

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model

E, K = 8, 2
MESHES = [{"ep": 4}, {"ep": 2, "tp": 2}, {"tp": 4}]
FFN_RTOL = 1e-5   # of max|y|: one FFN, f32 sums in another order
LOGIT_ATOL = 1e-4  # O(1) logits, f32 sums in another order


def _configs(**over):
    base = dict(arch=mfile.ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2, n_heads=4,
                n_kv_heads=2, head_dim=16, vocab_size=96, seq_len=64, norm_epsilon=1e-5,
                rope_theta=10000.0, rope_type=mfile.RopeType.LLAMA, n_experts=E,
                n_active_experts=K, compute_dtype="float32")
    base.update(over)
    jkw = dict(base, arch=jax_mfile.ArchType.LLAMA, rope_type=jax_mfile.RopeType.LLAMA)
    return ModelConfig(**base), JaxConfig(**jkw)


EXPERTS = ("we1", "we2", "we3")


def _jax_params(jcfg, repr_: str, seed: int):
    """JAX MoE params whose expert stacks are Q40 planes, Q80 planes (codes
    over [-127, 127]), dense f32 or bf16 stacks, or turbo a8/a16 planes."""
    if repr_.startswith("dense"):
        dt = jnp.bfloat16 if repr_ == "dense_bf16" else jnp.float32
        return jax_llama.init_random_params(jcfg, seed=seed, dtype=dt)
    jp = jax_llama.init_random_params(jcfg, seed=seed, quantized=True)
    rng = np.random.default_rng(seed)

    def conv(w):
        if repr_ == "q80":
            codes = rng.integers(-127, 128, np.shape(w.codes)).astype(np.int8)
            return JaxQW(scales=w.scales / 16, codes=jnp.asarray(codes))
        if repr_ in ("turbo", "turbo16"):
            return jax_derive_turbo(w, a8=repr_ == "turbo")
        return w

    lay = jp.layers
    return jp._replace(layers=lay._replace(**{f: conv(getattr(lay, f)) for f in EXPERTS}))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(w):
    """A weight's arrays in ``map_expert_weight``'s order."""
    if hasattr(w, "w8"):
        return [w.w8, w.scale]
    if hasattr(w, "codes"):
        return [w.scales, w.codes]
    return [w]


def _jax_shard(arr, device, layer=None):
    shard = next(s for s in arr.addressable_shards if s.device == device)
    data = np.asarray(shard.data.astype(jnp.float32) if shard.data.dtype == jnp.bfloat16
                      else shard.data)
    return data if layer is None else data[layer]


def _port_np(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("axes", MESHES, ids=["ep4", "ep2-tp2", "tp4"])
@pytest.mark.parametrize("repr_", ["q40", "q80", "dense_f32", "dense_bf16", "turbo",
                                   "turbo16"])
def test_expert_shards_equal_jax_shard_params_bitwise(repr_, axes):
    cfg, jcfg = _configs()
    jp = _jax_params(jcfg, repr_, seed=11)
    params = llama.from_jax_params(_np(jp), cfg)
    n = int(np.prod(list(axes.values())))
    plan = make_mesh(axes, ["cpu"] * n)
    jplan = jax_make_mesh(axes)
    jsharded = jax_sharding.shard_params(jplan, jp)
    devices = list(jplan.mesh.devices.flat)  # ep-major, as the port's grid
    ep, tp = axes.get("ep", 1), axes.get("tp", 1)
    for l, lp in enumerate(params.layers):
        slp = sharding.shard_layer(plan, lp)
        assert slp.moe_gate is lp.moe_gate  # the router stays whole on the lead
        for f in EXPERTS:
            w = getattr(slp, f)
            assert isinstance(w, ExpertShards) and w.ep == ep and len(w.shards) == n
            for s, dev in enumerate(devices):
                got, want = _leaves(w.shards[s]), _leaves(getattr(jsharded.layers, f))
                assert len(got) == len(want)
                for g, jw in zip(got, want):
                    np.testing.assert_array_equal(_port_np(g), _jax_shard(jw, dev, l))
                # each shard holds E / ep experts and hidden / tp of the hidden axis
                shape = sharding._expert_plane(w.shards[s]).shape
                assert shape[0] == E // ep and shape[2 if f != "we2" else 1] == 128 // tp
        # the dense layers' matmuls are cut over tp alone (whole at tp = 1)
        assert isinstance(slp.wq, ShardedWeight) == (tp > 1)


@pytest.mark.parametrize("split", ["out", "in"])
@pytest.mark.parametrize("a8", [True, False], ids=["a8", "a16"])
def test_turbo_linear_tp2_matches_jax(split, a8):
    """A turbo plane derived from the whole Q40 plane, then cut like it
    (a row split cuts w8's out axis and the scale; a col split w8's in axis,
    every shard keeping the whole scale), against JAX's dot over the same
    planes sharded by ``param_shardings``' rule."""
    rng = np.random.default_rng(5)
    Kd, N, M = 256, 128, 5
    w = (rng.standard_normal((N, Kd)) * 0.1).astype(np.float32)
    jw = jax_derive_turbo(quantize_weight_q40(w), a8=a8)
    x = rng.standard_normal((M, Kd)).astype(np.float32)
    jplan = jax_make_mesh({"tp": 2})
    in_ax, out_ax = (None, "heads") if split == "out" else ("heads", None)
    jsh = jax_sharding._weight_sharding(jplan, jw, out_ax, in_ax, False)
    jws = jax.device_put(jw, jsh)
    want = np.asarray(jax.jit(jax_turbo_matmul)(jnp.asarray(x), jws))
    tw = TurboWeight(torch.from_numpy(np.array(jw.w8)), torch.from_numpy(np.array(jw.scale)),
                     a8)
    plan = make_mesh({"tp": 2}, ["cpu"] * 2)
    sw = sharding.shard_weight(plan, tw, split)
    assert sw.split == split
    for j, dev in enumerate(jplan.mesh.devices.flat):
        np.testing.assert_array_equal(sw.shards[j].w8.numpy(), _jax_shard(jws.w8, dev))
        np.testing.assert_array_equal(sw.shards[j].scale.numpy(), _jax_shard(jws.scale, dev))
    got = linear(torch.from_numpy(x), sw).numpy()
    whole = linear(torch.from_numpy(x), tw).numpy()
    if a8 and split == "out":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(got, whole, rtol=0, atol=1e-6 * np.abs(whole).max())
    if a8 and split == "in":
        # the row is quantized once, whole: a shard quantizing its own
        # columns computes another function
        from dllama_tpu_torch.ops.turbo import turbo_matmul

        own = sum(turbo_matmul(torch.from_numpy(x[:, j * Kd // 2:(j + 1) * Kd // 2]).float(),
                               sw.shards[j]) for j in range(2)).numpy()
        assert np.abs(own - want).max() > 10 * np.abs(got - want).max()


@pytest.mark.parametrize("axes", [{"ep": 4}, {"ep": 2, "tp": 2}, {"tp": 4}, {"ep": 2, "tp": 4},
                                  {"sp": 2}])
def test_make_mesh_grid_and_axis_sizes_match_jax(axes):
    """The port's plan lays its shards out as JAX's ``make_mesh`` lays its
    devices (ep-major: shard ``(i, j)`` is device ``i * tp + j``), its first
    row is the tp group, and ``axis_size`` answers as JAX's for every axis."""
    n = int(np.prod(list(axes.values())))
    devs = [torch.device("cpu", i) for i in range(n)]
    plan = make_mesh(axes, devs)
    jplan = jax_make_mesh(axes)
    order = [d.id for d in jplan.mesh.devices.flat]
    assert [d.index for d in plan.shards] == order
    for name in ("dp", "pp", "sp", "tp", "ep"):
        assert plan.axis_size(name) == jplan.axis_size(name)
    row = axes.get("tp", 1) * axes.get("sp", 1)
    assert list(plan.devices) == devs[:row] and plan.lead == devs[0]


@pytest.mark.parametrize("axes,err", [
    ({"sp": 2, "ep": 2}, "sp=2 x ep=2 is not ported"),
    ({"sp": 2, "tp": 2}, "sp=2 x tp=2 is not ported"),
    ({"ep": 2, "dp": 2}, "dp=2 is not ported"), ({"ep": 2, "pp": 2}, "pp=2 is not ported")])
def test_make_mesh_refuses_what_is_not_ported(axes, err):
    with pytest.raises(NotImplementedError, match=err):
        make_mesh(axes, ["cpu"] * 4)
    with pytest.raises(ValueError, match="mesh ep=2 tp=2 needs 4 devices, found 3"):
        make_mesh({"ep": 2, "tp": 2}, ["cpu"] * 3)


@pytest.mark.parametrize("ep", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("n_experts", [0, 6, 8])
def test_validate_ep_matches_jax(n_experts, ep):
    cfg, jcfg = _configs(n_experts=n_experts, n_active_experts=K if n_experts else 0)
    msgs = []
    for fn, c in ((jax_sharding.validate_ep, jcfg), (sharding.validate_ep, cfg)):
        try:
            fn(c, ep)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    assert msgs[0] == msgs[1]


def test_default_tp_of_moe_and_turbo_follows_jax_rule():
    for over in ({}, dict(hidden_dim=96), dict(hidden_dim=36)):
        cfg, jcfg = _configs(**over)
        for n_dev in (1, 2, 4, 8):
            rule = 1
            while rule * 2 <= n_dev and jax_tp_ok(jcfg, rule * 2):
                rule *= 2
            assert sharding.default_tp(cfg, n_dev) == rule


def _lp_pair(cfg, jcfg, repr_, seed):
    jp = _jax_params(jcfg, repr_, seed)
    jlp = jax.tree.map(lambda a: None if a is None else a[0], jp.layers,
                       is_leaf=lambda x: x is None)
    return jlp, llama.from_jax_params(_np(jp), cfg).layers[0]


def _jax_ffn(jcfg, jlp, h, axes, monkeypatch=None):
    """JAX's ``_moe_ffn`` under ``make_mesh(axes)``, and whether it took the
    dense oracle."""
    taken = []
    real = jax_llama._moe_ffn_dense

    def spy(*a, **kw):
        taken.append(True)
        return real(*a, **kw)

    monkeypatch.setattr(jax_llama, "_moe_ffn_dense", spy)
    with use_plan(jax_make_mesh(axes)):
        y = jax.jit(lambda hh: jax_llama._moe_ffn(jcfg, hh, jlp))(jnp.asarray(h))
    return np.asarray(y), bool(taken)


@pytest.mark.parametrize("n_tokens", [6, 40], ids=["gather", "ragged"])
@pytest.mark.parametrize("axes,repr_", [
    ({"tp": 4}, "dense_f32"), ({"ep": 2, "tp": 2}, "dense_f32"), ({"tp": 8}, "dense_f32"),
    ({"ep": 2, "tp": 4}, "dense_f32"), ({"ep": 4}, "dense_f32"),
    ({"ep": 2, "tp": 2}, "q40"), ({"ep": 2, "tp": 2}, "turbo")],
    ids=["tp4", "ep2-tp2", "tp8", "ep2-tp4", "ep4", "ep2-tp2-q40", "ep2-tp2-turbo"])
def test_moe_ffn_sharded_matches_jax_and_dense_oracle(axes, repr_, n_tokens, monkeypatch):
    """The JAX test's config (hidden 96 for dense stacks; 128 for Q40 and
    turbo, so that a quantized we2's block axis divides by tp)."""
    cfg, jcfg = _configs(n_layers=1, hidden_dim=96 if repr_.startswith("dense") else 128)
    jlp, lp = _lp_pair(cfg, jcfg, repr_, seed=31)
    h = np.random.default_rng(6).standard_normal((1, n_tokens, cfg.dim)).astype(np.float32)
    want, dense_taken = _jax_ffn(jcfg, jlp, h, axes, monkeypatch)
    assert not dense_taken
    n = int(np.prod(list(axes.values())))
    plan = make_mesh(axes, ["cpu"] * n)
    slp = sharding.shard_layer(plan, lp)
    assert len(slp.we1.shards) == n and not slp.we1.oracle
    calls = []
    monkeypatch.setattr(llama, "moe_matmul", lambda x, we, *a, **kw: (
        calls.append(tuple(sharding._expert_plane(we).shape)), moe_matmul(x, we, *a, **kw))[1])
    got = llama._moe_ffn(cfg, torch.from_numpy(h), slp).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=FFN_RTOL * scale)
    if n_tokens * K > llama._MOE_GATHER_MAX_ROWS:
        # K5's wrapper once a shard a projection, at the shard's shapes
        ep, tp = axes.get("ep", 1), axes.get("tp", 1)
        H = cfg.hidden_dim // tp
        assert sorted(calls) == sorted([(E // ep, cfg.dim, H), (E // ep, cfg.dim, H),
                                        (E // ep, H, cfg.dim)] * n)
    if repr_ == "dense_f32":
        oracle = llama._moe_ffn_dense(cfg, torch.from_numpy(h), lp).numpy()
        np.testing.assert_allclose(got, oracle, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("case", ["hidden_not_divisible", "q40_blocks_not_divisible",
                                  "experts_not_divisible"])
def test_fallbacks_follow_jax(case, monkeypatch):
    """The JAX package's fallbacks: a hidden axis that tp does not divide
    runs the dense oracle; a quantized we2 whose 32-row block axis tp does
    not divide keeps the hidden axis whole (the partials sum over ep
    alone); experts that ep does not divide stay whole over ep."""
    over, repr_, axes = {
        "hidden_not_divisible": (dict(hidden_dim=36), "dense_f32", {"tp": 8}),
        "q40_blocks_not_divisible": (dict(hidden_dim=96), "q40", {"ep": 2, "tp": 2}),
        "experts_not_divisible": (dict(n_experts=6), "dense_f32", {"ep": 4, "tp": 2}),
    }[case]
    cfg, jcfg = _configs(n_layers=1, **over)
    jlp, lp = _lp_pair(cfg, jcfg, repr_, seed=41)
    h = np.random.default_rng(8).standard_normal((1, 40, cfg.dim)).astype(np.float32)
    want, dense_taken = _jax_ffn(jcfg, jlp, h, axes, monkeypatch)
    n = int(np.prod(list(axes.values())))
    plan = make_mesh(axes, ["cpu"] * n)
    grid = sharding.expert_grid(plan, lp)
    assert grid == {"hidden_not_divisible": None, "q40_blocks_not_divisible": (2, 1),
                    "experts_not_divisible": (1, 2)}[case]
    assert dense_taken == (grid is None)
    slp = sharding.shard_layer(plan, lp)
    assert slp.we1.oracle == (grid is None)
    got = llama._moe_ffn(cfg, torch.from_numpy(h), slp).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FFN_RTOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# the engine, serving and the CLI
# ---------------------------------------------------------------------------

PROMPT = "the quick brown fox jumps over the lazy dog, twice."


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A tiny Q40 MoE file whose expert hidden axis (128, four 32-row
    blocks) tp = 2 cuts, a tiny Q40 dense file, and a byte tokenizer."""
    out = tmp_path_factory.mktemp("moe_tp")
    moe, dense, t = out / "moe.m", out / "dense.m", out / "t.t"
    write_tiny_model(moe, tiny_header_params(vocab_size=268, seq_len=96, hidden_dim=128,
                                             n_experts=4, n_active_experts=2),
                     np.random.default_rng(43))
    write_tiny_model(dense, tiny_header_params(vocab_size=268, seq_len=96, n_heads=8,
                                               hidden_dim=128), np.random.default_rng(17))
    td = byte_vocab_tokenizer()
    td.chat_template = "<|start_header_id|>"  # detected as llama3
    tfile.write_tfile(t, td)
    return str(moe), str(dense), str(t)


def _prefill_logits(eng, jeng, ids):
    tokens = torch.tensor([ids])
    got, _ = llama.forward(eng.params, eng.cfg, tokens, 0, eng._fresh_kv(), eng.plan)
    kv0 = JaxKVCache.create(jeng.cfg)
    kv = jax.device_put(kv0, jax_sharding.kv_cache_sharding(jeng.plan, kv0))
    with use_plan(jeng.plan):
        want, _ = jax.jit(jax_llama.forward, static_argnums=1)(
            jeng.params, jeng.cfg, jnp.asarray([ids], jnp.int32), jnp.int32(0), kv)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("which", ["moe", "turbo"])
def test_engine_tp2_matches_jax_engine(files, which, monkeypatch):
    moe, dense, t = files
    path, qm = (moe, "auto") if which == "moe" else (dense, "turbo")
    monkeypatch.setenv("DLLAMA_TPU_QUANT_MODE", qm)
    eng = InferenceEngine(path, t, device="cpu", tp=2, temperature=0.0, quant_mode=qm)
    jeng = JaxEngine(path, t, tp=2, temperature=0.0)
    try:
        lp = eng.params.layers[0]
        if which == "moe":
            assert isinstance(lp.we1, ExpertShards) and len(lp.we1.shards) == 2
            assert lp.we1.shards[0].codes.shape == (4, 64, 64)  # hidden 128 cut in two
        else:
            # the turbo planes derive from the whole Q40 planes, then cut: each
            # shard equals the JAX engine's, bit for bit (a col split's scale
            # is the whole column's)
            devices = list(jeng.plan.mesh.devices.flat)
            for f in ("wq", "wo", "w1", "w2"):
                w, jw = getattr(lp, f), getattr(jeng.params.layers, f)
                assert all(isinstance(s, TurboWeight) for s in w.shards)
                for j, dev in enumerate(devices):
                    np.testing.assert_array_equal(w.shards[j].w8.numpy(),
                                                  _jax_shard(jw.w8, dev, 0))
                    np.testing.assert_array_equal(w.shards[j].scale.numpy(),
                                                  _jax_shard(jw.scale, dev, 0))
        ids = eng.tokenizer.encode(PROMPT)
        got, want = _prefill_logits(eng, jeng, ids)
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)
        jeng.reset()
        assert (eng.generate(ids, 16, stop_on_eos=False).tokens
                == jeng.generate(ids, 16, stop_on_eos=False).tokens)
        eng.reset()
        jeng.reset()
        assert eng.perplexity(ids) == pytest.approx(jeng.perplexity(ids), rel=1e-5)
    finally:
        eng.close()
        jeng.close()


def test_engine_builds_moe_and_turbo_at_tp2_and_keeps_refusals(files):
    moe, dense, t = files
    for path, qm in ((moe, "turbo16"), (dense, "turbo16")):
        eng = InferenceEngine(path, t, device="cpu", tp=2, quant_mode=qm)
        try:
            assert eng.tp == 2
        finally:
            eng.close()
    with pytest.raises(ValueError, match="--tp 2 does not support --kv-host-blocks"):
        InferenceEngine(moe, t, device="cpu", tp=2, kv_block_size=16, kv_host_blocks=8)
    with pytest.raises(ValueError, match="--tp 2 does not support --sp > 1"):
        InferenceEngine(moe, t, device="cpu", tp=2, sp=2)


def test_paged_serving_tp2_moe_token_exact_against_jax_solo(files):
    """6 mixed greedy/sampled requests through 2 slots of the tp = 2 paged
    pool on the MoE file: every transcript equals the JAX solo engine's."""
    moe, _, t = files
    prompts = ["hello world", "the quick brown fox jumps over", "abc",
               "hello world how are you today my friend", "xyzzy", "hello hello hello"]
    specs = [dict(temperature=0.0, seed=1), dict(temperature=0.8, seed=2),
             dict(temperature=0.0, seed=3), dict(temperature=1.2, seed=4),
             dict(temperature=0.0, seed=5), dict(temperature=0.6, seed=6)]
    solo = JaxEngine(moe, t, tp=1)
    want = []
    try:
        for p, s in zip(prompts, specs):
            solo.reset()
            solo.sampler.set_temp(s["temperature"])
            solo.sampler.set_seed(s["seed"])
            want.append(solo.generate(solo.tokenizer.encode(p, is_start=True), 10,
                                      stop_on_eos=False).tokens)
    finally:
        solo.close()
    eng = InferenceEngine(moe, t, device="cpu", tp=2, kv_block_size=16)
    sched = BatchScheduler(eng, n_slots=2)
    try:
        reqs = [sched.submit(eng.tokenizer.encode(p, is_start=True), 10, stop_on_eos=False,
                             temperature=s["temperature"], seed=s["seed"])
                for p, s in zip(prompts, specs)]
        for r in reqs:
            assert r.done.wait(timeout=300) and r.error is None, r.error
        assert [r.tokens for r in reqs] == want
        assert sched.gen.reused_tokens > 0
    finally:
        sched.close()
        eng.close()


def _streamed(out: str) -> str:
    return out.split(PROMPT + "\n", 1)[1].split("\n\nEvaluation", 1)[0].rstrip("\n")


def test_cli_inference_tp2_moe_matches_jax_cli(files, capsys):
    moe, _, t = files
    line = ["inference", "--model", moe, "--tokenizer", t, "--temperature", "0", "--tp", "2",
            "--prompt", PROMPT, "--steps", "80"]
    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]), ("jax", jax_cli.main, [])):
        assert main([*line, *extra]) in (0, None)
        got = capsys.readouterr().out
        assert "TP devices: 2" in got
        outs[name] = _streamed(got)
    assert outs["port"] and outs["port"] == outs["jax"]


def test_api_tp2_serves_moe_under_turbo(files):
    moe, _, t = files
    started, box = threading.Event(), {}

    def on_listening(srv, state):
        box["server"], box["state"] = srv, state
        started.set()

    th = threading.Thread(target=lambda: box.setdefault("rc", cli.main(
        ["api", "--model", moe, "--tokenizer", t, "--device", "cpu", "--tp", "2",
         "--quant-mode", "turbo", "--batch-slots", "2", "--kv-block-size", "16",
         "--port", "0", "--temperature", "0"], on_listening=on_listening)), daemon=True)
    th.start()
    assert started.wait(timeout=120), "server did not start"
    url = f"http://127.0.0.1:{box['server'].server_address[1]}/v1/chat/completions"
    try:
        eng = box["state"].engine
        assert eng.tp == 2 and isinstance(eng.params.layers[0].we2.shards[0], TurboWeight)
        body = json.dumps({"messages": [{"role": "user", "content": "hello"}],
                           "max_tokens": 6, "temperature": 0}).encode()
        texts = []
        for _ in range(2):
            req = urllib.request.Request(url, data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                texts.append(json.loads(r.read())["choices"][0]["message"]["content"])
        assert texts[0] and texts[0] == texts[1]
    finally:
        box["server"].shutdown()
        th.join(timeout=60)
    assert box["rc"] == 0


# ---------------------------------------------------------------------------
# C8: MoE paged serving under prefix sharing, against the JAX scheduler
# ---------------------------------------------------------------------------

LONG = "You are helpful and you answer every question about rivers and stones at length."
TWIN_TAIL = " Tell me a short story."


def _record_prefills(monkeypatch, gen_cls, jax_side: bool) -> list:
    """Wrap a paged generator's prefill launch: record each chunk's
    ``(first position, width)``."""
    seen = []
    real = gen_cls._exec_prefill
    if jax_side:
        def wrapped(self, col, padded, pos):
            seen.append((int(pos), len(padded)))
            return real(self, col, padded, pos)
    else:
        def wrapped(self, adm, padded):
            seen.append((int(adm.pos), len(padded)))
            return real(self, adm, padded)
    monkeypatch.setattr(gen_cls, "_exec_prefill", wrapped)
    return seen


def _record_reuse(monkeypatch, gen_cls) -> list:
    seen = []
    real = gen_cls._note_admitted

    def wrapped(self, req, slot, reused):
        seen.append(int(reused))
        return real(self, req, slot, reused)

    monkeypatch.setattr(gen_cls, "_note_admitted", wrapped)
    return seen


def test_c8_twin_pair_under_prefix_sharing_matches_jax_scheduler(files, monkeypatch):
    """The long request prefills the shared first block in a wide chunk and
    retires; the twins then map that block and prefill their own tail in a
    narrower chunk (the second twin reuses its sibling's blocks too). Both
    schedulers see one admission order: a first wave of the long request
    alone, then the twin pair together."""
    moe, _, t = files
    runs = {}
    for side in ("jax", "port"):
        jax_side = side == "jax"
        gen_cls = jax_serving.PagedGenerator if jax_side else serving.PagedGenerator
        chunks = _record_prefills(monkeypatch, gen_cls, jax_side)
        reuse = _record_reuse(monkeypatch, gen_cls)
        if jax_side:
            eng = JaxEngine(moe, t, tp=1, sync_type=quants.Q80, kv_block_size=16)
            sched = jax_serving.BatchScheduler(eng, n_slots=2)
        else:
            eng = InferenceEngine(moe, t, device="cpu", sync_type=quants.Q80,
                                  kv_block_size=16)
            sched = BatchScheduler(eng, n_slots=2)
        try:
            long_ids = eng.tokenizer.encode(LONG, is_start=True)
            # the twin: the long prompt's first 16-token block, then its own tail
            enc = [long_ids, long_ids[:16] + eng.tokenizer.encode(TWIN_TAIL, is_start=False)]
            first = sched.submit(enc[0], 4, stop_on_eos=False, temperature=0.0)
            assert first.done.wait(timeout=300) and first.error is None, first.error
            pair = [sched.submit(enc[1], 24, stop_on_eos=False, temperature=0.0)
                    for _ in range(2)]
            for r in pair:
                assert r.done.wait(timeout=300) and r.error is None, r.error
            runs[side] = dict(long=first.tokens, pair=[r.tokens for r in pair],
                              chunks=list(chunks), reuse=list(reuse))
        finally:
            sched.close()
            eng.close()
        monkeypatch.undo()
    port, ref = runs["port"], runs["jax"]
    assert len(enc[1]) > 16 and enc[0][:16] == enc[1][:16] and enc[0][16] != enc[1][16]
    # the twins' first block is the long request's, prefilled at another width
    assert port["reuse"][1] == 16 and port["reuse"][2] >= 16
    long_width = next(w for p, w in port["chunks"] if p == 0)
    twin_width = next(w for p, w in port["chunks"] if p == 16)
    assert long_width != twin_width
    assert port["chunks"] == ref["chunks"] and port["reuse"] == ref["reuse"]
    assert port["long"] == ref["long"]
    assert port["pair"] == ref["pair"]
    assert port["pair"][0] == port["pair"][1]  # on the CPU the twins do not part
