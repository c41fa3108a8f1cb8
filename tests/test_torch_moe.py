"""The port's mixture-of-experts path against the JAX package's on the same
inputs: the ``.m`` MoE tensor walk (with the routerless-file detection), the
top-k router, the sparse expert FFN in both of its regimes on Q40, dense and
turbo expert planes, the all-experts oracle, whole-model logits on tiny Q40
MoE files (Llama and Qwen3 arch, exact and fast), the loader's expert
stacks and the device-memory estimate.

On the CPU the expert dots run their plain versions: the gather regime
literally, the ragged regime through K5's wrapper (``ops/moe_matmul.py``),
whose plain version is the per-group loop. Tolerances are stated per test:
f32 paths differ from XLA only in the order of f32 sums; bf16 paths round
activations at op boundaries the two frameworks place differently."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats import mfile as jax_mfile
from dllama_tpu.formats import quants
from dllama_tpu.models import llama as jax_llama
from dllama_tpu.models.config import ModelConfig as JaxConfig
from dllama_tpu.runtime import hbm as jax_hbm
from dllama_tpu.runtime.kvcache import KVCache as JaxKVCache
from dllama_tpu.runtime.weights import load_params as jax_load_params
from dllama_tpu_torch.formats import mfile
from dllama_tpu_torch.models import llama
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.ops import moe_matmul as mm
from dllama_tpu_torch.ops.linear import QuantizedWeight
from dllama_tpu_torch.ops.turbo import TurboWeight
from dllama_tpu_torch.runtime import hbm
from dllama_tpu_torch.runtime.kvcache import KVCache
from dllama_tpu_torch.runtime.weights import load_params

from helpers import tiny_header_params, write_tiny_model

E, K = 4, 2  # experts / active experts of the tiny configs

# the bounds of tests/test_torch_model.py: f32 sums in another order (1e-4
# absolute on O(1) logits); bf16 rounding at other op boundaries (3e-2 of
# max|logit|)
F32_ATOL = 1e-4
BF16_RTOL = 3e-2
# one FFN call: f32 sums over <= 128 terms in another order
FFN_F32_RTOL = 1e-5


def _moe_file(path, arch=jax_mfile.ArchType.LLAMA, weight_type=quants.Q40, seed=7, **kw):
    params = tiny_header_params(arch=arch, n_experts=E, n_active_experts=K,
                                weight_type=weight_type, **kw)
    if arch == jax_mfile.ArchType.QWEN3:
        params["rope_type"] = int(jax_mfile.RopeType.FALCON)
    write_tiny_model(path, params, np.random.default_rng(seed))
    return path


def _records(tensors) -> dict:
    return {k: (r.name, r.layer, tuple(r.shape), r.float_type, r.offset, r.n_bytes)
            for k, r in tensors.items()}


def _routerless(src, dst):
    """``src`` with its router tensors cut out: the reference converter's
    MoE layout."""
    with jax_mfile.ModelFile.open(src) as mf:
        spans = sorted((r.offset, r.n_bytes) for r in mf.tensors.values()
                       if r.name == "block_moe_gate")
    raw = open(src, "rb").read()
    out, prev = bytearray(), 0
    for off, nb in spans:
        out += raw[prev:off]
        prev = off + nb
    dst.write_bytes(bytes(out + raw[prev:]))
    return dst


@pytest.mark.parametrize("router", [True, False], ids=["router", "routerless"])
def test_mfile_walk_matches_jax(tmp_path, router):
    path = _moe_file(tmp_path / "a.m")
    if not router:
        path = _routerless(path, tmp_path / "b.m")
    with jax_mfile.ModelFile.open(path) as jmf, mfile.ModelFile.open(path) as mf:
        assert mf.has_moe_router == jmf.has_moe_router == router
        assert _records(mf.tensors) == _records(jmf.tensors)
        assert list(mf.tensors) == list(jmf.tensors)  # the disk order
        assert f"block_expert_w2.1.{E - 1}" in mf.tensors
        assert "block_matmul_w1.0" not in mf.tensors


def test_routerless_file_refused_by_loader(tmp_path):
    path = _routerless(_moe_file(tmp_path / "a.m"), tmp_path / "b.m")
    with mfile.ModelFile.open(path) as mf:
        cfg = ModelConfig.from_header(mf.header)
        with pytest.raises(ValueError, match="no router tensors"):
            load_params(mf, cfg)


def test_truncated_moe_file_reports_router_layout(tmp_path):
    path = _moe_file(tmp_path / "a.m")
    raw = open(path, "rb").read()
    (tmp_path / "c.m").write_bytes(raw[:-10])
    with pytest.raises(ValueError, match="size mismatch"):
        mfile.ModelFile.open(tmp_path / "c.m")


def _cfgs(arch="llama", compute="float32", **over):
    base = dict(arch=mfile.ArchType.LLAMA if arch == "llama" else mfile.ArchType.QWEN3,
                dim=64, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
                vocab_size=96, seq_len=64, norm_epsilon=1e-5, rope_theta=10000.0,
                rope_type=mfile.RopeType.LLAMA if arch == "llama" else mfile.RopeType.FALCON,
                n_experts=E, n_active_experts=K, compute_dtype=compute)
    base.update(over)
    jkw = {k: (jax_mfile.RopeType(int(v)) if k == "rope_type" else
               jax_mfile.ArchType(int(v)) if k == "arch" else v) for k, v in base.items()}
    return ModelConfig(**base), JaxConfig(**jkw)


@pytest.mark.parametrize("norm_topk", [True, False], ids=["renorm", "raw"])
def test_router_matches_jax(norm_topk):
    cfg, jcfg = _cfgs(moe_norm_topk=norm_topk)
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 5, cfg.dim)).astype(np.float32)
    gate = rng.standard_normal((E, cfg.dim)).astype(np.float32) * 0.3
    jw, jidx = jax_llama._moe_router(jcfg, jnp.asarray(h), jnp.asarray(gate))
    w, idx = llama._moe_router(cfg, torch.from_numpy(h), torch.from_numpy(gate))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    # softmax and the renormalization in another order: a few f32 ulps
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    if norm_topk:
        np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_router_ties_break_to_the_lower_expert():
    """Experts 0 and 2 (and 1 and 3) have the same router row: equal
    probabilities, which ``lax.top_k`` orders by index."""
    cfg, jcfg = _cfgs(n_experts=4, n_active_experts=3)
    rng = np.random.default_rng(5)
    rows = rng.standard_normal((2, cfg.dim)).astype(np.float32)
    gate = np.stack([rows[0], rows[1], rows[0], rows[1]])
    h = rng.standard_normal((1, 6, cfg.dim)).astype(np.float32)
    jw, jidx = jax_llama._moe_router(jcfg, jnp.asarray(h), jnp.asarray(gate))
    w, idx = llama._moe_router(cfg, torch.from_numpy(h), torch.from_numpy(gate))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    for t in range(6):  # a tied pair in ascending index order
        pair = sorted(idx[0, t, :2].tolist())
        assert pair[1] - pair[0] == 2 and idx[0, t, 0] == pair[0]
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)


def _expert_reprs(jcfg, repr_: str, seed: int):
    """JAX expert stacks ``[E, in, out]`` of one repr: the three projections
    and the same leaves as numpy."""
    from dllama_tpu.ops.linear import quantize_weight_q40
    from dllama_tpu.ops.turbo import derive_turbo

    rng = np.random.default_rng(seed)
    D, H = jcfg.dim, jcfg.hidden_dim

    def stack(out, in_):
        w = (rng.standard_normal((E, out, in_)) * 0.1).astype(np.float32)
        if repr_ == "dense":
            return jnp.asarray(np.swapaxes(w, 1, 2))
        planes = [quantize_weight_q40(jnp.asarray(w[e])) for e in range(E)]
        qw = jax_llama._stack_weights(planes)
        if repr_ in ("turbo", "turbo16"):
            return derive_turbo(qw, a8=repr_ == "turbo")
        return qw

    return stack(H, D), stack(D, H), stack(H, D)


def _to_port(w, scale_dtype=torch.float32):
    if hasattr(w, "w8"):
        return TurboWeight(torch.from_numpy(np.array(w.w8)),
                           torch.from_numpy(np.array(w.scale)), bool(w.a8))
    if hasattr(w, "codes"):
        return QuantizedWeight(scales=torch.from_numpy(np.array(w.scales)).to(scale_dtype),
                               codes=torch.from_numpy(np.array(w.codes)))
    return torch.from_numpy(np.array(w))


@pytest.mark.parametrize("n_tokens", [4, 32], ids=["gather", "ragged"])
@pytest.mark.parametrize("repr_,compute", [("q40", "float32"), ("q40", "bfloat16"),
                                           ("dense", "float32"), ("turbo", "float32"),
                                           ("turbo16", "float32"), ("turbo", "bfloat16")])
def test_sparse_local_matches_jax(repr_, compute, n_tokens):
    """Both regimes (N·k = 8 and 64 rows against the threshold of 32) on
    each expert repr: the port's ``_moe_sparse_local`` against the JAX
    package's with every expert local."""
    cfg, jcfg = _cfgs(compute_dtype=compute)
    we = _expert_reprs(jcfg, repr_, seed=11)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((n_tokens, cfg.dim)).astype(np.float32)
    idx = np.stack([rng.permutation(E)[:K] for _ in range(n_tokens)]).astype(np.int32)
    wts = rng.random((n_tokens, K)).astype(np.float32)
    dt = jnp.dtype(compute)
    want = np.asarray(jax_llama._moe_sparse_local(
        jcfg, jnp.asarray(x, dt), jnp.asarray(idx), jnp.asarray(wts, dt), *we,
        jnp.int32(0), E), np.float32)
    tdt = getattr(torch, compute)
    sdt = torch.bfloat16 if compute == "bfloat16" else torch.float32
    got = llama._moe_sparse_local(
        cfg, torch.from_numpy(x).to(tdt), torch.from_numpy(idx).long(),
        torch.from_numpy(wts).to(tdt), *(_to_port(w, sdt) for w in we)).float().numpy()
    scale = np.abs(want).max()
    if compute == "float32":
        # f32 sums in another order (the a8 integer dots are exact)
        np.testing.assert_allclose(got, want, rtol=0, atol=FFN_F32_RTOL * scale)
    else:
        assert np.abs(got - want).max() <= BF16_RTOL * scale


@pytest.mark.parametrize("repr_", ["q40", "dense"])
def test_moe_ffn_dense_oracle_matches_jax(repr_):
    cfg, jcfg = _cfgs()
    we = _expert_reprs(jcfg, repr_, seed=17)
    rng = np.random.default_rng(19)
    h = rng.standard_normal((1, 5, cfg.dim)).astype(np.float32)
    gate = rng.standard_normal((E, cfg.dim)).astype(np.float32) * 0.3
    jlp = types_ns(moe_gate=jnp.asarray(gate), we1=we[0], we2=we[1], we3=we[2])
    want = np.asarray(jax_llama._moe_ffn_dense(jcfg, jnp.asarray(h), jlp))
    lp = types_ns(moe_gate=torch.from_numpy(gate), we1=_to_port(we[0]),
                  we2=_to_port(we[1]), we3=_to_port(we[2]))
    got = llama._moe_ffn_dense(cfg, torch.from_numpy(h), lp).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FFN_F32_RTOL * np.abs(want).max())
    # the sparse path computes the same function
    sparse = llama._moe_ffn(cfg, torch.from_numpy(h), lp).numpy()
    np.testing.assert_allclose(sparse, got, rtol=0, atol=FFN_F32_RTOL * np.abs(got).max())


def types_ns(**kw):
    import types

    return types.SimpleNamespace(**kw)


PROMPT = [5, 17, 3, 60, 41, 9]
LONG_PROMPT = [(7 * i + 3) % 90 + 1 for i in range(20)]  # 40 rows: the ragged regime
DECODE = [22, 7, 88]


def _run_both(path, compute: str, prompt):
    """Logits of the prefill and three decode steps, the JAX package's
    loader + forward against the port's, on one file."""
    with jax_mfile.ModelFile.open(path) as jmf:
        jcfg = JaxConfig.from_header(jmf.header, compute_dtype=compute)
        jparams = jax_load_params(jmf, jcfg)
    with mfile.ModelFile.open(path) as mf:
        cfg = ModelConfig.from_header(mf.header, compute_dtype=compute)
        params = load_params(mf, cfg)
    assert cfg.is_moe and params.layers[0].w1 is None
    jkv = JaxKVCache.create(jcfg, dtype=jnp.dtype(compute))
    kv = KVCache.create(cfg, dtype=getattr(torch, compute))
    got, want, pos = [], [], 0
    for ids in [prompt] + [[t] for t in DECODE]:
        jl, jkv = jax_llama.forward(jparams, jcfg, jnp.asarray([ids], jnp.int32),
                                    jnp.int32(pos), jkv)
        tl, kv = llama.forward(params, cfg, torch.tensor([ids]), pos, kv)
        want.append(np.asarray(jl, np.float32))
        got.append(tl.numpy())
        pos += len(ids)
    return got, want


@pytest.mark.parametrize("prompt", [PROMPT, LONG_PROMPT], ids=["gather", "ragged"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"], ids=["exact", "fast"])
@pytest.mark.parametrize("arch", ["llama", "qwen3"])
def test_forward_matches_jax_on_q40_moe_file(tmp_path, arch, compute, prompt):
    a = jax_mfile.ArchType.LLAMA if arch == "llama" else jax_mfile.ArchType.QWEN3
    path = _moe_file(tmp_path / "m.m", arch=a, seed=23, vocab_size=96)
    for got, want in zip(*_run_both(path, compute, prompt)):
        assert got.shape == want.shape and np.isfinite(got).all()
        if compute == "float32":
            np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
        else:
            assert np.abs(got - want).max() <= BF16_RTOL * np.abs(want).max()


def test_forward_matches_jax_on_dense_moe_file(tmp_path):
    """An F32 MoE file: dense expert stacks at the compute dtype."""
    path = _moe_file(tmp_path / "m.m", weight_type=quants.F32, seed=29, vocab_size=96)
    for got, want in zip(*_run_both(path, "float32", LONG_PROMPT)):
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("weight_mode", ["auto", "f32", "bf16"])
def test_loader_expert_stacks(tmp_path, weight_mode):
    """Q40 experts stay quantized K-major stacks ``[E, in, out]`` (the JAX
    loader's planes bit for bit); a dense weight mode dequantizes them to
    the JAX loader's dense stacks."""
    path = _moe_file(tmp_path / "m.m", seed=31)
    with jax_mfile.ModelFile.open(path) as jmf:
        jcfg = JaxConfig.from_header(jmf.header)
        jp = jax_load_params(jmf, jcfg, weight_mode=weight_mode)
    with mfile.ModelFile.open(path) as mf:
        cfg = ModelConfig.from_header(mf.header)
        p = load_params(mf, cfg, weight_mode=weight_mode)
    for l in range(cfg.n_layers):
        np.testing.assert_array_equal(p.layers[l].moe_gate.numpy(),
                                      np.asarray(jp.layers.moe_gate[l]))
        for name in ("we1", "we2", "we3"):
            w, jw = getattr(p.layers[l], name), getattr(jp.layers, name)
            if weight_mode == "auto":
                assert isinstance(w, QuantizedWeight) and w.codes.dim() == 3
                np.testing.assert_array_equal(w.codes.numpy(), np.asarray(jw.codes[l]))
                np.testing.assert_array_equal(w.scales.numpy(), np.asarray(jw.scales[l]))
            else:
                assert isinstance(w, torch.Tensor)
                np.testing.assert_array_equal(w.float().numpy(),
                                              np.asarray(jw[l], np.float32))


def test_from_jax_params_expert_stacks_and_turbo():
    """``init_random_params`` of a JAX MoE config → ``from_jax_params``: the
    stacks split per layer, planes bit for bit; turbo leaves keep their a8;
    the forward matches."""
    from dllama_tpu.ops.turbo import turbo_params as jax_turbo_params

    cfg, jcfg = _cfgs()
    jparams = jax_llama.init_random_params(jcfg, seed=3, quantized=True)
    params = llama.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    lp = params.layers[1]
    assert lp.w1 is None and lp.we2.codes.shape == (E, cfg.hidden_dim, cfg.dim)
    np.testing.assert_array_equal(lp.we2.codes.numpy(), np.asarray(jparams.layers.we2.codes[1]))
    toks = [4, 8, 15, 16, 23, 42]
    jl, _ = jax_llama.forward(jparams, jcfg, jnp.asarray([toks], jnp.int32), jnp.int32(0),
                              JaxKVCache.create(jcfg))
    tl, _ = llama.forward(params, cfg, torch.tensor([toks]), 0, KVCache.create(cfg))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=F32_ATOL)

    tjp = jax_turbo_params(jparams, a8=False, free_source=False)
    tparams = llama.from_jax_params(jax.tree_util.tree_map(np.asarray, tjp), cfg)
    tw = tparams.layers[0].we1
    assert isinstance(tw, TurboWeight) and not tw.a8
    np.testing.assert_array_equal(tw.w8.numpy(), np.asarray(tjp.layers.we1.w8[0]))


def test_init_random_params_moe_shapes():
    cfg, _ = _cfgs()
    p = llama.init_random_params(cfg, quantized=True)
    lp = p.layers[0]
    assert lp.moe_gate.shape == (E, cfg.dim)
    assert lp.we1.codes.shape == (E, cfg.dim, cfg.hidden_dim)
    assert lp.we2.scales.shape == (E, cfg.hidden_dim // 32, cfg.dim)
    dense = llama.init_random_params(cfg)
    assert dense.layers[0].we3.shape == (E, cfg.dim, cfg.hidden_dim)
    logits, _ = llama.forward(p, cfg, torch.tensor([[1, 2, 3]]), 0, KVCache.create(cfg))
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("mode", ["auto", "exact", "fast", "turbo", "turbo16"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("moe", [True, False], ids=["moe", "dense"])
def test_hbm_estimate_matches_jax(monkeypatch, moe, compute, mode):
    """The device-memory estimate equals the JAX module's for the same
    config: the MoE weight count and the turbo derivation's transient (the
    JAX side reads the mode from its environment variable)."""
    kw = dict(n_experts=128, n_active_experts=8) if moe else dict(n_experts=0,
                                                                 n_active_experts=0)
    cfg, jcfg = _cfgs(compute=compute, dim=2048, hidden_dim=768, n_layers=8, n_heads=32,
                      n_kv_heads=4, head_dim=128, vocab_size=151936, seq_len=4096, **kw)
    cfg = dataclasses.replace(cfg, quant_mode=mode)
    monkeypatch.setenv("DLLAMA_TPU_QUANT_MODE", mode)
    assert hbm.matmul_weight_count(cfg) == jax_hbm.matmul_weight_count(jcfg)
    for repr_ in ("q40", "bf16", "f32"):
        got = hbm.estimate_device_bytes(cfg, weight_repr=repr_, kv_dtype_bytes=2)
        want = jax_hbm.estimate_device_bytes(jcfg, weight_repr=repr_, kv_dtype_bytes=2)
        assert got == want, (repr_, got, want)


def test_moe_matmul_plain_decoders_agree_with_gather_dot():
    """K5's plain version over sorted rows computes the gather regime's
    function for the gather decoders (a8 bit for bit)."""
    _, jcfg = _cfgs()
    rng = np.random.default_rng(37)
    rows = np.array([0, 0, 1, 3, 3, 3], dtype=np.int64)
    offsets = torch.tensor([0, 2, 3, 3, 6], dtype=torch.int32)
    for repr_, dec in (("turbo", "a8"), ("turbo16", "a16"), ("q40", "q")):
        we = _to_port(_expert_reprs(jcfg, repr_, seed=41)[0])
        x = torch.from_numpy(rng.standard_normal((6, jcfg.dim)).astype(np.float32))
        want = llama._expert_gather_dot(x, we, torch.from_numpy(rows))
        got = mm.moe_matmul(x, we, offsets, decoder=dec)
        if dec == "a8":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
