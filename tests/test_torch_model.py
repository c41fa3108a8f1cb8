"""The port's dense Llama/Qwen3 forward against the JAX package's ``forward``
on the same weights: ``init_random_params`` (JAX) → numpy →
``from_jax_params`` (port), the same token ids through both, a prefill plus
three decode steps over each framework's own KV cache, in exact (f32) and
fast (bf16) numerics, with the Q80 sync casts on and off.

On the CPU the port's kernel wrappers run their plain versions and the JAX
package takes its XLA paths (no Pallas off the TPU), so this holds the
algorithm: layer order, the fake-quant sync points, rope, GQA attention,
the dense-cache writes and the logits head."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats import mfile as jax_mfile
from dllama_tpu.models import llama as jax_llama
from dllama_tpu.models.config import ModelConfig as JaxConfig
from dllama_tpu.runtime.kvcache import KVCache as JaxKVCache
from dllama_tpu_torch.formats import mfile
from dllama_tpu_torch.models import llama
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.ops.linear import QuantizedWeight
from dllama_tpu_torch.runtime.kvcache import KVCache

ARCHS = {
    # llama3.1 rope scaling exercises all three frequency bands at theta 1e4
    "llama": dict(arch=mfile.ArchType.LLAMA, rope_type=mfile.RopeType.LLAMA3_1,
                  rope_scaling_factor=8.0, rope_scaling_low_freq_factor=1.0,
                  rope_scaling_high_freq_factor=4.0,
                  rope_scaling_orig_max_seq_len=64),
    "qwen3": dict(arch=mfile.ArchType.QWEN3, rope_type=mfile.RopeType.FALCON),
}

# f32: the same f32 math summed in another order (PyTorch's CPU matmul vs
# XLA's dot), a few ulps of O(1) logits -> 1e-4 absolute. bf16: every
# activation is rounded to bf16 (8-bit mantissa) at op boundaries the two
# frameworks place differently, and one flipped ulp feeds the next layer ->
# 3e-2 of max|logit| (observed up to 1.6e-2: four bf16 ulps of |logit| ~0.5).
F32_ATOL = 1e-4
BF16_RTOL = 3e-2

PROMPT = [5, 17, 3, 60, 41, 9]
DECODE = [22, 7, 88]


def _configs(arch: str, compute: str, sync_q80: bool, **over):
    base = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                head_dim=16, vocab_size=96, seq_len=64, norm_epsilon=1e-5,
                rope_theta=10000.0, compute_dtype=compute, sync_q80=sync_q80)
    base.update(ARCHS[arch])
    base.update(over)
    jkw = {k: (jax_mfile.RopeType(int(v)) if k == "rope_type" else
               jax_mfile.ArchType(int(v)) if k == "arch" else v)
           for k, v in base.items()}
    return ModelConfig(**base), JaxConfig(**jkw)


def _pair(cfg, jcfg, quantized=True, seed=0):
    jparams = jax_llama.init_random_params(jcfg, seed=seed, quantized=quantized)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, llama.from_jax_params(tree, cfg)


def _run_both(cfg, jcfg, jparams, params):
    """Logits of the prefill and of each decode step, JAX then port."""
    dt = getattr(torch, cfg.compute_dtype)
    jkv = JaxKVCache.create(jcfg, dtype=jnp.dtype(jcfg.compute_dtype))
    kv = KVCache.create(cfg, dtype=dt)
    got, want = [], []
    pos = 0
    for ids in [PROMPT] + [[t] for t in DECODE]:
        jl, jkv = jax_llama.forward(jparams, jcfg, jnp.asarray([ids], jnp.int32),
                                    jnp.int32(pos), jkv)
        tl, kv = llama.forward(params, cfg, torch.tensor([ids]), pos, kv)
        want.append(np.asarray(jl, np.float32))
        got.append(tl.numpy())
        pos += len(ids)
    return got, want


@pytest.mark.parametrize("sync_q80", [False, True], ids=["f32sync", "q80sync"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_matches_jax_exact(arch, sync_q80):
    cfg, jcfg = _configs(arch, "float32", sync_q80)
    jparams, params = _pair(cfg, jcfg, seed=len(arch) + sync_q80)
    for got, want in zip(*_run_both(cfg, jcfg, jparams, params)):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("sync_q80", [False, True], ids=["f32sync", "q80sync"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_matches_jax_fast(arch, sync_q80):
    cfg, jcfg = _configs(arch, "bfloat16", sync_q80)
    jparams, params = _pair(cfg, jcfg, seed=3 + sync_q80)
    # fast configs store the Q40 scales in bf16 (the loader's rule)
    assert params.layers[0].wq.scales.dtype == torch.bfloat16
    for got, want in zip(*_run_both(cfg, jcfg, jparams, params)):
        assert np.isfinite(got).all()
        err = np.abs(got - want).max()
        assert err <= BF16_RTOL * np.abs(want).max(), (err, np.abs(want).max())


def test_forward_matches_jax_dense_weights():
    """F32 (unquantized) matmul weights take the dense path on both sides."""
    cfg, jcfg = _configs("llama", "float32", False)
    jparams, params = _pair(cfg, jcfg, quantized=False, seed=11)
    assert isinstance(params.layers[0].wq, torch.Tensor)
    for got, want in zip(*_run_both(cfg, jcfg, jparams, params)):
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)


def test_from_jax_params_layout():
    """Stacked ``[L, ...]`` JAX leaves split per layer; Q40 planes keep the
    K-major layout bit for bit."""
    cfg, jcfg = _configs("qwen3", "float32", False)
    jparams, params = _pair(cfg, jcfg, seed=2)
    assert len(params.layers) == cfg.n_layers
    for l in range(cfg.n_layers):
        lp = params.layers[l]
        assert isinstance(lp.w2, QuantizedWeight)
        assert lp.w2.codes.shape == (cfg.hidden_dim, cfg.dim)
        assert lp.w2.scales.shape == (cfg.hidden_dim // 32, cfg.dim)
        np.testing.assert_array_equal(lp.w2.codes.numpy(),
                                      np.asarray(jparams.layers.w2.codes[l]))
        np.testing.assert_array_equal(lp.w2.scales.numpy(),
                                      np.asarray(jparams.layers.w2.scales[l]))
        np.testing.assert_array_equal(lp.norm_q.numpy(),
                                      np.asarray(jparams.layers.norm_q[l]))
    assert params.embedding.shape == (cfg.vocab_size, cfg.dim)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_nll_matches_jax(arch):
    cfg, jcfg = _configs(arch, "float32", True)
    jparams, params = _pair(cfg, jcfg, seed=21)
    ids = PROMPT + DECODE
    toks, tgts = ids[:-1], ids[1:]
    jnll, _ = jax_llama.prefill_nll(
        jparams, jcfg, jnp.asarray([toks], jnp.int32), jnp.asarray([tgts], jnp.int32),
        jnp.int32(0), JaxKVCache.create(jcfg))
    nll, _ = llama.prefill_nll(params, cfg, torch.tensor([toks]), torch.tensor([tgts]),
                               0, KVCache.create(cfg))
    assert nll.shape == (1, len(toks))
    np.testing.assert_allclose(nll.numpy(), np.asarray(jnll), rtol=0, atol=F32_ATOL)


def test_greedy_and_sampled_steps_match_jax():
    """The fused next-token steps pick the JAX package's tokens, greedy and
    sampled (temperature 0.9, top-p 0.9) on shared host coins."""
    cfg, jcfg = _configs("llama", "float32", True)
    jparams, params = _pair(cfg, jcfg, seed=5)
    jkv, kv = JaxKVCache.create(jcfg), KVCache.create(cfg)
    jtok, jkv = jax_llama.greedy_step(jparams, jcfg, jnp.asarray([PROMPT], jnp.int32),
                                      jnp.int32(0), jkv)
    tok, nf, kv = llama.greedy_step(params, cfg, torch.tensor([PROMPT]), 0, kv)
    assert nf.tolist() == [0]
    assert int(tok[0]) == int(jtok[0])
    pos, t = len(PROMPT), int(tok[0])
    for coin in (0.05, 0.5, 0.93):
        jt, jkv = jax_llama.sampled_step(
            jparams, jcfg, jnp.asarray([[t]], jnp.int32), jnp.int32(pos), jkv,
            jnp.float32(0.9), jnp.float32(0.9), jnp.float32(coin))
        tt, _, kv = llama.sampled_step(params, cfg, torch.tensor([[t]]), pos, kv,
                                       0.9, 0.9, coin)
        assert int(tt[0]) == int(jt[0])
        pos, t = pos + 1, int(tt[0])


def test_ragged_start_positions_match_per_row_runs():
    """A ``[B]`` start_pos batch gives each row the logits of its own
    single-row run (the cache writes and the oracle's masks are per row)."""
    cfg, jcfg = _configs("llama", "float32", False)
    _, params = _pair(cfg, jcfg, seed=8)
    rows = [[3, 4, 5], [9, 8, 7]]
    starts = [0, 10]
    kv = KVCache.create(cfg, batch_size=2)
    for b, s in enumerate(starts):  # history before each row's start
        pre = KVCache.create(cfg)
        if s:
            llama.forward(params, cfg, torch.arange(1, s + 1)[None], 0, pre)
        kv.k[:, b] = pre.k[:, 0]
        kv.v[:, b] = pre.v[:, 0]
    logits, _ = llama.forward(params, cfg, torch.tensor(rows), torch.tensor(starts), kv)
    for b, s in enumerate(starts):
        one = KVCache.create(cfg)
        if s:
            llama.forward(params, cfg, torch.arange(1, s + 1)[None], 0, one)
        want, _ = llama.forward(params, cfg, torch.tensor([rows[b]]), s, one)
        torch.testing.assert_close(logits[b], want[0], rtol=0, atol=1e-5)


def test_attn_impl_choice():
    """``auto`` takes the kernel wrapper on a CUDA tensor whatever its shape
    (the wrapper launches K3 or raises; the oracle is never the answer on
    the card) and the oracle on a CPU tensor; ``xla`` never takes it;
    ``flash`` always does; other values fail."""
    cfg, _ = _configs("llama", "float32", False)
    q = torch.zeros((1, 1, cfg.n_heads, cfg.head_dim))
    assert not llama._use_flash(cfg, q)  # CPU tensor: the oracle
    assert not llama._use_flash(dataclasses.replace(cfg, attn_impl="xla"), q)
    assert llama._use_flash(dataclasses.replace(cfg, attn_impl="flash"), q)
    with pytest.raises(ValueError, match="attn_impl"):
        llama._use_flash(dataclasses.replace(cfg, attn_impl="pallas"), q)
    # a CUDA-typed q of a head dim the kernel has no instance for (96) and a
    # too-wide query: ``auto`` still picks the wrapper, and the wrapper raises
    # before touching the card instead of running the oracle
    from dllama_tpu_torch.ops.flash_attention import MAX_ROWS, flash_attention

    for T, D in ((1, 96), (MAX_ROWS // cfg.n_heads + 1, 128)):
        q_cuda = types.SimpleNamespace(device=torch.device("cuda"),
                                       shape=(1, T, cfg.n_heads, D))
        assert llama._use_flash(cfg, q_cuda)
        assert not llama._use_flash(dataclasses.replace(cfg, attn_impl="xla"), q_cuda)
        k = torch.empty((1, cfg.n_kv_heads, 64, D), device="meta")
        with pytest.raises(ValueError, match="not supported"):
            flash_attention(q_cuda, k, k, 0, D)


# --- Q80 weight files: the code kind travels with the planes ---


def _write_q80_model(path, seed):
    """A tiny Q80 Llama ``.m`` file written by the port's own writer
    (``formats.mfile.write_header`` + ``formats.quants.encode_tensor``)."""
    from dllama_tpu_torch.formats import quants

    rng = np.random.default_rng(seed)
    dim, hidden, n_heads, n_kv, hd, vocab, n_layers = 64, 96, 4, 2, 16, 96, 2
    header = dict(version=1, arch_type=int(mfile.ArchType.LLAMA), dim=dim, hidden_dim=hidden,
                  n_layers=n_layers, n_heads=n_heads, n_kv_heads=n_kv, vocab_size=vocab,
                  seq_len=64, hidden_act=int(mfile.HiddenAct.SILU), rope_theta=10000,
                  weight_float_type=quants.Q80, rope_type=int(mfile.RopeType.LLAMA),
                  head_dim=hd, norm_epsilon=5)

    def rand(*shape, base=0.0):
        return (rng.standard_normal(shape) * 0.05 + base).astype(np.float32)

    with open(path, "wb") as f:
        mfile.write_header(f, header)
        f.write(quants.encode_tensor(rand(vocab, dim), quants.F32))
        for _ in range(n_layers):
            for out, in_ in ((n_heads * hd, dim), (n_kv * hd, dim), (n_kv * hd, dim),
                             (dim, n_heads * hd), (hidden, dim), (dim, hidden), (hidden, dim)):
                f.write(quants.encode_tensor(rand(out, in_), quants.Q80))
            for _ in range(2):
                f.write(quants.encode_tensor(rand(dim, base=1.0), quants.F32))
        f.write(quants.encode_tensor(rand(dim, base=1.0), quants.F32))
        f.write(quants.encode_tensor(rand(vocab, dim), quants.Q80))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_q80_file_loads_with_code_kind_and_matches_jax(tmp_path, compute):
    """A Q80 ``.m`` file loads with every matmul plane marked ``q80`` (codes
    past the Q40 nibble range), and the forward over it matches the JAX
    package's forward over the same file, in both numerics."""
    from dllama_tpu.models.llama import load_params_from_mfile
    from dllama_tpu_torch.runtime.weights import load_params

    path = tmp_path / "q80.m"
    _write_q80_model(path, seed=4)
    mf = mfile.ModelFile.open(path)
    cfg = ModelConfig.from_header(mf.header, compute)
    params = load_params(mf, cfg)
    planes = [getattr(lp, n) for lp in params.layers
              for n in ("wq", "wk", "wv", "wo", "w1", "w2", "w3")]
    assert all(isinstance(w, QuantizedWeight) and w.kind == "q80" for w in planes)
    assert max(int(w.codes.abs().max()) for w in planes) > 8
    if compute == "float32":  # exact configs keep the quantized head
        assert params.logits.kind == "q80"
    jmf = jax_mfile.ModelFile.open(path)
    jcfg = JaxConfig.from_header(jmf.header, compute)
    jparams = load_params_from_mfile(jmf, jcfg)
    for got, want in zip(*_run_both(cfg, jcfg, jparams, params)):
        assert np.isfinite(got).all()
        if compute == "float32":
            np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
        else:
            assert np.abs(got - want).max() <= BF16_RTOL * np.abs(want).max()


def test_from_jax_params_keeps_code_kind_when_told():
    """The JAX planes do not record their code range, so their codes tell
    it: ``from_jax_params`` marks a weight Q80 when any code lies outside
    [-8, 7] (here layer 1's ``w2``, redrawn over Q80's [-127, 127]) and Q40
    otherwise, bit for bit the same codes either way."""
    cfg, jcfg = _configs("llama", "float32", False)
    jparams = jax_llama.init_random_params(jcfg, seed=5, quantized=True)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    q40 = llama.from_jax_params(tree, cfg)
    w2 = tree.layers.w2
    codes = np.array(w2.codes)
    codes[1] = np.random.default_rng(5).integers(-127, 128, codes[1].shape, dtype=np.int8)
    tree80 = tree._replace(layers=tree.layers._replace(w2=w2._replace(codes=codes)))
    mixed = llama.from_jax_params(tree80, cfg)
    for params in (q40, mixed):
        for l, lp in enumerate(params.layers):
            kinds = {w.kind for w in (lp.wq, lp.wk, lp.wv, lp.wo, lp.w1, lp.w3)}
            assert kinds == {"q40"}
            assert lp.w2.kind == ("q80" if params is mixed and l == 1 else "q40")
        assert params.logits.kind == "q40"
    assert torch.equal(mixed.layers[1].w2.codes, torch.from_numpy(codes[1]))
    assert torch.equal(mixed.layers[0].w2.codes, q40.layers[0].w2.codes)


@pytest.mark.parametrize("kind,reach", [("q40", 7), ("q80", 127)])
def test_init_random_params_code_kind(kind, reach):
    """Random planes of either kind: mean-zero codes over [-reach, reach],
    marked with their kind."""
    cfg, _ = _configs("llama", "float32", False)
    params = llama.init_random_params(cfg, seed=1, quantized=True, codes_kind=kind)
    w = params.layers[0].w1
    assert w.kind == kind
    assert int(w.codes.min()) == -reach and int(w.codes.max()) == reach
