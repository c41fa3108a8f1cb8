"""Port layers against the JAX package on shared numpy inputs: RMS norms,
RoPE in its three styles, the Q80 fake-quant casts, on-device sampling, and
the host-side copies (Q40/Q80 codecs, .m/.t formats, BPE tokenizer, xorshift
sampler)."""

import dataclasses
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dllama_tpu.formats import mfile as jax_mfile
from dllama_tpu.formats import quants as jax_quants
from dllama_tpu.models.config import ModelConfig as JaxConfig
from dllama_tpu.models.rope import apply_rope as jax_apply_rope
from dllama_tpu.models.rope import build_rope_cache as jax_rope_cache
from dllama_tpu.ops.linear import q80_quantize_planes as jax_q80_planes
from dllama_tpu.ops.norms import rms_norm as jax_rms_norm
from dllama_tpu.ops.norms import rms_norm_per_head as jax_rms_norm_per_head
from dllama_tpu.ops.sampling import sampled_token as jax_sampled_token
from dllama_tpu.tokenizer.bpe import Tokenizer as JaxTokenizer
from dllama_tpu.tokenizer.sampler import Sampler as JaxSampler
from dllama_tpu_torch.formats import mfile, quants, tfile
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.models.rope import apply_rope, build_rope_cache
from dllama_tpu_torch.ops.linear import fake_quant_q80, q80_dequant, q80_quantize_planes
from dllama_tpu_torch.ops.norms import rms_norm, rms_norm_per_head
from dllama_tpu_torch.ops.sampling import sampled_token
from dllama_tpu_torch.tokenizer.bpe import Tokenizer
from dllama_tpu_torch.tokenizer.sampler import Sampler, xorshift_random_f32

GOLDENS = Path(__file__).parent / "goldens"


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    x = _rng(1).standard_normal((2, 3, 64)).astype(np.float32) * 3
    w = 1.0 + _rng(2).standard_normal(64).astype(np.float32) * 0.1
    want = jax_rms_norm(jnp.asarray(x, dtype), jnp.asarray(w), 1e-5)
    got = rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    # f32: mean of squares summed in another order (a few ulps); bf16: the
    # same f32 math then one bf16 rounding of the output (1 ulp = 2^-8)
    tol = 1e-6 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_rms_norm_per_head_matches_jax():
    x = _rng(3).standard_normal((1, 5, 4, 16)).astype(np.float32)
    w = 1.0 + _rng(4).standard_normal(16).astype(np.float32) * 0.1
    want = jax_rms_norm_per_head(jnp.asarray(x), jnp.asarray(w), 1e-6)
    got = rms_norm_per_head(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


ROPE_STYLES = {
    "llama": dict(rope_type=mfile.RopeType.LLAMA),
    "falcon": dict(rope_type=mfile.RopeType.FALCON),
    "llama3_1": dict(rope_type=mfile.RopeType.LLAMA3_1, rope_scaling_factor=8.0,
                     rope_scaling_low_freq_factor=1.0, rope_scaling_high_freq_factor=4.0,
                     rope_scaling_orig_max_seq_len=8192),
}


def _configs(**kw):
    base = dict(arch=mfile.ArchType.LLAMA, dim=64, hidden_dim=96, n_layers=1,
                n_heads=4, n_kv_heads=2, head_dim=16, vocab_size=32, seq_len=64,
                norm_epsilon=1e-5, rope_theta=500000.0)
    base.update(kw)
    jkw = {k: (jax_mfile.RopeType(int(v)) if k == "rope_type" else
               jax_mfile.ArchType(int(v)) if k == "arch" else v) for k, v in base.items()}
    return ModelConfig(**base), JaxConfig(**jkw)


@pytest.mark.parametrize("style", sorted(ROPE_STYLES))
def test_rope_matches_jax(style):
    cfg, jcfg = _configs(**ROPE_STYLES[style])
    cos, sin = build_rope_cache(cfg)
    jcos, jsin = jax_rope_cache(jcfg)
    np.testing.assert_array_equal(cos, jcos)  # the same numpy table build
    np.testing.assert_array_equal(sin, jsin)
    x = _rng(5).standard_normal((2, 3, 4, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2], [40, 41, 42]], np.int32)
    want = jax_apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos), jcfg.rope_type)
    tcos, tsin = torch.from_numpy(cos), torch.from_numpy(sin)
    got = apply_rope(torch.from_numpy(x), tcos, tsin, torch.from_numpy(pos).long(),
                     cfg.rope_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # uniform rows may index the tables by slice (the engine's hot path)
    sliced = apply_rope(torch.from_numpy(x[:1]), tcos, tsin, slice(0, 3), cfg.rope_type)
    np.testing.assert_array_equal(sliced.numpy(), got[:1].numpy())


def test_fake_quant_q80_codes_bit_exact_with_half_to_even_ties():
    rng = _rng(6)
    x = rng.standard_normal((3, 128)).astype(np.float32) * 5
    # blocks whose absmax is exactly 127 (scale d = 1): x.5 values are ties
    # that half-to-even rounding sends to the even code
    x[0, :32] = np.arange(32, dtype=np.float32) - 15.5
    x[0, 31] = 127.0
    x[1, 32:64] = 0.0  # an all-zero block: d = 0, codes 0
    jc, js = jax_q80_planes(jnp.asarray(x))
    tc, ts = q80_quantize_planes(torch.from_numpy(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tc[0, 0, :31].tolist() == [int(np.round(v)) for v in x[0, :31]]
    assert tc[0, 0, 0].item() == -16 and tc[0, 0, 1].item() == -14  # -15.5, -14.5
    from dllama_tpu.ops.linear import fake_quant_q80 as jax_fq

    np.testing.assert_array_equal(fake_quant_q80(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_fq(jnp.asarray(x))))
    # the int8 planes and the fused cast agree bit for bit
    np.testing.assert_array_equal(q80_dequant(tc, ts, x.shape).numpy(),
                                  fake_quant_q80(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("V", [128, 1024])
@pytest.mark.parametrize("temperature,topp", [(0.7, 0.9), (1.0, 0.5), (0.8, 1.0), (0.0, 0.9)])
def test_sampled_token_matches_jax_on_shared_coins(V, temperature, topp):
    """The same logits and the same host coins pick the same tokens (V=1024
    takes the JAX package's 256-wide top-k window; the port sorts fully)."""
    rng = _rng(V)
    logits = (rng.standard_normal((16, V)) * 3).astype(np.float32)
    coins = rng.random(16).astype(np.float32)
    want = jax_sampled_token(jnp.asarray(logits), jnp.float32(temperature),
                             jnp.float32(topp), jnp.asarray(coins))
    got = sampled_token(torch.from_numpy(logits), temperature, topp, torch.from_numpy(coins))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_token_matches_host_oracle_stream():
    """The device sampler over the host xorshift* stream reproduces the numpy
    oracle draw for draw."""
    rng = _rng(11)
    host = Sampler(256, 0.8, 0.9, seed=12345)
    state = 12345
    for _ in range(50):
        logits = (rng.standard_normal(256) * 2).astype(np.float32)
        want = host.sample(logits)
        coin, state = xorshift_random_f32(state)
        got = sampled_token(torch.from_numpy(logits)[None], 0.8, 0.9, coin)
        assert int(got[0]) == want


def test_sampler_copy_matches_jax():
    a, b = Sampler(64, 0.9, 0.8, 99), JaxSampler(64, 0.9, 0.8, 99)
    logits = _rng(12).standard_normal((40, 64)).astype(np.float32)
    assert [a.sample(r) for r in logits] == [b.sample(r) for r in logits]
    assert a.rng_state == b.rng_state


def test_q40_q80_codecs_byte_identical():
    x = (_rng(13).standard_normal(4096) * 0.3).astype(np.float32)
    assert quants.quantize_q40(x) == jax_quants.quantize_q40_np(x)
    assert quants.quantize_q80(x) == jax_quants.quantize_q80_np(x)
    buf = quants.quantize_q40(x)
    np.testing.assert_array_equal(quants.dequantize_q40(buf, x.size),
                                  jax_quants.dequantize_q40_np(buf, x.size))
    s, c = quants.unpack_q40(buf, x.size)
    assert quants.pack_q40(s, c) == buf


def test_model_file_parse_matches_jax(tmp_path):
    import helpers

    params = helpers.tiny_header_params(arch=jax_mfile.ArchType.QWEN3,
                                        rope_type=jax_mfile.RopeType.FALCON)
    path = tmp_path / "m.m"
    helpers.write_tiny_model(path, params, _rng(14))
    with mfile.ModelFile.open(path, max_seq_len=32) as mf, \
            jax_mfile.ModelFile.open(path, max_seq_len=32) as jmf:
        assert dataclasses.asdict(mf.header) == dataclasses.asdict(jmf.header)
        assert list(mf.tensors) == list(jmf.tensors)
        for key in ("embedding", "block_matmul_w2.1", "block_norm_q.0"):
            np.testing.assert_array_equal(mf.tensor_f32(key), jmf.tensor_f32(key))


def test_tokenizer_copy_matches_jax(tmp_path):
    """The production-shape BPE fixture encodes and decodes identically."""
    path = GOLDENS / "fixture_bpe.t"
    text = ("The quick brown fox — Résumé café 🦊 def tokenize(text):\n"
            "    return text.split()\n")
    tok, jtok = Tokenizer.load(path), JaxTokenizer.load(path)
    ids = tok.encode(text)
    assert ids == jtok.encode(text)
    assert tok.decode_all(ids) == jtok.decode_all(ids)
    data = tfile.read_tfile(path)
    tfile.write_tfile(tmp_path / "copy.t", data)
    assert (tmp_path / "copy.t").read_bytes() == path.read_bytes()
