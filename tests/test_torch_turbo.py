"""The port's turbo quant mode (``ops/turbo.py``) and ``--quant-mode``
against the JAX package's: the per-column int8 derivation bit for bit (the
zero-column guard, stacked expert planes, Q40 and Q80 codes, f32 and bf16
scales), the a8 matmul bit for bit and a16 within 1e-5 relative, the
dispatch in ``linear``, the engine under ``quant_mode="turbo"`` against the
JAX engine under ``DLLAMA_TPU_QUANT_MODE=turbo``, the refusals, and the
exact/fast choice of ``--quant-mode`` against JAX's ``linear`` for each
activation dtype.

The JAX side runs jitted, as its model does: XLA turns the divisions by
the constant 127 into products with the f32 reciprocal, and the port does
the same arithmetic."""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats import quants, tfile
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu_torch.ops import linear as lin
from dllama_tpu_torch.ops import turbo
from dllama_tpu_torch.ops.linear import QuantizedWeight
from dllama_tpu_torch.runtime.engine import InferenceEngine

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model

# the modules (``dllama_tpu.ops`` re-exports a function named ``linear``)
jax_linear = importlib.import_module("dllama_tpu.ops.linear")
jax_turbo = importlib.import_module("dllama_tpu.ops.turbo")


def _planes(rng, lead, K, N, q80=False, zero_col=None):
    lo, hi = (-127, 128) if q80 else (-8, 8)
    codes = rng.integers(lo, hi, (*lead, K, N)).astype(np.int8)
    scales = (rng.random((*lead, K // 32, N)) * 0.01 + 1e-3).astype(np.float32)
    if zero_col is not None:
        codes[..., zero_col] = 0
    return codes, scales


def _both(codes, scales, bf16=False):
    j = jax_linear.QuantizedWeight(
        scales=jnp.asarray(scales, jnp.bfloat16 if bf16 else jnp.float32),
        codes=jnp.asarray(codes))
    t = QuantizedWeight(scales=torch.from_numpy(scales).to(
        torch.bfloat16 if bf16 else torch.float32), codes=torch.from_numpy(codes))
    return j, t


@pytest.mark.parametrize("lead", [(), (3,)], ids=["plane", "stack"])
@pytest.mark.parametrize("q80", [False, True], ids=["q40", "q80"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32scales", "bf16scales"])
def test_derivation_bit_equal_to_jax(lead, q80, bf16):
    rng = np.random.default_rng(1 + 2 * q80 + bf16)
    codes, scales = _planes(rng, lead, 128, 96, q80=q80, zero_col=7)
    jq, tq = _both(codes, scales, bf16)
    jw = jax_turbo.derive_turbo(jq, a8=True)
    tw = turbo.derive_turbo(tq, a8=True)
    assert tw.w8.dtype == torch.int8 and tw.scale.dtype == torch.float32
    assert tw.w8.shape == (*lead, 128, 96) and tw.scale.shape == (*lead, 96)
    np.testing.assert_array_equal(tw.w8.numpy(), np.asarray(jw.w8))
    np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    # the zero column: scale 1, codes 0 (no division by zero)
    assert (tw.scale[..., 7] == 1.0).all() and (tw.w8[..., 7] == 0).all()


def test_activation_quantization_bit_equal_to_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((9, 256)).astype(np.float32)
    x[3] = 0.0  # an all-zero row: sx = 1
    jq, jsx = jax.jit(jax_turbo.quantize_activations_a8)(jnp.asarray(x))
    tq, tsx = turbo.quantize_activations_a8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))


@pytest.mark.parametrize("M", [1, 5, 33])
@pytest.mark.parametrize("a8", [True, False], ids=["a8", "a16"])
def test_turbo_matmul_matches_jax(a8, M):
    rng = np.random.default_rng(10 + M)
    codes, scales = _planes(rng, (), 256, 160)
    jq, tq = _both(codes, scales)
    jw, tw = jax_turbo.derive_turbo(jq, a8=a8), turbo.derive_turbo(tq, a8=a8)
    x = rng.standard_normal((M, 256)).astype(np.float32)
    want = np.asarray(jax.jit(jax_turbo.turbo_matmul)(jnp.asarray(x), jw))
    got = turbo.turbo_matmul(torch.from_numpy(x), tw).numpy()
    if a8:  # integer sums are exact on both sides; the same f32 epilogue
        np.testing.assert_array_equal(got, want)
    else:  # exact products, f32 sums in another order
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("a8", [True, False], ids=["a8", "a16"])
def test_turbo_drift_within_jax_bounds(a8):
    """``tests/test_turbo.py``'s drift bound against the exact f32 matmul:
    8e-2 (a8) / 5e-2 (a16) of the output RMS."""
    rng = np.random.default_rng(11)
    codes, scales = _planes(rng, (), 512, 256)
    _, tq = _both(codes, scales)
    tw = turbo.derive_turbo(tq, a8=a8)
    x = torch.from_numpy(rng.standard_normal((4, 512)).astype(np.float32)).to(torch.bfloat16)
    got = turbo.turbo_matmul(x, tw).float()
    want = x.float() @ lin.dequantize_weight(tq, torch.float32)
    rms = want.pow(2).mean().sqrt()
    assert ((got - want).abs().max() / rms).item() < (8e-2 if a8 else 5e-2)


def test_linear_dispatches_turbo_weight():
    rng = np.random.default_rng(13)
    codes, scales = _planes(rng, (), 256, 128)
    _, tq = _both(codes, scales)
    x = torch.from_numpy(rng.standard_normal((1, 4, 256)).astype(np.float32))
    for a8 in (True, False):
        tw = turbo.derive_turbo(tq, a8=a8)
        y = lin.linear(x.to(torch.bfloat16), tw)
        assert y.dtype == torch.bfloat16 and y.shape == (1, 4, 128)
        assert torch.equal(y, turbo.turbo_matmul(x.to(torch.bfloat16), tw))
        # the mode rides on the weight: the config's quant mode is inert here
        assert torch.equal(lin.linear(x, tw, quant_mode="exact"), turbo.turbo_matmul(x, tw))


def test_turbo_params_converts_every_quantized_leaf():
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.models.config import ModelConfig
    from dllama_tpu_torch.formats.mfile import ArchType, RopeType

    cfg = ModelConfig(arch=ArchType.LLAMA, dim=64, hidden_dim=96, n_layers=2, n_heads=4,
                      n_kv_heads=2, head_dim=16, vocab_size=96, seq_len=64,
                      norm_epsilon=1e-5, rope_theta=1e4, rope_type=RopeType.LLAMA,
                      n_experts=4, n_active_experts=2)
    p = llama.init_random_params(cfg, quantized=True)
    src = p.layers[1].we2
    p = turbo.turbo_params(p, a8=False)
    for lp in p.layers:
        for name in ("wq", "wk", "wv", "wo", "we1", "we2", "we3"):
            w = getattr(lp, name)
            assert isinstance(w, turbo.TurboWeight) and not w.a8, name
    assert isinstance(p.logits, turbo.TurboWeight)  # an exact config keeps a Q40 head
    assert torch.equal(p.layers[1].we2.w8, turbo.derive_turbo(src).w8)


def _tiny(tmp_path, weight_type=quants.Q40):
    m, t = tmp_path / "m.m", tmp_path / "t.t"
    write_tiny_model(m, tiny_header_params(vocab_size=268, seq_len=96,
                                           weight_type=weight_type),
                     np.random.default_rng(7))
    tfile.write_tfile(t, byte_vocab_tokenizer())
    return str(m), str(t)


@pytest.mark.parametrize("mode", ["turbo", "turbo16"])
def test_engine_turbo_matches_jax_engine(tmp_path, monkeypatch, mode):
    """The engine under ``quant_mode`` gives one transcript twice, and the
    JAX engine's under ``DLLAMA_TPU_QUANT_MODE`` (f32 compute: the a8 dots
    are exact on both sides, every other op f32)."""
    m, t = _tiny(tmp_path)
    prompt = [2, 5, 9, 40, 77]
    runs = []
    for _ in range(2):
        eng = InferenceEngine(m, t, device="cpu", temperature=0.0, seed=3, quant_mode=mode)
        try:
            assert isinstance(eng.params.layers[0].wq, turbo.TurboWeight)
            assert eng.params.layers[0].wq.a8 == (mode == "turbo")
            assert isinstance(eng.params.logits, torch.Tensor)  # turbo loads like fast
            runs.append(eng.generate(prompt, 12, stop_on_eos=False).tokens)
        finally:
            eng.close()
    assert runs[0] == runs[1] and len(runs[0]) == 12
    monkeypatch.setenv("DLLAMA_TPU_QUANT_MODE", mode)
    jeng = JaxEngine(m, t, tp=1, temperature=0.0, seed=3)
    try:
        want = jeng.generate(prompt, 12, stop_on_eos=False).tokens
    finally:
        jeng.close()
    assert runs[0] == want


def test_turbo_refusals(tmp_path):
    m, t = _tiny(tmp_path)
    # before the load: a path that does not exist is never opened
    with pytest.raises(ValueError, match="requires --weight-mode auto"):
        InferenceEngine(str(tmp_path / "missing.m"), t, device="cpu", quant_mode="turbo",
                        weight_mode="f32")
    (tmp_path / "dense").mkdir()
    dm, _ = _tiny(tmp_path / "dense", weight_type=quants.F32)
    with pytest.raises(ValueError, match="requires a quantized"):
        InferenceEngine(dm, t, device="cpu", quant_mode="turbo16")
    with pytest.raises(ValueError, match="quant_mode must be one of"):
        InferenceEngine(m, t, device="cpu", quant_mode="int4")


def test_cli_turbo_with_dense_weights_exits_nonzero(tmp_path):
    import subprocess
    import sys
    from pathlib import Path

    m, t = _tiny(tmp_path)
    r = subprocess.run([sys.executable, "-m", "dllama_tpu_torch", "inference", "--model", m,
                        "--tokenizer", t, "--prompt", "hi", "--steps", "4", "--device", "cpu",
                        "--quant-mode", "turbo", "--weight-mode", "f32"],
                       cwd=Path(__file__).resolve().parent.parent, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert "requires --weight-mode auto" in r.stderr
    assert "Arch:" not in r.stdout  # refused before the banner: nothing was loaded


@pytest.mark.parametrize("kernel", ["auto", "pallas"])
def test_exact_mode_under_bf16_activations_matches_jax_linear(monkeypatch, kernel):
    """``--quant-mode exact`` with bf16 activations: the port upcasts them
    to f32 (the JAX tiled kernel's numerics, ``DLLAMA_TPU_QUANT_KERNEL=
    pallas``, held within one bf16 ulp of the output); JAX's XLA fallback
    (``auto`` on the CPU) dequantizes at bf16 instead, within 2e-2."""
    monkeypatch.setenv("DLLAMA_TPU_QUANT_MODE", "exact")
    monkeypatch.setenv("DLLAMA_TPU_QUANT_KERNEL", kernel)
    rng = np.random.default_rng(21)
    codes, scales = _planes(rng, (), 256, 128)
    jq, tq = _both(codes, scales)
    x = rng.standard_normal((1, 3, 256)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jax_linear.linear(jnp.asarray(x, jnp.bfloat16), jq), np.float32)
    got = lin.linear(xb, tq, quant_mode="exact")
    assert got.dtype == torch.bfloat16
    # the f32 result of the upcast product, before its rounding to bf16
    f32 = (xb.float() @ lin.dequantize_weight(tq, torch.float32)).numpy()
    np.testing.assert_allclose(got.float().numpy(), f32, rtol=2 ** -8, atol=1e-6)
    tol = 2 ** -8 if kernel == "pallas" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())
    # auto under bf16 is fast: JAX's XLA path, the same bf16 dequant
    monkeypatch.setenv("DLLAMA_TPU_QUANT_MODE", "auto")
    monkeypatch.setenv("DLLAMA_TPU_QUANT_KERNEL", "auto")
    want_fast = np.asarray(jax_linear.linear(jnp.asarray(x, jnp.bfloat16), jq), np.float32)
    np.testing.assert_allclose(lin.linear(xb, tq).float().numpy(), want_fast, rtol=0,
                               atol=2 ** -8 * np.abs(want_fast).max())


def test_fast_mode_under_f32_activations_matches_jax_linear(monkeypatch):
    """``--quant-mode fast`` with f32 activations: bf16 dequant and bf16
    activations, f32 sums and an f32 result, as JAX's ``linear``."""
    monkeypatch.setenv("DLLAMA_TPU_QUANT_MODE", "fast")
    rng = np.random.default_rng(22)
    codes, scales = _planes(rng, (), 256, 128)
    jq, tq = _both(codes, scales)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32)
    want = np.asarray(jax_linear.linear(jnp.asarray(x), jq))
    got = lin.linear(torch.from_numpy(x), tq, quant_mode="fast")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    exact = lin.linear(torch.from_numpy(x), tq)  # auto under f32: exact
    assert not torch.equal(exact, got)


def test_quant_mode_rules(monkeypatch):
    assert lin.fast_numerics_resolved("float32", "auto") is False
    assert lin.fast_numerics_resolved("bfloat16", "auto") is True
    assert lin.fast_numerics_resolved("bfloat16", "exact") is False
    for m in ("fast", "turbo", "turbo16"):
        assert lin.fast_numerics_resolved("float32", m) is True
    assert [lin.turbo_mode(m) for m in lin.QUANT_MODES] == [None, None, None, "a8", "a16"]
    assert lin.quant_mode_label("auto", True) == "auto(fast)"
    assert lin.quant_mode_label("auto", False) == "auto(exact)"
    assert lin.quant_mode_label("turbo16", False) == "turbo16"
    for m in lin.QUANT_MODES:  # the JAX package's labels under its variable
        monkeypatch.setenv("DLLAMA_TPU_QUANT_MODE", m)
        for bf16 in (False, True):
            assert lin.quant_mode_label(m, bf16) == jax_linear.quant_mode_label(bf16)
            assert (lin.fast_numerics_resolved("bfloat16" if bf16 else "float32", m)
                    == jax_linear.fast_numerics_resolved("bfloat16" if bf16 else "float32"))
