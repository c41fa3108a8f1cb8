"""The port's ``--weight-mode f32|bf16`` (dense dequantized weights,
``runtime/weights.py``) against the JAX package's on the CPU: the loaded
matrices bit for bit (Q40 and Q80 files, both computes, the logits head's
dense-bf16 rule under fast numerics), the forward's logits against JAX's
dense forward (f32 within 1e-5 of max|logit|, bf16 within the fast-mode
bound of ``test_torch_model.py``), greedy generation token-equal to the
JAX engine's ``weight_mode="f32"``, the dense f32 run equal to the
quantized-plane exact run (as ``tests/test_model.py`` holds it in JAX), and
the refusal of ``offload``."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from dllama_tpu.formats import mfile as jax_mfile
from dllama_tpu.formats import quants, tfile
from dllama_tpu.models import llama as jax_llama
from dllama_tpu.models.config import ModelConfig as JaxConfig
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu.runtime.kvcache import KVCache as JaxKVCache
from dllama_tpu_torch.formats import mfile
from dllama_tpu_torch.models import llama
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.ops.linear import QuantizedWeight
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.kvcache import KVCache
from dllama_tpu_torch.runtime.weights import load_params

from test_torch_model import BF16_RTOL

TOKENS = [9, 27, 64, 3, 81, 14, 50]
NAMES = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


@pytest.fixture(scope="module", params=[quants.Q40, quants.Q80], ids=["q40", "q80"])
def model(tmp_path_factory, request):
    d = tmp_path_factory.mktemp("wmode")
    p = d / "m.m"
    helpers.write_tiny_model(p, helpers.tiny_header_params(weight_type=request.param),
                             np.random.default_rng(7))
    return str(p)


def _both(path, mode, compute):
    with jax_mfile.ModelFile.open(path) as jmf:
        jcfg = JaxConfig.from_header(jmf.header, compute_dtype=compute)
        jparams = jax_llama.load_params_from_mfile(jmf, jcfg, weight_mode=mode)
    with mfile.ModelFile.open(path) as mf:
        cfg = ModelConfig.from_header(mf.header, compute_dtype=compute)
        params = load_params(mf, cfg, "cpu", weight_mode=mode)
    return jcfg, jparams, cfg, params


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_dense_weights_bitwise_equal_jax_loader(model, mode, compute):
    _, jparams, _, params = _both(model, mode, compute)
    want_dtype = torch.float32 if mode == "f32" else torch.bfloat16
    for l, lp in enumerate(params.layers):
        for name in NAMES:
            got = getattr(lp, name)
            want = np.asarray(getattr(jparams.layers, name)[l]).astype(np.float32)
            assert not isinstance(got, QuantizedWeight) and got.dtype == want_dtype
            np.testing.assert_array_equal(_np(got), want, err_msg=f"{name}.{l}")
    # the head: dense bf16 under fast numerics, else the mode's dtype
    head_dtype = torch.bfloat16 if compute == "bfloat16" else want_dtype
    assert params.logits.dtype == head_dtype
    np.testing.assert_array_equal(_np(params.logits),
                                  np.asarray(jparams.logits).astype(np.float32))


def _logits(cfg, params, jcfg, jparams):
    dt = getattr(torch, cfg.compute_dtype)
    got, _ = llama.forward(params, cfg, torch.tensor([TOKENS]), 0, KVCache.create(cfg, dtype=dt))
    want, _ = jax.jit(jax_llama.forward, static_argnums=1)(
        jparams, jcfg, jnp.asarray([TOKENS], jnp.int32), jnp.int32(0),
        JaxKVCache.create(jcfg, dtype=jnp.dtype(jcfg.compute_dtype)))
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("mode,compute", [("f32", "float32"), ("bf16", "float32"),
                                          ("f32", "bfloat16"), ("bf16", "bfloat16")])
def test_dense_forward_matches_jax(model, mode, compute):
    jcfg, jparams, cfg, params = _both(model, mode, compute)
    got, want = _logits(cfg, params, jcfg, jparams)
    scale = np.abs(want).max()
    if compute == "float32":
        assert np.abs(got - want).max() <= 1e-5 * scale
    else:
        assert np.abs(got - want).max() <= BF16_RTOL * scale


def test_dense_f32_equals_quantized_plane_exact_run(model):
    """Q40/Q80 planes dequantize to exactly the dense f32 values, so the
    exact (f32) forward agrees to float tolerance."""
    with mfile.ModelFile.open(model) as mf:
        cfg = ModelConfig.from_header(mf.header)
        qparams = load_params(mf, cfg, "cpu")
        fparams = load_params(mf, cfg, "cpu", weight_mode="f32")
    assert isinstance(qparams.layers[0].wq, QuantizedWeight)
    lq, _ = llama.forward(qparams, cfg, torch.tensor([TOKENS[:3]]), 0, KVCache.create(cfg))
    lf, _ = llama.forward(fparams, cfg, torch.tensor([TOKENS[:3]]), 0, KVCache.create(cfg))
    np.testing.assert_allclose(lq.numpy(), lf.numpy(), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("wmode_eng")
    tok = helpers.byte_vocab_tokenizer()
    helpers.write_tiny_model(d / "m.m", helpers.tiny_header_params(
        vocab_size=tok.vocab_size, seq_len=96), np.random.default_rng(21))
    tfile.write_tfile(d / "t.t", tok)
    return str(d / "m.m"), str(d / "t.t")


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_greedy_generate_token_equal_jax_engine(files, mode):
    eng = InferenceEngine(*files, device="cpu", weight_mode=mode, temperature=0.0)
    jeng = JaxEngine(*files, tp=1, weight_mode=mode, temperature=0.0)
    try:
        got = eng.generate("hello world", 20, stop_on_eos=False).tokens
        want = jeng.generate("hello world", 20, stop_on_eos=False).tokens
        assert got == want
        assert all(not isinstance(lp.wq, QuantizedWeight) for lp in eng.params.layers)
    finally:
        eng.close()
        jeng.close()


def test_offload_refused(files):
    with pytest.raises(ValueError, match="offload"):
        InferenceEngine(*files, device="cpu", weight_mode="offload")
    with pytest.raises(ValueError, match="weight_mode"):
        InferenceEngine(*files, device="cpu", weight_mode="f16")
