"""The port's engine options ``host_sampling`` (``--host-sampling``) and
``n_batches`` (``--nbatches``) against the JAX engine's on the CPU, and the
CLI's five new flags and its ``verify`` mode.

``host_sampling`` is the parity oracle of sampled decode: one eager forward
a token, the logits on the host, :class:`Sampler.sample` — the JAX engine's
``host_sampling=True`` path; the sampled tokens are JAX's, a departure
allowed only at a top-p boundary (C6's signature, as
``test_torch_spec_serving.py`` checks it). ``n_batches=32`` pins the
reference's prefill chunk: the prefill logits and the perplexity are the
JAX engine's at ``n_batches=32``."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dllama_tpu.formats import tfile
from dllama_tpu.formats.quants import Q80
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu_torch.formats import mfile
from dllama_tpu_torch.runtime.engine import InferenceEngine

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model
from test_torch_spec_serving import _assert_topp_boundary_departure

REPO = Path(__file__).resolve().parent.parent
LONG = "the quick brown fox jumps over the lazy dog, and then it runs far away!"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_flags")
    write_tiny_model(d / "m.m", tiny_header_params(vocab_size=268, seq_len=96),
                     np.random.default_rng(13))
    tfile.write_tfile(d / "t.t", byte_vocab_tokenizer())
    mfile.write_manifest(d / "m.m")
    return str(d / "m.m"), str(d / "t.t")


@pytest.mark.parametrize("temperature,topp,seed", [(0.8, 0.9, 21), (1.2, 0.0, 5)],
                         ids=["topp", "multinomial"])
def test_host_sampling_tokens_equal_jax(files, temperature, topp, seed):
    eng = InferenceEngine(*files, device="cpu", host_sampling=True, temperature=temperature,
                          topp=topp, seed=seed)
    jeng = JaxEngine(*files, tp=1, host_sampling=True, temperature=temperature, topp=topp,
                     seed=seed)
    try:
        prompt = eng.tokenizer.encode("hello world")
        got = eng.generate(prompt, 24, stop_on_eos=False).tokens
        want = jeng.generate(prompt, 24, stop_on_eos=False).tokens
        assert eng.decode_chunk == 1 and not eng._graphs  # eager, never captured
        if got != want:
            _assert_topp_boundary_departure(jeng, prompt, got, want,
                                            temperature, topp, seed)
        else:
            assert eng.sampler.rng_state == jeng.sampler.rng_state
    finally:
        eng.close()
        jeng.close()


def test_host_sampling_refuses_spec_and_forces_single_steps(files):
    with pytest.raises(ValueError, match="host-sampling"):
        InferenceEngine(*files, device="cpu", host_sampling=True, spec_lookup=3)
    eng = InferenceEngine(*files, device="cpu", host_sampling=True, decode_chunk=4,
                          temperature=0.8, seed=3)
    try:
        res = eng.generate("abc", 8, stop_on_eos=False)
        assert eng.decode_chunk == 1
        assert all(s.width == 1 for s in res.steps if s.kind == "pred")
    finally:
        eng.close()


def test_nbatches_32_prefill_and_perplexity_equal_jax(files):
    eng = InferenceEngine(*files, device="cpu", n_batches=32)
    jeng = JaxEngine(*files, tp=1, n_batches=32)
    try:
        assert eng.prefill_buckets == jeng.prefill_buckets == (32,)
        ids = eng.tokenizer.encode(LONG)
        assert len(ids) > 64  # three chunks, the last one padded
        got, metrics = eng.prefill(ids)
        want, jmetrics = jeng.prefill(ids)
        assert [m.n_tokens for m in metrics] == [m.n_tokens for m in jmetrics]
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
        assert eng.perplexity(ids) == pytest.approx(jeng.perplexity(ids), rel=1e-5)
    finally:
        eng.close()
        jeng.close()


def _run(*argv: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "-m", "dllama_tpu_torch", *argv], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)


def test_cli_takes_the_five_flags(files):
    """``inference`` with all five flags prints the text the engine built
    from the same options prints."""
    m, t = files
    r = _run("inference", "--model", m, "--tokenizer", t, "--prompt", "hello", "--steps", "20",
             "--temperature", "0.8", "--seed", "9", "--kv-dtype", "f8", "--weight-mode", "f32",
             "--nbatches", "32", "--host-sampling", "--verify-weights", "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert "KV: float8_e4m3fn  Weights: f32" in r.stdout
    assert "nBatches: 32" in r.stdout
    eng = InferenceEngine(m, t, device="cpu", temperature=0.8, seed=9, kv_dtype="f8",
                          weight_mode="f32", n_batches=32, host_sampling=True,
                          sync_type=Q80)  # the CLI's --buffer-float-type default
    try:
        ids = eng.tokenizer.encode("hello")
        want = eng.generate(ids, 20 - len(ids), stop_on_eos=False).text
    finally:
        eng.close()
    assert r.stdout.split("hello\n", 1)[1].split("\n\nEvaluation", 1)[0].rstrip("\n") == want


def test_cli_verify_needs_no_tokenizer(files, tmp_path):
    m, _ = files
    r = _run("verify", "--model", m)
    assert r.returncode == 0, r.stderr
    assert "tensors verified" in r.stdout
    bare = tmp_path / "bare.m"
    bare.write_bytes(Path(m).read_bytes())
    assert _run("verify", "--model", str(bare)).returncode == 2
    assert _run("verify", "--model", str(bare), "--write").returncode == 0
    assert _run("verify", "--model", str(bare)).returncode == 0
