"""The port's serving paths on a tiny Q40 mixture-of-experts file (4
experts, 2 active; vocab 268, seq_len 96), held against the JAX package's
single-sequence engine on the same files: ``python -m dllama_tpu_torch
inference --device cpu`` greedy text, the engine's transcripts and
perplexity, the paged pool (``BatchScheduler`` with ``kv_block_size``) and
the dense slot pool, token for token, greedy and sampled; turbo under the
CLI's ``--quant-mode``. Prompts of 17 tokens or more prefill through the
ragged regime (more than 32 (token, expert) rows), decode steps through the
gather regime."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dllama_tpu.formats import quants, tfile
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.serving import BatchScheduler

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model

REPO = Path(__file__).resolve().parent.parent
PROMPTS = ["hello world", "the quick brown fox jumps over", "abc",
           "hello world how are you today my friend", "xyzzy", "hello hello hello"]
SPECS = [dict(temperature=0.0, seed=1), dict(temperature=0.8, seed=2),
         dict(temperature=0.0, seed=3), dict(temperature=1.2, seed=4),
         dict(temperature=0.0, seed=5), dict(temperature=0.6, seed=6)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_moe_serving")
    m, t = d / "moe.m", d / "t.t"
    write_tiny_model(m, tiny_header_params(vocab_size=268, seq_len=96, n_experts=4,
                                           n_active_experts=2, weight_type=quants.Q40),
                     np.random.default_rng(43))
    tfile.write_tfile(t, byte_vocab_tokenizer())
    return str(m), str(t)


@pytest.fixture(scope="module")
def solo(files):
    """The oracle: one JAX single-sequence engine (tp=1), reset and
    re-seeded per transcript."""
    eng = JaxEngine(*files, tp=1)

    def run(prompt_ids, n, temperature=0.0, seed=7):
        eng.reset()
        eng.sampler.set_temp(temperature)
        eng.sampler.set_seed(seed)
        return eng.generate(prompt_ids, n, stop_on_eos=False).tokens

    yield run
    eng.close()


def _enc(engine, text):
    return engine.tokenizer.encode(text, is_start=True)


def _cli(*argv):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "dllama_tpu_torch", *argv], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)


def test_cli_inference_matches_jax_greedy_text(files):
    m, t = files
    prompt, steps = "the quick brown fox jumps over the lazy", 40
    r = _cli("inference", "--model", m, "--tokenizer", t, "--prompt", prompt, "--steps",
             str(steps), "--temperature", "0", "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert "Quant: auto(exact)" in r.stdout
    eng = JaxEngine(m, t, tp=1, sync_type=quants.Q80, temperature=0.0, seed=1)
    try:
        ids = eng.tokenizer.encode(prompt)
        assert len(ids) * 2 > 32  # the prompt prefills through the ragged regime
        want = eng.generate(ids, steps - len(ids), stop_on_eos=False).text
    finally:
        eng.close()
    streamed = r.stdout.split(prompt + "\n", 1)[1].split("\n\nEvaluation", 1)[0]
    assert want and streamed.rstrip("\n") == want


def test_cli_quant_mode_turbo_banner(files):
    m, t = files
    r = _cli("inference", "--model", m, "--tokenizer", t, "--prompt", "hello", "--steps",
             "12", "--temperature", "0", "--device", "cpu", "--quant-mode", "turbo16")
    assert r.returncode == 0, r.stderr
    assert "Quant: turbo16" in r.stdout and "Prediction" in r.stdout


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_engine_transcripts_and_perplexity_match_jax(files, compute):
    m, t = files
    eng = InferenceEngine(m, t, device="cpu", compute_dtype=compute, temperature=0.0)
    jeng = JaxEngine(m, t, tp=1, compute_dtype=compute, temperature=0.0)
    try:
        for text in PROMPTS[1::2]:
            ids = _enc(eng, text)
            for e in (eng, jeng):
                e.reset()
            got = eng.generate(ids, 16, stop_on_eos=False).tokens
            want = jeng.generate(ids, 16, stop_on_eos=False).tokens
            assert got == want, (compute, text)
        ids = _enc(eng, " ".join(PROMPTS))
        for e in (eng, jeng):
            e.reset()
        # f32: the same logits up to f32 sums; bf16: rounding at other places
        tol = 1e-4 if compute == "float32" else 2e-2
        assert eng.perplexity(ids) == pytest.approx(jeng.perplexity(ids), rel=tol)
    finally:
        eng.close()
        jeng.close()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense_pool"])
def test_batched_serving_token_exact_against_jax_solo(files, solo, paged):
    """6 mixed greedy/sampled requests through 2 slots of the paged pool
    (block 16) or the dense slot pool: every transcript equals the JAX solo
    engine's."""
    m, t = files
    eng = InferenceEngine(m, t, device="cpu", kv_block_size=16 if paged else 0)
    sched = BatchScheduler(eng, n_slots=2)
    try:
        want = [solo(_enc(eng, p), 10, **s) for p, s in zip(PROMPTS, SPECS)]
        reqs = [sched.submit(_enc(eng, p), 10, stop_on_eos=False,
                             temperature=s["temperature"], seed=s["seed"])
                for p, s in zip(PROMPTS, SPECS)]
        for r in reqs:
            assert r.done.wait(timeout=300)
            assert r.error is None, r.error
        for r, w, p in zip(reqs, want, PROMPTS):
            assert r.tokens == w, p
    finally:
        sched.close()
        eng.close()


def test_dense_weight_mode_moe_matches_quantized_planes(files):
    """``--weight-mode f32`` loads the expert stacks dense (f32 ``code *
    scale``): the same greedy transcript as the quantized planes in exact
    mode."""
    m, t = files
    ids = None
    out = []
    for mode in ("auto", "f32"):
        eng = InferenceEngine(m, t, device="cpu", weight_mode=mode, temperature=0.0)
        try:
            ids = ids or _enc(eng, PROMPTS[3])
            out.append(eng.generate(ids, 12, stop_on_eos=False).tokens)
        finally:
            eng.close()
    assert out[0] == out[1]
