"""The port's multi-step decode (``--decode-chunk K``) against the JAX
package's on the CPU: K tokens per dispatch, fed back on the device, must
be output-identical to single-step decode and to the JAX engine with the
same K — greedy and sampled, with EOS truncation mid-chunk and the
sampler-RNG rewind that keeps the xorshift stream bit-identical after it
(the port of ``tests/test_decode_chunk.py``), tails that fall back to
single steps, the eager chunk at ``sp = 2``, the CLI's ``--decode-chunk``
and the ``api`` refusal of ``--decode-chunk`` with ``--kv-block-size``.

On the CPU the engine's chunk runs the captured step's body on its static
buffers (``runtime/graphs.py``; on the card it replays the graph), and at
``sp = 2`` the eager ``greedy_steps``/``sampled_steps`` loop. Token ids
compare exactly."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dllama_tpu.formats import tfile
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu_torch.runtime.engine import InferenceEngine

import golden_assets
from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model

REPO = Path(__file__).resolve().parent.parent
PROMPT = "hello world"
STEPS = 20  # with K = 8: two chunks, then four single-step tails


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_chunk")
    mpath, tpath = d / "m.m", d / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=96),
                     np.random.default_rng(13))
    tfile.write_tfile(tpath, byte_vocab_tokenizer())
    return str(mpath), str(tpath)


def _port(files, **kw) -> InferenceEngine:
    return InferenceEngine(*files, device="cpu", **kw)


def _jax(files, **kw) -> JaxEngine:
    return JaxEngine(*files, tp=1, **kw)


def _preds(result) -> list[tuple[int, int]]:
    return [(s.n_tokens, s.width) for s in result.steps if s.kind == "pred"]


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
@pytest.mark.parametrize("chunk", [2, 4, 8])
def test_chunked_matches_single_step_and_jax(model_files, temperature, chunk):
    single = _port(model_files, temperature=temperature, seed=21)
    r1 = single.generate(PROMPT, STEPS, stop_on_eos=False)
    chunked = _port(model_files, temperature=temperature, seed=21, decode_chunk=chunk)
    r2 = chunked.generate(PROMPT, STEPS, stop_on_eos=False)
    jeng = _jax(model_files, temperature=temperature, seed=21, decode_chunk=chunk)
    try:
        rj = jeng.generate(PROMPT, STEPS, stop_on_eos=False)
        assert r2.tokens == r1.tokens == rj.tokens
        assert chunked.pos == single.pos == jeng.pos
        assert chunked.sampler.rng_state == single.sampler.rng_state == jeng.sampler.rng_state
    finally:
        for e in (single, chunked, jeng):
            e.close()
    # full-size chunks, then single-step tails, each dispatch's width
    # recorded; the same dispatches as the JAX engine's
    preds = _preds(r2)
    assert all(w == (chunk if n > 1 else 1) and n in (chunk, 1) for n, w in preds), preds
    assert sum(n for n, _ in preds) == STEPS
    assert len(preds) < len(_preds(r1))
    assert [s.n_tokens for s in rj.steps if s.kind == "pred"] == [n for n, _ in preds]


def _force_eos_on(engine, token_id):
    orig = engine.tokenizer.is_eos
    engine.tokenizer.is_eos = lambda t: t == token_id or orig(t)


@pytest.mark.parametrize("temperature,at", [(0.8, 6), (0.0, 4)], ids=["sampled", "greedy"])
def test_eos_mid_chunk_truncates_and_rewinds_rng(model_files, temperature, at):
    """EOS landing mid-chunk: kept tokens, position and the sampler RNG
    state match the single-step run and the JAX chunked engine — and a
    continued generation after the EOS matches too (the rewind proof, and
    the overshoot rows past the EOS are invisible)."""
    probe = _port(model_files, temperature=temperature, seed=5)
    eos_tok = probe.generate(PROMPT, 12, stop_on_eos=False).tokens[at]
    probe.close()
    engines = [_port(model_files, temperature=temperature, seed=5),
               _port(model_files, temperature=temperature, seed=5, decode_chunk=8),
               _jax(model_files, temperature=temperature, seed=5, decode_chunk=8)]
    try:
        for e in engines:
            _force_eos_on(e, eos_tok)
        runs = [e.generate(PROMPT, 12, stop_on_eos=True) for e in engines]
        assert runs[0].tokens == runs[1].tokens == runs[2].tokens
        assert runs[0].tokens[-1] == eos_tok and len(runs[0].tokens) < 12
        # the chunk that held the EOS ran all 8 steps and kept fewer
        assert any(w == 8 and n < 8 for n, w in _preds(runs[1])), _preds(runs[1])
        assert len({e.pos for e in engines}) == 1
        assert len({e.sampler.rng_state for e in engines}) == 1
        more = [e.generate([r.tokens[-1]], 6, stop_on_eos=False).tokens
                for e, r in zip(engines, runs)]
        assert more[0] == more[1] == more[2]
    finally:
        for e in engines:
            e.close()


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
def test_tail_near_seq_len_falls_to_single_steps(model_files, temperature):
    """Generation up to the context cap: chunks while K positions are left,
    then single steps to the last position; ``decode_chunk_tokens`` itself
    clamps k to the positions left."""
    single = _port(model_files, temperature=temperature, seed=3)
    chunked = _port(model_files, temperature=temperature, seed=3, decode_chunk=8)
    try:
        r1 = single.generate(PROMPT, 500, stop_on_eos=False)
        r2 = chunked.generate(PROMPT, 500, stop_on_eos=False)
        assert r1.tokens == r2.tokens
        assert single.pos == chunked.pos == chunked.cfg.seq_len
        preds = _preds(r2)
        n_prompt = r2.prompt_tokens - 1
        left = chunked.cfg.seq_len - n_prompt
        assert [n for n, _ in preds] == [8] * (left // 8) + [1] * (left % 8)
        chunked.reset()
        chunked.prefill(chunked.tokenizer.encode(PROMPT)[:-1])
        chunked.pos = chunked.cfg.seq_len - 3
        assert len(chunked.decode_chunk_tokens(5, 8)) == 3
        assert chunked.pos == chunked.cfg.seq_len - 3  # not committed
    finally:
        single.close()
        chunked.close()


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
def test_sp2_chunk_matches_sp1(model_files, temperature):
    """At sp = 2 (shards ``[cpu] * 2``) the chunk is the eager
    ``greedy_steps``/``sampled_steps`` loop; its tokens equal sp = 1's."""
    one = _port(model_files, temperature=temperature, seed=9)
    two = _port(model_files, temperature=temperature, seed=9, sp=2,
                sp_devices=["cpu", "cpu"], decode_chunk=4)
    try:
        r1 = one.generate(PROMPT, 18, stop_on_eos=False)
        r2 = two.generate(PROMPT, 18, stop_on_eos=False)
        assert r1.tokens == r2.tokens
        assert one.sampler.rng_state == two.sampler.rng_state
        assert [n for n, _ in _preds(r2)] == [4] * 4 + [1, 1]
        assert not two._graphs  # sp > 1 captures nothing
    finally:
        one.close()
        two.close()


def _cli(module: str, *argv: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env.update(CUDA_VISIBLE_DEVICES="", JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def _section(out: str, prompt: str) -> tuple[str, list[str]]:
    """The streamed text after the echoed prompt, and the nTokens lines."""
    streamed = out.split(prompt + "\n", 1)[1].split("\n\nEvaluation", 1)[0]
    return streamed, [ln.strip() for ln in out.splitlines() if "nTokens:" in ln]


def test_cli_decode_chunk_prints_the_jax_cli_text(tmp_path):
    m, t, _, _ = golden_assets.build_assets("llama_q40", tmp_path)
    prompt = golden_assets.PROMPT
    argv = ["inference", "--model", str(m), "--tokenizer", str(t), "--prompt", prompt,
            "--steps", "24", "--temperature", "0", "--seed", "1", "--decode-chunk", "4"]
    port = _cli("dllama_tpu_torch", *argv, "--device", "cpu")
    ref = _cli("dllama_tpu", *argv)
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    got, want = _section(port.stdout, prompt), _section(ref.stdout, prompt)
    assert got[0].strip() and got == want
    assert "Prediction" in port.stdout and "tokens/s" in port.stdout


def test_api_refuses_decode_chunk_with_paged_kv(model_files):
    """``api --kv-block-size 16 --batch-slots 2 --decode-chunk 2`` exits
    non-zero with the JAX engine's refusal (the JAX package serves no
    chunked paged step either)."""
    m, t = model_files
    with pytest.raises(ValueError) as e:
        JaxEngine(m, t, tp=1, kv_block_size=16, decode_chunk=2)
    assert "--decode-chunk > 1" in str(e.value)
    r = _cli("dllama_tpu_torch", "api", "--model", m, "--tokenizer", t, "--device", "cpu",
             "--kv-block-size", "16", "--batch-slots", "2", "--decode-chunk", "2",
             "--port", "0")
    assert r.returncode != 0
    assert str(e.value) in r.stderr
    assert "listening" not in r.stdout
