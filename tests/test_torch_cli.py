"""``python -m dllama_tpu_torch inference|perplexity`` end to end on the
CPU (``--device cpu``), in a subprocess as a user runs it: exit 0, the JAX
engine's greedy text at temperature 0 and its perplexity. Without
``--device cpu`` a machine with no GPU gets a clear error and no fallback;
modes, flags and flag values that are not ported fail loudly."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

from dllama_tpu.formats.quants import Q80
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine

import golden_assets

REPO = Path(__file__).resolve().parent.parent
PROMPT = golden_assets.PROMPT
STEPS = 24


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli")
    m, t, _, _ = golden_assets.build_assets("llama_q40", out)
    return str(m), str(t)


def _run(*argv: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no GPU, whatever the host has
    return subprocess.run([sys.executable, "-m", "dllama_tpu_torch", *argv],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def _jax_engine(m, t) -> JaxEngine:
    return JaxEngine(m, t, sync_type=Q80, compute_dtype="float32",
                     temperature=0.0, seed=1)


def test_inference_cpu_matches_jax_greedy_text(assets):
    m, t = assets
    r = _run("inference", "--model", m, "--tokenizer", t, "--prompt", PROMPT,
             "--steps", str(STEPS), "--temperature", "0", "--device", "cpu")
    assert r.returncode == 0, r.stderr
    eng = _jax_engine(m, t)
    try:
        ids = eng.tokenizer.encode(PROMPT)
        want = eng.generate(ids, STEPS - len(ids), stop_on_eos=False).text
    finally:
        eng.close()
    assert want
    # the CLI echoes the prompt on its own line, then streams the pieces
    streamed = r.stdout.split(PROMPT + "\n", 1)[1].split("\n\nEvaluation", 1)[0]
    assert streamed.rstrip("\n") == want
    assert "Prediction" in r.stdout and "tokens/s" in r.stdout
    assert "Device: cpu" in r.stdout


def test_perplexity_cpu_matches_jax(assets, tmp_path):
    m, t = assets
    text = tmp_path / "ppl.txt"
    text.write_text("w010 w011 w012 w013 w014 w015 w016 w017 w018 w019 ")
    r = _run("perplexity", "--model", m, "--tokenizer", t, "--file", str(text),
             "--device", "cpu")
    assert r.returncode == 0, r.stderr
    got = float(next(ln for ln in r.stdout.splitlines()
                     if "Perplexity" in ln).split()[-1])
    eng = _jax_engine(m, t)
    try:
        want = eng.perplexity(eng.tokenizer.encode(text.read_text()))
    finally:
        eng.close()
    # the CLI prints 4 decimals; both sides compute the same f32 logits
    assert got == pytest.approx(want, abs=1e-4, rel=1e-5)


def test_cuda_default_without_gpu_fails_clearly(assets):
    m, t = assets
    r = _run("inference", "--model", m, "--tokenizer", t, "--prompt", PROMPT,
             "--steps", "12", "--temperature", "0")
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    assert "--device cpu" in r.stderr
    assert "Traceback" not in r.stderr and "Prediction" not in r.stdout


@pytest.mark.parametrize("argv,msg", [
    (["worker"], "not ported"),
    (["inference", "--tp", "2", "--dp", "2"], "not-yet-ported flag"),
    (["inference", "--weight-mode", "offload"], "offload"),
    (["inference", "--kv-dtype", "int8"], "invalid choice"),
])
def test_unported_modes_and_flags_fail_loudly(assets, argv, msg):
    m, t = assets
    r = _run(*argv, "--model", m, "--tokenizer", t, "--device", "cpu")
    assert r.returncode != 0 and msg in r.stderr
