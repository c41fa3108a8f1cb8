"""The port's sequence-parallel model path against the JAX package's, on the
CPU: ``forward`` with a mesh plan of ``sp`` shards over ``[cpu] * sp``, the
``InferenceEngine(sp=2)`` and the CLI's ``--sp``.

- A two-layer ``forward`` (a 66-token chunk, a 6-token chunk, three decode
  steps; the 128-row cache splits into 64 or 32 rows per shard, so the
  chunks cross shard boundaries and sp = 4 takes the merge at T > 1) with
  sp in {2, 4} against the port's sp = 1 and against JAX ``forward`` under
  ``use_plan(make_mesh({"sp": 2}))``. The Q80 sync casts are off there: a
  cast turns a last-ulp difference of summation order into a whole int8
  step. Tolerance 1e-4 absolute on O(1) logits (f32 sums in another order).
- ``InferenceEngine(sp=2, device="cpu")``: greedy generation token-exact
  against the JAX ``InferenceEngine(tp=1, sp=2)`` over a prompt that
  crosses the 128-row shard boundary, perplexity within 1e-5 relative;
  ``test_ring_attention.py::test_engine_sp_with_non_divisible_seq_len``'s
  seq_len 100 case.
- The CLI: ``--sp 2 --device cpu`` prints the JAX engine's greedy text and
  perplexity; ``--sp 2 --kv-block-size 16`` gets the JAX refusal; ``--sp 2``
  with ``--tp 2``, ``--dp 2`` and ``--pp 2`` fail as not ported; ``--sp 2``
  on ``cuda`` without two cards exits non-zero with the device-count
  message."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats import mfile as jax_mfile
from dllama_tpu.formats import tfile
from dllama_tpu.models import llama as jax_llama
from dllama_tpu.models.config import ModelConfig as JaxConfig
from dllama_tpu.parallel import use_plan
from dllama_tpu.parallel.api import make_mesh as jax_make_mesh
from dllama_tpu.parallel.sharding import kv_cache_sharding, shard_params
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu.runtime.kvcache import KVCache as JaxKVCache
from dllama_tpu_torch.formats import mfile
from dllama_tpu_torch.models import llama
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.parallel.api import make_mesh
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.kvcache import KVCache, ShardedKVCache
from dllama_tpu_torch.serve import cli

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-4
CHUNKS = [(0, 66), (66, 72), (72, 73), (73, 74), (74, 75)]


def _configs(attn_impl="auto"):
    base = dict(arch=mfile.ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2, n_heads=8,
                n_kv_heads=2, head_dim=16, vocab_size=96, seq_len=100, norm_epsilon=1e-5,
                rope_theta=10000.0, rope_type=mfile.RopeType.LLAMA, compute_dtype="float32")
    jkw = dict(base, arch=jax_mfile.ArchType.LLAMA, rope_type=jax_mfile.RopeType.LLAMA)
    return ModelConfig(**base, attn_impl=attn_impl), JaxConfig(**jkw)


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = _configs()
    jparams = jax_llama.init_random_params(jcfg, seed=31, quantized=True)
    params = llama.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, CHUNKS[-1][1]))
    return cfg, jcfg, jparams, params, tokens


def _port_logits(cfg, params, tokens, sp):
    plan = make_mesh({"sp": sp}, ["cpu"] * sp) if sp > 1 else None
    kv = ShardedKVCache.create(cfg, plan.devices) if plan else KVCache.create(cfg)
    out = []
    for a, b in CHUNKS:
        logits, kv = llama.forward(params, cfg, torch.from_numpy(tokens[:, a:b]), a, kv, plan)
        out.append(logits.numpy())
    return out, kv


def _jax_logits(jcfg, jparams, tokens, sp):
    plan = jax_make_mesh({"sp": sp})
    kv0 = JaxKVCache.create(jcfg)
    kv = jax.device_put(kv0, kv_cache_sharding(plan, kv0))
    fwd = jax.jit(jax_llama.forward, static_argnums=1)
    out = []
    with use_plan(plan):
        sharded = shard_params(plan, jparams)
        for a, b in CHUNKS:
            logits, kv = fwd(sharded, jcfg, jnp.asarray(tokens[:, a:b], jnp.int32),
                             jnp.int32(a), kv)
            out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("sp", [2, 4])
def test_forward_sp_matches_sp1_and_jax(model, sp):
    cfg, jcfg, jparams, params, tokens = model
    got, kv = _port_logits(cfg, params, tokens, sp)
    solo, solo_kv = _port_logits(cfg, params, tokens, 1)
    want = _jax_logits(jcfg, jparams, tokens, 2)
    for g, s, w in zip(got, solo, want):
        assert np.isfinite(g).all() and g.shape == w.shape
        np.testing.assert_allclose(g, s, rtol=0, atol=ATOL)
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    # the shards hold the dense cache cut along S
    np.testing.assert_allclose(torch.cat(kv.k, dim=3).numpy(), solo_kv.k.numpy(),
                               rtol=0, atol=ATOL)
    assert kv.seq_len == solo_kv.seq_len == 128 and kv.batch_size == 1


def test_forward_sp_kernel_wrapper_matches_plain(model):
    """``attn_impl="flash"`` sends every block through the K3s wrapper (its
    plain version on the CPU, in the kernel's folded layout)."""
    cfg, _, _, params, tokens = model
    flash_cfg, _ = _configs("flash")
    got, _ = _port_logits(flash_cfg, params, tokens, 2)
    want, _ = _port_logits(cfg, params, tokens, 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the engine and the CLI
# ---------------------------------------------------------------------------

PROMPT = ("a long prompt for the sequence-parallel engine, long enough that its "
          "prefill crosses the boundary of the first shard of the cache at row 128. Then "
          "it decodes.")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    out = tmp_path_factory.mktemp("sp")
    m, t = out / "m.m", out / "t.t"
    write_tiny_model(m, tiny_header_params(vocab_size=268, seq_len=200, n_heads=8,
                                           n_kv_heads=2), np.random.default_rng(17))
    tfile.write_tfile(t, byte_vocab_tokenizer())
    return str(m), str(t)


def test_engine_sp2_matches_jax_engine(files):
    m, t = files
    jeng = JaxEngine(m, t, tp=1, sp=2, temperature=0.0)
    eng = InferenceEngine(m, t, device="cpu", sp=2, temperature=0.0)
    try:
        assert eng.sp == 2 and isinstance(eng.kv, ShardedKVCache)
        assert [k.shape[3] for k in eng.kv.k] == [128, 128]
        ids = jeng.tokenizer.encode(PROMPT)
        assert len(ids) > 140
        want = jeng.generate(ids, 12, stop_on_eos=False).tokens
        got = eng.generate(ids, 12, stop_on_eos=False).tokens
        assert got == want
        assert eng.perplexity(ids) == pytest.approx(jeng.perplexity(ids), rel=1e-5)
        # reset zeroes every shard
        eng.reset()
        assert eng.pos == 0 and all(not k.any() for k in eng.kv.k)
    finally:
        eng.close()
        jeng.close()


def test_engine_sp_with_non_divisible_seq_len(tmp_path):
    """seq_len 100 under sp = 2: the padded 128-row cache divides the sp
    axis, and generation matches the unsharded port and the JAX engine."""
    m, t = tmp_path / "m.m", tmp_path / "t.t"
    write_tiny_model(m, tiny_header_params(vocab_size=268, seq_len=100),
                     np.random.default_rng(51))
    tfile.write_tfile(t, byte_vocab_tokenizer())
    runs = {}
    for name, make in (("solo", lambda: InferenceEngine(str(m), str(t), device="cpu",
                                                        temperature=0.0)),
                       ("sp2", lambda: InferenceEngine(str(m), str(t), device="cpu", sp=2,
                                                       temperature=0.0)),
                       ("jax", lambda: JaxEngine(str(m), str(t), tp=1, temperature=0.0))):
        eng = make()
        try:
            runs[name] = eng.generate("hello world", 6, stop_on_eos=False).tokens
        finally:
            eng.close()
    assert runs["sp2"] == runs["solo"] == runs["jax"]


def test_engine_refusals(files):
    m, t = files
    with pytest.raises(ValueError, match=r"does not support --sp > 1"):
        InferenceEngine(m, t, device="cpu", sp=2, kv_block_size=16)
    with pytest.raises(ValueError, match="not divisible by sp=3"):
        InferenceEngine(m, t, device="cpu", sp=3)
    with pytest.raises(ValueError, match="sp must be >= 1"):
        InferenceEngine(m, t, device="cpu", sp=0)
    with pytest.raises(ValueError, match="needs 2 cpu devices"):
        InferenceEngine(m, t, device="cpu", sp=2, sp_devices=["cpu"])


def _run(*argv: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no GPU, whatever the host has
    return subprocess.run([sys.executable, "-m", "dllama_tpu_torch", *argv], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)


def test_cli_inference_and_perplexity_sp2_match_jax(files, tmp_path):
    m, t = files
    steps = 170
    r = _run("inference", "--model", m, "--tokenizer", t, "--prompt", PROMPT, "--steps",
             str(steps), "--temperature", "0", "--buffer-float-type", "f32", "--sp", "2",
             "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert "TP devices: 1  SP devices: 2" in r.stdout
    text = tmp_path / "ppl.txt"
    text.write_text(PROMPT)
    p = _run("perplexity", "--model", m, "--tokenizer", t, "--file", str(text),
             "--buffer-float-type", "f32", "--sp", "2", "--device", "cpu")
    assert p.returncode == 0, p.stderr
    jeng = JaxEngine(m, t, tp=1, sp=2, temperature=0.0)
    try:
        ids = jeng.tokenizer.encode(PROMPT)
        want = jeng.generate(ids, steps - len(ids), stop_on_eos=False).text
        want_ppl = jeng.perplexity(jeng.tokenizer.encode(PROMPT))
    finally:
        jeng.close()
    streamed = r.stdout.split(PROMPT + "\n", 1)[1].split("\n\nEvaluation", 1)[0]
    assert want and streamed.rstrip("\n") == want
    got_ppl = float(next(ln for ln in p.stdout.splitlines() if "Perplexity" in ln).split()[-1])
    assert got_ppl == pytest.approx(want_ppl, abs=1e-4, rel=1e-5)


def test_cli_refusals(files):
    m, t = files
    base = ["--model", m, "--tokenizer", t, "--prompt", "hi", "--steps", "4"]
    with pytest.raises(ValueError, match=r"--kv-block-size \(paged KV serving\) does not "
                                         r"support --sp > 1"):
        cli.main(["inference", *base, "--device", "cpu", "--sp", "2", "--kv-block-size", "16"])
    with pytest.raises(ValueError, match="does not support --sp > 1"):
        cli.main(["api", *base, "--device", "cpu", "--sp", "2", "--batch-slots", "2",
                  "--kv-block-size", "16"])
    with pytest.raises(SystemExit, match="--sp 2 together with --tp 2 is not ported"):
        cli.main(["inference", *base, "--device", "cpu", "--tp", "2", "--sp", "2"])
    for axis in ("--dp", "--pp"):
        with pytest.raises(SystemExit, match=f"not-yet-ported flag.*{axis}"):
            cli.main(["inference", *base, "--device", "cpu", axis, "2"])


def test_cli_sp2_on_cuda_without_two_cards_fails(files):
    m, t = files
    r = _run("inference", "--model", m, "--tokenizer", t, "--prompt", "hi", "--steps", "4",
             "--sp", "2")
    assert r.returncode != 0
    assert "mesh dp=1 sp=2 pp=1 tp=1 needs 2 devices, found 0" in r.stderr
    assert "Traceback" not in r.stderr and "Prediction" not in r.stdout
