"""The port's prompt-lookup speculative decoding against the JAX package's
on the CPU (the port of ``tests/test_speculative.py``): the n-gram
proposer, ``spec_decide`` (the verify epilogue: greedy prefix rule,
sampled exact-match rule, a zero-length draft equal to the plain sampled
step) and the coin commit rule; ``verify_step`` and ``paged_verify_step``
against the JAX functions on the same weights (``from_jax_params``) and
pool contents, the paged one with the lanes past each row's draft length
written to the null block only; the engine's ``--spec-lookup`` against the
JAX engine's and against plain greedy at sp 1 and 2; its refusals; and the
CLI's ``spec rate`` line against the JAX CLI's text.

Token ids and accepted counts compare exactly. Pools and logits keep the
bounds of ``tests/test_torch_model.py``: 1e-4 absolute in f32 (f32 sums
taken in another order by the two frameworks, values of magnitude ~1)."""

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

from dllama_tpu.formats import tfile
from dllama_tpu.models import llama as jax_llama
from dllama_tpu.ops import sampling as jax_sampling
from dllama_tpu.runtime import speculative as jax_spec
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu.runtime.kvcache import KVCache as JaxKVCache
from dllama_tpu_torch.models import llama
from dllama_tpu_torch.ops.sampling import sampled_token
from dllama_tpu_torch.runtime import speculative as spec
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.kvblocks import PagedKVCache, blocks_per_seq
from dllama_tpu_torch.runtime.kvcache import KVCache

import golden_assets
from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model
from test_torch_model import F32_ATOL, _configs, _pair
from test_torch_paged_model import BS, _pools, _tables

REPO = Path(__file__).resolve().parent.parent


# -- proposer ----------------------------------------------------------------

# (K, history, draft): the cases of tests/test_speculative.py
PROPOSER_CASES = [
    (3, [1, 2, 3, 4, 9, 1, 2], [3, 4, 9]),          # previous continuation
    (4, [1, 2, 3, 1, 2], [3, 1, 2, 2]),             # short continuation padded
    (2, [5, 6, 7], [7, 7]),                         # no signal: last token
    (2, [], [0, 0]),                                # no history
    (3, [8, 8, 8, 8], [8, 8, 8]),                   # self-overlap
    (2, [0, 1, 2, 7, 7, 9, 1, 2, 5, 5, 9, 1, 2], [5, 5]),  # trigram beats bigram
    (2, [4, 1, 2, 7, 7, 3, 1, 2], [7, 7]),          # bigram fallback
]


@pytest.mark.parametrize("k,history,want", PROPOSER_CASES)
def test_proposer_matches_jax(k, history, want):
    mine, ref = spec.NgramProposer(k), jax_spec.NgramProposer(k)
    # extended in two pieces: the table carries across calls
    for part in (history[:len(history) // 2], history[len(history) // 2:]):
        mine.extend(part)
        ref.extend(part)
    assert mine.draft() == ref.draft() == want


# -- spec_decide -------------------------------------------------------------


def _jax_decide(logits, tokens, lens, temps, topps, acoins, fcoins):
    n_acc, out = jax.jit(jax_spec.spec_decide)(
        jnp.asarray(logits), jnp.asarray(tokens, jnp.int32), jnp.asarray(lens, jnp.int32),
        jnp.asarray(temps), jnp.asarray(topps), jnp.asarray(acoins), jnp.asarray(fcoins))
    return np.asarray(n_acc).tolist(), np.asarray(out).tolist()


def _decide(logits, tokens, lens, temps, topps, acoins, fcoins):
    n_acc, out = spec.spec_decide(*(torch.from_numpy(np.asarray(a)) for a in (
        logits, tokens, lens, temps, topps, acoins, fcoins)))
    return n_acc.tolist(), out.tolist()


def test_spec_decide_zero_draft_is_plain_sampled_step():
    """``lens == 0``: no draft is accepted and position 0 is the plain
    sampled step with position 0's coin (``acoins[:, 0]``), as JAX's."""
    rng = np.random.default_rng(3)
    B, K, V = 4, 3, 64
    logits = rng.standard_normal((B, K + 1, V)).astype(np.float32)
    tokens = rng.integers(0, V, (B, K + 1))
    temps = np.array([0.6, 0.9, 1.3, 0.8], np.float32)
    topps = np.array([0.9, 0.5, 1.0, 0.95], np.float32)
    acoins = rng.random((B, K)).astype(np.float32)
    fcoins = rng.random(B).astype(np.float32)
    args = (logits, tokens, np.zeros(B, np.int64), temps, topps, acoins, fcoins)
    got = _decide(*args)
    assert got == _jax_decide(*args)
    assert got[0] == [0] * B
    want = sampled_token(torch.from_numpy(logits[:, 0]), torch.from_numpy(temps),
                         torch.from_numpy(topps), torch.from_numpy(acoins[:, 0]))
    assert [row[0] for row in got[1]] == want.tolist()


def test_spec_decide_greedy_rows_match_exact_prefix_rule():
    rng = np.random.default_rng(7)
    B, K, V = 3, 4, 32
    logits = rng.standard_normal((B, K + 1, V)).astype(np.float32)
    preds = np.argmax(logits, -1)
    # row 0: drafts equal the model's own predictions; row 1: first draft
    # wrong; row 2: lens caps acceptance
    tokens = np.zeros((B, K + 1), np.int64)
    tokens[:, 1:] = preds[:, :-1]
    tokens[1, 1] = (preds[1, 0] + 1) % V
    args = (logits, tokens, np.array([K, K, 2]), np.zeros(B, np.float32),
            np.full(B, 0.9, np.float32), np.zeros((B, K), np.float32),
            np.zeros(B, np.float32))
    got = _decide(*args)
    assert got == _jax_decide(*args)
    assert got == ([K, 0, 2], preds.tolist())


@pytest.mark.parametrize("V", [64, 300], ids=["V64", "V300-past-topk-window"])
def test_spec_decide_sampled_rows_exact_match_rule(V):
    """Sampled rows: ``out`` is the plain sampled step at every position
    with that position's coin, and drafts are accepted while they equal
    those samples (capped at ``lens``); mixed with a greedy row."""
    rng = np.random.default_rng(11)
    B, K = 4, 3
    logits = (rng.standard_normal((B, K + 1, V)) * 3).astype(np.float32)
    temps = np.array([0.7, 1.1, 0.0, 0.9], np.float32)
    topps = np.array([0.9, 1.0, 0.9, 0.6], np.float32)
    acoins = rng.random((B, K)).astype(np.float32)
    fcoins = rng.random(B).astype(np.float32)
    coins = np.concatenate([acoins, fcoins[:, None]], 1)
    samples = sampled_token(torch.from_numpy(logits.reshape(-1, V)),
                            torch.from_numpy(np.repeat(temps, K + 1)),
                            torch.from_numpy(np.repeat(topps, K + 1)),
                            torch.from_numpy(coins.reshape(-1))).reshape(B, K + 1).numpy()
    tokens = rng.integers(0, V, (B, K + 1))
    tokens[0, 1:] = samples[0, :-1]                  # all drafts match
    tokens[1, 1:3] = samples[1, :2]                  # two match, then not
    tokens[1, 3] = (samples[1, 2] + 1) % V
    tokens[3, 1:] = samples[3, :-1]                  # match, capped by lens
    lens = np.array([K, K, K, 1])
    args = (logits, tokens, lens, temps, topps, acoins, fcoins)
    got = _decide(*args)
    assert got == _jax_decide(*args)
    assert got[0] == [K, 2, got[0][2], 1]
    assert [got[1][b] for b in (0, 1, 3)] == samples[[0, 1, 3]].tolist()


def test_spec_coins_consumed_rule():
    for n_acc, draft_len in ((0, 0), (0, 4), (2, 4), (4, 4)):
        assert (spec.spec_coins_consumed(n_acc)
                == jax_spec.spec_coins_consumed(n_acc, draft_len) == n_acc + 1)


# -- verify steps against the JAX functions -----------------------------------


@pytest.mark.parametrize("trial", range(2))
def test_verify_step_matches_jax_and_sequential_greedy(trial):
    cfg, jcfg = _configs("llama", "float32", sync_q80=True)
    jparams, params = _pair(cfg, jcfg, seed=trial)
    rng = np.random.default_rng(trial)
    prompt = rng.integers(0, cfg.vocab_size, 9).tolist()
    token = int(rng.integers(0, cfg.vocab_size))
    # the oracle: sequential greedy steps of the port
    kv = KVCache.create(cfg)
    _, kv = llama.forward(params, cfg, torch.tensor([prompt]), 0, kv)
    seq, t = [], token
    for i in range(5):
        nxt, _, kv = llama.greedy_step(params, cfg, torch.tensor([[t]]), len(prompt) + i, kv)
        seq.append(int(nxt[0]))
        t = seq[-1]
    # drafts: the first two right, then a wrong one
    drafts = seq[:2] + [(seq[2] + 1) % cfg.vocab_size, seq[3]]
    toks = [token, *drafts]
    kv2 = KVCache.create(cfg)
    _, kv2 = llama.forward(params, cfg, torch.tensor([prompt]), 0, kv2)
    n_acc, preds, nf, kv2 = llama.verify_step(params, cfg, torch.tensor([toks]),
                                              torch.tensor([len(prompt)], dtype=torch.int32),
                                              kv2)
    assert nf.tolist() == [0]
    jkv = JaxKVCache.create(jcfg)
    _, jkv = jax_llama.forward(jparams, jcfg, jnp.asarray([prompt], jnp.int32),
                               jnp.int32(0), jkv)
    jn, jp, jkv = jax_llama.verify_step(jparams, jcfg, jnp.asarray([toks], jnp.int32),
                                        jnp.int32(len(prompt)), jkv)
    assert n_acc.tolist() == np.asarray(jn).tolist() == [2]
    assert preds.tolist() == np.asarray(jp).tolist()
    assert preds[0, :3].tolist() == seq[:3]
    n = len(prompt) + len(toks)
    np.testing.assert_allclose(kv2.k[:, :, :, :n].numpy(),
                               np.asarray(jkv.k)[:, :, :, :n], rtol=0, atol=F32_ATOL)


def test_paged_verify_step_matches_jax_guarded_step():
    """One ragged verify step over five rows: a greedy row whose drafts all
    match, a sampled row whose drafts match, a greedy row with a
    zero-length draft, a sampled row capped at one draft near the context
    end (its padded lanes reach past ``seq_len``), and an inactive row
    with an all-null table. ``(n_acc, out, nonfinite)`` equal the JAX
    guarded step's (poison 0), the pools agree outside the null block, and
    every write past a row's draft length went to the null block. The Q80
    sync casts are off: with them a last-ulp difference of the two
    frameworks' sums can flip a whole int8 step of a cast, which the pool
    bound is not for."""
    cfg, jcfg = _configs("llama", "float32", sync_q80=False)
    jparams, params = _pair(cfg, jcfg, seed=21)
    K, B = 4, 5
    M = blocks_per_seq(cfg.seq_len, BS)
    n_blocks = B * M + 1
    pkv0, jkv = _pools(cfg, n_blocks, seed=12, dtype="float32")
    tables = _tables(cfg, B, n_blocks, seed=5, null_rows=(4,))
    pos = np.array([9, 30, 17, cfg.seq_len - 2, cfg.seq_len])
    lens = np.array([K, K, 0, 1, 0])
    temps = np.array([0.0, 0.8, 0.0, 1.2, 0.0], np.float32)
    topps = np.array([0.9, 0.9, 0.9, 0.6, 0.0], np.float32)
    rng = np.random.default_rng(9)
    acoins = rng.random((B, K)).astype(np.float32)
    fcoins = rng.random(B).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (B, K + 1))

    def port(toks, pool):
        t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
        return llama.paged_verify_step(params, cfg, t(toks), t(pos), pool, t(tables),
                                       t(lens), t(temps), t(topps), t(acoins), t(fcoins))

    # make rows 0, 1 and 3 draft what the model itself emits: each pass
    # fixes one more position (position i's pick depends on tokens <= i)
    for i in range(K):
        _, out, _ = port(tokens, PagedKVCache(pkv0.k.clone(), pkv0.v.clone()))
        for b in (0, 1, 3):
            tokens[b, i + 1] = int(out[b, i])
    pkv = PagedKVCache(pkv0.k.clone(), pkv0.v.clone())
    n_acc, out, nf = port(tokens, pkv)
    (jn, jout, jnf), jkv = jax_llama.paged_verify_step_guarded(
        jparams, jcfg, jnp.asarray(tokens, jnp.int32), jnp.asarray(pos, jnp.int32), jkv,
        jnp.asarray(tables), jnp.asarray(lens, jnp.int32), jnp.asarray(temps),
        jnp.asarray(topps), jnp.asarray(acoins), jnp.asarray(fcoins), jnp.float32(0.0))
    assert n_acc.tolist() == np.asarray(jn).tolist() == [K, K, 0, 1, 0]
    assert out.tolist() == np.asarray(jout).tolist()
    assert nf.tolist() == np.asarray(jnf).tolist() == [0] * B
    # the pools outside the null block (several padded lanes write one null
    # cell there, and which write lands last is each framework's own)
    for got, want in ((pkv.k, jkv.k), (pkv.v, jkv.v)):
        np.testing.assert_allclose(got[:, 1:].numpy(), np.asarray(want)[:, 1:], rtol=0,
                                   atol=F32_ATOL)
    # the cells a real lane may write: pos .. pos + lens of each active row
    written = np.zeros(pkv.k.shape[1:4:2], bool)                  # [n_blocks, bs]
    for b in range(4):
        for p in range(pos[b], pos[b] + lens[b] + 1):
            written[tables[b, p // BS], p % BS] = True
    changed = (pkv.k != pkv0.k).any(dim=(0, 2, 4)).numpy()        # [n_blocks, bs]
    assert changed[1:][~written[1:]].sum() == 0
    assert changed[0].any()  # the padded lanes and the inactive row


# -- the engine ---------------------------------------------------------------


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_spec")
    mpath, tpath = d / "m.m", d / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=96),
                     np.random.default_rng(11))
    tfile.write_tfile(tpath, byte_vocab_tokenizer())
    return str(mpath), str(tpath)


def _gen(eng, prompt, steps):
    try:
        return eng.generate(prompt, steps, stop_on_eos=False)
    finally:
        eng.close()


def _n_dispatches(result) -> int:
    return sum(1 for s in result.steps if s.kind == "pred")


@pytest.mark.parametrize("sp", [1, 2])
@pytest.mark.parametrize("prompt", ["the quick brown fox", "hello hello hello hello"])
def test_engine_spec_matches_plain_greedy_and_jax(model_files, prompt, sp):
    """``InferenceEngine(spec_lookup=4)`` emits plain greedy's tokens and the
    JAX engine's speculative tokens, dispatch for dispatch; at sp = 2 the
    verify runs eagerly through the merge attention over ``[cpu] * 2``."""
    m, t = model_files
    kw = dict(device="cpu", temperature=0.0, sp=sp)
    plain = _gen(InferenceEngine(m, t, **kw), prompt, 40)
    eng = InferenceEngine(m, t, spec_lookup=4, **kw)
    assert eng.spec_active
    mine = _gen(eng, prompt, 40)
    ref = _gen(JaxEngine(m, t, tp=1, sp=sp, temperature=0.0, spec_lookup=4), prompt, 40)
    assert mine.tokens == plain.tokens == ref.tokens
    assert mine.text == plain.text
    steps = [(s.n_tokens, s.width) for s in mine.steps if s.kind == "pred"]
    assert steps == [(s.n_tokens, s.width) for s in ref.steps if s.kind == "pred"]
    assert sum(n for n, _ in steps) == 40
    if prompt.startswith("hello"):  # a repetitive stream: real acceptance
        assert _n_dispatches(mine) < 40


def test_engine_spec_reaches_the_context_end(model_files):
    """Verify dispatches while K+1 positions are left, single steps after;
    the engine fills the context like plain greedy."""
    m, t = model_files
    plain = _gen(InferenceEngine(m, t, device="cpu", temperature=0.0), "abcabc", 500)
    mine = _gen(InferenceEngine(m, t, device="cpu", temperature=0.0, spec_lookup=4),
                "abcabc", 500)
    assert mine.tokens == plain.tokens and len(mine.tokens) == 96 - len("abcabc") - 1 + 1


def test_spec_ignored_at_temperature(model_files):
    m, t = model_files
    kw = dict(device="cpu", temperature=0.9, seed=7)
    eng = InferenceEngine(m, t, spec_lookup=4, **kw)
    assert not eng.spec_active
    a = _gen(eng, "the quick", 24)
    b = _gen(InferenceEngine(m, t, **kw), "the quick", 24)
    assert a.tokens == b.tokens and _n_dispatches(a) == 24


def test_refusals_match_jax(model_files):
    m, t = model_files
    for kw, msg in ((dict(spec_lookup=4, decode_chunk=8), "exclusive"),
                    (dict(spec_lookup=16, kv_block_size=16), "spec-lookup > 15")):
        with pytest.raises(ValueError, match=msg) as mine:
            InferenceEngine(m, t, device="cpu", **kw)
        with pytest.raises(ValueError, match=msg) as ref:
            JaxEngine(m, t, tp=1, **kw)
        assert str(mine.value) == str(ref.value)
    InferenceEngine(m, t, device="cpu", spec_lookup=15, kv_block_size=16).close()


def test_closing_releases_the_verify_graphs_without_a_collection(model_files):
    """The verify steps' bodies (the engine's and the paged generator's)
    close over tensors only: ``close()`` frees the parameters, the cache,
    the pool and the static buffers by reference counting alone."""
    import gc
    import weakref

    from dllama_tpu_torch.runtime.serving import PagedGenerator

    gc.collect()
    gc.disable()
    try:
        eng = InferenceEngine(*model_files, device="cpu", temperature=0.0, spec_lookup=4,
                              kv_block_size=16)
        eng.generate("hello hello", 6, stop_on_eos=False)
        gen = PagedGenerator(eng, n_slots=2)
        assert gen.capture() is gen.verify_graph() and gen._graph is None
        refs = [weakref.ref(t) for t in (eng.params.embedding, eng.kv.k, gen.pkv.k,
                                         eng._verify_graph.tok, gen._vin)]
        gen.close()
        del gen
        eng.close()
        del eng
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()


# -- the CLI -----------------------------------------------------------------


def _cli(module: str, *argv: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env.update(CUDA_VISIBLE_DEVICES="", JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("sp", ["1", "2"])
def test_cli_spec_rate_line_matches_the_jax_cli(tmp_path, sp):
    """``inference --spec-lookup 4 --temperature 0`` streams the JAX CLI's
    text and prints its ``spec rate`` line, at ``--sp 1`` and ``2`` (the
    JAX side on the suite's virtual CPU devices)."""
    m, t, _, _ = golden_assets.build_assets("llama_q40", tmp_path)
    prompt = golden_assets.PROMPT
    argv = ["inference", "--model", str(m), "--tokenizer", str(t), "--prompt", prompt,
            "--steps", "32", "--temperature", "0", "--seed", "1", "--spec-lookup", "4",
            "--sp", sp]
    port = _cli("dllama_tpu_torch", *argv, "--device", "cpu")
    ref = _cli("dllama_tpu", *argv)
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr

    def section(out):
        streamed = out.split(prompt + "\n", 1)[1].split("\n\nEvaluation", 1)[0]
        return streamed, [ln for ln in out.splitlines()
                          if "nTokens:" in ln or "spec rate:" in ln]

    got, want = section(port.stdout), section(ref.stdout)
    assert got[0].strip() and got == want
    assert any(ln.startswith("  spec rate: ") and ln.endswith(" dispatches)")
               for ln in got[1]), got[1]


@pytest.mark.parametrize("V,seed", [(40, 0), (300, 1), (1000, 2), (4096, 3)])
def test_target_sampling_probs_equals_jax(V, seed):
    """``target_sampling_probs`` (the distribution a sampled draft's accept
    rate must match) against the JAX function on seeded logits: greedy
    one-hots, plain softmax (top-p outside (0, 1)) and nucleus rows at
    several temperatures; above 256 entries the JAX function takes its
    windowed top-k, which gives the same vector when the nucleus fits it."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((8, V)) * 4).astype(np.float32)
    temps = np.array([0.0, 0.5, 0.9, 1.3, 0.7, 1.0, 0.2, 2.0], np.float32)
    topps = np.array([0.9, 0.9, 0.5, 1.0, 0.0, 0.95, 0.8, 0.3], np.float32)
    want = np.asarray(jax_spec.target_sampling_probs(jnp.asarray(logits), jnp.asarray(temps),
                                                     jnp.asarray(topps)))
    got = spec.target_sampling_probs(torch.tensor(logits), torch.tensor(temps),
                                     torch.tensor(topps)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    assert (got[0] == np.eye(V)[np.argmax(logits[0])]).all()
