"""The port's dense slot pool (``BatchedGenerator`` under ``BatchScheduler``,
``api --batch-slots N`` without ``--kv-block-size``) on the tiny model of
``tests/test_torch_serving.py`` (vocab 268, seq_len 96), held against the
JAX package's ``BatchedGenerator`` / ``BatchScheduler`` on the same files
(``tp=1``): a mixed greedy and sampled stream with staggered admission and
slot reuse, cross-slot prefix reuse, cancel, ``step_chunk`` at K = 2 and 4
(against K = 1 and JAX, EOS mid-chunk with the coin stream rewound),
``ragged_verify_step`` and the ragged ``sampled_steps`` against the JAX
functions, the spec pool against spec-off and JAX (retiring near the cap),
and the captured step's body against the eager step.

Token ids compare exactly; a sampled departure from JAX must show ROADMAP
C6's top-p boundary signature (``test_torch_spec_serving.py``'s check).
Logits compare within 1e-5 of max|logits| (f32, Q80 sync off: the two
frameworks sum in other orders), caches within 1e-4 absolute."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats import tfile
from dllama_tpu.models import llama as jax_llama
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu.runtime.kvcache import KVCache as JaxKVCache
from dllama_tpu.runtime.serving import BatchedGenerator as JaxBatchedGenerator
from dllama_tpu.runtime.serving import BatchScheduler as JaxBatchScheduler
from dllama_tpu.runtime.serving import Request as JaxRequest
from dllama_tpu_torch.models import llama
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.kvcache import KVCache
from dllama_tpu_torch.runtime.serving import BatchedGenerator, BatchScheduler, Request
from dllama_tpu_torch.tokenizer.sampler import xorshift_random_f32

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model
from test_torch_model import F32_ATOL, _configs, _pair
from test_torch_spec_serving import _assert_topp_boundary_departure

LOGIT_RTOL = 1e-5

PROMPTS = ["hello world", "hello there", "abc", "hello world how are you", "xyzzy",
           "hello hello hello"]
KNOBS = [dict(temperature=0.0, seed=1), dict(temperature=0.8, seed=2),
         dict(temperature=0.0, seed=3), dict(temperature=1.2, seed=4),
         dict(temperature=0.0, seed=5), dict(temperature=0.6, seed=6)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dense_serving")
    mpath, tpath = d / "m.m", d / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=96),
                     np.random.default_rng(41))
    tfile.write_tfile(tpath, byte_vocab_tokenizer())
    return str(mpath), str(tpath)


@pytest.fixture(scope="module")
def jeng(files):
    eng = JaxEngine(*files, tp=1)
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def engine(files):
    eng = InferenceEngine(*files, device="cpu")
    yield eng
    eng.close()


def _enc(eng, text):
    return eng.tokenizer.encode(text, is_start=True)


def _stream(sched, eng, work):
    reqs = [sched.submit(_enc(eng, p), n, stop_on_eos=False, **kw) for p, n, kw in work]
    for r in reqs:
        assert r.done.wait(timeout=300) and r.error is None, r.error
    return reqs


def _jax_stream(jeng, work, n_slots=2):
    sched = JaxBatchScheduler(jeng, n_slots=n_slots)
    try:
        return [r.tokens for r in _stream(sched, jeng, work)]
    finally:
        sched.close()


def _hold(jeng, eng, work, got, want):
    """Each transcript equals JAX's; a sampled one may part only at a top-p
    boundary (C6)."""
    for (p, _, kw), g, w in zip(work, got, want):
        if kw.get("temperature", 0.0) > 0.0 and g != w:
            _assert_topp_boundary_departure(jeng, _enc(eng, p), g, w, kw["temperature"],
                                            kw.get("topp", 0.9), kw["seed"])
        else:
            assert g == w, p


def test_mixed_stream_with_staggered_admission_matches_jax(engine, jeng):
    """6 greedy and sampled requests through 2 slots: admissions stagger as
    slots retire and are reused, and every transcript equals the JAX dense
    scheduler's; the shared "hello" prefix is reused across slots."""
    work = [(p, 8, kw) for p, kw in zip(PROMPTS, KNOBS)]
    sched = BatchScheduler(engine, n_slots=2)
    try:
        reqs = _stream(sched, engine, work)
        assert isinstance(sched.gen, BatchedGenerator)
        assert sched.gen.reused_tokens > 0
    finally:
        sched.close()
    for r in reqs:
        assert r.t_first_token >= r.t_submit > 0
    _hold(jeng, engine, work, [r.tokens for r in reqs], _jax_stream(jeng, work))


def test_cross_slot_prefix_reuse_skips_prefill_and_stays_exact(engine, jeng):
    """A prompt that extends a retired slot's prompt admits into the other
    slot, copies the shared rows and prefills only its own tail; its
    transcript equals a cold JAX generator's."""
    base = "abcdefghijklmnopqrstuvwxy "
    gen = BatchedGenerator(engine, n_slots=2)
    a = Request(rid=0, prompt_ids=_enc(engine, base + "111"), max_tokens=6,
                stop_on_eos=False)
    gen.admit(a, 0)
    while gen.n_active:
        gen.step()
    ids_b = _enc(engine, base + "222")
    common = next(i for i, (x, y) in enumerate(zip(ids_b, a.prompt_ids)) if x != y)
    adm = gen.begin_admit(Request(rid=1, prompt_ids=ids_b, max_tokens=6,
                                  stop_on_eos=False), 1)
    assert adm.pos == common == gen.reused_tokens
    while not gen.continue_admit(adm):
        pass
    b = adm.req
    while gen.n_active:
        gen.step()
    jgen = JaxBatchedGenerator(jeng, n_slots=2)
    jb = JaxRequest(rid=0, prompt_ids=ids_b, max_tokens=6, stop_on_eos=False)
    jgen.admit(jb, 0)
    while jgen.n_active:
        jgen.step()
    assert b.tokens == jb.tokens


def test_cancel_retires_the_slot_and_spares_the_batch(engine, jeng):
    """A client cancel after two tokens retires that slot at the next step;
    the other request runs on to JAX's transcript."""
    sched = BatchScheduler(engine, n_slots=2)
    try:
        box: dict = {}

        def cut(t, piece):
            r = box.get("victim")
            if r is not None and len(r.tokens) >= 2:
                r.cancel.set()

        victim = box["victim"] = sched.submit(_enc(engine, "cancel me please"), 40,
                                              stop_on_eos=False, on_token=cut)
        other = sched.submit(_enc(engine, "hello there"), 12, stop_on_eos=False,
                             temperature=0.8, seed=9)
        assert victim.done.wait(timeout=300) and other.done.wait(timeout=300)
        assert 2 <= len(victim.tokens) < 40 and victim.error is None
        assert sched.gen.n_active == 0
    finally:
        sched.close()
    want = _jax_stream(jeng, [("hello there", 12, dict(temperature=0.8, seed=9))])[0]
    _hold(jeng, engine, [("hello there", 12, dict(temperature=0.8, seed=9))],
          [other.tokens], [want])


def _chunk_run(gen, work, k, eng):
    reqs = []
    for slot, (p, n, kw) in enumerate(work):
        req = Request(rid=slot, prompt_ids=_enc(eng, p), max_tokens=n, stop_on_eos=False,
                      **kw)
        gen.admit(req, slot)
        reqs.append(req)
    while gen.n_active:
        gen.step_chunk(k)
    return reqs


CHUNK_WORK = [("hello world", 11, dict(temperature=0.0, seed=1)),
              ("xyzzy", 9, dict(temperature=0.9, seed=2)),
              ("abc", 7, dict(temperature=0.0, seed=3))]


@pytest.mark.parametrize("k", [2, 4])
def test_step_chunk_matches_single_steps_and_jax(files, engine, jeng, k):
    """``step_chunk(k)`` (k replays, one readback; the tails fall back to
    single steps) gives K = 1's transcripts and JAX's ``step_chunk``'s,
    and every sampled row's RNG advanced by exactly its tokens."""
    eng = InferenceEngine(*files, device="cpu", decode_chunk=k)
    try:
        got = _chunk_run(BatchedGenerator(eng, n_slots=3), CHUNK_WORK, k, eng)
        one = _chunk_run(BatchedGenerator(engine, n_slots=3), CHUNK_WORK, 1, engine)
    finally:
        eng.close()
    jgen = JaxBatchedGenerator(jeng, n_slots=3)
    jreqs = []
    for slot, (p, n, kw) in enumerate(CHUNK_WORK):
        jr = JaxRequest(rid=slot, prompt_ids=_enc(engine, p), max_tokens=n, stop_on_eos=False,
                        **kw)
        jgen.admit(jr, slot)
        jreqs.append(jr)
    while jgen.n_active:
        jgen.step_chunk(k)
    for g, o, j, (_, n, kw) in zip(got, one, jreqs, CHUNK_WORK):
        assert g.tokens == o.tokens and len(g.tokens) == n
        st = kw["seed"]
        for _ in range(len(g.tokens) if kw["temperature"] > 0 else 0):
            _, st = xorshift_random_f32(st)
        assert g.rng_state == o.rng_state == st
    _hold(jeng, engine, CHUNK_WORK, [r.tokens for r in got], [r.tokens for r in jreqs])


def test_step_chunk_eos_mid_chunk_rewinds_rng(files, engine):
    """A sampled request whose sixth token is an EOS stops there inside a
    chunk of 4: it keeps six tokens, its RNG advanced by six coins, and the
    request admitted into its slot next runs as it runs alone."""
    prompt = _enc(engine, "xyzzy")
    solo = BatchedGenerator(engine, n_slots=2)
    ref = Request(rid=0, prompt_ids=prompt, max_tokens=12, temperature=0.9, seed=2,
                  stop_on_eos=False)
    solo.admit(ref, 0)
    while solo.n_active:
        solo.step()
    eos = ref.tokens[5]
    assert eos not in ref.tokens[:5]
    eng = InferenceEngine(*files, device="cpu", decode_chunk=4)
    try:
        eng.tokenizer.eos_token_ids = [eos]
        gen = BatchedGenerator(eng, n_slots=2)
        req = Request(rid=0, prompt_ids=prompt, max_tokens=12, temperature=0.9, seed=2)
        gen.admit(req, 0)
        while gen.n_active:
            gen.step_chunk(4)
        assert req.tokens == ref.tokens[:6]
        st = 2
        for _ in range(6):
            _, st = xorshift_random_f32(st)
        assert req.rng_state == st
        nxt = Request(rid=1, prompt_ids=_enc(eng, "hello there"), max_tokens=8,
                      temperature=0.7, seed=5, stop_on_eos=False)
        gen.admit(nxt, 0)
        while gen.n_active:
            gen.step_chunk(4)
    finally:
        eng.close()
    alone = BatchedGenerator(engine, n_slots=2)
    want = Request(rid=1, prompt_ids=nxt.prompt_ids, max_tokens=8, temperature=0.7,
                   seed=5, stop_on_eos=False)
    alone.admit(want, 1)
    while alone.n_active:
        alone.step()
    assert nxt.tokens == want.tokens


def _filled_caches(cfg, jcfg, B, rng):
    """Shared random cache contents ``[L, B, n_kv, S, hd]`` for both sides."""
    kv = KVCache.create(cfg, batch_size=B)
    k = rng.standard_normal(kv.k.shape).astype(np.float32) * 0.5
    v = rng.standard_normal(kv.v.shape).astype(np.float32) * 0.5
    kv.k[:] = torch.from_numpy(k)
    kv.v[:] = torch.from_numpy(v)
    jkv = JaxKVCache.create(jcfg, batch_size=B)
    return kv, JaxKVCache(k=jnp.asarray(k[:, :, :, :jkv.k.shape[3]]),
                          v=jnp.asarray(v[:, :, :, :jkv.v.shape[3]]))


def test_ragged_verify_step_matches_jax():
    """One ragged verify over four rows at their own positions: a greedy
    row whose drafts are its own greedy run (all accepted), a greedy row
    right for two drafts, a sampled row (one coin on position 0, nothing
    accepted) and a greedy row at position 0. ``(n_acc, preds)`` equal the
    JAX function's, the logits agree within 1e-5 of max|logits| and the
    caches within 1e-4."""
    cfg, jcfg = _configs("llama", "float32", sync_q80=False)
    jparams, params = _pair(cfg, jcfg, seed=3)
    rng = np.random.default_rng(3)
    B, K = 4, 4
    pos = np.array([9, 30, 17, 0])
    temps = np.array([0.0, 0.0, 0.9, 0.0], np.float32)
    topps = np.full(B, 0.9, np.float32)
    coins = rng.random(B).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, K + 1))
    kv0, _ = _filled_caches(cfg, jcfg, B, np.random.default_rng(7))
    for row, n_right in ((0, K), (1, 2)):
        for j in range(n_right):  # draft j + 1 = the greedy pick after j + 1 tokens
            kv = KVCache(kv0.k.clone(), kv0.v.clone())
            _, preds, _ = llama.ragged_verify_step(params, cfg, torch.from_numpy(toks),
                                                   torch.from_numpy(pos), kv, temps,
                                                   topps, coins)
            toks[row, j + 1] = int(preds[row, j])
    toks[1, 3] = (toks[1, 3] + 1) % cfg.vocab_size
    kv, jkv = _filled_caches(cfg, jcfg, B, np.random.default_rng(7))
    n_acc, preds, nf = llama.ragged_verify_step(params, cfg, torch.from_numpy(toks),
                                                torch.from_numpy(pos), kv, temps, topps,
                                                coins)
    jn, jp, jkv = jax_llama.ragged_verify_step(
        jparams, jcfg, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32), jkv,
        jnp.asarray(temps), jnp.asarray(topps), jnp.asarray(coins))
    assert n_acc.tolist() == np.asarray(jn).tolist() == [K, 2, 0, n_acc[3].item()]
    assert preds.tolist() == np.asarray(jp).tolist()
    assert nf.tolist() == [0] * B
    S = jkv.k.shape[3]
    np.testing.assert_allclose(kv.k[:, :, :, :S].numpy(), np.asarray(jkv.k), rtol=0,
                               atol=F32_ATOL)
    kv, jkv = _filled_caches(cfg, jcfg, B, np.random.default_rng(7))
    got, _ = llama.forward(params, cfg, torch.from_numpy(toks), torch.from_numpy(pos), kv)
    want, _ = jax_llama.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                                jnp.asarray(pos, jnp.int32), jkv)
    want = np.asarray(want, np.float32)
    assert np.abs(got.numpy() - want).max() <= LOGIT_RTOL * np.abs(want).max()


def test_ragged_sampled_steps_match_jax():
    """The ragged chunked step: ``sampled_steps`` over three rows at their
    own positions with per-row temperatures (one greedy) and coins ``[k,
    B]`` gives the JAX function's tokens."""
    cfg, jcfg = _configs("llama", "float32", sync_q80=False)
    jparams, params = _pair(cfg, jcfg, seed=5)
    rng = np.random.default_rng(5)
    B, k = 3, 4
    pos = np.array([12, 3, 40])
    token = rng.integers(0, cfg.vocab_size, B)
    temps = np.array([0.0, 0.8, 1.1], np.float32)
    topps = np.array([0.9, 0.9, 0.95], np.float32)
    coins = rng.random((k, B)).astype(np.float32)
    kv, jkv = _filled_caches(cfg, jcfg, B, np.random.default_rng(11))
    got, _, _ = llama.sampled_steps(params, cfg, torch.from_numpy(token),
                                    torch.from_numpy(pos), kv, torch.from_numpy(temps),
                                    torch.from_numpy(topps), torch.from_numpy(coins), k)
    want, _ = jax_llama.sampled_steps(jparams, jcfg, jnp.asarray(token, jnp.int32),
                                      jnp.asarray(pos, jnp.int32), jkv,
                                      jnp.asarray(temps), jnp.asarray(topps),
                                      jnp.asarray(coins), k)
    assert got.tolist() == np.asarray(want).tolist()


def test_spec_pool_matches_spec_off_and_jax(files, jeng):
    """``--spec-lookup 4`` on the dense pool: greedy rows verify drafts,
    sampled rows emit one token a step; every transcript equals spec-off's
    and the JAX spec pool's. A greedy request run to the context retires
    once its K + 1 write would pass ``seq_len``: it keeps spec-off's tokens
    up to there, as the JAX pool does."""
    eng = InferenceEngine(*files, device="cpu", spec_lookup=4)
    jspec = JaxEngine(*files, tp=1, spec_lookup=4)
    work = [("hello hello hello hello", 10, dict(temperature=0.0, seed=1)),
            ("abcabcabcabc", 12, dict(temperature=0.8, seed=2)),
            ("xyzzy", 200, dict(temperature=0.0, seed=3)),
            ("hello world", 9, dict(temperature=0.0, seed=4))]
    try:
        sched = BatchScheduler(eng, n_slots=2)
        try:
            reqs = _stream(sched, eng, work)
        finally:
            sched.close()
        jwant = _jax_stream(jspec, work)
    finally:
        eng.close()
        jspec.close()
    off = _jax_stream(jeng, work)
    got = [r.tokens for r in reqs]
    _hold(jeng, eng, work, got, jwant)
    for g, o, r in zip(got, off, reqs):
        assert g == o[:len(g)]
    near_cap = reqs[2]
    assert len(near_cap.tokens) < len(off[2])
    assert len(near_cap.prompt_ids) - 1 + len(near_cap.tokens) + 5 > 96
    assert sum(r.spec_accepted for r in reqs) > 0
    assert reqs[1].spec_drafted == 0  # sampled rows draft nothing


def test_graph_body_equals_eager_step(engine):
    """The captured step's body (what a CPU replay runs) against eager
    ``ragged_sampled_step`` on a copy of the pool, for the same inputs:
    the same tokens, and the same pool after the step. A retired slot
    rides along at its clamped position."""
    gen = BatchedGenerator(engine, n_slots=3)
    for slot, (p, kw) in enumerate([("hello world", dict(temperature=0.0)),
                                    ("xyzzy", dict(temperature=0.9, seed=4))]):
        gen.admit(Request(rid=slot, prompt_ids=_enc(engine, p), max_tokens=20,
                          stop_on_eos=False, **kw), slot)
    gen.pos[2] = engine.cfg.seq_len  # a slot retired at the context cap
    for _ in range(3):
        kv = KVCache(gen.kv.k.clone(), gen.kv.v.clone())
        nxt, pos = gen.next_token.copy(), gen.pos.copy()
        st = gen.slots[1].rng_state
        coin, _ = xorshift_random_f32(st)
        gen.step()
        want, nf = llama.ragged_sampled_step(
            engine.params, engine.cfg, torch.from_numpy(nxt)[:, None],
            torch.from_numpy(pos).clamp(max=engine.cfg.seq_len - 1), kv,
            torch.tensor([0.0, 0.9, 0.0]), torch.tensor([0.9, 0.9, 0.0]),
            torch.tensor([0.0, coin, 0.0]))
        assert [r.tokens[-1] for r in gen.slots[:2]] == want[:2].tolist()
        assert nf.tolist() == [0, 0, 0]
        assert torch.equal(gen.kv.k, kv.k) and torch.equal(gen.kv.v, kv.v)
