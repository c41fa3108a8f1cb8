"""Speculative decoding through the port's continuous batching
(``PagedGenerator`` / ``BatchScheduler`` under ``--spec-lookup K``, the
port of ``tests/test_spec_paged.py``), on the tiny model of
``tests/test_torch_serving.py`` (vocab 268, seq_len 96, block size 16),
held against the JAX package's single-sequence engine on the same files:
greedy and sampled transcripts token for token through a continuous stream
with shared prefixes, a sampled request independent of its batch-mates,
a near-cap slot that clamps its draft length instead of retiring, the
admission price of the verify frontier (``+ spec``), and the ``api``
completion text against the JAX ``BatchedApiState.complete``. On the CPU
the verify step runs its captured body on the static buffers
(``PagedGenerator.verify_graph``). Token ids compare exactly."""

from __future__ import annotations

import json
import threading
import urllib.request

import numpy as np
import pytest

from dllama_tpu.formats import tfile
from dllama_tpu.formats.quants import Q80
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.serving import BatchScheduler, PagedGenerator, Request
from dllama_tpu_torch.serve import cli

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_spec_serving")
    mpath, tpath = d / "m.m", d / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=96),
                     np.random.default_rng(29))
    td = byte_vocab_tokenizer()
    td.chat_template = "<|start_header_id|>"  # detected as llama3 (api test)
    tfile.write_tfile(tpath, td)
    return str(mpath), str(tpath)


@pytest.fixture(scope="module")
def solo(files):
    """The oracle: the JAX single-sequence engine, reset and re-seeded per
    transcript."""
    eng = JaxEngine(*files, tp=1)

    def run(prompt, n, temperature=0.0, seed=7, topp=0.9):
        eng.reset()
        eng.sampler.set_temp(temperature)
        eng.sampler.set_seed(seed)
        eng.sampler.topp = topp
        return eng.generate(prompt, n, stop_on_eos=False).tokens

    run.engine = eng
    yield run
    eng.close()


def _walk(x: np.ndarray, temperature: float, topp: float, coin: float,
          last: int) -> int:
    """The nucleus walk of the samplers in float64 over ``x`` (one row of
    f32 logits), with the nucleus ending at sorted index ``last``."""
    p = np.exp((x - x.max()) / temperature)
    p /= p.sum()
    p = np.where(p >= (1.0 - topp) / (len(p) - 1), p, 0.0)
    order = np.argsort(-p, kind="stable")
    cs = np.cumsum(p[order])
    return int(order[min(int(np.argmax(cs > coin * cs[last])), last)])


def _assert_topp_boundary_departure(jeng, prompt: list[int], got: list[int],
                                    jax_tokens: list[int], temperature: float,
                                    topp: float, seed: int) -> None:
    """Where the port's sampled tokens ``got`` first part from the JAX
    engine's ``jax_tokens`` (ROADMAP C6), the departure must be the top-p
    boundary case and nothing else: on the JAX engine's own logits there,
    the float64 nucleus mass where the walk crosses top-p lies within 4
    f32 ulps of top-p, the port's token is the float64 pick, and JAX's is
    the pick of a nucleus that crosses one token later (its f32 sum). A
    departure for any other cause fails."""
    from dllama_tpu_torch.tokenizer.sampler import xorshift_random_f32

    i = next((j for j, (a, b) in enumerate(zip(got, jax_tokens)) if a != b), None)
    if i is None:
        assert len(got) == len(jax_tokens)
        return
    jeng.reset()
    x = np.asarray(jeng.prefill(list(prompt) + list(got[:i]))[0], np.float64).reshape(-1)
    coin, st = 0.0, seed
    for _ in range(i + 1):
        coin, st = xorshift_random_f32(st)
    p = np.exp((x - x.max()) / temperature)
    p /= p.sum()
    p = np.where(p >= (1.0 - topp) / (len(p) - 1), p, 0.0)
    cs = np.cumsum(np.sort(p)[::-1])
    last = int(np.argmax(cs > topp))
    assert abs(cs[last] - topp) <= 4 * np.spacing(np.float32(topp)), (i, cs[last] - topp)
    assert got[i] == _walk(x, temperature, topp, coin, last), i
    assert jax_tokens[i] == _walk(x, temperature, topp, coin, last + 1), i


@pytest.fixture(scope="module")
def engine(files):
    eng = InferenceEngine(*files, device="cpu", kv_block_size=16, spec_lookup=4)
    yield eng
    eng.close()


def _enc(eng, text):
    return eng.tokenizer.encode(text, is_start=True)


def _stream(sched, eng, work):
    reqs = [sched.submit(_enc(eng, p), n, stop_on_eos=False, **kw) for p, n, kw in work]
    for r in reqs:
        assert r.done.wait(timeout=300) and r.error is None, r.error
    return reqs


BASE = "abcdefghijklmnopqrstuvwxyz "  # more than one 16-row block, shared
WORK = [(BASE + "hello hello hello", 14, {}),
        (BASE + "hello hello there", 12, dict(temperature=0.8, seed=11)),
        ("ababababababab", 16, {}),
        (BASE + "hello goodbye", 10, dict(temperature=1.1, seed=5, topp=0.6)),
        ("the quick brown fox", 12, {}),
        ("hello hello hello hello", 16, dict(temperature=0.7, seed=3))]


def test_spec_stream_token_exact_vs_jax_solo(engine, solo):
    """Six greedy and sampled requests through three slots: admissions and
    retirements mid-batch, shared prefixes, ragged draft lengths; every
    transcript equals the JAX solo engine's, greedy rows accept drafts, and
    the verify step was captured once for the pool geometry."""
    want = [solo(p, n, **kw) for p, n, kw in WORK]
    sched = BatchScheduler(engine, n_slots=3)
    try:
        reqs = _stream(sched, engine, WORK)
        graph = sched.gen._verify
        assert graph is not None and sched.gen._graph is None
        assert sched.gen.reused_tokens > 0
    finally:
        sched.close()
    assert [r.tokens for r in reqs] == want
    assert all(r.spec_drafted > 0 for r in reqs)
    assert any(r.spec_accepted > 0 for r in reqs if r.temperature == 0.0)
    assert all(r.spec_accepted <= r.spec_drafted for r in reqs)
    assert sched.gen.pool.used_blocks() == 0


def test_sampled_spec_deterministic_and_batchmate_independent(engine):
    sampled = ("the quick brown fox", 14, dict(temperature=0.8, seed=11, topp=0.9))
    out = []
    for work in ([sampled], [sampled, ("hello hello hello hello", 16, {}),
                             ("zzzz yyyy xxxx", 12, dict(temperature=0.5, seed=5))]):
        sched = BatchScheduler(engine, n_slots=3)
        try:
            out.append(_stream(sched, engine, work)[0].tokens)
        finally:
            sched.close()
    assert out[0] == out[1] and len(out[0]) == 14


def _to_the_cap(eng, temperature):
    """One request that decodes to the very last row, alone in a generator
    of ``eng``: its tokens and the draft-length caps its verify steps ran
    (none with speculation off)."""
    ids = _enc(eng, "hello hello hello hello")
    cap = eng.cfg.seq_len - len(ids) + 1
    gen = PagedGenerator(eng, n_slots=1)
    r = Request(rid=0, prompt_ids=list(ids), max_tokens=cap, temperature=temperature,
                seed=13, stop_on_eos=False)
    gen.admit(r, 0)
    caps = []
    spec_step = gen._spec_step

    def record(active):
        caps.append(min(gen.spec, eng.cfg.seq_len - 1 - int(gen.pos[0])))
        return spec_step(active)

    if gen.spec:
        gen._spec_step = record
    while gen.n_active:
        gen.step()
    gen.close()
    assert len(r.tokens) == cap and gen.pos[0] == eng.cfg.seq_len
    return r.tokens, caps


def test_near_cap_greedy_slot_clamps_lens_instead_of_retiring(engine, solo):
    """A slot within K+1 positions of seq_len keeps decoding at a clamped
    draft length to the very last row, and its tokens equal the JAX solo
    engine's."""
    toks, caps = _to_the_cap(engine, 0.0)
    assert toks == solo("hello hello hello hello", len(toks))
    assert caps[-1] < engine.spec_lookup  # the tail ran clamped widths


def test_near_cap_sampled_slot_matches_spec_off(engine, files, solo):
    """The same at temperature 0.9, held against the port's generator with
    speculation off, and against the JAX solo engine up to their first
    departure, which must be the top-p boundary case of ROADMAP C6 (these
    89 sampled tokens part from JAX's at token 26 with or without
    speculation: on the same logits and coin the JAX sampler's f32
    cumulative sum crosses top-p one token later than the port's and than
    a float64 sum, on a near-flat distribution whose nucleus holds 213 of
    268 tokens)."""
    toks, caps = _to_the_cap(engine, 0.9)
    plain = InferenceEngine(*files, device="cpu", kv_block_size=16)
    try:
        want, _ = _to_the_cap(plain, 0.9)
    finally:
        plain.close()
    assert toks == want and caps[-1] < engine.spec_lookup
    prompt = _enc(engine, "hello hello hello hello")
    jax_tokens = solo(prompt, len(toks), temperature=0.9, seed=13)
    _assert_topp_boundary_departure(solo.engine, prompt, toks, jax_tokens, 0.9, 0.9, 13)



def test_reservation_prices_verify_frontier(engine):
    gen = PagedGenerator(engine, n_slots=2)
    bs = gen.block_size
    assert gen._worst_case_blocks(10, 8) == -(-(10 - 1 + 8 + 4) // bs)
    assert gen._worst_case_blocks(10, 8) >= -(-(10 - 1 + 8) // bs)
    assert gen._worst_case_blocks(10, 10_000) == -(-engine.cfg.seq_len // bs)


def test_api_spec_completion_matches_jax_batched_state(files):
    """``api --spec-lookup 4``: the greedy and the sampled completion texts
    equal the JAX ``BatchedApiState.complete`` on the same files (built
    without speculation: spec-on output equals spec-off output), on one
    device (``tp=1``, as the port runs; under the test suite's 8 virtual
    devices the JAX engine's default tensor parallelism sums in another
    order, which the Q80 casts widen enough to change the sampled body's
    second token)."""
    from dllama_tpu.serve.api import BatchedApiState

    m, t = files
    started, box = threading.Event(), {}

    def on_listening(srv, state):
        box["server"], box["state"] = srv, state
        started.set()

    th = threading.Thread(target=lambda: box.setdefault("rc", cli.main(
        ["api", "--model", m, "--tokenizer", t, "--device", "cpu", "--batch-slots", "2",
         "--kv-block-size", "16", "--spec-lookup", "4", "--port", "0",
         "--temperature", "0", "--seed", "3"], on_listening=on_listening)), daemon=True)
    th.start()
    assert started.wait(timeout=120), "server did not start"
    url = f"http://127.0.0.1:{box['server'].server_address[1]}/v1/chat/completions"
    bodies = [{"messages": [{"role": "user", "content": "hello hello hello"}],
               "max_tokens": 12, "temperature": 0},
              {"messages": [{"role": "user", "content": "abcabc"}],
               "max_tokens": 10, "temperature": 0.8, "seed": 17}]
    try:
        assert box["state"].sched.gen.spec == 4
        got = []
        for body in bodies:
            req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                got.append(json.loads(r.read())["choices"][0]["message"]["content"])
    finally:
        box["server"].shutdown()
        th.join(timeout=60)
    assert not th.is_alive() and box["rc"] == 0
    # the CLI's buffers (Q80)
    jeng = JaxEngine(m, t, tp=1, sync_type=Q80, temperature=0.0, seed=3)
    jstate = BatchedApiState(jeng, n_slots=2)
    try:
        want = [jstate.complete(dict(body))["text"] for body in bodies]
    finally:
        jstate.close()
        jeng.close()
    assert got == want and all(got)
