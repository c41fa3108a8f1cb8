"""The port's continuous batching (``PagedGenerator``/``BatchScheduler``)
on the tiny model of ``tests/test_kvblocks.py`` (vocab 268, seq_len 96,
block size 16), held against the JAX package's single-sequence engine on
the same files: every transcript token for token, greedy and sampled.
Ports the acceptance tests of ``tests/test_kvblocks.py`` — a continuous
stream of 6 requests through 2 slots, live block sharing with
copy-on-write isolation, lazy growth, a fully shared prompt, the
mid-admission ride-along, no organic exhaustion, atomic rollback, cancel
mid-admission — plus deadlines, ``max_queue`` shedding, ``close`` and
crash supervision. Token ids compare exactly."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from dllama_tpu.formats import tfile
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.kvblocks import BlockPool
from dllama_tpu_torch.runtime.serving import (BatchScheduler, PagedGenerator,
                                              QueueFullError, Request,
                                              SchedulerUnavailableError)

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model

PATHS: dict[str, str] = {}


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serving")
    mpath, tpath = d / "m.m", d / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=96),
                     np.random.default_rng(41))
    tfile.write_tfile(tpath, byte_vocab_tokenizer())
    PATHS["m"], PATHS["t"] = str(mpath), str(tpath)
    eng = InferenceEngine(str(mpath), str(tpath), device="cpu", kv_block_size=16)
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def solo(engine):
    """The oracle: one JAX single-sequence engine on the same files, reset
    and re-seeded per transcript (a fresh solo run each time)."""
    eng = JaxEngine(PATHS["m"], PATHS["t"], tp=1)

    def run(prompt, n, temperature=0.0, seed=7):
        eng.reset()
        eng.sampler.set_temp(temperature)
        eng.sampler.set_seed(seed)
        return eng.generate(prompt, n, stop_on_eos=False).tokens

    yield run
    eng.close()


def _enc(engine, text):
    return engine.tokenizer.encode(text, is_start=True)


def test_continuous_stream_exceeds_slot_capacity_token_exact(engine, solo):
    """6 mixed greedy/sampled requests through 2 slots: sequences admit and
    retire mid-batch, and every transcript equals the JAX solo run."""
    prompts = ["hello world", "hello there", "abc",
               "hello world how are you", "xyzzy", "hello hello hello"]
    specs = [dict(temperature=0.0, seed=1), dict(temperature=0.8, seed=2),
             dict(temperature=0.0, seed=3), dict(temperature=1.2, seed=4),
             dict(temperature=0.0, seed=5), dict(temperature=0.6, seed=6)]
    want = [solo(p, 8, **s) for p, s in zip(prompts, specs)]
    sched = BatchScheduler(engine, n_slots=2)
    try:
        reqs = [sched.submit(_enc(engine, p), 8, stop_on_eos=False,
                             temperature=s["temperature"], seed=s["seed"])
                for p, s in zip(prompts, specs)]
        for r in reqs:
            assert r.done.wait(timeout=300)
            assert r.error is None, r.error
        for r, w, p in zip(reqs, want, prompts):
            assert r.tokens == w, p
            assert r.t_first_token >= r.t_submit > 0
        # two prompts share "hello world"'s first block: reuse happened
        assert sched.gen.reused_tokens > 0
    finally:
        sched.close()
    assert sched.gen.pool.used_blocks() == 0


def test_block_sharing_live_and_cow_write_isolation(engine, solo):
    """A second live sequence with a >= 1-block common prefix shares the
    physical blocks, the shared bytes are never rewritten, and both
    transcripts stay solo-exact."""
    base = "abcdefghijklmnopqrstuvwxy "
    want_a, want_b = solo(base + "111", 6), solo(base + "222", 6)
    gen = PagedGenerator(engine, n_slots=2)
    r_a = Request(rid=0, prompt_ids=_enc(engine, base + "111"), max_tokens=6,
                  stop_on_eos=False)
    gen.admit(r_a, 0)
    gen.step()  # r_a live and decoding; its prompt blocks are registered
    ids_b = _enc(engine, base + "222")
    n_common = next(i for i, (x, y) in enumerate(zip(ids_b, r_a.prompt_ids)) if x != y)
    assert n_common >= gen.block_size
    c0 = gen.reused_tokens
    r_b = Request(rid=1, prompt_ids=ids_b, max_tokens=6, stop_on_eos=False)
    gen.admit(r_b, 1)
    assert gen.pool.shared_blocks() > 0
    assert gen.reused_tokens - c0 >= n_common
    shared = [b for b in gen._seq_bids[1] if gen.pool.refcount(b) > 1]
    assert shared
    before = gen.pkv.k[:, shared[0]].clone()
    while gen.n_active:
        gen.step()
    assert torch.equal(before, gen.pkv.k[:, shared[0]])
    assert r_a.tokens == want_a
    assert r_b.tokens == want_b


def test_mid_decode_block_growth_is_lazy(engine):
    """A sequence only holds the blocks its live context spans: decoding
    across a block boundary allocates exactly one more block, there."""
    gen = PagedGenerator(engine, n_slots=2)
    r = Request(rid=0, prompt_ids=_enc(engine, "hello w"), max_tokens=24,
                stop_on_eos=False)
    gen.admit(r, 0)
    assert len(gen._seq_bids[0]) == 1
    grew_at = None
    while gen.n_active:
        pos_before, blocks_before = int(gen.pos[0]), len(gen._seq_bids[0])
        gen.step()
        if gen.n_active and len(gen._seq_bids[0]) > blocks_before:
            assert grew_at is None, "grew more than once before row 32"
            grew_at = pos_before
    assert grew_at is not None and grew_at % gen.block_size == 0


def test_fully_shared_prompt_skips_prefill_and_stays_token_exact(engine):
    """Resubmitting an identical prompt reuses every prefill position — no
    column gather, no prefill — and decodes the same tokens."""
    gen = PagedGenerator(engine, n_slots=2)
    ids = _enc(engine, "abcdefghijklmnopqrstuvwxy!")
    r_a = Request(rid=0, prompt_ids=ids, max_tokens=6, stop_on_eos=False)
    gen.admit(r_a, 0)
    while gen.n_active:
        gen.step()
    c0 = gen.reused_tokens
    r_b = Request(rid=1, prompt_ids=list(ids), max_tokens=6, stop_on_eos=False)
    adm = gen.begin_admit(r_b, 1)
    assert adm.col is None and adm.pos == len(ids) - 1
    assert gen.reused_tokens - c0 == len(ids) - 1
    assert gen.continue_admit(adm)
    while gen.n_active:
        gen.step()
    assert r_b.tokens == r_a.tokens


def test_mid_admission_ride_along_never_writes_shared_blocks(engine, solo):
    """The slot's table stays all-null until the admission commits: a slot
    mid-admission rides along decode steps with its previous occupant's
    stale position, and that write lands in the null block."""
    base = "abcdefghijklmnopqrstuvwxy "
    want_a, want_b = solo(base + "111", 8), solo(base + "222", 6)
    gen = PagedGenerator(engine, n_slots=2)
    r0 = Request(rid=0, prompt_ids=_enc(engine, "hi"), max_tokens=12, stop_on_eos=False)
    gen.admit(r0, 1)
    while gen.n_active:
        gen.step()
    assert 0 < int(gen.pos[1]) < gen.block_size  # stale pos inside block 0
    r_a = Request(rid=1, prompt_ids=_enc(engine, base + "111"), max_tokens=8,
                  stop_on_eos=False)
    gen.admit(r_a, 0)
    gen.step()
    r_b = Request(rid=2, prompt_ids=_enc(engine, base + "222"), max_tokens=6,
                  stop_on_eos=False)
    adm = gen.begin_admit(r_b, 1)
    shared = [b for b in gen._seq_bids[1] if gen.pool.refcount(b) > 1]
    assert shared and (gen.tables[1] == gen.pool.NULL).all()
    before = gen.pkv.k[:, shared[0]].clone()
    gen.step()  # slot 1 rides along with its stale pos mid-admission
    assert torch.equal(before, gen.pkv.k[:, shared[0]])
    while not gen.continue_admit(adm):
        gen.step()
    while gen.n_active:
        gen.step()
    assert r_a.tokens == want_a
    assert r_b.tokens == want_b


def test_admission_reserves_decode_growth_no_organic_exhaustion(engine):
    """Every live sequence's worst-case growth stays reserved: a second
    request that would double-spend the same free blocks queues instead of
    admitting, and nobody runs dry mid-decode."""
    sched = BatchScheduler(engine, n_slots=2, _start_thread=False)
    try:
        # 9 allocatable blocks (< two 6-block worst cases); ids 1..9 stay
        # valid indices into the larger device pool
        sched.gen.pool = BlockPool(10, sched.gen.block_size)
        ids = _enc(engine, "hello wor")  # rest 9 -> 1 block held
        r1 = sched.submit(ids, 85, stop_on_eos=False)  # 94 rows -> 6 blocks
        r2 = sched.submit(list(ids), 85, stop_on_eos=False)
        max_active = 0
        for _ in range(500):
            sched._tick()
            max_active = max(max_active, sched.gen.n_active)
            if r1.done.is_set() and r2.done.is_set():
                break
        assert r1.error is None and r2.error is None
        assert len(r1.tokens) == 85 and len(r2.tokens) == 85
        assert max_active == 1  # the second request queued
    finally:
        sched.close()


def test_begin_admit_rolls_back_blocks_on_any_failure(engine):
    """A device error mid-admission releases every block taken."""
    gen = PagedGenerator(engine, n_slots=2)
    free0 = gen.pool.free_blocks()

    def boom(*a):
        raise RuntimeError("device boom")

    gen._exec_take = boom
    r = Request(rid=0, prompt_ids=_enc(engine, "hello world"), max_tokens=4,
                stop_on_eos=False)
    with pytest.raises(RuntimeError, match="device boom"):
        gen.begin_admit(r, 0)
    assert gen.pool.free_blocks() == free0
    del gen._exec_take  # the class method again
    gen.admit(r, 0)
    while gen.n_active:
        gen.step()
    assert len(r.tokens) == 4


def test_cancelled_mid_admission_releases_blocks(engine):
    """A client cancel between prefill chunks aborts the admission and
    returns its blocks."""
    sched = BatchScheduler(engine, n_slots=2, _start_thread=False)
    try:
        free0 = sched.gen.pool.free_blocks()
        ids = [int(x) for x in np.random.default_rng(9).integers(1, 200, 80)]
        req = sched.submit(ids, 8, stop_on_eos=False)
        sched._tick()
        assert sched._admissions
        assert sched.gen.pool.free_blocks() < free0
        req.cancel.set()
        sched._tick()
        assert req.done.is_set() and not sched._admissions
        assert sched.gen.pool.free_blocks() == free0
    finally:
        sched.close()


def test_deadlines_queued_and_in_flight(engine):
    """A queued request past its deadline fails at the next tick; an
    in-flight one is cancelled at the next step boundary with partial
    output; both are marked timed out."""
    sched = BatchScheduler(engine, n_slots=2, _start_thread=False)
    try:
        ids = _enc(engine, "hello")
        queued = sched.submit(ids, 8, timeout_s=1e-3, stop_on_eos=False)
        time.sleep(0.01)
        sched._tick()
        assert queued.done.is_set() and queued.timed_out and not queued.tokens
        live = sched.submit(ids, 60, timeout_s=0.5, stop_on_eos=False)
        while not live.tokens:
            sched._tick()
        time.sleep(0.6)
        for _ in range(3):
            sched._tick()
        assert live.done.is_set() and live.timed_out
        assert 0 < len(live.tokens) < 60 and live.error is None
    finally:
        sched.close()


def test_max_queue_sheds_and_close_fails_waiters(engine):
    sched = BatchScheduler(engine, n_slots=2, max_queue=2, _start_thread=False)
    ids = _enc(engine, "hello")
    a = sched.submit(ids, 4)
    b = sched.submit(ids, 4)
    with pytest.raises(QueueFullError):
        sched.submit(ids, 4)
    assert sched.readiness() == (False, "queue full (shedding)", "queue_full")
    sched.close()
    for r in (a, b):
        assert r.done.is_set() and r.server_error
        assert r.error == "server shutting down"
    with pytest.raises(SchedulerUnavailableError):
        sched.submit(ids, 4)


def test_crash_fails_waiters_then_restarts(engine):
    """Supervision: a step that raises fails the in-flight request (server
    error), resets the pool, and the loop keeps serving."""
    sched = BatchScheduler(engine, n_slots=2)
    real_step = sched.gen.step
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("device lost")
        return real_step()

    sched.gen.step = flaky
    try:
        ids = _enc(engine, "hello")
        first = sched.submit(ids, 4, stop_on_eos=False)
        assert first.done.wait(timeout=120)
        assert first.server_error and "device lost" in first.error
        second = sched.submit(ids, 4, stop_on_eos=False)
        assert second.done.wait(timeout=120)
        assert second.error is None and len(second.tokens) == 4
        assert sched.is_alive() and sched.readiness()[0]
    finally:
        sched.close()
