"""The port's tiered KV memory (``--kv-host-blocks``: the host tier of
``runtime/kvblocks.py`` and ``HostKVMirror`` under ``PagedGenerator``),
mirroring ``tests/test_kvtier.py`` case for case on the tiny model (vocab
268, seq_len 96, block size 16):

1. the engine's ``--kv-host-blocks`` validation;
2. the round trip: a spilled block's device bytes, its host lane and its
   paged-in device bytes are equal bit for bit (f32 pool, and an e4m3 pool
   through its bytes);
3. the capacity proof: 12 idle sessions' KV through a 16-block device pool
   with the tier, then resumes — no exhaustion, no requeue, every resumed
   transcript token-equal to a never-spilled solo run (the JAX engine) and
   to the JAX package's tiered scheduler on the same files;
4. the ``pagein`` TTFT phase, its histogram and span;
5. a resume whose match spans both tiers under a dry free list pins its
   device-resident matches first;
6. the chunk-accounted host budget under fragmentation;
7. crash reset clears the host tier;

plus the ``spill`` failpoint (drop-evict, the resume recomputes, equal
tokens) and the ``pagein`` failpoint (only the resuming request fails,
503-shaped; a bystander keeps decoding; the retry pages in and matches),
and the host slab's bytes against the budget at a depth and a KV-head count
that are not powers of two. Token ids compare exactly."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dllama_tpu.formats import tfile
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu.runtime.serving import BatchScheduler as JaxScheduler
from dllama_tpu_torch.runtime import failpoints, flightrec
from dllama_tpu_torch.runtime import telemetry as tm
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.kvcache import cache_bits
from dllama_tpu_torch.runtime.serving import BatchScheduler, PagedGenerator, Request

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model

PATHS: dict[str, str] = {}
BLOCK = 16


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.registry().clear()
    yield
    failpoints.registry().clear()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_kvtier")
    mpath, tpath = d / "m.m", d / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=96),
                     np.random.default_rng(41))
    tfile.write_tfile(tpath, byte_vocab_tokenizer())
    PATHS["m"], PATHS["t"] = str(mpath), str(tpath)
    return PATHS


@pytest.fixture(scope="module")
def tiered_engine(files):
    eng = InferenceEngine(files["m"], files["t"], device="cpu", kv_block_size=BLOCK,
                          kv_host_blocks=64)
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def solo(files):
    """The never-spilled oracle: a JAX single-sequence engine, reset per run."""
    eng = JaxEngine(files["m"], files["t"], tp=1)

    def run(prompt, n):
        eng.reset()
        return eng.generate(prompt, n, stop_on_eos=False).tokens

    yield run
    eng.close()


def _enc(engine, text):
    return engine.tokenizer.encode(text, is_start=True)


def _session_text(i: int) -> str:
    """A distinct 33-char session prompt: 2 full blocks + a tail of
    prefill-built context, so ~12 sessions exceed a 16-block pool."""
    return "".join(chr(97 + (i + j) % 26) for j in range(33))


def _run(sched, req, ticks=800):
    for _ in range(ticks):
        sched._tick()
        if req.done.is_set():
            return
    raise AssertionError(f"request {req.rid} never finished")


def _finish(gen):
    while gen.n_active:
        gen.step()


def test_engine_validates_host_blocks_need_block_size(files):
    with pytest.raises(ValueError, match="--kv-host-blocks"):
        InferenceEngine(files["m"], files["t"], device="cpu", kv_host_blocks=8)


@pytest.mark.parametrize("kv_dtype", ["auto", "f8"])
def test_spill_pagein_roundtrip_is_bit_exact(files, kv_dtype):
    """Tier traffic is copies: device bytes -> host lane -> paged-in device
    bytes, equal bit for bit (an e4m3 pool moves its bytes); the pool is
    written in place (its storage never moves)."""
    eng = InferenceEngine(files["m"], files["t"], device="cpu", kv_block_size=BLOCK,
                          kv_host_blocks=64, kv_dtype=kv_dtype)
    try:
        gen = PagedGenerator(eng, n_slots=2)
        assert gen.mirror is not None and gen.mirror.kind == "cpu"
        ptr = gen.pkv.k.data_ptr()
        r = Request(rid=0, prompt_ids=_enc(eng, _session_text(0)), max_tokens=2,
                    stop_on_eos=False)
        gen.admit(r, 0)
        _finish(gen)
        sh, n, _, _ = gen.pool.match_prefix(r.prompt_ids[:-1])
        assert n >= BLOCK and not gen.pool.is_host(sh[0])
        bid = sh[0]
        before = [cache_bits(p)[:, bid].clone() for p in gen.pkv]
        assert before[0].any(), "the block holds real context rows"
        taken = []
        while gen.pool._cached:  # pressure: the cached blocks spill
            taken.append(gen.pool.alloc())
        sh2, n2, _, _ = gen.pool.match_prefix(r.prompt_ids[:-1])
        assert n2 == n and gen.pool.is_host(sh2[0])
        assert gen.pool.host_used_blocks() > 0
        for lane, want in zip(gen.mirror.lane(sh2[0]), before):
            assert torch.equal(lane, want)
        for b in taken[:2]:
            gen.pool.release(b)
        pairs = gen.pool.begin_pagein([sh2[0]])
        gen.mirror.load(gen.pkv, pairs)
        gen.pool.commit_pagein(pairs)
        dev = pairs[0][1]
        for p, want in zip(gen.pkv, before):
            assert torch.equal(cache_bits(p)[:, dev], want)
        sh3, n3, _, _ = gen.pool.match_prefix(r.prompt_ids[:-1])
        assert sh3[0] == dev and n3 == n
        assert gen.pkv.k.data_ptr() == ptr
    finally:
        eng.close()


def _jax_tiered_resumes(files, idle, resumes, n_tok):
    """The same idle wave and resumes through the JAX package's tiered
    scheduler: the resumed transcripts."""
    eng = JaxEngine(files["m"], files["t"], tp=1, kv_block_size=BLOCK, kv_host_blocks=64)
    try:
        sched = JaxScheduler(eng, n_slots=2, _start_thread=False)
        for txt in idle:
            _run(sched, sched.submit(_enc(eng, txt), 4, stop_on_eos=False))
        out = []
        for txt in resumes:
            r = sched.submit(_enc(eng, txt), n_tok, stop_on_eos=False)
            _run(sched, r)
            out.append(r.tokens)
        sched.close()
        return out
    finally:
        eng.close()


def test_capacity_proof_idle_resume_stream(tiered_engine, files, solo):
    """12 idle sessions' KV (~36 blocks) through a 16-block device pool with
    the tier, then resumes: no exhaustion, no requeue, resumed transcripts
    equal to never-spilled solo runs and to the JAX tiered scheduler's,
    spills and host occupancy observed mid-run, no graph captured anew."""
    flightrec.recorder().reset()
    reg = tm.registry()
    exh0 = reg.counter(tm.KV_BLOCK_EXHAUSTION).total()
    spill0 = reg.counter(tm.KV_SPILL_BLOCKS).total()
    pagein0 = reg.counter(tm.KV_PAGEIN_BLOCKS).total()
    sched = BatchScheduler(tiered_engine, n_slots=2, _start_thread=False)
    gen = sched.gen
    assert gen.pool.n_blocks - 1 == 16 and gen.pool.n_host_blocks == 64
    idle = [_session_text(i) for i in range(12)]
    resumes = [_session_text(i) + " and then" for i in (2, 5, 8, 11)]
    try:
        graph = gen.step_graph()
        ptr = gen.pkv.k.data_ptr()
        for txt in idle:
            r = sched.submit(_enc(tiered_engine, txt), 4, stop_on_eos=False)
            _run(sched, r)
            assert r.error is None, r.error
        assert reg.counter(tm.KV_SPILL_BLOCKS).total() > spill0
        assert reg.gauge(tm.KV_BLOCKS_HOST_USED).value() > 0
        got = []
        for txt in resumes:
            r = sched.submit(_enc(tiered_engine, txt), 6, stop_on_eos=False)
            _run(sched, r)
            assert r.error is None, r.error
            assert r.tokens == solo(txt, 6), f"resume {txt!r} diverged from solo"
            got.append(r.tokens)
        assert reg.counter(tm.KV_PAGEIN_BLOCKS).total() > pagein0
        assert reg.counter(tm.KV_BLOCK_EXHAUSTION).total() == exh0
        events = flightrec.recorder().snapshot()["events"]
        assert not [e for e in events if e["event"] == "requeue"]
        assert [e for e in events if e["event"] == "spill"]
        assert [e for e in events if e["event"] == "pagein"]
        trace = flightrec.to_chrome_trace(flightrec.recorder().snapshot())
        assert not flightrec.validate_chrome_trace(trace)
        assert [e for e in trace["traceEvents"] if e.get("name") == "kv_blocks"
                and "host_used" in e.get("args", {})]
        assert gen.step_graph() is graph and gen.pkv.k.data_ptr() == ptr
    finally:
        sched.close()
    assert got == _jax_tiered_resumes(files, idle, resumes, 6)


def test_resume_carries_pagein_ttft_phase(tiered_engine):
    """A resumed session's TTFT has a nonzero ``pagein`` phase, the phases
    sum to wall TTFT, and the phase lands in ``dllama_ttft_attrib_ms`` and
    the span ring."""
    h = tm.registry().histogram(tm.TTFT_ATTRIB_MS)
    p0 = h.count(phase="pagein")
    sched = BatchScheduler(tiered_engine, n_slots=2, _start_thread=False)
    try:
        texts = [_session_text(13 + i) for i in range(10)]
        for txt in texts:
            _run(sched, sched.submit(_enc(tiered_engine, txt), 4, stop_on_eos=False))
        sh, _, _, _ = sched.gen.pool.match_prefix(_enc(tiered_engine, texts[0])[:-1])
        assert any(sched.gen.pool.is_host(b) for b in sh), "the session spilled"
        r = sched.submit(_enc(tiered_engine, texts[0] + " resume"), 4, stop_on_eos=False)
        _run(sched, r)
        assert r.error is None
        bd = r.ttft_breakdown()
        assert bd["pagein_ms"] > 0
        total = (bd["queue_ms"] + bd["kvmigrate_ms"] + bd["pagein_ms"] + bd["admission_ms"]
                 + bd["prefill_ms"] + bd["first_decode_ms"])
        assert abs(total - bd["ttft_ms"]) <= 1e-6 * max(1.0, bd["ttft_ms"])
        assert h.count(phase="pagein") > p0
        spans = [s for s in tm.tracer().raw_spans()
                 if s["phase"] == "pagein" and s["request_id"] == r.rid]
        assert spans and spans[0]["n_tokens"] > 0
    finally:
        sched.close()


def test_mixed_tier_resume_under_pressure_pins_matched_blocks(files, solo):
    """A resume whose match spans both tiers under a dry free list, the
    matched DEVICE block at the LRU end of the cached list: begin_admit
    pins it before the page-in's allocations resolve pressure, so the
    eviction takes the unmatched cached blocks and the resume completes
    token-exact."""
    eng = InferenceEngine(files["m"], files["t"], device="cpu", kv_block_size=BLOCK,
                          kv_host_blocks=2)
    try:
        sched = BatchScheduler(eng, n_slots=2, _start_thread=False)
        gen = sched.gen
        assert gen.pool.n_host_blocks == 2
        a_text = _session_text(50)
        for text in (a_text, _session_text(60)):  # A idles first (LRU)
            r = sched.submit(_enc(eng, text), 2, stop_on_eos=False)
            _run(sched, r)
            assert r.error is None
        taken = []
        while gen.pool._free:
            taken.append(gen.pool.alloc())
        taken.append(gen.pool.alloc())  # one spill: A's blocks fill the 2 lanes
        while gen.pool._free:
            taken.append(gen.pool.alloc())
        ids_a = _enc(eng, a_text + " back")
        shared, n, cow, cow_r = gen.pool.match_prefix(ids_a[:-1])
        assert any(gen.pool.is_host(b) for b in shared)
        dev_matched = [b for b in shared if not gen.pool.is_host(b)]
        assert dev_matched and cow is not None and cow_r > 0
        assert dev_matched[0] == next(iter(gen.pool._cached)), \
            "scenario: the matched device block must be the LRU"
        assert not gen.pool._free and gen.pool._cached
        resume = sched.submit(ids_a, 4, stop_on_eos=False)
        _run(sched, resume)
        assert resume.error is None, resume.error
        assert resume.tokens == solo(a_text + " back", 4)
        sched.close()
    finally:
        eng.close()


def test_host_budget_is_chunk_accounted_under_fragmentation(files):
    """Mirror chunks are SPILL_BATCH blocks of host RAM whether or not every
    lane is live: under fragmentation a new spill first drains the host LRU
    until the fragmented chunk frees, and resident chunks never exceed the
    budget."""
    eng = InferenceEngine(files["m"], files["t"], device="cpu", kv_block_size=BLOCK,
                          kv_host_blocks=4)  # exactly ONE chunk of budget
    try:
        gen = PagedGenerator(eng, n_slots=2)
        assert gen.mirror.max_chunks == 1 and len(gen.mirror._idle) == 1
        r = Request(rid=0, prompt_ids=_enc(eng, _session_text(70)), max_tokens=2,
                    stop_on_eos=False)
        gen.admit(r, 0)
        _finish(gen)
        taken = []
        while gen.pool._free:
            taken.append(gen.pool.alloc())
        taken.append(gen.pool.alloc())  # spills A's cold blocks: one chunk
        assert len(gen.mirror._chunks) == 1
        spilled = list(gen.pool._host_cached)
        assert spilled
        gen.pool.release(taken.pop())
        pairs = gen.pool.begin_pagein(spilled[:1])
        gen.mirror.load(gen.pkv, pairs)
        gen.pool.commit_pagein(pairs)
        gen.pool.release(pairs[0][1])
        assert gen.pool._host_cached, "the chunk keeps live lanes"
        assert len(gen.mirror._chunks) == 1  # fragmented, still resident
        assert gen.pool._host_free, "lanes freed pool-side"
        s0 = tm.registry().counter(tm.KV_SPILL_BLOCKS).total()
        r2 = Request(rid=1, prompt_ids=_enc(eng, _session_text(80)), max_tokens=2,
                     stop_on_eos=False)
        gen.admit(r2, 1)
        _finish(gen)
        while gen.pool._free:
            taken.append(gen.pool.alloc())
        taken.append(gen.pool.alloc())  # pressure again
        assert len(gen.mirror._chunks) <= 1, "budget overshot by a chunk"
        assert tm.registry().counter(tm.KV_SPILL_BLOCKS).total() > s0
        assert len(gen.mirror._idle) + len(gen.mirror._chunks) == 1  # no new buffer
    finally:
        eng.close()


def test_host_slab_bytes_equal_the_budget_at_odd_depth(tmp_path, monkeypatch):
    """At a depth and a KV-head count that are not powers of two the mirror
    holds exactly the bytes ``fit_host_pool`` granted: one slab, every chunk
    a view of it, nothing rounded up (a per-chunk ``pin_memory`` allocation
    would round each chunk to a power of two)."""
    from dllama_tpu_torch.runtime.hbm import estimate_block_pool_bytes
    from dllama_tpu_torch.runtime.kvblocks import SPILL_BATCH

    mpath, tpath = tmp_path / "m.m", tmp_path / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=96, dim=96,
                                               n_layers=3, n_heads=6, n_kv_heads=3),
                     np.random.default_rng(43))
    tfile.write_tfile(tpath, byte_vocab_tokenizer())
    eng = InferenceEngine(str(mpath), str(tpath), device="cpu", kv_block_size=BLOCK,
                          kv_host_blocks=40)
    try:
        per_block = estimate_block_pool_bytes(eng.cfg, 1, BLOCK, eng.kv_dtype.itemsize)
        budget = 9 * per_block + per_block // 2  # grants 8 blocks: two chunks
        monkeypatch.setenv("DLLAMA_HOST_KV_BYTES", str(budget))
        gen = PagedGenerator(eng, n_slots=2)
        assert gen.pool.n_host_blocks == 2 * SPILL_BATCH
        assert gen.mirror.host_bytes == gen.pool.n_host_blocks * per_block <= budget
        bufs = gen.mirror._idle
        assert len(bufs) == 2
        base = bufs[0].k.untyped_storage().data_ptr()
        assert all(t.untyped_storage().data_ptr() == base for b in bufs for t in (b.k, b.v))
        assert sum(t.nbytes for b in bufs for t in (b.k, b.v)) == gen.mirror.host_bytes
    finally:
        eng.close()


def test_scheduler_crash_reset_clears_host_tier(tiered_engine):
    """reset_state forgets the host tier (pool lanes AND mirror chunks) with
    everything else; the host buffers go back to the idle list."""
    gen = PagedGenerator(tiered_engine, n_slots=2)
    n_bufs = len(gen.mirror._idle)
    r = Request(rid=0, prompt_ids=_enc(tiered_engine, _session_text(40)), max_tokens=2,
                stop_on_eos=False)
    gen.admit(r, 0)
    _finish(gen)
    while gen.pool._cached:
        gen.pool.alloc()
    assert gen.pool.host_used_blocks() > 0 and gen.mirror._chunks
    gen.reset_state()
    assert gen.pool.host_used_blocks() == 0
    assert not gen.mirror._chunks and not gen.mirror._where
    assert len(gen.mirror._idle) == n_bufs


def test_spill_failpoint_degrades_to_drop_evict(tiered_engine, solo):
    """``spill:raise`` on every spill: the pool drop-evicts (no host block
    used, ``spill_failed`` on the tick record), the resume recomputes its
    prefix and its tokens equal the never-spilled run."""
    flightrec.recorder().reset()
    reg = tm.registry()
    s0 = reg.counter(tm.KV_SPILL_BLOCKS).total()
    sched = BatchScheduler(tiered_engine, n_slots=2, _start_thread=False)
    try:
        failpoints.arm("spill", "raise")
        for i in range(12):
            r = sched.submit(_enc(tiered_engine, _session_text(30 + i)), 4, stop_on_eos=False)
            _run(sched, r)
            assert r.error is None
        assert reg.counter(tm.KV_SPILL_BLOCKS).total() == s0
        assert sched.gen.pool.host_used_blocks() == 0
        events = flightrec.recorder().snapshot()["events"]
        assert [e for e in events if e["event"] == "spill_failed"]
        txt = _session_text(30) + " again"
        r = sched.submit(_enc(tiered_engine, txt), 6, stop_on_eos=False)
        _run(sched, r)
        assert r.error is None and r.tokens == solo(txt, 6)
        assert r.ttft_breakdown()["pagein_ms"] == 0
    finally:
        sched.close()


def test_pagein_failpoint_fails_only_the_resume(tiered_engine, solo):
    """``pagein:raise:1``: the resuming request fails 503-shaped
    (``server_error``, PageInError) while a bystander stream keeps
    decoding; the host content stays registered, and a retry of the same
    session pages in and equals the never-spilled run."""
    sched = BatchScheduler(tiered_engine, n_slots=2, _start_thread=False)
    try:
        texts = [_session_text(3 + 2 * i) for i in range(10)]
        for txt in texts:
            _run(sched, sched.submit(_enc(tiered_engine, txt), 4, stop_on_eos=False))
        ids = _enc(tiered_engine, texts[0] + " resume")
        sh, _, _, _ = sched.gen.pool.match_prefix(ids[:-1])
        assert any(sched.gen.pool.is_host(b) for b in sh)
        bystander = sched.submit(_enc(tiered_engine, "bystander text here"), 20,
                                 stop_on_eos=False)
        while not sched.gen.n_active:
            sched._tick()
        failpoints.arm("pagein", "raise", times=1)
        r = sched.submit(ids, 4, stop_on_eos=False)
        _run(sched, r)
        assert r.error and "PageInError" in r.error and r.server_error
        assert not bystander.done.is_set() or bystander.error is None
        _run(sched, bystander)
        assert bystander.error is None and len(bystander.tokens) == 20
        # the host content stays registered under the same host ids
        assert sched.gen.pool.match_prefix(ids[:-1])[0] == sh
        retry = sched.submit(ids, 4, stop_on_eos=False)
        _run(sched, retry)
        assert retry.error is None
        assert retry.tokens == solo(texts[0] + " resume", 4)
        assert retry.ttft_breakdown()["pagein_ms"] > 0
    finally:
        sched.close()


def test_failed_tier_warmup_fails_the_start(files, monkeypatch, tmp_path):
    """A tier that was asked for is never quietly absent: a host buffer that
    cannot be allocated fails the generator's construction (the JAX
    generator serves untiered instead), and the CLI's ``api`` exits with
    it."""
    from dllama_tpu_torch.runtime.kvblocks import HostKVMirror
    from dllama_tpu_torch.serve import cli

    def no_memory(self):
        raise MemoryError("pinned host allocation refused")

    monkeypatch.setattr(HostKVMirror, "_alloc_slab", no_memory)
    eng = InferenceEngine(files["m"], files["t"], device="cpu", kv_block_size=BLOCK,
                          kv_host_blocks=8)
    try:
        with pytest.raises(MemoryError, match="pinned host"):
            PagedGenerator(eng, n_slots=2)
    finally:
        eng.close()
    td = byte_vocab_tokenizer()
    td.chat_template = "<|start_header_id|>"  # the api needs a chat template
    tfile.write_tfile(tmp_path / "chat.t", td)
    with pytest.raises(MemoryError, match="pinned host"):
        cli.main(["api", "--model", files["m"], "--tokenizer", str(tmp_path / "chat.t"),
                  "--device", "cpu",
                  "--batch-slots", "2", "--kv-block-size", "16", "--kv-host-blocks", "8",
                  "--port", "0"])
