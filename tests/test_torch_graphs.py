"""The captured decode steps of ``dllama_tpu_torch/runtime/graphs.py`` on the
CPU, against the eager steps and the JAX package's.

On the card a :class:`StepGraph` captures its body once and replays it; on
the CPU a replay runs the same body on the same static buffers, through the
plain versions. So these tests hold what the graph holds: the step written
for capture (positions as ``[1]``/``[B]`` device tensors, the picked token
fed back into the static input on the device, the coins read from a static
table) against the eager step called by name with an int position, and
against the JAX ``greedy_steps``/``sampled_steps``/``forward``. Whether the
capture itself succeeds is a question for the card: ``chip_smoke.py``'s
``graphs`` phase.

``test_no_readback_in_the_step_body`` runs each body with
``Tensor.item/tolist/cpu/numpy`` (and ``bool``/``int``/``float`` of a
tensor) patched to raise. That is only a proxy for "nothing in the captured
step reads back to the host": the card's capture is the real test (a
synchronising call there fails the capture), and the smoke run's chunk
replays under ``torch.cuda.set_sync_debug_mode("error")``.

Tolerances are ``tests/test_torch_model.py``'s: 1e-4 absolute on O(1) f32
logits (the same math summed in another order), 3e-2 of max|logit| in
bf16. Token ids compare exactly."""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.formats import mfile as jax_mfile
from dllama_tpu.formats import tfile
from dllama_tpu.models import llama as jax_llama
from dllama_tpu.models.config import ModelConfig as JaxConfig
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu.runtime.kvcache import KVCache as JaxKVCache
from dllama_tpu_torch.formats import mfile
from dllama_tpu_torch.models import llama
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.graphs import DecodeGraph, StepGraph
from dllama_tpu_torch.runtime.kvcache import KVCache, update_layer
from dllama_tpu_torch.runtime.serving import PagedGenerator, Request

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model

F32_ATOL = 1e-4
BF16_RTOL = 3e-2
PROMPT = [5, 17, 3, 60, 41, 9]
N_STEPS = 16


def _configs(compute: str, sync_q80: bool = True):
    base = dict(arch=mfile.ArchType.LLAMA, rope_type=mfile.RopeType.LLAMA3_1,
                rope_scaling_factor=8.0, rope_scaling_low_freq_factor=1.0,
                rope_scaling_high_freq_factor=4.0, rope_scaling_orig_max_seq_len=64,
                dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                head_dim=16, vocab_size=96, seq_len=64, norm_epsilon=1e-5,
                rope_theta=10000.0, compute_dtype=compute, sync_q80=sync_q80)
    jkw = {k: (jax_mfile.RopeType(int(v)) if k == "rope_type" else
               jax_mfile.ArchType(int(v)) if k == "arch" else v)
           for k, v in base.items()}
    return ModelConfig(**base), JaxConfig(**jkw)


def _pair(cfg, jcfg, seed=0):
    jparams = jax_llama.init_random_params(jcfg, seed=seed, quantized=True)
    return jparams, llama.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), cfg)


def _prefilled(params, cfg):
    """A port cache holding ``PROMPT[:-1]`` (its last token seeds decode)."""
    kv = KVCache.create(cfg, dtype=getattr(torch, cfg.compute_dtype))
    llama.forward(params, cfg, torch.tensor([PROMPT[:-1]]), 0, kv)
    return kv


# -- update_layer -------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,T", [(1, 1), (3, 1), (3, 4)])
def test_update_layer_device_positions_bitwise(dtype, B, T):
    """The ``[1]``/``[B]`` tensor form (a device scatter along S) writes
    exactly what the int form writes: uniform positions against one int,
    ragged positions against per-row int writes."""
    rng = np.random.default_rng(10 * B + T)
    cache = torch.from_numpy(rng.standard_normal((B, 2, 32, 8)).astype(np.float32)).to(dtype)
    new_k, new_v = (torch.from_numpy(rng.standard_normal((B, T, 2, 8)).astype(np.float32))
                    for _ in range(2))
    want_k, want_v = cache.clone(), cache.clone()
    update_layer(want_k, want_v, new_k, new_v, 7)
    for pos in (torch.tensor([7], dtype=torch.int32), torch.full((B,), 7)):
        if pos.numel() != B:
            continue
        got_k, got_v = cache.clone(), cache.clone()
        update_layer(got_k, got_v, new_k, new_v, pos)
        assert torch.equal(got_k, want_k) and torch.equal(got_v, want_v)
    starts = [3, 11, 28 - T][:B]
    got_k, got_v = cache.clone(), cache.clone()
    update_layer(got_k, got_v, new_k, new_v, torch.tensor(starts, dtype=torch.int32))
    for b, s in enumerate(starts):
        row_k, row_v = cache[b:b + 1].clone(), cache[b:b + 1].clone()
        update_layer(row_k, row_v, new_k[b:b + 1], new_v[b:b + 1], s)
        assert torch.equal(got_k[b:b + 1], row_k) and torch.equal(got_v[b:b + 1], row_v)


# -- the single-sequence step -----------------------------------------------


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_decode_graph_matches_eager_and_jax(sampled):
    """16 steps through :class:`DecodeGraph`'s static buffers (one launch,
    one readback) pick the eager step's tokens (``greedy_step`` /
    ``sampled_step`` by name, int positions, the same coins) and the JAX
    ``greedy_steps`` / ``sampled_steps`` scan's, and leave the same cache."""
    cfg, jcfg = _configs("float32")
    jparams, params = _pair(cfg, jcfg, seed=5)
    start, token = len(PROMPT) - 1, PROMPT[-1]
    coins = np.random.default_rng(7).random(N_STEPS).astype(np.float32)

    kv = _prefilled(params, cfg)
    g = DecodeGraph(params, cfg, kv, "cpu", sampled=sampled, pos=start)
    assert g.step.graph is None  # the CPU runs the body
    g.launch(token, start, N_STEPS, 0.8, 0.9, coins if sampled else None)
    got = g.tokens()

    eager_kv = _prefilled(params, cfg)
    eager, t = [], token
    for i in range(N_STEPS):
        if sampled:
            nxt, _, _ = llama.sampled_step(params, cfg, torch.tensor([[t]]), start + i,
                                           eager_kv, 0.8, 0.9, float(coins[i]))
        else:
            nxt, _, _ = llama.greedy_step(params, cfg, torch.tensor([[t]]), start + i,
                                          eager_kv)
        t = int(nxt[0])
        eager.append(t)

    jkv = JaxKVCache.create(jcfg)
    _, jkv = jax_llama.forward(jparams, jcfg, jnp.asarray([PROMPT[:-1]], jnp.int32),
                               jnp.int32(0), jkv)
    tok0, pos0 = jnp.asarray([token], jnp.int32), jnp.int32(start)
    if sampled:
        jt, _ = jax_llama.sampled_steps(jparams, jcfg, tok0, pos0, jkv, jnp.float32(0.8),
                                        jnp.float32(0.9), jnp.asarray(coins), N_STEPS)
    else:
        jt, _ = jax_llama.greedy_steps(jparams, jcfg, tok0, pos0, jkv, N_STEPS)
    want = [int(x) for x in np.asarray(jt)[0]]

    assert got == eager == want
    assert len(set(got)) > 1
    end = start + N_STEPS
    assert torch.equal(kv.k[:, :, :, :end], eager_kv.k[:, :, :, :end])
    assert torch.equal(kv.v[:, :, :, :end], eager_kv.v[:, :, :, :end])
    assert int(g.pos[0]) == end and int(g.tok[0, 0]) == got[-1]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"], ids=["f32", "bf16"])
def test_step_graph_logits_match_jax(compute):
    """A :class:`StepGraph` over ``forward`` at a ``[1]`` int32 device
    position, feeding its argmax back into its static input: each replay's
    logits against the JAX ``forward`` on the same tokens."""
    cfg, jcfg = _configs(compute)
    jparams, params = _pair(cfg, jcfg, seed=3)
    kv = _prefilled(params, cfg)
    tok = torch.tensor([[PROMPT[-1]]])
    pos = torch.tensor([len(PROMPT) - 1], dtype=torch.int32)
    logits = torch.zeros(cfg.vocab_size)

    def body():
        out, _ = llama.forward(params, cfg, tok, pos, kv)
        logits.copy_(out[0, -1])
        tok.copy_(torch.argmax(out[:, -1], dim=-1).view(1, 1))
        pos.add_(1)

    g = StepGraph(body, "cpu")
    jkv = JaxKVCache.create(jcfg, dtype=jnp.dtype(compute))
    _, jkv = jax_llama.forward(jparams, jcfg, jnp.asarray([PROMPT[:-1]], jnp.int32),
                               jnp.int32(0), jkv)
    for i in range(N_STEPS):
        fed = int(tok[0, 0])
        g.replay()
        jl, jkv = jax_llama.forward(jparams, jcfg, jnp.asarray([[fed]], jnp.int32),
                                    jnp.int32(len(PROMPT) - 1 + i), jkv)
        want = np.asarray(jl, np.float32)[0, -1]
        got = logits.numpy()
        if compute == "float32":
            np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
        else:
            assert np.abs(got - want).max() <= BF16_RTOL * np.abs(want).max()
    assert int(pos[0]) == len(PROMPT) - 1 + N_STEPS


# -- the paged step -----------------------------------------------------------


@pytest.fixture(scope="module")
def paged_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_graphs")
    mpath, tpath = d / "m.m", d / "t.t"
    write_tiny_model(mpath, tiny_header_params(vocab_size=268, seq_len=96),
                     np.random.default_rng(41))
    tfile.write_tfile(tpath, byte_vocab_tokenizer())
    return str(mpath), str(tpath)


def test_paged_step_static_buffers_match_jax_solo(paged_files):
    """``PagedGenerator.step`` replays its step graph on static buffers
    that keep their addresses; two requests (greedy and sampled) decoded
    together equal the JAX single-sequence engine's transcripts (the
    comparison of ``tests/test_torch_serving.py``)."""
    eng = InferenceEngine(*paged_files, device="cpu", kv_block_size=16)
    solo = JaxEngine(*paged_files, tp=1)
    try:
        specs = [("hello world", 0.0, 1), ("hello there", 0.8, 2)]
        want = []
        for text, temp, seed in specs:
            solo.reset()
            solo.sampler.set_temp(temp)
            solo.sampler.set_seed(seed)
            want.append(solo.generate(text, 10, stop_on_eos=False).tokens)
        gen = PagedGenerator(eng, n_slots=2)
        reqs = [Request(rid=i, prompt_ids=eng.tokenizer.encode(text, is_start=True),
                        max_tokens=10, temperature=temp, seed=seed, stop_on_eos=False)
                for i, (text, temp, seed) in enumerate(specs)]
        for i, r in enumerate(reqs):
            gen.admit(r, i)
        graph = gen.step_graph()
        ptrs = [t.data_ptr() for t in (gen._in, gen._knobs, gen._out)]
        while gen.n_active:
            gen.step()
            assert gen.step_graph() is graph
            assert [t.data_ptr() for t in (gen._in, gen._knobs, gen._out)] == ptrs
        assert [r.tokens for r in reqs] == want
        gen.close()
        assert gen._graph is None
    finally:
        eng.close()
        solo.close()


# -- nothing reads back inside a step -----------------------------------------


@contextlib.contextmanager
def _no_readback(monkeypatch):
    def refuse(name):
        def f(*_a, **_k):
            raise AssertionError(f"Tensor.{name} inside a captured step body")
        return f

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__"):
            m.setattr(torch.Tensor, name, refuse(name))
        yield


def test_no_readback_in_the_step_body(monkeypatch, paged_files):
    """Each step body (greedy, sampled, paged) runs with the host readbacks
    of a tensor patched to raise — the CPU's proxy for capturability."""
    cfg, jcfg = _configs("float32")
    _, params = _pair(cfg, jcfg, seed=2)
    start = len(PROMPT) - 1
    for sampled in (False, True):
        g = DecodeGraph(params, cfg, _prefilled(params, cfg), "cpu", sampled=sampled,
                        pos=start)
        g.launch(PROMPT[-1], start, 1, 0.8, 0.9, np.array([0.3], np.float32))
        with _no_readback(monkeypatch):
            for _ in range(3):
                g.step.replay()
        assert int(g.pos[0]) == start + 4
    eng = InferenceEngine(*paged_files, device="cpu", kv_block_size=16)
    try:
        gen = PagedGenerator(eng, n_slots=2)
        gen.admit(Request(rid=0, prompt_ids=eng.tokenizer.encode("hello", is_start=True),
                          max_tokens=4, temperature=0.8, seed=3, stop_on_eos=False), 0)
        gen.step()
        with _no_readback(monkeypatch):
            gen.step_graph().replay()
    finally:
        eng.close()


def test_scheduler_capture_failure_raises_at_construction(monkeypatch, paged_files):
    """The scheduler's loop thread captures the paged step before the
    scheduler is handed out: a capture that raises fails the construction
    (no server would listen), and nothing falls back to the eager step."""
    from dllama_tpu_torch.runtime.serving import BatchScheduler

    def broken(self):
        raise RuntimeError("capture refused")

    eng = InferenceEngine(*paged_files, device="cpu", kv_block_size=16)
    try:
        monkeypatch.setattr(PagedGenerator, "step_graph", broken)
        with pytest.raises(RuntimeError, match="capture refused"):
            BatchScheduler(eng, n_slots=2)
    finally:
        eng.close()


def test_closing_releases_the_graphs_memory_without_a_collection(paged_files):
    """The step graphs hold the parameters, the cache and the pool through
    their bodies: ``close()`` must free them by reference counting alone
    (a reference cycle through a graph kept a closed engine's weights
    alive on the card until the next garbage collection)."""
    import gc
    import weakref

    gc.collect()
    gc.disable()
    try:
        eng = InferenceEngine(*paged_files, device="cpu", kv_block_size=16, temperature=0.8)
        eng.generate("hello", 3, stop_on_eos=False)
        eng.sampler.set_temp(0.0)
        eng.generate("hello", 3, stop_on_eos=False)
        gen = PagedGenerator(eng, n_slots=2)
        gen.step_graph()
        assert len(eng._graphs) == 2
        refs = [weakref.ref(t) for t in (eng.params.embedding, eng.kv.k, gen.pkv.k,
                                         eng._graphs[True].coins, gen._in)]
        gen.close()
        del gen
        eng.close()
        del eng
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()
