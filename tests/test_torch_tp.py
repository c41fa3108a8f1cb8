"""The port's tensor parallelism (``--tp``) against the JAX package's, on
the CPU: shards on ``[cpu] * tp`` in the port, the tier-1 conftest's
virtual host devices under ``make_tp_mesh(tp)`` in JAX.

- Layout: every port shard of every matmul weight equals, bit for bit, the
  data of the matching device's shard of JAX ``shard_params`` (Q40 planes,
  Q80 planes, dense weights; tp in {2, 4}; a config whose kv heads replicate
  and whose wk/wv stay whole).
- ``validate_tp`` accepts and refuses the JAX function's ``(cfg, tp)``
  pairs with its messages; the default tp follows the JAX engine's rule.
- ``forward`` (a 66-token chunk, a 6-token chunk, three decode steps; two
  layers) and ``paged_forward`` (a prefill chunk and a ragged decode step
  through scrambled tables) at tp in {2, 4} against the port's tp = 1 and
  JAX's forward under the plan. The Q80 sync casts are off there: a cast
  turns a last-ulp difference of summation order into a whole int8 step.
  Tolerance 1e-4 absolute on O(1) logits (f32 sums in another order).
- ``InferenceEngine(tp=2)`` token-exact against JAX's
  ``InferenceEngine(tp=2)``, perplexity within 1e-5 relative; paged
  serving at tp = 2 (6 requests through 2 slots, sharing and copy-on-write)
  token-exact against the JAX solo engine; ``api --tp 2`` in process.
- The CLI: ``--tp 2 --device cpu`` prints the JAX CLI's text and
  perplexity on one reference-style line that also carries the
  reference's executor flags (``--nthreads --workers --net-turbo``, ignored
  by both); each combination tp > 1 does not take yet exits with a message
  naming it; ``--tp 2`` on ``cuda`` without two cards exits with the JAX
  device-count message."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request
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
from dllama_tpu.ops.linear import QuantizedWeight as JaxQW
from dllama_tpu.parallel import use_plan
from dllama_tpu.parallel.api import make_tp_mesh
from dllama_tpu.parallel import sharding as jax_sharding
from dllama_tpu.runtime import kvblocks as jax_kvblocks
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu.runtime.engine import _tp_ok as jax_tp_ok
from dllama_tpu.runtime.kvcache import KVCache as JaxKVCache
from dllama_tpu.serve import cli as jax_cli
from dllama_tpu_torch.formats import mfile
from dllama_tpu_torch.models import llama
from dllama_tpu_torch.models.config import ModelConfig
from dllama_tpu_torch.ops.linear import ShardedWeight
from dllama_tpu_torch.parallel import sharding
from dllama_tpu_torch.parallel.api import make_mesh
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.kvblocks import (PagedKVCache, ShardedPagedKVCache,
                                               blocks_per_seq)
from dllama_tpu_torch.runtime.kvcache import HeadShardedKVCache, KVCache
from dllama_tpu_torch.runtime.serving import BatchScheduler
from dllama_tpu_torch.serve import cli

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-4
CHUNKS = [(0, 66), (66, 72), (72, 73), (73, 74), (74, 75)]
FIELDS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def _configs(**over):
    base = dict(arch=mfile.ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=2, n_heads=8,
                n_kv_heads=2, head_dim=16, vocab_size=96, seq_len=100, norm_epsilon=1e-5,
                rope_theta=10000.0, rope_type=mfile.RopeType.LLAMA, compute_dtype="float32")
    base.update(over)
    jkw = dict(base, arch=jax_mfile.ArchType.LLAMA, rope_type=jax_mfile.RopeType.LLAMA)
    return ModelConfig(**base), JaxConfig(**jkw)


def _jax_params(jcfg, repr_: str, seed: int):
    """JAX params with Q40 planes, Q80 planes (codes over [-127, 127]) or
    dense weights."""
    jp = jax_llama.init_random_params(jcfg, seed=seed, quantized=repr_ != "dense")
    if repr_ != "q80":
        return jp
    rng = np.random.default_rng(seed)

    def q80(w):
        codes = rng.integers(-127, 128, np.shape(w.codes)).astype(np.int8)
        return JaxQW(scales=w.scales / 16, codes=jnp.asarray(codes))

    lay = jp.layers
    return jp._replace(layers=lay._replace(**{f: q80(getattr(lay, f)) for f in FIELDS}),
                       logits=q80(jp.logits))


def _np(jp):
    return jax.tree_util.tree_map(np.asarray, jp)


def _planes(w):
    """A weight's arrays: the planes of a quantized one, else the matrix."""
    return [w.scales, w.codes] if hasattr(w, "codes") else [w]


def _jax_shard(arr, device, layer=None):
    shard = next(s for s in arr.addressable_shards if s.device == device)
    data = np.asarray(shard.data)
    return data if layer is None else data[layer]


@pytest.mark.parametrize("repr_,tp,over", [
    ("q40", 2, {}), ("q40", 4, {}), ("q80", 2, {}), ("q80", 4, {}),
    ("dense", 2, {}), ("dense", 4, {}),
    # tp > n_kv_heads: the cache replicates, and kv_dim 6 cannot split by
    # 4, so wk and wv stay whole on every shard
    ("q40", 4, dict(n_heads=64, n_kv_heads=1, head_dim=6)),
    ("dense", 4, dict(n_heads=64, n_kv_heads=1, head_dim=6)),
], ids=["q40-tp2", "q40-tp4", "q80-tp2", "q80-tp4", "dense-tp2", "dense-tp4",
        "q40-tp4-replicated", "dense-tp4-replicated"])
def test_shards_equal_jax_shard_params_bitwise(repr_, tp, over):
    cfg, jcfg = _configs(**over)
    jp = _jax_params(jcfg, repr_, seed=11)
    params = llama.from_jax_params(_np(jp), cfg)
    plan = make_mesh({"tp": tp}, ["cpu"] * tp)
    shards = sharding.shard_params(plan, params)
    jplan = make_tp_mesh(tp)
    jsharded = jax_sharding.shard_params(jplan, jp)
    devices = list(jplan.mesh.devices.flat)
    whole = []
    for j, dev in enumerate(devices):
        for l in range(cfg.n_layers):
            for f in FIELDS:
                got = _planes(getattr(shards[j].layers[l], f))
                want = _planes(getattr(jsharded.layers, f))
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g.numpy(), _jax_shard(w, dev, l))
                    if j == 0 and l == 0 and tuple(g.shape) == tuple(w.shape[1:]):
                        whole.append(f)
        for g, w in zip(_planes(shards[j].logits), _planes(jsharded.logits)):
            np.testing.assert_array_equal(g.numpy(), _jax_shard(w, dev))
        # norms and the embedding are the lead's, placed once
        assert shards[j].embedding is params.embedding
        assert shards[j].layers[0].norm_att is params.layers[0].norm_att
    if over:
        assert set(whole) == {"wk", "wv"}
        tpp = sharding.tp_params(plan, params)
        wk = tpp.layers[0].wk
        assert wk.split == "" and all(s is wk.shards[0] for s in wk.shards)
    else:
        assert not whole


@pytest.mark.parametrize("over", [
    {}, dict(n_heads=6), dict(hidden_dim=96), dict(vocab_size=98), dict(n_kv_heads=4),
    dict(n_kv_heads=1), dict(n_heads=12, n_kv_heads=3, head_dim=8)])
@pytest.mark.parametrize("tp", [1, 2, 3, 4, 8])
def test_validate_tp_and_default_tp_match_jax(over, tp):
    cfg, jcfg = _configs(**over)
    try:
        jax_sharding.validate_tp(jcfg, tp)
        want = None
    except ValueError as e:
        want = str(e)
    try:
        sharding.validate_tp(cfg, tp)
        got = None
    except ValueError as e:
        got = str(e)
    assert got == want
    for n_dev in (1, 2, 3, 4, 8):
        for sp in (1, 2):
            rule = 1  # the JAX engine's loop (runtime/engine.py:285-297)
            while sp * rule * 2 <= n_dev and jax_tp_ok(jcfg, rule * 2):
                rule *= 2
            assert sharding.default_tp(cfg, n_dev, sp) == rule


# ---------------------------------------------------------------------------
# forward and paged_forward
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = _configs()
    jparams = jax_llama.init_random_params(jcfg, seed=31, quantized=True)
    params = llama.from_jax_params(_np(jparams), cfg)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, CHUNKS[-1][1]))
    return cfg, jcfg, jparams, params, tokens


def _port_logits(cfg, params, tokens, tp):
    plan = make_mesh({"tp": tp}, ["cpu"] * tp) if tp > 1 else None
    if plan:
        params = sharding.tp_params(plan, params)
        kv = sharding.kv_cache_sharding(plan, cfg)
    else:
        kv = KVCache.create(cfg)
    out = []
    for a, b in CHUNKS:
        logits, kv = llama.forward(params, cfg, torch.from_numpy(tokens[:, a:b]), a, kv, plan)
        out.append(logits.numpy())
    return out, kv


def _jax_logits(jcfg, jparams, tokens, tp):
    plan = make_tp_mesh(tp)
    kv0 = JaxKVCache.create(jcfg)
    kv = jax.device_put(kv0, jax_sharding.kv_cache_sharding(plan, kv0))
    fwd = jax.jit(jax_llama.forward, static_argnums=1)
    out = []
    with use_plan(plan):
        sharded = jax_sharding.shard_params(plan, jparams)
        for a, b in CHUNKS:
            logits, kv = fwd(sharded, jcfg, jnp.asarray(tokens[:, a:b], jnp.int32),
                             jnp.int32(a), kv)
            out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("tp", [2, 4])
def test_forward_tp_matches_tp1_and_jax(model, tp):
    cfg, jcfg, jparams, params, tokens = model
    got, kv = _port_logits(cfg, params, tokens, tp)
    solo, solo_kv = _port_logits(cfg, params, tokens, 1)
    want = _jax_logits(jcfg, jparams, tokens, tp)
    for g, s, w in zip(got, solo, want):
        assert np.isfinite(g).all() and g.shape == w.shape
        np.testing.assert_allclose(g, s, rtol=0, atol=ATOL)
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    # each shard holds its kv heads of the dense cache (tp = 4 > n_kv = 2:
    # shards 2j and 2j + 1 hold head j)
    assert isinstance(kv, HeadShardedKVCache)
    assert all(shard.seq_len == solo_kv.seq_len for shard in kv.shards)
    for j, shard in enumerate(kv.shards):
        hs = sharding.kv_heads(cfg, tp, j)
        np.testing.assert_allclose(shard.k.numpy(), solo_kv.k[:, :, hs].numpy(),
                                   rtol=0, atol=ATOL)
    assert [sharding.kv_heads(cfg, tp, j).start for j in range(tp)] == (
        [0, 1] if tp == 2 else [0, 0, 1, 1])


def test_forward_tp_kernel_wrapper_matches_plain(model):
    """``attn_impl="flash"`` sends every shard through the K3 wrapper (its
    plain version on the CPU), ``quant_impl="xla"`` every matmul shard
    through K1/K2's plain version by name."""
    cfg, _, _, params, tokens = model
    from dataclasses import replace

    got, _ = _port_logits(replace(cfg, attn_impl="flash", quant_impl="xla"), params,
                          tokens, 2)
    want, _ = _port_logits(cfg, params, tokens, 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


BS = 8


def _paged_case(cfg, seed):
    """Random pool contents, a scrambled table per row (the last row
    inactive, all-null) and a decode step's tokens and positions."""
    M = blocks_per_seq(cfg.seq_len, BS)
    n_blocks = 3 * M + 1
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, n_blocks, cfg.n_kv_heads, BS, cfg.head_dim)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    perm = rng.permutation(np.arange(1, n_blocks))
    tables = perm[:3 * M].reshape(3, M).astype(np.int32)
    tables[2] = 0
    return k, v, tables


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("phase", ["prefill", "ragged_decode"])
def test_paged_forward_tp_matches_tp1_and_jax(model, tp, phase):
    cfg, jcfg, jparams, params, _ = model
    k, v, tables = _paged_case(cfg, seed=4)
    rng = np.random.default_rng(6)
    if phase == "prefill":  # two rows, a 12-token chunk each at depths 0 and 20
        tokens, pos = rng.integers(0, cfg.vocab_size, (2, 12)), np.array([0, 20])
        tables = tables[:2]
    else:  # three ragged rows, the last inactive with an all-null table
        tokens, pos = rng.integers(0, cfg.vocab_size, (3, 1)), np.array([5, 41, 17])
    args = (torch.from_numpy(tokens), torch.from_numpy(pos))
    solo_pkv = PagedKVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()))
    solo, _ = llama.paged_forward(params, cfg, *args, solo_pkv, torch.from_numpy(tables))
    plan = make_mesh({"tp": tp}, ["cpu"] * tp)
    pkv = ShardedPagedKVCache([
        PagedKVCache(k=torch.from_numpy(k[:, :, sharding.kv_heads(cfg, tp, j)].copy()),
                     v=torch.from_numpy(v[:, :, sharding.kv_heads(cfg, tp, j)].copy()))
        for j in range(tp)])
    got, pkv = llama.paged_forward(sharding.tp_params(plan, params), cfg, *args, pkv,
                                   torch.from_numpy(tables), plan=plan)
    jplan = make_tp_mesh(tp)
    jkv0 = jax_kvblocks.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v))
    jkv = jax.device_put(jkv0, jax_sharding.paged_kv_sharding(jplan, jkv0))
    with use_plan(jplan):
        want, jkv = jax.jit(jax_llama.paged_forward, static_argnums=1)(
            jax_sharding.shard_params(jplan, jparams), jcfg, jnp.asarray(tokens, jnp.int32),
            jnp.asarray(pos, jnp.int32), jkv, jnp.asarray(tables))
    for ref in (solo.numpy(), np.asarray(want)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    for j, shard in enumerate(pkv.shards):
        hs = sharding.kv_heads(cfg, tp, j)
        np.testing.assert_allclose(shard.k.numpy(), solo_pkv.k[:, :, hs].numpy(),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(shard.v.numpy(), np.asarray(jkv.v)[:, :, hs],
                                   rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# the engine, serving and the CLI
# ---------------------------------------------------------------------------

PROMPT = "a prompt for the tensor-parallel engine. Then it decodes."


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    m, t = out / "m.m", out / "t.t"
    write_tiny_model(m, tiny_header_params(vocab_size=268, seq_len=96, n_heads=8,
                                           n_kv_heads=2, hidden_dim=128),
                     np.random.default_rng(17))
    td = byte_vocab_tokenizer()
    td.chat_template = "<|start_header_id|>"  # detected as llama3
    tfile.write_tfile(t, td)
    return str(m), str(t)


@pytest.fixture(scope="module")
def jax_tp2(files):
    eng = JaxEngine(*files, tp=2, temperature=0.0)
    yield eng
    eng.close()


def test_engine_tp2_matches_jax_engine(files, jax_tp2):
    m, t = files
    eng = InferenceEngine(m, t, device="cpu", tp=2, temperature=0.0)
    try:
        assert eng.tp == 2 and isinstance(eng.kv, HeadShardedKVCache)
        assert isinstance(eng.params.layers[0].wo, ShardedWeight)
        assert [s.k.shape[2] for s in eng.kv.shards] == [1, 1]
        jax_tp2.reset()
        ids = jax_tp2.tokenizer.encode(PROMPT)
        want = jax_tp2.generate(ids, 12, stop_on_eos=False).tokens
        got = eng.generate(ids, 12, stop_on_eos=False).tokens
        assert got == want
        assert eng.perplexity(ids) == pytest.approx(jax_tp2.perplexity(ids), rel=1e-5)
        eng.reset()
        assert eng.pos == 0 and all(not s.k.any() for s in eng.kv.shards)
    finally:
        eng.close()


def test_engine_tp_refusals_and_default(files, tmp_path):
    m, t = files
    eng = InferenceEngine(m, t, device="cpu")
    try:
        assert eng.tp == 1 and eng.plan is None  # the default on the CPU
    finally:
        eng.close()
    with pytest.raises(ValueError, match="n_heads 8 not divisible by tp=3"):
        InferenceEngine(m, t, device="cpu", tp=3)
    with pytest.raises(ValueError, match="--tp 2 does not support --sp > 1"):
        InferenceEngine(m, t, device="cpu", tp=2, sp=2)
    eng = InferenceEngine(m, t, device="cpu", tp=2, quant_mode="turbo")
    try:  # turbo planes shard like the Q40 planes they come from
        assert eng.tp == 2 and type(eng.params.layers[0].wq.shards[0]).__name__ == "TurboWeight"
    finally:
        eng.close()
    with pytest.raises(ValueError, match="--tp 2 does not support --kv-host-blocks"):
        InferenceEngine(m, t, device="cpu", tp=2, kv_block_size=16, kv_host_blocks=8)
    with pytest.raises(ValueError, match="needs 2 cpu devices"):
        InferenceEngine(m, t, device="cpu", tp=2, tp_devices=["cpu"])
    moe = tmp_path / "moe.m"
    write_tiny_model(moe, tiny_header_params(vocab_size=268, seq_len=96, n_experts=4,
                                             n_active_experts=2), np.random.default_rng(43))
    eng = InferenceEngine(str(moe), t, device="cpu", tp=2)
    try:
        assert eng.tp == 2 and type(eng.params.layers[0].we1).__name__ == "ExpertShards"
    finally:
        eng.close()
    eng = InferenceEngine(str(moe), t, device="cpu", tp=None)
    try:
        # MoE takes the JAX engine's default rule, as dense models do: one
        # device on the CPU
        assert eng.tp == sharding.default_tp(eng.cfg, 1) == 1
        with jax_mfile.ModelFile.open(str(moe)) as jmf:
            jcfg = JaxConfig.from_header(jmf.header)
        for n in (2, 4, 8):
            rule = 1  # the JAX engine's loop (runtime/engine.py:285-297)
            while rule * 2 <= n and jax_tp_ok(jcfg, rule * 2):
                rule *= 2
            assert sharding.default_tp(eng.cfg, n) == rule
    finally:
        eng.close()


def test_paged_serving_tp2_token_exact_against_jax_solo(files):
    """6 mixed greedy/sampled requests through 2 slots of the tp = 2 paged
    pool (one allocator, two head-sharded pools): every transcript equals
    the JAX solo engine's, and the shared prefix was reused."""
    m, t = files
    prompts = ["hello world", "hello there", "abc", "hello world how are you", "xyzzy",
               "hello hello hello"]
    specs = [dict(temperature=0.0, seed=1), dict(temperature=0.8, seed=2),
             dict(temperature=0.0, seed=3), dict(temperature=1.2, seed=4),
             dict(temperature=0.0, seed=5), dict(temperature=0.6, seed=6)]
    solo = JaxEngine(m, t, tp=1)
    want = []
    try:
        for p, s in zip(prompts, specs):
            solo.reset()
            solo.sampler.set_temp(s["temperature"])
            solo.sampler.set_seed(s["seed"])
            want.append(solo.generate(p, 8, stop_on_eos=False).tokens)
    finally:
        solo.close()
    eng = InferenceEngine(m, t, device="cpu", tp=2, kv_block_size=16)
    sched = BatchScheduler(eng, n_slots=2)
    try:
        assert isinstance(sched.gen.pkv, ShardedPagedKVCache)
        enc = [eng.tokenizer.encode(p, is_start=True) for p in prompts]
        reqs = [sched.submit(ids, 8, stop_on_eos=False, temperature=s["temperature"],
                             seed=s["seed"]) for ids, s in zip(enc, specs)]
        for r in reqs:
            assert r.done.wait(timeout=300)
            assert r.error is None, r.error
        assert [r.tokens for r in reqs] == want
        assert sched.gen.reused_tokens > 0
    finally:
        sched.close()
        eng.close()
    assert sched.gen.pool.used_blocks() == 0


def test_copy_on_write_touches_every_shard(files):
    m, t = files
    eng = InferenceEngine(m, t, device="cpu", tp=2, kv_block_size=16)
    try:
        from dllama_tpu_torch.runtime.serving import PagedGenerator

        gen = PagedGenerator(eng, n_slots=2)
        for s in gen.pkv.shards:
            s.k[:, 3].normal_()
            s.v[:, 3].normal_()
        gen._copy_block(3, 5)
        for s in gen.pkv.shards:
            assert torch.equal(s.k[:, 5], s.k[:, 3]) and torch.equal(s.v[:, 5], s.v[:, 3])
    finally:
        eng.close()


def _post(url, payload, path="/v1/chat/completions"):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def test_api_tp2_serves_and_refuses_kv_export(files):
    m, t = files
    started, box = threading.Event(), {}

    def on_listening(srv, state):
        box["server"], box["state"] = srv, state
        started.set()

    th = threading.Thread(target=lambda: box.setdefault("rc", cli.main(
        ["api", "--model", m, "--tokenizer", t, "--device", "cpu", "--tp", "2",
         "--batch-slots", "2", "--kv-block-size", "16", "--port", "0",
         "--temperature", "0"], on_listening=on_listening)), daemon=True)
    th.start()
    assert started.wait(timeout=120), "server did not start"
    url = f"http://127.0.0.1:{box['server'].server_address[1]}"
    try:
        assert box["state"].engine.tp == 2
        body = {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 6,
                "temperature": 0}
        with _post(url, body) as r:
            first = json.loads(r.read())["choices"][0]["message"]["content"]
        with _post(url, body) as r:
            assert json.loads(r.read())["choices"][0]["message"]["content"] == first
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, {"tokens": [1, 2, 3]}, path="/v1/kv/export")
        assert e.value.code == 501 and "--tp 2" in json.loads(e.value.read())["error"]
    finally:
        box["server"].shutdown()
        th.join(timeout=60)
    assert box["rc"] == 0


@pytest.mark.parametrize("argv,err", [
    (["api", "--batch-slots", "2", "--tp", "2"], "api --tp 2 needs --batch-slots N with "
                                                 "--kv-block-size"),
    (["api", "--tp", "2"], "api --tp 2 needs --batch-slots N with --kv-block-size"),
    (["api", "--tp", "2", "--batch-slots", "2", "--kv-block-size", "16", "--role",
      "prefill"], "--role with --tp 2"),
    (["inference", "--tp", "2", "--sp", "2"], "--sp 2 together with --tp 2"),
])
def test_cli_tp_refusals(files, argv, err):
    m, t = files
    with pytest.raises(SystemExit, match=err):
        cli.main([*argv, "--model", m, "--tokenizer", t, "--device", "cpu",
                  "--prompt", "hi", "--steps", "4"])


def _run(*argv: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no GPU, whatever the host has
    return subprocess.run([sys.executable, "-m", "dllama_tpu_torch", *argv], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)


def test_cli_tp2_on_cuda_without_two_cards_fails(files):
    m, t = files
    r = _run("inference", "--model", m, "--tokenizer", t, "--prompt", "hi", "--steps", "4",
             "--tp", "2")
    assert r.returncode != 0
    assert "mesh dp=1 sp=1 pp=1 tp=2 needs 2 devices, found 0" in r.stderr
    assert "Traceback" not in r.stderr and "Prediction" not in r.stdout


def _streamed(out: str) -> str:
    return out.split(PROMPT + "\n", 1)[1].split("\n\nEvaluation", 1)[0].rstrip("\n")


def test_cli_reference_line_tp2_matches_jax_cli(files, tmp_path, capsys):
    """One reference-style command line, the executor and network flags
    included, through both packages' ``main`` at ``--tp 2``: the same
    streamed text and the same perplexity."""
    m, t = files
    line = ["--model", m, "--tokenizer", t, "--temperature", "0", "--tp", "2",
            "--nthreads", "4", "--workers", "--net-turbo", "1"]
    inf = ["inference", *line, "--prompt", PROMPT, "--steps", "90"]
    text = tmp_path / "ppl.txt"
    text.write_text(PROMPT)
    ppl = ["perplexity", *line, "--file", str(text)]
    outs = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jax_cli.main, [])):
        assert main([*inf, *extra]) in (0, None)
        got = capsys.readouterr().out
        assert "TP devices: 2" in got
        assert main([*ppl, *extra]) in (0, None)
        p = capsys.readouterr().out
        outs[name] = (_streamed(got), float(next(ln for ln in p.splitlines()
                                                 if "Perplexity" in ln).split()[-1]))
    assert outs["port"][0] and outs["port"][0] == outs["jax"][0]
    assert outs["port"][1] == pytest.approx(outs["jax"][1], abs=1e-4, rel=1e-5)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("limit_gb", [5, 11, 30])
def test_hbm_charges_a_device_its_shards_like_jax(monkeypatch, n_shards, limit_gb):
    """The memory guard divides the weight and KV bytes by ``n_shards``,
    the JAX module's rule: ``tp`` over the most shards one device holds."""
    from dllama_tpu.runtime import hbm as jax_hbm
    from dllama_tpu_torch.runtime import hbm

    from test_torch_hbm import GB, _cfgs as hbm_cfgs

    port, jcfg = hbm_cfgs(seq_len=2048)
    kw = dict(weight_repr="q40", kv_dtype_bytes=2, n_shards=n_shards)
    assert (hbm.estimate_device_bytes(port, **kw)
            == jax_hbm.estimate_device_bytes(jcfg, **kw))
    monkeypatch.setenv("DLLAMA_HBM_BYTES", str(limit_gb * GB))
    kw.update(block_size=16, min_blocks=129)
    assert (hbm.fit_block_pool(port, 8 * 128 + 1, **kw)
            == jax_hbm.fit_block_pool(jcfg, 8 * 128 + 1, **kw))
    one_card = make_mesh({"tp": 4}, ["cuda:0"] * 4)
    assert one_card.shards_per_device == 4
    assert make_mesh({"tp": 4}, [f"cuda:{i}" for i in range(4)]).shards_per_device == 1
    assert make_mesh({"tp": 4}, ["cuda:0", "cuda:0", "cuda:1", "cuda:1"]
                     ).shards_per_device == 2


@pytest.mark.parametrize("kw", [
    dict(decode_chunk=4), dict(spec_lookup=3), dict(kv_dtype="f8"), dict(weight_mode="f32"),
    dict(weight_mode="bf16"), dict(n_batches=16), dict(numerics_taps=True),
    dict(host_sampling=True, temperature=0.8, seed=5), dict(temperature=0.8, seed=5),
    dict(compute_dtype="bfloat16")],
    ids=["decode_chunk", "spec_lookup", "kv_f8", "weights_f32", "weights_bf16", "nbatches",
         "taps", "host_sampling", "sampled", "bf16"])
def test_engine_options_ride_tp(files, kw):
    """What rides on ``forward`` runs at tp = 2 and gives tp = 1's tokens."""
    m, t = files
    kw = dict(dict(temperature=0.0), **kw)
    runs = {}
    for tp in (1, 2):
        eng = InferenceEngine(m, t, device="cpu", tp=tp, **kw)
        try:
            runs[tp] = eng.generate(PROMPT, 16, stop_on_eos=False).tokens
        finally:
            eng.close()
    assert runs[2] == runs[1]


@pytest.mark.parametrize("kw", [dict(spec_lookup=2), dict(kv_dtype="f8")],
                         ids=["spec_lookup", "kv_f8"])
def test_paged_serving_options_ride_tp(files, kw):
    """The paged verify step and an e4m3 pool at tp = 2 give tp = 1's
    tokens (greedy and sampled rows)."""
    m, t = files
    prompts = ["hello world", "hello world again", "abc abc abc abc"]
    runs = {}
    for tp in (1, 2):
        eng = InferenceEngine(m, t, device="cpu", tp=tp, kv_block_size=16, **kw)
        sched = BatchScheduler(eng, n_slots=2)
        try:
            reqs = [sched.submit(eng.tokenizer.encode(p, is_start=True), 10, stop_on_eos=False,
                                 temperature=0.7 * (i % 2), seed=i)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                assert r.done.wait(timeout=300) and r.error is None, r.error
            runs[tp] = [r.tokens for r in reqs]
        finally:
            sched.close()
            eng.close()
    assert runs[2] == runs[1]


def test_eval_tp2_single_and_paged_score_alike(tmp_path, capsys):
    """``eval --tp 2`` scores the builtin eval set in the single and the
    paged config with one NLL hex (the paged pool's chunks are the
    engine's), within 1e-6 relative of tp = 1's; the dense config refuses."""
    m = tmp_path / "m.m"
    write_tiny_model(m, tiny_header_params(seq_len=64), np.random.RandomState(0x5EED))
    data = str(REPO / "tests" / "goldens" / "eval_tiny.jsonl")
    base = ["eval", "--model", str(m), "--data", data, "--device", "cpu",
            "--buffer-float-type", "f32", "--json"]
    out = {}
    for name, extra in (("tp1", []), ("tp2", ["--tp", "2", "--batch-slots", "2",
                                               "--kv-block-size", "8", "--compare",
                                               "single"])):
        assert cli.main([*base, *extra]) == 0
        out[name] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    tp2 = out["tp2"]
    assert tp2["config"] == "paged" and not tp2["parity_drift"]
    assert tp2["total_nll_hex"] == tp2["compare"]["total_nll_hex"]
    assert tp2["total_nll"] == pytest.approx(out["tp1"]["total_nll"], rel=1e-6)
    with pytest.raises(SystemExit, match="eval's dense config runs at tp = 1"):
        cli.main([*base, "--tp", "2", "--batch-slots", "2"])
