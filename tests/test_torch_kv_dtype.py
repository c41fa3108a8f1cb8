"""The port's float8 e4m3 KV cache (``--kv-dtype f8``) against the JAX
package's on the CPU.

* The cache write (``runtime/kvcache.py::to_cache``) gives the bits of
  JAX's ``astype(float8_e4m3fn)``: round to nearest even in range, NaN with
  the value's sign past 464 and for inf and NaN (PyTorch's own cast
  saturates those to ±448), from f32 and from bf16 values, on the special
  values and on 10^5 random values at four scales.
* ``update_layer`` with an int and with a tensor position writes what the
  JAX ``update_layer`` writes, bit for bit.
* The plain versions of K3, K3s and K4 read an f8 cache as the JAX
  kernels do (interpreted Pallas, or for K4 the gather and oracle) at the
  tolerance of ``tests/test_kv_dtype.py``.
* The engine at ``kv_dtype="f8"`` gives JAX's f8 engine's prefill logits
  at f32 tolerance (both round at the same write), drifts from the f32
  cache within JAX's bound, and runs every path — sp = 2, spec_lookup,
  decode_chunk, the paged pool and the dense slot pool — token-equal to
  the single-step f8 run and to JAX's; ``kv_dtype="int8"`` is refused."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dllama_tpu.formats import quants, tfile
from dllama_tpu.ops.attention import attention as jax_attention
from dllama_tpu.ops.flash_attention import flash_attention as jax_flash
from dllama_tpu.ops.flash_attention import flash_block_stats as jax_block_stats
from dllama_tpu.ops.paged_attention import paged_ragged_attention
from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
from dllama_tpu.runtime.kvcache import update_layer as jax_update_layer
from dllama_tpu_torch.ops import flash_attention as fa
from dllama_tpu_torch.ops import paged_attention as pa
from dllama_tpu_torch.runtime.engine import InferenceEngine
from dllama_tpu_torch.runtime.kvcache import F8, to_cache, update_layer
from dllama_tpu_torch.runtime.serving import BatchScheduler

from helpers import byte_vocab_tokenizer, tiny_header_params, write_tiny_model

TOL = 2e-5  # tests/test_kv_dtype.py's kernel-vs-oracle tolerance on an f8 cache
# the f8 cast's edge cases: the largest finite value, the rounding midpoint
# to 480 (a tie, to even: 448) and just past it, infinities, NaNs of both
# signs, subnormals and their rounding ties, signed zeros
SPECIAL = np.array([0.0, -0.0, 448.0, -448.0, 449.0, -449.0, 463.99, 464.0, -464.0,
                    464.01, 465.0, -465.0, 480.0, 1e9, -1e9, np.inf, -np.inf, np.nan,
                    -np.nan, 2.0 ** -9, -(2.0 ** -9), 2.0 ** -10, 3 * 2.0 ** -10,
                    2.0 ** -7, 1.0625, 240.0, 232.0, -232.0, 17.5, 2.0 ** -6 * 0.9375],
                   np.float32)


def _bits_both(x: np.ndarray, src: str) -> tuple[np.ndarray, np.ndarray]:
    """``(port, jax)`` e4m3 bits of ``x`` held as ``src`` values. Both sides
    cast the same ``src`` bits: from bf16 these are JAX's bf16 values
    (PyTorch's own f32 -> bf16 cast drops the sign of a NaN)."""
    xs = jnp.asarray(x).astype(jnp.dtype(src))
    want = np.asarray(jax.jit(lambda a: a.astype(jnp.float8_e4m3fn))(xs)).view(np.uint8)
    if src == "bfloat16":
        t = torch.from_numpy(np.array(xs).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x)
    return to_cache(t, F8).view(torch.uint8).numpy(), want


def _to_jax(t: torch.Tensor):
    """A port tensor as a JAX array of the same dtype and bits."""
    if t.dtype == F8:
        return jnp.asarray(t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn))
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_f8_write_bits_equal_jax_on_special_values(src):
    got, want = _bits_both(SPECIAL, src)
    np.testing.assert_array_equal(got, want)
    # the NaN rule is what PyTorch's saturating cast lacks
    assert got[SPECIAL == 480.0][0] == 0x7F and got[SPECIAL == -np.inf][0] == 0xFF
    assert got[SPECIAL == 464.0][0] == 0x7E


def test_chip_smoke_special_table_holds_jax_bits():
    """``chip_smoke.py`` holds the cast on the card to a copied table of e4m3
    bits (``F8_SPECIAL``); each entry is JAX's cast of its value."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    values = np.array([v for v, _ in smoke.F8_SPECIAL], np.float32)
    want = np.asarray(jnp.asarray(values).astype(jnp.float8_e4m3fn)).view(np.uint8)
    assert [b for _, b in smoke.F8_SPECIAL] == want.tolist()
    assert {480.0, 465.0, 449.0, 448.0, 464.0, np.inf, -np.inf} <= set(values.tolist())


@pytest.mark.parametrize("scale", [1e-3, 1.0, 100.0, 1000.0])
@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_f8_write_bits_equal_jax_on_random_values(src, scale):
    x = (np.random.default_rng(int(scale * 1000) + len(src)).standard_normal(100_000)
         * scale).astype(np.float32)
    np.testing.assert_array_equal(*_bits_both(x, src))


@pytest.mark.parametrize("tensor_pos", [False, True], ids=["int_pos", "tensor_pos"])
def test_update_layer_on_f8_cache_equals_jax(tensor_pos):
    rng = np.random.default_rng(3)
    B, n_kv, S, hd, T = 2, 2, 32, 16, 5
    new_k = (rng.standard_normal((B, T, n_kv, hd)) * 300).astype(np.float32)
    new_v = (rng.standard_normal((B, T, n_kv, hd)) * 300).astype(np.float32)
    pos = np.array([3, 19], np.int32) if tensor_pos else np.int32(7)
    k = torch.zeros((B, n_kv, S, hd), dtype=F8)
    v = torch.zeros_like(k)
    start = torch.from_numpy(pos) if tensor_pos else int(pos)
    update_layer(k, v, torch.from_numpy(new_k), torch.from_numpy(new_v), start)
    jk = jnp.zeros((B, n_kv, S, hd), jnp.float8_e4m3fn)
    jk, jv = jax_update_layer(jk, jk, jnp.asarray(new_k), jnp.asarray(new_v), jnp.asarray(pos))
    np.testing.assert_array_equal(k.view(torch.uint8).numpy(), np.asarray(jk).view(np.uint8))
    np.testing.assert_array_equal(v.view(torch.uint8).numpy(), np.asarray(jv).view(np.uint8))
    assert np.isnan(k.float().numpy()).any()  # some |x| > 464 became NaN


def _f8(rng, shape) -> torch.Tensor:
    return to_cache(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)), F8)


def test_plain_k3_matches_interpreted_jax_flash_on_f8_cache():
    rng = np.random.default_rng(31)
    B, T, H, KV, D, S = 1, 4, 8, 4, 32, 256
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k8, v8 = _f8(rng, (B, KV, S, D)), _f8(rng, (B, KV, S, D))
    got = fa.flash_attention(torch.from_numpy(q), k8, v8, 21, D).numpy()
    want = np.asarray(jax_flash(jnp.asarray(q), _to_jax(k8), _to_jax(v8), jnp.int32(21), D,
                                interpret=True))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    positions = 21 + jnp.arange(T, dtype=jnp.int32)[None, :]
    oracle = np.asarray(jax_attention(jnp.asarray(q), _to_jax(k8), _to_jax(v8), positions, D))
    np.testing.assert_allclose(got, oracle, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("q_pos0,kv_pos0", [(170, 128), (300, 0), (10, 128)],
                         ids=["diagonal", "whole", "masked"])
def test_plain_k3s_matches_interpreted_jax_block_stats_on_f8_block(q_pos0, kv_pos0):
    rng = np.random.default_rng(q_pos0)
    B, n_kv, t, kv_mul, D, S = 1, 2, 3, 4, 32, 128
    q_g = rng.standard_normal((B, n_kv, t * kv_mul, D)).astype(np.float32)
    k8, v8 = _f8(rng, (B, n_kv, S, D)), _f8(rng, (B, n_kv, S, D))
    got = fa.flash_block_stats(torch.from_numpy(q_g), k8, v8, q_pos0, kv_pos0, D, t)
    want = jax_block_stats(jnp.asarray(q_g), _to_jax(k8), _to_jax(v8), jnp.int32(q_pos0),
                           jnp.int32(kv_pos0), D, t, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


def test_plain_k4_matches_jax_on_f8_pool():
    rng = np.random.default_rng(5)
    B, T, H, KV, D, bs, M, nb = 3, 2, 8, 2, 32, 16, 4, 12
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    kp, vp = _f8(rng, (nb, KV, bs, D)), _f8(rng, (nb, KV, bs, D))
    tables = rng.integers(1, nb, (B, M)).astype(np.int32)
    positions = (np.array([5, 33, 60], np.int32)[:, None]
                 + np.arange(T, dtype=np.int32)[None, :])
    got = pa.paged_attention(torch.from_numpy(q), kp, vp, torch.from_numpy(tables),
                             torch.from_numpy(positions), D).numpy()
    pallas = np.asarray(paged_ragged_attention(
        jnp.asarray(q), _to_jax(kp), _to_jax(vp), jnp.asarray(tables), jnp.asarray(positions),
        D, interpret=True), np.float32)
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)


# -- the engine ---------------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_kv8")
    tok = byte_vocab_tokenizer()
    hdr = tiny_header_params(vocab_size=tok.vocab_size, seq_len=96, weight_type=quants.Q40)
    write_tiny_model(d / "m.m", hdr, np.random.default_rng(21))
    tfile.write_tfile(d / "t.t", tok)
    return str(d / "m.m"), str(d / "t.t")


PROMPT = "the quick brown fox jumps"


def _prefill_logits(eng) -> np.ndarray:
    try:
        return np.asarray(eng.prefill(eng.tokenizer.encode(PROMPT))[0], np.float32)
    finally:
        eng.close()


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_engine_f8_prefill_logits_match_jax_f8_engine(files, compute):
    eng = InferenceEngine(*files, device="cpu", kv_dtype="f8", compute_dtype=compute)
    assert eng.kv.k.dtype == F8
    got = _prefill_logits(eng)
    want = _prefill_logits(JaxEngine(*files, tp=1, kv_dtype="f8", compute_dtype=compute))
    scale = max(np.abs(want).max(), 1.0)
    # f32: both round the same K/V at the same write; bf16: the fast-mode
    # bound of test_torch_model.py
    tol = 1e-4 if compute == "float32" else 3e-2 * scale
    assert np.abs(got - want).max() <= tol


def test_engine_f8_logits_drift_from_f32_cache_bounded(files):
    rows = {kvd: _prefill_logits(InferenceEngine(*files, device="cpu", kv_dtype=kvd))
            for kvd in ("f32", "f8")}
    diff = np.abs(rows["f8"] - rows["f32"]).max()
    ref = np.abs(rows["f32"]).max()
    assert 0 < diff < 0.15 * max(ref, 1.0), (diff, ref)


def _gen(eng, prompt="hello hello hello", n=16):
    try:
        return eng.generate(prompt, n, stop_on_eos=False).tokens
    finally:
        eng.close()


@pytest.fixture(scope="module")
def f8_reference(files):
    """Greedy f8 tokens of the single-step port engine and of JAX's."""
    got = _gen(InferenceEngine(*files, device="cpu", kv_dtype="f8", temperature=0.0))
    want = _gen(JaxEngine(*files, tp=1, kv_dtype="f8", temperature=0.0))
    assert got == want and len(got) == 16
    return got


@pytest.mark.parametrize("kw", [{"sp": 2}, {"spec_lookup": 3}, {"decode_chunk": 4}],
                         ids=["sp2", "spec3", "chunk4"])
def test_f8_cache_runs_on_every_engine_path(files, f8_reference, kw):
    eng = InferenceEngine(*files, device="cpu", kv_dtype="f8", temperature=0.0, **kw)
    if "sp" in kw:
        assert all(t.dtype == F8 for t in eng.kv.k)
    assert _gen(eng) == f8_reference


@pytest.mark.parametrize("block", [16, 0], ids=["paged_pool", "dense_slot_pool"])
def test_f8_serving_pools_token_equal_solo(files, block):
    prompts = ["hello world", "hello there", "abc", "hello world how are you"]
    solo = JaxEngine(*files, tp=1, kv_dtype="f8", temperature=0.0)
    try:
        want = []
        for p in prompts:
            solo.reset()
            want.append(solo.generate(solo.tokenizer.encode(p, is_start=True), 8,
                                      stop_on_eos=False).tokens)
    finally:
        solo.close()
    eng = InferenceEngine(*files, device="cpu", kv_dtype="f8", kv_block_size=block)
    sched = BatchScheduler(eng, n_slots=2)
    try:
        reqs = [sched.submit(eng.tokenizer.encode(p, is_start=True), 8, stop_on_eos=False,
                             temperature=0.0, seed=1) for p in prompts]
        for r in reqs:
            assert r.done.wait(timeout=300) and r.error is None, r.error
        pool = sched.gen.pkv.k if block else sched.gen.kv.k
        assert pool.dtype == F8
        assert [r.tokens for r in reqs] == want
    finally:
        sched.close()
        eng.close()


def test_bad_kv_dtype_rejected(files):
    with pytest.raises(ValueError, match="kv_dtype"):
        InferenceEngine(*files, device="cpu", kv_dtype="int8")


@pytest.mark.parametrize("T,S", [(1, 2048), (256, 32768), (64, 2048)])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_path_rule_on_f8_cache(T, S, q_dtype):
    """An e4m3 cache's single pass runs on the tensor cores under bf16
    queries (widened to bf16 exactly) and on the SIMT kernel under f32
    ones, whose queries the tensor cores would round; split launches stay
    SIMT. The bf16 and f32 caches' rule is unchanged."""
    n = fa._attn_splits(1, 8, 4 * T, S)
    want = "tc" if n == 1 and q_dtype == torch.bfloat16 else "simt"
    assert fa._attn_path(F8, n, q_dtype) == want
    assert fa._attn_path(torch.bfloat16, n, q_dtype) == ("tc" if n == 1 else "simt")
    assert fa._attn_path(torch.float32, n, q_dtype) == "simt"


def test_tc_twin_reads_f8_cache_as_its_bf16_widening():
    """The tensor-core path's plain twin over an e4m3 cache is the twin over
    the same values held in bf16 (e4m3 widens to bf16 exactly), so the
    kernel's f8 route is held to the twin the bf16 route is held to."""
    rng = np.random.default_rng(41)
    q = torch.from_numpy(rng.standard_normal((1, 64, 8, 64)).astype(np.float32)).to(torch.bfloat16)
    k8, v8 = _f8(rng, (1, 2, 256, 64)), _f8(rng, (1, 2, 256, 64))
    got = fa.flash_attention_tc_plain(q, k8, v8, 100, 64)
    want = fa.flash_attention_tc_plain(q, k8.to(torch.bfloat16), v8.to(torch.bfloat16), 100, 64)
    assert torch.equal(k8.to(torch.bfloat16).float(), k8.float())
    torch.testing.assert_close(got, want, rtol=0, atol=0)
