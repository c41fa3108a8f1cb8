"""Port kernels K1/K2 (Q40 dequant matmul): their plain versions — what the
wrappers run on a CPU tensor — against the JAX package's Pallas kernels in
interpret mode and its XLA ``linear``, on the same numpy-seeded inputs.
The CUDA kernels themselves are held against the plain version on the card
by ``chip_smoke.py`` (the card's machine has no JAX for this file)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dllama_tpu.ops.linear import linear as jax_linear
from dllama_tpu.ops.linear import quantize_weight_q40 as jax_q40
from dllama_tpu.ops.quant_matmul import quant_matmul as jax_quant_matmul
from dllama_tpu_torch.ops import quant_matmul as qm
from dllama_tpu_torch.ops.linear import QuantizedWeight, dequantize_weight, linear

# exact: f32 products, sums in another order -> 1e-5 of max|y|;
# fast: bf16 operands (8-bit mantissa) summed in another order, and the JAX
# interpret-mode kernel rounds its dequant at other places -> 1e-2 of max|y|
TOL = {False: 1e-5, True: 1e-2}


def _pair(out, in_, seed, scale_dtype=torch.float32):
    rng = np.random.default_rng(seed)
    jw = jax_q40((rng.standard_normal((out, in_)) * 0.1).astype(np.float32))
    tw = QuantizedWeight(scales=torch.tensor(np.asarray(jw.scales)).to(scale_dtype),
                         codes=torch.tensor(np.asarray(jw.codes)))
    return jw, tw


def _close(got, want, fast):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= TOL[fast] * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("m", [1, 4, 16, 64])
def test_plain_matches_pallas_tiled_kernel(m, fast):
    jw, tw = _pair(256, 512, seed=m)
    x = np.random.default_rng(100 + m).standard_normal((m, 512)).astype(np.float32)
    want = jax_quant_matmul(jnp.asarray(x), jw, interpret=True, fast=fast)
    wrapper = qm.q40_gemv if m <= qm.FUSED_MAX_M else qm.q40_matmul
    _close(wrapper(torch.from_numpy(x), tw, fast=fast), want, fast)
    _close(qm.quant_matmul(torch.from_numpy(x), tw, fast=fast), want, fast)


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("m", [1, 4, 16])
def test_plain_matches_pallas_fused_decode_kernel(m, fast):
    jw, tw = _pair(256, 512, seed=7 + m)
    x = np.random.default_rng(m).standard_normal((m, 512)).astype(np.float32)
    want = jax_quant_matmul(jnp.asarray(x), jw, interpret=True, fast=fast, fused=True)
    _close(qm.q40_gemv(torch.from_numpy(x), tw, fast=fast), want, fast)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 64])
def test_linear_matches_jax_linear(m, compute):
    """The model-level entry: dtype in = dtype out, exact/fast resolved from
    the activation dtype like the JAX package; bf16 scales force fast."""
    fast = compute == "bfloat16"
    jw, tw = _pair(128, 256, seed=3 * m,
                   scale_dtype=torch.bfloat16 if fast else torch.float32)
    x = np.random.default_rng(m).standard_normal((1, m, 256)).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if fast else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, compute))
    want = jax_linear(jx, jw)
    got = linear(tx, tw)
    assert got.dtype == tx.dtype and got.shape == (1, m, 128)
    _close(got.float(), np.asarray(want, dtype=np.float32), fast)
    # the plain version by name gives the same numbers as the wrapper
    _close(linear(tx, tw, impl="xla").float(), got.float(), fast)


def test_bf16_scales_force_fast_numerics():
    jw, tw = _pair(64, 128, seed=1)
    tw16 = QuantizedWeight(scales=tw.scales.to(torch.bfloat16), codes=tw.codes)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 128)).astype(np.float32))
    got = linear(x, tw16)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  qm.quant_matmul_plain(x, tw16, fast=True).numpy())


def test_dequantize_matches_jax():
    from dllama_tpu.ops.linear import dequantize_weight as jax_dequant

    jw, tw = _pair(96, 64, seed=5)
    np.testing.assert_array_equal(dequantize_weight(tw).numpy(), np.asarray(jax_dequant(jw)))
    np.testing.assert_array_equal(
        dequantize_weight(tw, torch.bfloat16).float().numpy(),
        np.asarray(jax_dequant(jw, jnp.bfloat16), dtype=np.float32))


def test_supports_gates():
    _, tw = _pair(256, 512, seed=0)
    assert qm.supports((64, 512), tw) and qm.supports((1024, 512), tw)
    assert not qm.supports((4, 256), tw)              # K mismatch
    assert qm.supports_decode((1, 16, 512), tw)
    assert not qm.supports_decode((2, 16, 512), tw)  # M = 32 > FUSED_MAX_M
    _, odd = _pair(250, 512, seed=0)
    assert not qm.supports_decode((1, 512), odd)      # N % 4 != 0


@pytest.mark.parametrize("N,fast_ok", [(1024, True), (1040, True), (1028, False), (100, False)])
def test_fast_tile_needs_n_multiple_of_16(N, fast_ok):
    """K1's fast tile copies rows of codes by TMA, whose pitch must be a
    multiple of 16 bytes: ``supports(fast=True)`` refuses any other N (the
    wrapper raises on it on the card); the exact tile and K2 take it."""
    _, tw = _pair(N, 64, seed=0)
    assert qm.supports((128, 64), tw)
    assert qm.supports((128, 64), tw, fast=True) == fast_ok
    assert qm.supports_decode((1, 64), tw)


@pytest.mark.parametrize("K,N", [(4096, 1024), (4096, 4096), (14336, 4096),
                                 (4096, 14336), (4096, 128256), (64, 96)])
def test_gemv_split_plan_covers_k(K, N):
    """K2's cross-block K split: every Q40 block lands in exactly one split,
    each split gives all 8 warps work, narrow N still puts at least one
    block on each of the H100's 132 SMs, and a split grid fits in one wave
    of resident blocks."""
    s = qm._gemv_splits(K, N)
    nkb = K // 32
    per = -(-nkb // s)
    assert s >= 1 and (s - 1) * per < nkb <= s * per
    col_blocks = -(-N // 128)
    if s > 1:
        assert per >= 8
        assert col_blocks * s >= min(132, col_blocks * (nkb // 8))
        assert col_blocks * s <= qm._RESIDENT_BLOCKS  # one wave, no idle tail


@pytest.mark.parametrize("M", [32, 128, 256])
@pytest.mark.parametrize("K,N", [(4096, 1024), (4096, 4096), (14336, 4096),
                                 (4096, 14336), (4096, 128256), (4128, 1040), (64, 96)])
def test_matmul_split_plan_covers_k(M, K, N):
    """K1's cross-block K split: every 64-row stage of K lands in exactly
    one split, no split is empty, a split walks at least the minimum
    number of stages, and a split grid fits the H100's 132 SMs in one
    wave (one tile block per SM); a grid of fewer tiles than SMs with
    room to split does split."""
    s = qm._matmul_splits(M, K, N)
    n_stages = -(-K // qm._STAGE_K)
    per = -(-n_stages // s)
    assert s >= 1 and (s - 1) * per < n_stages <= s * per
    tiles = -(-N // qm._TILE_N) * -(-M // qm._TILE_M)
    if s > 1:
        assert per >= qm._MIN_SPLIT_STAGES
        assert tiles * s <= qm.SMS
    elif tiles * 2 <= qm.SMS:
        assert n_stages < 2 * qm._MIN_SPLIT_STAGES


@pytest.mark.parametrize("M", [32, 64, 128, 256])
@pytest.mark.parametrize("K,N", [(4096, 1024), (4096, 4096), (14336, 4096),
                                 (4096, 14336), (4096, 128256), (4128, 1040), (64, 96)])
def test_exact_matmul_split_plan_covers_k(M, K, N):
    """K1 exact's cross-block K split: whole Q40 blocks per split, every
    K row in exactly one split, no empty split, at least the minimum number
    of stages a split, a split grid within the H100's 132 SMs; the head's
    width (1002 column tiles) never splits."""
    s = qm._matmul_splits(M, K, N, fast=False)
    nkb = K // 32
    per = -(-nkb // s)                      # Q40 blocks per split
    assert s >= 1 and (s - 1) * per < nkb <= s * per
    covered = [kb for z in range(s) for kb in range(z * per, min(nkb, (z + 1) * per))]
    assert covered == list(range(nkb))      # each 32-row block (and K row) once
    tiles = -(-N // qm._EXACT_TILE_N) * -(-M // qm._exact_tile_m(M))
    if s > 1:
        assert per >= qm._EXACT_MIN_SPLIT_STAGES
        assert tiles * s <= qm.SMS
    if N == 128256:
        assert s == 1


@pytest.mark.parametrize("M,bm", [(17, 32), (32, 32), (33, 64), (64, 64), (65, 128), (512, 128)])
def test_exact_tile_rows(M, bm):
    assert qm._exact_tile_m(M) == bm


def test_wrapper_refuses_other_devices():
    _, tw = _pair(64, 128, seed=0)
    with pytest.raises(ValueError, match="unsupported device"):
        qm.q40_gemv(torch.zeros((1, 128), device="meta"), tw, fast=False)
