"""Kernel K4's plain version (the port's gather + oracle over ``pool[tables]``)
against the JAX package's gather + ``ops.attention.attention`` and its
Pallas kernel ``paged_ragged_attention`` in interpret mode, on the
geometries of ``tests/test_paged_attention.py``: scrambled tables, partial
tail blocks and ragged rows, shared and null-redirected blocks, T in
{1, 16}, head dims 40/72/128, a bf16 pool. Plus ``supports`` and the gate.

Tolerances: the two gather + oracle pairs run the same f32 math summed in
another order (PyTorch's CPU einsum vs XLA's dot): 2e-6 absolute on outputs
of magnitude ~1. Against the Pallas kernel in interpret mode 1e-6: on this
jax version it is not bitwise against its own gather + oracle either (a few
ulps, max 2.4e-7 measured; ROADMAP C1)."""

from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops.attention import attention as jax_attention
from dllama_tpu.ops.paged_attention import paged_ragged_attention
from dllama_tpu_torch.ops import flash_attention as fa
from dllama_tpu_torch.ops import paged_attention as pa

ORACLE_ATOL = 2e-6
PALLAS_ATOL = 1e-6


def _jax_reference(q, k_pool, v_pool, tables, positions, hd):
    B, M = tables.shape
    n_kv, bs = k_pool.shape[1], k_pool.shape[2]

    @jax.jit
    def ref(q, k_pool, v_pool, tables, positions):
        def view(pool):
            return jnp.moveaxis(pool[tables], 2, 1).reshape(B, n_kv, M * bs, hd)

        return jax_attention(q, view(k_pool), view(v_pool), positions, hd)

    return np.asarray(ref(q, k_pool, v_pool, tables, positions), np.float32)


def _case(seed, B, T, n_heads, n_kv, hd, bs, M, nb, tables, pos0):
    rng = np.random.default_rng(seed)
    k_pool = rng.standard_normal((nb, n_kv, bs, hd)).astype(np.float32)
    v_pool = rng.standard_normal((nb, n_kv, bs, hd)).astype(np.float32)
    q = rng.standard_normal((B, T, n_heads, hd)).astype(np.float32)
    if callable(tables):
        tables = tables(rng)
    tables = np.asarray(tables, np.int32).reshape(B, M)
    positions = (np.asarray(pos0, np.int32)[:, None]
                 + np.arange(T, dtype=np.int32)[None, :])
    return q, k_pool, v_pool, tables, positions


GEOMETRIES = {
    # (seed, B, T, n_heads, n_kv, hd, bs, M, nb, tables, pos0)
    "scrambled": (0, 3, 1, 8, 2, 16, 16, 4, 14,
                  lambda r: r.permutation(np.arange(1, 13)), [37, 5, 63]),
    "partial_tail_ragged": (1, 4, 1, 8, 4, 32, 16, 8, 40,
                            lambda r: r.integers(1, 40, (4, 8)), [0, 15, 16, 55]),
    "shared_and_null": (2, 3, 1, 4, 2, 16, 16, 6, 10,
                        [5, 6, 7, 0, 0, 0, 5, 6, 8, 0, 0, 0, 9, 3, 0, 0, 0, 0],
                        [35, 41, 17]),
    "t1": (4, 2, 1, 8, 2, 16, 16, 6, 20, lambda r: r.integers(1, 20, (2, 6)), [3, 33]),
    "t16": (19, 2, 16, 8, 2, 16, 16, 6, 20, lambda r: r.integers(1, 20, (2, 6)), [3, 33]),
    "hd40": (11, 2, 2, 4, 4, 40, 8, 4, 9, lambda r: r.integers(0, 9, (2, 4)), [7, 19]),
    "hd72": (11, 2, 2, 4, 4, 72, 8, 4, 9, lambda r: r.integers(0, 9, (2, 4)), [7, 19]),
    "hd128_8b_group": (5, 2, 1, 8, 2, 128, 16, 4, 12,
                       lambda r: r.permutation(np.arange(1, 12))[:8], [0, 63]),
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_plain_matches_jax_gather_oracle_and_pallas(name):
    q, kp, vp, tables, positions = _case(*GEOMETRIES[name])
    hd = q.shape[-1]
    got = pa.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                             torch.from_numpy(vp), torch.from_numpy(tables),
                             torch.from_numpy(positions), hd).numpy()
    want = _jax_reference(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                          jnp.asarray(tables), jnp.asarray(positions), hd)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ORACLE_ATOL)
    pallas = np.asarray(paged_ragged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(positions), hd, interpret=True), np.float32)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=PALLAS_ATOL)


def test_bf16_pool_matches_jax():
    """The serving pool dtype under bf16 compute: both sides widen the same
    bf16 rows to f32 exactly, so the f32 tolerance holds."""
    q, kp, vp, tables, positions = _case(
        21, 2, 1, 4, 2, 16, 16, 4, 8, lambda r: r.integers(1, 8, (2, 4)), [9, 47])
    hd = q.shape[-1]
    kb = torch.from_numpy(kp).to(torch.bfloat16)
    vb = torch.from_numpy(vp).to(torch.bfloat16)
    got = pa.paged_attention(torch.from_numpy(q), kb, vb, torch.from_numpy(tables),
                             torch.from_numpy(positions), hd).numpy()
    want = _jax_reference(jnp.asarray(q), jnp.asarray(kb.float().numpy(), jnp.bfloat16),
                          jnp.asarray(vb.float().numpy(), jnp.bfloat16),
                          jnp.asarray(tables), jnp.asarray(positions), hd)
    np.testing.assert_allclose(got, want, rtol=0, atol=ORACLE_ATOL)


def test_paged_view_equals_dense_column():
    """``paged_view`` is the dense head-major cache the table describes."""
    rng = np.random.default_rng(3)
    pool = torch.from_numpy(rng.standard_normal((6, 2, 4, 8)).astype(np.float32))
    tables = torch.tensor([[4, 1, 0], [2, 2, 5]])
    view = pa.paged_view(pool, tables)
    assert view.shape == (2, 2, 12, 8)
    for b in range(2):
        for m in range(3):
            torch.testing.assert_close(view[b, :, 4 * m:4 * m + 4],
                                       pool[tables[b, m]], rtol=0, atol=0)


def test_supports_states_the_kernel_limits():
    assert pa.supports((8, 1, 32, 128), 8, 16)        # Llama 3.1 8B decode
    assert pa.supports((1, 128, 32, 128), 8, 32)      # a 128-token chunk: 512 rows
    assert pa.supports((2, 2, 4, 72), 4, 8)
    assert not pa.supports((1, 129, 32, 128), 8, 16)  # 516 folded rows
    assert not pa.supports((1, 1, 32, 256), 8, 16)    # head dim above 128
    assert not pa.supports((1, 1, 4, 36), 4, 16)      # head dim not a multiple of 8
    assert not pa.supports((1, 1, 32, 128), 8, 4)     # block size not a multiple of 8
    assert not pa.supports((1, 1, 6, 64), 4, 16)      # heads not a multiple of n_kv


def test_gate_plain_on_cpu_and_xla_kernel_or_raise_on_cuda():
    """The model's gate is ``_use_flash``: ``xla`` → plain; ``auto`` → the
    K4 wrapper on a CUDA tensor and plain on a CPU tensor; the wrapper on a
    CPU tensor runs the plain version, and on a CUDA-typed q with shapes
    the kernel cannot take raises before touching the card."""
    from dllama_tpu_torch.formats import mfile
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(arch=mfile.ArchType.LLAMA, dim=64, hidden_dim=128, n_layers=1,
                      n_heads=4, n_kv_heads=2, head_dim=16, vocab_size=96, seq_len=64,
                      norm_epsilon=1e-5, rope_theta=1e4, rope_type=mfile.RopeType.LLAMA)
    q = torch.zeros((1, 1, 4, 16))
    assert not llama._use_flash(cfg, q)
    assert not llama._use_flash(dataclasses.replace(cfg, attn_impl="xla"), q)
    q_cuda = types.SimpleNamespace(device=torch.device("cuda"), shape=(1, 1, 4, 36))
    assert llama._use_flash(cfg, q_cuda)
    assert not llama._use_flash(dataclasses.replace(cfg, attn_impl="xla"), q_cuda)
    pool = torch.empty((3, 2, 16, 36), device="meta")
    tables = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="not supported"):
        pa.paged_attention(q_cuda, pool, pool, tables, torch.zeros((1, 1)), 36)
    # a CPU tensor takes the plain version, and no launch is counted
    before = pa.paged_attention.launches
    q, kp, vp, tables, positions = _case(*GEOMETRIES["t1"])
    got = pa.paged_attention(*(torch.from_numpy(a) for a in (q, kp, vp, tables, positions)),
                             16)
    want = pa.paged_attention_plain(*(torch.from_numpy(a)
                                      for a in (q, kp, vp, tables, positions)), 16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert pa.paged_attention.launches == before


# --- K4's split-S plan and its arithmetic, emulated plainly ---


@pytest.mark.parametrize("B,n_kv,TQ,S,want", [
    (1, 8, 4, 2048, 32),      # Llama 3.1 8B decode, one row: 8 blocks -> 256
    (8, 8, 4, 2048, 9),       # the 8-slot serving step: 64 blocks -> 576
    (2, 8, 64, 2048, 9),      # a 16-token query chunk of two rows
    (32, 8, 4, 2048, 3),      # 256 blocks, under two an SM
    (64, 8, 4, 2048, 1),      # 512 blocks fill the card unsplit
    (1, 8, 4, 64, 1),         # two 32-key tiles: nothing to split
    (1, 8, 4, 256, 4),        # at least two tiles a split
])
def test_paged_split_count_from_shapes(B, n_kv, TQ, S, want):
    """The split count is a function of the shapes alone (B, n_kv, the
    folded rows and the table's reach), never of the positions: about four
    blocks per SM, at least two 32-key tiles a split, no split when the
    grid already holds two blocks per SM. Unlike K3's rule it splits the
    64-block serving step."""
    n = pa._paged_splits(B, n_kv, TQ, S)
    assert n == want
    blocks = -(-TQ // fa.BQ) * n_kv * B
    if n > 1:
        assert blocks < 2 * pa.SMS and n <= -(-S // fa.BS) // 2
        assert blocks * (n - 1) < 4 * pa.SMS  # one split fewer would not reach the aim


@pytest.mark.parametrize("n_splits", [1, 2, 5, 32])
@pytest.mark.parametrize("newest", [0, 1, 31, 32, 100, 1023, 2047])
def test_paged_split_ranges_cover_every_visible_key_once(newest, n_splits):
    """Each row's split ranges are whole 32-key tiles that cover its keys
    [0, newest] exactly once, in split order; splits past a short row's
    end are empty (they load nothing)."""
    from dllama_tpu_torch.ops.flash_attention import _split_ranges

    ranges = _split_ranges(newest, n_splits)
    assert len(ranges) == n_splits
    keys = [s for lo, hi in ranges for s in range(lo, hi)]
    assert keys == list(range(0, (newest // fa.BS + 1) * fa.BS))
    assert all(lo % fa.BS == 0 and hi % fa.BS == 0 and lo <= hi for lo, hi in ranges)


def _split_emulation(q, kp, vp, tables, positions, hd, n_splits):
    """K4's split-S arithmetic plainly: per (row, 16-row query tile), the
    tile's newest visible key from the row's own position, its whole-tile
    ranges (``_split_ranges``), each range's unnormalised ``(acc, m, l)``
    from ``flash_block_stats_plain`` (the port's ``_block_attn``), merged in
    split order as ``combine_splits_kernel`` does."""
    from dllama_tpu_torch.ops.flash_attention import (_split_ranges, flash_block_stats_plain,
                                                      fold_queries, unfold_output)

    B, T, n_heads, D = q.shape
    n_kv = kp.shape[1]
    kv_mul = n_heads // n_kv
    S = tables.shape[1] * kp.shape[2]
    qg = fold_queries(q, n_kv)
    kview, vview = pa.paged_view(kp, tables), pa.paged_view(vp, tables)
    out = torch.zeros_like(qg)
    for b in range(B):
        for r0 in range(0, T * kv_mul, fa.BQ):
            rows = min(fa.BQ, T * kv_mul - r0)
            pos_r0 = int(positions[b, 0]) + r0 // kv_mul
            newest = min(S - 1, int(positions[b, 0]) + (r0 + rows - 1) // kv_mul)
            parts = []
            for lo, hi in _split_ranges(newest, n_splits):
                hi = min(hi, S)
                if lo >= hi:   # past the row's end: nothing loaded
                    parts.append((torch.zeros((1, n_kv, rows, D)),
                                  torch.full((1, n_kv, rows), float("-inf")),
                                  torch.zeros((1, n_kv, rows))))
                    continue
                parts.append(flash_block_stats_plain(
                    qg[b:b + 1, :, r0:r0 + rows], kview[b:b + 1, :, lo:hi],
                    vview[b:b + 1, :, lo:hi], pos_r0, lo, hd, rows // kv_mul))
            mx = torch.stack([m for _, m, _ in parts]).amax(0)
            m_safe = torch.where(torch.isfinite(mx), mx, 0.0)
            acc = torch.zeros((1, n_kv, rows, D))
            L = torch.zeros((1, n_kv, rows))
            for a, m, l in parts:
                w = torch.exp(m - m_safe)
                L = L + l * w
                acc = acc + a * w[..., None]
            out[b:b + 1, :, r0:r0 + rows] = acc / torch.where(L > 0, L, 1.0)[..., None]
    return unfold_output(out, T, n_heads)


@pytest.mark.parametrize("pool", ["f32", "bf16"])
@pytest.mark.parametrize("n_splits", [1, 2, 5])
@pytest.mark.parametrize("name", ["scrambled", "partial_tail_ragged", "shared_and_null", "t16",
                                  "hd72"])
def test_split_combine_emulation_matches_jax_oracle(name, n_splits, pool):
    """The split + combine arithmetic against the JAX package's gather +
    oracle, f32 and bf16 pools (widened exactly on both sides): the merge
    reorders sums and exps, 1e-5 absolute on outputs of magnitude ~1."""
    q, kp, vp, tables, positions = _case(*GEOMETRIES[name])
    hd = q.shape[-1]
    kt, vt = torch.from_numpy(kp), torch.from_numpy(vp)
    if pool == "bf16":
        kt, vt = kt.to(torch.bfloat16), vt.to(torch.bfloat16)
    got = _split_emulation(torch.from_numpy(q), kt, vt, torch.from_numpy(tables),
                           torch.from_numpy(positions), hd, n_splits).numpy()
    jdt = jnp.bfloat16 if pool == "bf16" else jnp.float32
    want = _jax_reference(jnp.asarray(q), jnp.asarray(kt.float().numpy(), jdt),
                          jnp.asarray(vt.float().numpy(), jdt), jnp.asarray(tables),
                          jnp.asarray(positions), hd)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
