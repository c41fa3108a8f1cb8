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
