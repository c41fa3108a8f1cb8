"""The port's paged program family against the JAX package's on the same
weights (``init_random_params`` (JAX) → numpy → ``from_jax_params``) and
the same pool contents: ``paged_forward`` through scrambled block tables
(a prefill chunk, and a ragged decode step with an inactive ride-along
row), ``paged_sampled_step`` against ``paged_sampled_step_guarded``
(poison 0) on shared per-row temperatures, top-ps and coins, and the
port's ``paged_forward`` against its own dense ``forward`` bit for bit.

Tolerances are those of ``tests/test_torch_model.py``, for the same
reasons: f32 sums taken in another order by the two frameworks, 1e-4
absolute on logits of magnitude ~1; bf16 rounds every activation at op
boundaries the frameworks place differently, 3e-2 of max |logit|. The
pools compare with the same bounds (they hold the K/V the two sides
computed). Within the port, the block table is value-invisible: the plain
gather materializes exactly the dense cache's rows and the oracle runs the
same shapes, so paged equals dense bitwise."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.models import llama as jax_llama
from dllama_tpu.runtime import kvblocks as jax_kvblocks
from dllama_tpu_torch.models import llama
from dllama_tpu_torch.runtime.kvblocks import PagedKVCache, blocks_per_seq
from dllama_tpu_torch.runtime.kvcache import KVCache

from test_torch_model import BF16_RTOL, F32_ATOL, _configs, _pair

BS = 8


def _pools(cfg, n_blocks, seed, dtype):
    """The same random pool contents (stand-in history) for both sides."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, n_blocks, cfg.n_kv_heads, BS, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    tdt = getattr(torch, dtype)
    pkv = PagedKVCache(k=torch.from_numpy(k).to(tdt), v=torch.from_numpy(v).to(tdt))
    jdt = jnp.dtype(dtype)
    # the JAX side gets the port's (possibly bf16-rounded) values exactly
    jkv = jax_kvblocks.PagedKVCache(k=jnp.asarray(pkv.k.float().numpy(), jdt),
                                    v=jnp.asarray(pkv.v.float().numpy(), jdt))
    return pkv, jkv


def _tables(cfg, n_rows, n_blocks, seed, null_rows=()):
    """Scrambled physical placement: every row's logical blocks land at
    distinct permuted pool ids; ``null_rows`` get all-null tables (the
    inactive ride-along rows of a decode step)."""
    M = blocks_per_seq(cfg.seq_len, BS)
    perm = np.random.default_rng(seed).permutation(np.arange(1, n_blocks))
    tables = perm[:n_rows * M].reshape(n_rows, M).astype(np.int32)
    for r in null_rows:
        tables[r] = 0
    return tables


def _compare(dtype, got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    else:
        err = np.abs(got - want).max()
        assert err <= BF16_RTOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("phase", ["prefill", "ragged_decode"])
def test_paged_forward_matches_jax(dtype, phase):
    cfg, jcfg = _configs("llama", dtype, sync_q80=True)
    jparams, params = _pair(cfg, jcfg, seed=13)
    M = blocks_per_seq(cfg.seq_len, BS)
    n_blocks = 3 * M + 1
    pkv, jkv = _pools(cfg, n_blocks, seed=4, dtype=dtype)
    rng = np.random.default_rng(6)
    if phase == "prefill":  # two rows, a 12-token chunk each at depths 0 and 20
        tables = _tables(cfg, 2, n_blocks, seed=1)
        tokens = rng.integers(0, cfg.vocab_size, (2, 12))
        pos = np.array([0, 20])
    else:  # three ragged rows, the last inactive with an all-null table
        tables = _tables(cfg, 3, n_blocks, seed=2, null_rows=(2,))
        tokens = rng.integers(0, cfg.vocab_size, (3, 1))
        pos = np.array([5, 41, 17])
    logits, pkv = llama.paged_forward(params, cfg, torch.from_numpy(tokens),
                                      torch.from_numpy(pos), pkv, torch.from_numpy(tables))
    jlogits, jkv = jax_llama.paged_forward(
        jparams, jcfg, jnp.asarray(tokens, jnp.int32), jnp.asarray(pos, jnp.int32),
        jkv, jnp.asarray(tables))
    _compare(dtype, logits.numpy(), jlogits)
    _compare(dtype, pkv.k.float().numpy(), np.asarray(jkv.k, np.float32))
    _compare(dtype, pkv.v.float().numpy(), np.asarray(jkv.v, np.float32))


def test_paged_forward_equals_dense_forward_bitwise():
    """A 24-token prefill and two decode steps through a descending
    (scrambled) block table give the dense ``forward``'s logits bit for bit,
    and the pool rows gathered back through the table equal the dense
    cache's rows."""
    cfg, jcfg = _configs("llama", "float32", sync_q80=True)
    _, params = _pair(cfg, jcfg, seed=7)
    M = blocks_per_seq(cfg.seq_len, BS)
    n_blocks = 2 * M + 1
    table = torch.arange(n_blocks - 1, n_blocks - 1 - M, -1)[None]
    pkv = PagedKVCache.create(cfg, n_blocks, BS)
    kv = KVCache.create(cfg)
    rng = np.random.default_rng(5)
    steps = [rng.integers(0, cfg.vocab_size, (1, 24))] + [
        rng.integers(0, cfg.vocab_size, (1, 1)) for _ in range(2)]
    pos = 0
    for toks in steps:
        t = torch.from_numpy(toks)
        dense, kv = llama.forward(params, cfg, t, pos, kv)
        paged, pkv = llama.paged_forward(params, cfg, t, torch.tensor([pos]), pkv, table)
        assert torch.equal(dense, paged)
        pos += toks.shape[1]
    col = pkv.k[:, table[0]].transpose(1, 2).reshape(
        cfg.n_layers, cfg.n_kv_heads, M * BS, cfg.head_dim)
    assert torch.equal(col[:, :, :pos], kv.k[:, 0, :, :pos])


def test_paged_sampled_step_matches_jax_guarded_step():
    """One ragged decode step over four rows — greedy, two sampled at
    different temperatures/top-ps, and an inactive ride-along row — picks
    the JAX package's tokens from the same host coins, with no non-finite
    lanes."""
    cfg, jcfg = _configs("llama", "float32", sync_q80=True)
    jparams, params = _pair(cfg, jcfg, seed=5)
    M = blocks_per_seq(cfg.seq_len, BS)
    n_blocks = 4 * M + 1
    pkv, jkv = _pools(cfg, n_blocks, seed=8, dtype="float32")
    tables = _tables(cfg, 4, n_blocks, seed=3, null_rows=(3,))
    tokens = np.array([[11], [40], [7], [0]])
    pos = np.array([9, 30, 52, 0])
    temps = np.array([0.0, 0.9, 1.3, 0.0], np.float32)
    topps = np.array([0.9, 0.9, 0.6, 0.0], np.float32)
    for coins in ([0.31, 0.72, 0.05, 0.0], [0.9, 0.15, 0.5, 0.0]):
        coins = np.array(coins, np.float32)
        tok, nf = llama.paged_sampled_step(
            params, cfg, torch.from_numpy(tokens), torch.from_numpy(pos),
            PagedKVCache(pkv.k.clone(), pkv.v.clone()), torch.from_numpy(tables),
            torch.from_numpy(temps), torch.from_numpy(topps), torch.from_numpy(coins))
        (jtok, jnf), _ = jax_llama.paged_sampled_step_guarded(
            jparams, jcfg, jnp.asarray(tokens, jnp.int32), jnp.asarray(pos, jnp.int32),
            jkv, jnp.asarray(tables), jnp.asarray(temps), jnp.asarray(topps),
            jnp.asarray(coins), jnp.float32(0.0))
        assert tok.tolist() == np.asarray(jtok).tolist()
        assert nf.tolist() == np.asarray(jnf).tolist() == [0, 0, 0, 0]


def test_nonfinite_rows_and_stale_position_clamp():
    """``_nonfinite_rows`` counts NaN/Inf lanes per row; an inactive row at a
    stale position equal to seq_len (its previous occupant filled the
    context) clamps into the tables instead of raising, and writes only the
    null block."""
    logits = torch.zeros((3, 1, 5))
    logits[1, 0, 2] = float("nan")
    logits[2, 0, :2] = float("inf")
    assert llama._nonfinite_rows(logits[:, -1]).tolist() == [0, 1, 2]
    cfg, jcfg = _configs("llama", "float32", sync_q80=False)
    _, params = _pair(cfg, jcfg, seed=3)
    M = blocks_per_seq(cfg.seq_len, BS)
    pkv = PagedKVCache.create(cfg, M + 1, BS)
    tables = torch.zeros((1, M), dtype=torch.long)
    logits, pkv = llama.paged_forward(params, cfg, torch.tensor([[4]]),
                                      torch.tensor([cfg.seq_len]), pkv, tables)
    assert torch.isfinite(logits).all()
    assert not pkv.k[:, 1:].any()  # nothing outside the null block
