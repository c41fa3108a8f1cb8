"""Port kernel K3 (causal GQA flash attention): the wrapper's plain version —
the position-masked oracle it runs on a CPU tensor — against the JAX
package's Pallas flash kernel in interpret mode and its XLA oracle, on the
same numpy-seeded inputs; plus the GQA fold/unfold and row-visibility rule
the CUDA kernel relies on. The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dllama_tpu.ops.attention import attention as jax_attention
from dllama_tpu.ops.flash_attention import flash_attention as jax_flash
from dllama_tpu_torch.ops import flash_attention as fa
from dllama_tpu_torch.ops.attention import attention

# f32 softmax/weighted sums in another order than the JAX kernel's online
# softmax: a few f32 ulps of the O(1) outputs
RTOL, ATOL = 2e-5, 2e-6


def _mk(B, T, H, n_kv, D, S, filled, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = np.zeros((B, n_kv, S, D), np.float32)
    v = np.zeros((B, n_kv, S, D), np.float32)
    k[:, :, :filled] = rng.standard_normal((B, n_kv, filled, D))
    v[:, :, :filled] = rng.standard_normal((B, n_kv, filled, D))
    return q, k, v


@pytest.mark.parametrize("T,H,n_kv,S,start_pos", [
    (1, 8, 2, 128, 0), (1, 8, 2, 128, 127),       # decode, kv_mul 4, S 128
    (1, 8, 2, 256, 128), (1, 8, 2, 256, 255),     # decode across a 128 block
    (1, 4, 4, 256, 127),                          # kv_mul 1
    (16, 8, 2, 256, 37), (64, 8, 2, 256, 100),    # prefill chunks, kv_mul 4
    (16, 4, 4, 128, 0),                           # prefill, kv_mul 1
])
def test_plain_matches_pallas_and_oracle(T, H, n_kv, S, start_pos):
    D = 32
    q, k, v = _mk(1, T, H, n_kv, D, S, start_pos + T, seed=T + start_pos)
    want_flash = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.int32(start_pos), D, interpret=True)
    pos = start_pos + np.arange(T, dtype=np.int32)[None, :]
    want_oracle = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(pos), D)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), start_pos, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_flash), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_oracle), rtol=RTOL, atol=ATOL)


def test_ragged_start_positions():
    B, T, H, n_kv, D, S = 3, 4, 8, 2, 32, 256
    starts = np.array([0, 100, 200], np.int32)
    q, k, v = _mk(B, T, H, n_kv, D, S, int(starts.max()) + T, seed=9)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(starts), D, interpret=True)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(starts), D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_bf16_cache():
    """The fast path's bf16 cache: both sides upcast the same bf16 values."""
    D, S, start_pos = 32, 128, 60
    q, k, v = _mk(1, 1, 8, 2, D, S, start_pos + 1, seed=4)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
                     jnp.asarray(v, jnp.bfloat16), jnp.int32(start_pos), D,
                     interpret=True)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k).bfloat16(),
                             torch.from_numpy(v).bfloat16(), start_pos, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _folded_reference(q_g, k, v, pos, kv_mul, scale):
    """The CUDA kernel's contract written plainly: folded row r of batch b
    sees slots s <= pos[b] + r // kv_mul."""
    B, n_kv, TQ, D = q_g.shape
    S = k.shape[2]
    scores = torch.einsum("bkrd,bksd->bkrs", q_g, k.float()) * scale
    limit = pos[:, None] + torch.arange(TQ)[None, :] // kv_mul       # [B, TQ]
    mask = torch.arange(S)[None, None, :] <= limit[:, :, None]       # [B, TQ, S]
    scores = scores.masked_fill(~mask[:, None], float("-inf"))
    return torch.einsum("bkrs,bksd->bkrd", torch.softmax(scores, -1), v.float())


@pytest.mark.parametrize("T,H,n_kv", [(1, 32, 8), (5, 8, 2), (3, 4, 4)])
def test_gqa_fold_and_row_rule_match_oracle(T, H, n_kv):
    B, D, S = 2, 64, 128
    starts = torch.tensor([3, 40])
    q, k, v = (torch.from_numpy(a) for a in _mk(B, T, H, n_kv, D, S, 40 + T, seed=T))
    q_g = fa.fold_queries(q, n_kv)
    assert q_g.shape == (B, n_kv, T * (H // n_kv), D)
    assert torch.equal(fa.unfold_output(q_g, T, H), q)
    got = fa.unfold_output(_folded_reference(q_g, k, v, starts, H // n_kv, D ** -0.5), T, H)
    positions = starts[:, None] + torch.arange(T)[None, :]
    want = attention(q, k, v, positions, D)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_supports_gate():
    assert fa.supports((1, 1, 32, 128), 8, 2048)
    assert fa.supports((1, 128, 32, 128), 8, 2048)
    assert not fa.supports((1, 1, 8, 32), 2, 256)      # head_dim 32 not built
    assert not fa.supports((1, 600, 32, 128), 8, 2048)  # T*kv_mul > MAX_TQ


def test_wrapper_refuses_other_devices():
    q = torch.zeros((1, 1, 8, 64), device="meta")
    kv = torch.zeros((1, 2, 128, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q, kv, kv, 0, 64)


# ---------------------------------------------------------------------------
# split-S (flash-decoding): the split rule the CUDA kernel follows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_splits", [1, 2, 7, 32, 33])
@pytest.mark.parametrize("newest", [-5, 0, 31, 32, 100, 2047, 20145])
def test_split_ranges_are_whole_tiles_covering_each_key_once(newest, n_splits):
    """Each split's key range is whole 32-key tiles; together the ranges
    cover the keys [0, newest] (through newest's tile) once, in order, and
    differ in length by at most one tile; a tile that sees nothing walks
    nothing."""
    ranges = fa._split_ranges(newest, n_splits)
    assert len(ranges) == n_splits
    keys = []
    for lo, hi in ranges:
        assert lo % fa.BS == 0 and hi % fa.BS == 0 and lo <= hi
        keys.extend(range(lo, hi))
    n_tiles = newest // fa.BS + 1 if newest >= 0 else 0
    assert keys == list(range(n_tiles * fa.BS))
    sizes = [hi - lo for lo, hi in ranges]
    assert max(sizes) - min(sizes) <= fa.BS


@pytest.mark.parametrize("S", [2048, 16384, 32768])
def test_decode_split_count_puts_a_block_on_every_sm(S):
    """Decode at B = 1 with n_kv = 8 (8 unsplit blocks) splits into at
    least one block per SM of the H100, each split at least two tiles of a
    full cache."""
    n = fa._attn_splits(1, 8, 4, S)
    assert 8 * n >= fa.SMS
    assert S // fa.BS // n >= fa._SPLIT_MIN_TILES


@pytest.mark.parametrize("T", [64, 128, 256])
def test_prefill_chunks_keep_the_single_pass(T):
    """A prefill chunk at n_kv = 8 already fills the card (the ring's
    64-token chunks give 128 blocks): no split, no combine."""
    assert fa._attn_splits(1, 8, 4 * T, 2048) == 1
    assert fa._attn_splits(1, 8, 4 * T, 32768) == 1


def test_split_count_depends_on_shapes_only():
    """The count comes from (B, n_kv, TQ, S): one tile of cache never
    splits, and more batch rows or query rows never split more."""
    assert fa._attn_splits(1, 8, 4, fa.BS) == 1
    counts = [fa._attn_splits(B, 8, 4, 4096) for B in (1, 2, 4)]
    assert counts == sorted(counts, reverse=True)
