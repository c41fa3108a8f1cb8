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
