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
    assert fa.supports((1, 600, 32, 128), 8, 2048)      # a 600-token chunk (C7)
    assert not fa.supports((1, 2**28, 32, 128), 8, 2048)  # folded rows past int32
    assert not fa.supports((1, 1, 32, 128), 8, 2**29)     # cache rows past int32


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


# ---------------------------------------------------------------------------
# the tensor-core path (a single pass over a bf16 cache): its rounding,
# written plainly, against the JAX kernel on a bf16 cache; the path rule
# ---------------------------------------------------------------------------

# the JAX package's own bound for its flash kernel over a bf16 cache
# (tests/test_flash_attention.py::test_bf16_cache_matches_oracle)
BF16_RTOL = BF16_ATOL = 2e-2


@pytest.mark.parametrize("B,T,start", [
    (1, 1, 200),                 # a decode row deep in the cache: 4 tiles of 64 keys
    (1, 16, 37),                 # a chunk whose rows cross a tile edge
    (1, 128, 64),                # a 128-token chunk: 512 folded rows, 8 blocks
    (3, 4, [0, 100, 200]),       # ragged start positions
])
def test_tc_plain_matches_pallas_on_bf16_cache(B, T, start):
    H, n_kv, D, S = 8, 2, 64, 256
    starts = np.broadcast_to(np.asarray(start, np.int32), (B,)).copy()
    q, k, v = _mk(B, T, H, n_kv, D, S, int(starts.max()) + T, seed=T)
    kb, vb = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    jpos = jnp.asarray(starts) if isinstance(start, list) else jnp.int32(start)
    want = jax_flash(jnp.asarray(q), kb, vb, jpos, D, interpret=True)
    pos = torch.from_numpy(starts) if isinstance(start, list) else start
    got = fa.flash_attention_tc_plain(torch.from_numpy(q), torch.from_numpy(k).bfloat16(),
                                      torch.from_numpy(v).bfloat16(), pos, D)
    assert got.shape == (B, T, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("T,q_pos0,kv_pos0", [
    (1, 300, 128),               # decode over a whole 256-row block
    (8, [124, 200], 128),        # ragged: one row sees nothing at first, then part
    (16, 100, 128),              # every row lies before the block: fully masked
    (64, 128, 128),              # the block's diagonal
])
def test_tc_block_stats_plain_matches_pallas(T, q_pos0, kv_pos0):
    from dllama_tpu.ops.flash_attention import flash_block_stats as jax_block_stats

    n_kv, kv_mul, D, S = 2, 4, 64, 256
    B = len(q_pos0) if isinstance(q_pos0, list) else 1
    rng = np.random.default_rng(T)
    q_g = rng.standard_normal((B, n_kv, T * kv_mul, D)).astype(np.float32)
    k = rng.standard_normal((B, n_kv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, n_kv, S, D)).astype(np.float32)
    q0 = np.broadcast_to(np.asarray(q_pos0, np.int32), (B,)).copy()
    want = jax_block_stats(jnp.asarray(q_g), jnp.asarray(k, jnp.bfloat16),
                           jnp.asarray(v, jnp.bfloat16), jnp.asarray(q0),
                           jnp.int32(kv_pos0), D, T, interpret=True)
    pos = torch.from_numpy(q0) if isinstance(q_pos0, list) else q_pos0
    got = fa.flash_block_stats_tc_plain(torch.from_numpy(q_g), torch.from_numpy(k).bfloat16(),
                                        torch.from_numpy(v).bfloat16(), pos, kv_pos0, D, T)
    acc, m, l = got
    masked = torch.from_numpy(np.isneginf(np.asarray(want[1])))
    assert torch.equal(torch.isneginf(m), masked)
    # a row that sees nothing of the block: exactly 0 / -inf / 0
    assert not acc[masked].any() and not l[masked].any()
    for g, w in zip(got, want):
        w = np.asarray(w)
        fin = np.isfinite(w)
        np.testing.assert_allclose(g.numpy()[fin], w[fin], rtol=BF16_RTOL, atol=BF16_ATOL)
    if T == 16:
        assert bool(masked.all())


def test_tc_plain_is_exact_where_nothing_rounds():
    """The twin differs from the f32 single pass only by its bf16 roundings:
    with bf16-exact queries and a softmax whose p are all exact (one visible
    key per row), it equals the plain version."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((1, 1, 8, 64)).astype(np.float32)).bfloat16().float()
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 128, 64)).astype(np.float32)).bfloat16()
            for _ in range(2))
    got = fa.flash_attention_tc_plain(q, k, v, 0, 64)
    want = fa.flash_attention(q, k, v, 0, 64)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("T,S", [(64, 2048), (128, 2048), (256, 32768), (64, 16384)])
def test_path_rule_single_pass_over_bf16_takes_tensor_cores(T, S):
    """A prefill chunk (or a ring block) keeps the single pass; over a bf16
    cache it takes the tensor cores, over an f32 cache the SIMT kernel."""
    n = fa._attn_splits(1, 8, 4 * T, S)
    assert n == 1
    assert fa._attn_path(torch.bfloat16, n) == "tc"
    assert fa._attn_path(torch.float32, n) == "simt"


@pytest.mark.parametrize("S", [2048, 16384, 32768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_path_rule_split_launches_stay_simt(S, dtype):
    """Decode splits its keys (split-S) and keeps the SIMT kernel in both
    numerics: the rule reads only the dtype and the split count."""
    n = fa._attn_splits(1, 8, 4, S)
    assert n > 1
    assert fa._attn_path(dtype, n) == "simt"


# --- C7: every prefill chunk the engine can pick fits K3 and K3s ------------


def _engine_widths(seq_len: int, n_batches: int | None) -> set[int]:
    """Every chunk width (``pad_to``) the port's engine dispatches for a
    prompt of any length from any position: its own ``_chunks`` over a
    stand-in holding only the bucket state the constructor derives."""
    import types

    from dllama_tpu_torch.runtime.engine import PREFILL_BUCKETS, InferenceEngine

    nb = min(n_batches or 32, seq_len)
    buckets = ((tuple(b for b in PREFILL_BUCKETS if b <= seq_len) or (nb,))
               if n_batches is None else (nb,))
    eng = types.SimpleNamespace(prefill_buckets=buckets,
                                cfg=types.SimpleNamespace(seq_len=seq_len), pos=0)
    eng._prefill_chunk_size = types.MethodType(InferenceEngine._prefill_chunk_size, eng)
    widths: set[int] = set()
    top = max(buckets)
    # a prompt's chunks are all `top` wide but the last; its tail width
    # depends on the prompt length and, at the context end, on the room left
    for pos in sorted({0, 1, seq_len - top, seq_len - top // 2 - 1, seq_len - 2}):
        if pos < 0:
            continue
        eng.pos = pos
        for n in range(1, min(seq_len - pos, 2 * top + 1) + 1):
            widths.update(pad for _, _, pad in InferenceEngine._chunks(eng, n))
    return widths


# (n_heads, n_kv, head_dim, seq_len, sp): the serving tests' geometry at the
# kernel's head dims, and Llama 3.1 8B at --max-seq-len 2048 and in the long
# sp cell (32768 rows over 2 shards)
C7_MODELS = [(4, 2, 64, 96, 1), (8, 2, 128, 256, 2), (32, 8, 128, 2048, 1),
             (32, 8, 128, 2048, 2), (32, 8, 128, 32768, 2)]


@pytest.mark.parametrize("n_heads,n_kv,D,seq_len,sp", C7_MODELS)
@pytest.mark.parametrize("n_batches", [None, 1, 32, 513, 2048])
def test_every_engine_chunk_width_is_supported(n_heads, n_kv, D, seq_len, sp, n_batches):
    """C7: ``--nbatches N`` pins the chunk at ``min(N, seq_len)``, so at kv_mul
    4 any N above 512 gave ``T * kv_mul`` past the old 2048-row cap and the
    first prefill chunk raised on the card. Every width the engine can pick
    now passes K3's ``supports`` over the whole cache and K3s's over one sp
    shard; widths past the int32 row limit still do not."""
    from dllama_tpu_torch.runtime.kvcache import padded_cache_len

    S = padded_cache_len(seq_len)
    kv_mul = n_heads // n_kv
    widths = _engine_widths(seq_len, n_batches)
    assert max(widths) == (min(n_batches, seq_len) if n_batches
                           else max(b for b in (256, 128, 64, 32) if b <= seq_len))
    for T in sorted(widths):
        assert fa.supports((1, T, n_heads, D), n_kv, S), T
        assert fa.supports_block_stats((1, n_kv, T * kv_mul, D), T,
                                       (1, n_kv, S // sp, D)), T
    too_wide = fa.MAX_ROWS // n_heads + 1
    assert not fa.supports((1, too_wide, n_heads, D), n_kv, S)
    assert not fa.supports_block_stats((1, n_kv, too_wide * kv_mul, D), too_wide,
                                       (1, n_kv, S // sp, D))
