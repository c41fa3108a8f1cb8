"""Sequence-parallel attention of the port (``dllama_tpu_torch/parallel``)
against the JAX package's ``parallel/ring.py`` on the same numpy inputs.

- The block math: the port's ``_block_attn`` (the plain version of kernel
  K3s) against JAX ``ring._block_attn``, and the K3s wrapper — which runs
  that plain version on a CPU tensor, in the kernel's GQA-folded layout —
  against the JAX Pallas ``flash_block_stats`` in interpret mode. Cases: a
  mid-sequence block, a fully masked block (exact zeros and ``-inf``), the
  diagonal, GQA ``kv_mul`` 4 and 1, T = 1 and T = 64, ragged ``q_pos0``.
- ``_combine`` on ``-inf`` statistics gives no NaN.
- The split-S (flash-decoding) algebra of the CUDA kernel, written plainly:
  the keys of each 16-row query tile cut into the kernel's ranges
  (``_split_ranges``), each range through ``_block_attn`` (pass 1), the
  partials merged by a torch copy of pass 2's formula, against the JAX
  Pallas kernels in interpret mode, for K3 (normalised) and K3s (stats),
  with empty splits and fully masked rows.
- ``sp_attention`` over ``[cpu] * n`` shards against JAX ``sp_attention`` on
  the virtual ``make_mesh({"sp": n})``: the ring (T % n == 0, T > 1), the
  merge at T = 1 and at T > 1, ragged depths, and a prefill followed by
  decode steps over one cache; the shards after the call must equal the JAX
  cache cut along S.

Tolerance: f32 sums taken in another order (torch's einsum against XLA's,
the Pallas kernel's one-block online softmax), 1e-5 absolute on O(1)
values. The CUDA kernel itself is held against the plain version on the card
by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops.flash_attention import flash_attention as jax_flash
from dllama_tpu.ops.flash_attention import flash_block_stats as jax_block_stats
from dllama_tpu.parallel import ring as jring
from dllama_tpu.parallel.api import make_mesh as jax_make_mesh
from dllama_tpu_torch.ops import flash_attention as fa
from dllama_tpu_torch.parallel import api, ring

TOL = 1e-5

# (B, T, kv_mul, q_pos0, kv_pos0) over one 128-row block (the Pallas
# kernel's tile), n_kv 2, head dim 32
BLOCK_CASES = {
    "decode_mid_block": (1, 1, 4, 200, 128),     # keys 128..200 of 128..255
    "decode_fully_masked": (1, 1, 4, 100, 128),  # the block lies past the query
    "decode_whole_block": (1, 1, 4, 300, 128),
    "diagonal_T64": (1, 64, 4, 128, 128),        # prefill over its own block
    "prefill_past_T64": (1, 64, 4, 256, 0),      # every key visible
    "kv_mul1_mid": (1, 16, 1, 150, 128),
    "ragged_T1": (3, 1, 4, [50, 140, 260], 128),  # masked / partial / whole
    "ragged_T8": (2, 8, 4, [124, 200], 128),      # rows masked, then visible
}
N_KV, D, S_BLOCK = 2, 32, 128


def _block_inputs(B, T, kv_mul, q_pos0, kv_pos0, seed):
    rng = np.random.default_rng(seed)
    qg = rng.standard_normal((B, T, N_KV, kv_mul, D)).astype(np.float32)
    k = rng.standard_normal((B, N_KV, S_BLOCK, D)).astype(np.float32)
    v = rng.standard_normal((B, N_KV, S_BLOCK, D)).astype(np.float32)
    q0 = np.broadcast_to(np.asarray(q_pos0, np.int32), (B,)).copy()
    positions = q0[:, None] + np.arange(T, dtype=np.int32)[None, :]
    mask = (kv_pos0 + np.arange(S_BLOCK))[None, None, :] <= positions[:, :, None]
    return qg, k, v, q0, mask


def _fold(qg: np.ndarray) -> np.ndarray:
    """Ring layout ``[B, T, n_kv, kv_mul, D]`` → the kernels' folded rows."""
    B, T, n_kv, kv_mul, d = qg.shape
    return np.ascontiguousarray(qg.transpose(0, 2, 1, 3, 4).reshape(B, n_kv, T * kv_mul, d))


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_attn_matches_jax(case):
    B, T, kv_mul, q_pos0, kv_pos0 = BLOCK_CASES[case]
    qg, k, v, _, mask = _block_inputs(B, T, kv_mul, q_pos0, kv_pos0, seed=len(case))
    want = jring._block_attn(jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(mask), D)
    got = ring._block_attn(torch.from_numpy(qg), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(mask), D)
    for g, w in zip(got, want):
        assert not torch.isnan(g).any()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_stats_wrapper_matches_pallas(case):
    """The K3s wrapper on a CPU tensor (``_block_attn`` in the folded layout)
    against the JAX stats-mode Pallas kernel, interpreted."""
    B, T, kv_mul, q_pos0, kv_pos0 = BLOCK_CASES[case]
    qg, k, v, q0, _ = _block_inputs(B, T, kv_mul, q_pos0, kv_pos0, seed=len(case))
    q_g = _fold(qg)
    want = jax_block_stats(jnp.asarray(q_g), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(q0), jnp.int32(kv_pos0), D, T, interpret=True)
    pos = torch.from_numpy(q0) if isinstance(q_pos0, list) else int(q_pos0)
    got = fa.flash_block_stats(torch.from_numpy(q_g), torch.from_numpy(k),
                               torch.from_numpy(v), pos, kv_pos0, D, T)
    assert [tuple(g.shape) for g in got] == [(B, N_KV, T * kv_mul, D),
                                             (B, N_KV, T * kv_mul), (B, N_KV, T * kv_mul)]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


def test_fully_masked_block_is_exact_zeros_and_neg_inf():
    """A row that sees nothing of the block: acc = 0, l = 0, m = -inf
    exactly, in the port and in the JAX kernel alike."""
    B, T, kv_mul, q_pos0, kv_pos0 = BLOCK_CASES["decode_fully_masked"]
    qg, k, v, q0, _ = _block_inputs(B, T, kv_mul, q_pos0, kv_pos0, seed=3)
    acc, m, l = fa.flash_block_stats(torch.from_numpy(_fold(qg)), torch.from_numpy(k),
                                     torch.from_numpy(v), q_pos0, kv_pos0, D, T)
    assert torch.equal(acc, torch.zeros_like(acc)) and torch.equal(l, torch.zeros_like(l))
    assert bool((m == float("-inf")).all())
    jacc, jm, jl = jax_block_stats(jnp.asarray(_fold(qg)), jnp.asarray(k), jnp.asarray(v),
                                   jnp.int32(q_pos0), jnp.int32(kv_pos0), D, T,
                                   interpret=True)
    assert not np.asarray(jacc).any() and not np.asarray(jl).any()
    assert np.isneginf(np.asarray(jm)).all()


def test_combine_of_neg_inf_stats_has_no_nan():
    """Folding a fully masked block into an empty accumulator (and into a
    live one) gives the JAX package's values and no NaN."""
    rng = np.random.default_rng(5)
    shape = (1, 2, 2, 4)
    empty = (np.full(shape, -np.inf, np.float32), np.zeros(shape, np.float32),
             np.zeros(shape + (8,), np.float32))
    live = (rng.standard_normal(shape).astype(np.float32),
            rng.random(shape).astype(np.float32) + 0.5,
            rng.standard_normal(shape + (8,)).astype(np.float32))
    for run, blk in ((empty, empty), (live, empty), (empty, live)):
        got = ring._combine(*(torch.from_numpy(a) for a in run + blk))
        want = jring._combine(*(jnp.asarray(a) for a in run + blk))
        for g, w in zip(got, want):
            assert not torch.isnan(g).any()
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)
    l = torch.zeros(shape)
    assert torch.equal(ring._finish(torch.zeros(shape + (8,)), l, torch.float32),
                       torch.zeros(shape + (8,)))


# ---------------------------------------------------------------------------
# sp_attention against the JAX shard_map on the virtual CPU mesh
# ---------------------------------------------------------------------------

H, N_KV_SP, S, HD = 8, 4, 32, 16


def _sp_case(B, T, start, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, HD)).astype(np.float32)
    new_k = rng.standard_normal((B, T, N_KV_SP, HD)).astype(np.float32)
    new_v = rng.standard_normal((B, T, N_KV_SP, HD)).astype(np.float32)
    k = rng.standard_normal((B, N_KV_SP, S, HD)).astype(np.float32)
    v = rng.standard_normal((B, N_KV_SP, S, HD)).astype(np.float32)
    starts = np.broadcast_to(np.asarray(start, np.int32), (B,)).copy()
    positions = starts[:, None] + np.arange(T, dtype=np.int32)[None, :]
    return q, new_k, new_v, k, v, positions, starts


def _shards(a: np.ndarray, n: int) -> list[torch.Tensor]:
    return [t.contiguous() for t in torch.from_numpy(a.copy()).chunk(n, dim=2)]


def _jax_sp(n, q, k, v, new_k, new_v, positions, start):
    plan = jax_make_mesh({"sp": n})
    return jax.jit(lambda *a: jring.sp_attention(plan, *a, head_dim=HD))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(new_k),
        jnp.asarray(new_v), jnp.asarray(positions), jnp.asarray(start))


SP_CASES = [  # (sp, B, T, start): test_ring_attention.py's sp cases and more
    (2, 1, 8, 4),          # ring
    (4, 1, 8, 0),          # ring, 4 shards
    (2, 1, 1, 20),         # merge, decode in the second shard
    (4, 1, 1, 9),          # merge
    (4, 1, 6, 3),          # T = 6 not divisible by sp = 4: merge at T > 1
    (2, 2, 1, [9, 20]),    # ragged decode, merge
    (2, 2, 4, [3, 11]),    # ragged chunk, ring
]


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("sp,B,T,start", SP_CASES)
def test_sp_attention_matches_jax(sp, B, T, start, impl):
    q, new_k, new_v, k, v, positions, starts = _sp_case(B, T, start, seed=sp * 10 + T)
    want, want_k, want_v = _jax_sp(sp, q, k, v, new_k, new_v, positions,
                                   starts if isinstance(start, list) else np.int32(start))
    plan = api.make_mesh({"sp": sp}, ["cpu"] * sp)
    k_sh, v_sh = _shards(k, sp), _shards(v, sp)
    pos0 = torch.from_numpy(starts) if isinstance(start, list) else start
    got = ring.sp_attention(plan, torch.from_numpy(q), k_sh, v_sh, torch.from_numpy(new_k),
                            torch.from_numpy(new_v), torch.from_numpy(positions).long(),
                            pos0, HD, attn_impl=impl)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    np.testing.assert_array_equal(torch.cat(k_sh, dim=2).numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(torch.cat(v_sh, dim=2).numpy(), np.asarray(want_v))


def test_sp_attention_prefill_then_decode_over_one_cache():
    """A ring prefill and merge decode steps on one sharded cache, against
    the JAX package doing the same (its own cache carried along)."""
    sp, B = 4, 1
    plan = api.make_mesh({"sp": sp}, ["cpu"] * sp)
    jplan = jax_make_mesh({"sp": sp})
    k_sh = [torch.zeros((B, N_KV_SP, S // sp, HD)) for _ in range(sp)]
    v_sh = [torch.zeros((B, N_KV_SP, S // sp, HD)) for _ in range(sp)]
    jk = jnp.zeros((B, N_KV_SP, S, HD))
    jv = jnp.zeros((B, N_KV_SP, S, HD))
    jax_step = jax.jit(lambda *a: jring.sp_attention(jplan, *a, head_dim=HD))
    pos = 0
    for step, T in enumerate((12, 1, 1, 1)):
        q, new_k, new_v, _, _, positions, _ = _sp_case(B, T, pos, seed=100 + step)
        want, jk, jv = jax_step(jnp.asarray(q), jk, jv, jnp.asarray(new_k),
                                jnp.asarray(new_v), jnp.asarray(positions), jnp.int32(pos))
        got = ring.sp_attention(plan, torch.from_numpy(q), k_sh, v_sh,
                                torch.from_numpy(new_k), torch.from_numpy(new_v),
                                torch.from_numpy(positions).long(), pos, HD)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
        pos += T
    np.testing.assert_array_equal(torch.cat(k_sh, dim=2).numpy(), np.asarray(jk))


# ---------------------------------------------------------------------------
# the plan and the wrappers' refusals
# ---------------------------------------------------------------------------


def test_mesh_plan_sp_only():
    plan = api.make_mesh({"sp": 3}, ["cpu"] * 4)
    assert plan.axis_size("sp") == 3 and plan.axis_size("tp") == 1
    assert plan.lead == torch.device("cpu") and len(plan.devices) == 3
    assert api.make_mesh({"sp": 2, "tp": 1}, ["cpu"] * 2).axis_size("sp") == 2
    assert api.make_mesh({"tp": 2}, ["cpu"] * 2).axis_size("tp") == 2
    with pytest.raises(NotImplementedError, match="sp=2 x tp=2 is not ported"):
        api.make_mesh({"sp": 2, "tp": 2}, ["cpu"] * 4)
    for axis in ("dp", "pp"):
        with pytest.raises(NotImplementedError, match="not ported"):
            api.make_mesh({"sp": 2, axis: 2}, ["cpu"] * 4)
    with pytest.raises(ValueError, match="needs 4 devices, found 2"):
        api.make_mesh({"sp": 4}, ["cpu"] * 2)
    assert api.default_devices("cpu", 3) == [torch.device("cpu")] * 3


def test_default_devices_count_cuda_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"mesh dp=1 sp=2 pp=1 tp=1 needs 2 devices, found 1"):
        api.default_devices("cuda", 2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert api.default_devices("cuda", 2) == [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_sp_attention_refuses_uneven_shards():
    plan = api.make_mesh({"sp": 2}, ["cpu"] * 2)
    q = torch.zeros((1, 1, H, HD))
    new = torch.zeros((1, 1, N_KV_SP, HD))
    shards = [torch.zeros((1, N_KV_SP, 16, HD)), torch.zeros((1, N_KV_SP, 8, HD))]
    with pytest.raises(ValueError, match="not covered"):
        ring.sp_attention(plan, q, shards, shards, new, new, torch.zeros((1, 1)), 0, HD)
    with pytest.raises(ValueError, match="attn_impl"):
        ring.sp_attention(plan, q, shards[:1] * 2, shards[:1] * 2, new, new,
                          torch.zeros((1, 1), dtype=torch.long), 0, HD, attn_impl="pallas")


def test_block_stats_wrapper_refuses_other_devices_and_shapes():
    q = torch.zeros((1, 2, 4, 64), device="meta")
    kv = torch.zeros((1, 2, 128, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_block_stats(q, kv, kv, 0, 0, 64, 1)
    # a CUDA-typed input of a head dim the kernel has no instance for raises
    # before touching a card (no fall back to the plain version)
    import types

    q_cuda = types.SimpleNamespace(device=torch.device("cuda"), shape=(1, 2, 4, 96))
    k_cuda = types.SimpleNamespace(shape=(1, 2, 128, 96))
    with pytest.raises(ValueError, match="not supported"):
        fa.flash_block_stats(q_cuda, k_cuda, k_cuda, 0, 0, 96, 1)


# ---------------------------------------------------------------------------
# split-S: the kernel's two passes written plainly, against the JAX kernels
# ---------------------------------------------------------------------------


def _combine_splits(parts):
    """A torch copy of pass 2 (``csrc/flash_attention.cu``,
    ``combine_splits_kernel``): in split order, ``M = max m_s``, ``L = sum
    l_s e^(m_s - M)``, ``acc = sum acc_s e^(m_s - M)``, with ``M`` taken as
    0 in the exponent when no split saw a key."""
    mx = parts[0][1]
    for _, m, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    m_safe = torch.where(mx == float("-inf"), 0.0, mx)
    acc = l = 0.0
    for a, m, ls in parts:
        w = torch.exp(m - m_safe)
        l = l + ls * w
        acc = acc + a * w[..., None]
    return acc, mx, l


def _split_then_combine(q_g, k, v, q_pos0, kv_pos0, t, n_splits):
    """The kernel's split-S path on folded queries ``[B, n_kv, TQ, D]``:
    per 16-row query tile, the tile's visible keys cut into
    ``fa._split_ranges``; each range's ``(acc, m, l)`` from ``_block_attn``
    (an empty range: 0, -inf, 0, as the kernel writes it); merged by
    :func:`_combine_splits`. Returns the unnormalised ``(acc, m, l)``."""
    B, n_kv, TQ, hd = q_g.shape
    kv_mul, S = TQ // t, k.shape[2]
    q0 = np.broadcast_to(np.asarray(q_pos0), (B,))
    acc = torch.zeros_like(q_g)
    m = torch.full((B, n_kv, TQ), float("-inf"))
    l = torch.zeros((B, n_kv, TQ))
    for b in range(B):
        for r0 in range(0, TQ, fa.BQ):
            rows = torch.arange(r0, min(TQ, r0 + fa.BQ))
            newest = min(S - 1, int(q0[b]) - kv_pos0 + int(rows[-1]) // kv_mul)
            qg = q_g[b:b + 1, :, rows].permute(0, 2, 1, 3)[:, :, :, None]  # [1, R, n_kv, 1, hd]
            parts = []
            for lo, hi in fa._split_ranges(newest, n_splits):
                hi = min(hi, S)
                if hi <= lo:
                    parts.append((torch.zeros((len(rows), n_kv, hd)),
                                  torch.full((len(rows), n_kv), float("-inf")),
                                  torch.zeros((len(rows), n_kv))))
                    continue
                kv_pos = kv_pos0 + torch.arange(lo, hi)
                mask = kv_pos[None, :] <= (int(q0[b]) + rows // kv_mul)[:, None]
                pa, pm, pl = fa._block_attn(qg, k[b:b + 1, :, lo:hi], v[b:b + 1, :, lo:hi],
                                            mask[None], hd)
                parts.append((pa[0, :, :, 0], pm[0, :, :, 0], pl[0, :, :, 0]))
            ca, cm, cl = _combine_splits(parts)
            acc[b, :, rows], m[b, :, rows], l[b, :, rows] = (ca.transpose(0, 1), cm.T, cl.T)
    return acc, m, l


@pytest.mark.parametrize("n_splits", [2, 4, 7])
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_split_then_combine_matches_pallas_block_stats(case, n_splits):
    """K3s under split-S: 4 tiles in the 128-row block, so 7 splits leave
    some ranges empty; fully masked rows keep exactly 0 / -inf / 0."""
    B, T, kv_mul, q_pos0, kv_pos0 = BLOCK_CASES[case]
    qg, k, v, q0, _ = _block_inputs(B, T, kv_mul, q_pos0, kv_pos0, seed=len(case))
    q_g = _fold(qg)
    want = jax_block_stats(jnp.asarray(q_g), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(q0), jnp.int32(kv_pos0), D, T, interpret=True)
    got = _split_then_combine(torch.from_numpy(q_g), torch.from_numpy(k),
                              torch.from_numpy(v), q0, kv_pos0, T, n_splits)
    for g, w in zip(got, want):
        assert not torch.isnan(g).any()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


@pytest.mark.parametrize("n_splits", [2, 4, 7])
def test_split_of_a_fully_masked_block_is_exact_zeros_and_neg_inf(n_splits):
    B, T, kv_mul, q_pos0, kv_pos0 = BLOCK_CASES["decode_fully_masked"]
    qg, k, v, q0, _ = _block_inputs(B, T, kv_mul, q_pos0, kv_pos0, seed=3)
    acc, m, l = _split_then_combine(torch.from_numpy(_fold(qg)), torch.from_numpy(k),
                                    torch.from_numpy(v), q0, kv_pos0, T, n_splits)
    assert torch.equal(acc, torch.zeros_like(acc)) and torch.equal(l, torch.zeros_like(l))
    assert bool((m == float("-inf")).all())


# (T, n_heads, n_kv, S, start, n_splits): decode deep and shallow (most
# splits empty), the split count the wrapper picks, a 16-token verify over
# four query tiles, GQA 1, ragged rows
K3_SPLIT_CASES = [(1, 8, 2, 256, 255, 4), (1, 8, 2, 256, 40, 8), (1, 8, 2, 256, 0, 3),
                  (1, 8, 2, 256, 200, "auto"), (16, 8, 2, 256, 100, 5),
                  (1, 4, 4, 128, 127, 2), (1, 8, 2, 256, [5, 200], 4)]


@pytest.mark.parametrize("T,H,n_kv,S,start,n_splits", K3_SPLIT_CASES)
def test_split_then_combine_matches_pallas_flash_attention(T, H, n_kv, S, start, n_splits):
    """K3 under split-S: the merged partials divided by L against the JAX
    flash kernel, interpreted."""
    starts = np.broadcast_to(np.asarray(start, np.int32), (np.size(start),)).copy()
    B, hd = len(starts), 32
    rng = np.random.default_rng(T + S + int(starts.sum()))
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, n_kv, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, n_kv, S, hd)).astype(np.float32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(starts),
                     hd, interpret=True)
    q_g = fa.fold_queries(torch.from_numpy(q), n_kv)
    if n_splits == "auto":
        n_splits = fa._attn_splits(B, n_kv, q_g.shape[2], S)
        assert n_splits > 1
    acc, _, l = _split_then_combine(q_g, torch.from_numpy(k), torch.from_numpy(v), starts,
                                    0, T, n_splits)
    got = fa.unfold_output(acc / torch.where(l > 0, l, 1.0)[..., None], T, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
