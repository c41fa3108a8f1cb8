"""K5's tensor-core arithmetic on the CPU (``ops/moe_matmul.py``).

The tensor-core kernel (``csrc/moe_matmul.cu::moe_tc_kernel``) runs only on
the card. What it computes is written out plainly by
``moe_matmul_tc_plain`` and its A operand by ``tc_operand``; here both are
held against the JAX package's expert dots on the same numpy inputs
(``_expert_gather_dot``, and ``lax.ragged_dot`` over ``_experts_dense``, as
``_moe_sparse_local`` calls them), against the port's plain version, and the
wrapper's rules (which kernel a decoder takes, the K split plan, the row
budget's slices) are checked as plain Python.

Widths are narrow with Qwen3-30B-A3B's K/N ratio (w1/w3 2048 -> 768, w2 768
-> 2048, cut to 256 -> 96 and 96 -> 256).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.models import llama as jax_llama
from dllama_tpu.ops.linear import QuantizedWeight as JaxQuantizedWeight
from dllama_tpu.ops.turbo import derive_turbo as jax_derive_turbo
from dllama_tpu_torch.ops import moe_matmul as mm
from dllama_tpu_torch.ops.cuda_build import SMS
from dllama_tpu_torch.ops.linear import Q40_CODES, Q80_CODES, QuantizedWeight
from dllama_tpu_torch.ops.turbo import TurboWeight

G = 6  # experts
SHAPES = {"w1": (256, 96), "w2": (96, 256)}  # (K, N)
# exact: f32 sums in another order and the block scale applied to a block's
# sum instead of each product (a reassociation within f32 rounding)
EXACT_RTOL = 1e-5
# fast: both sides' products are exact in f32, but JAX rounds its bf16
# operands at other op boundaries than the twin's f32 sums
FAST_RTOL = 1e-2


def _routing(kind: str, rng: np.random.Generator) -> np.ndarray:
    """Expert id per row, sorted: ``random`` (some experts empty, R not a
    multiple of 8), ``one`` (every row on one expert, past the 64-row
    budget), ``skewed`` (one expert most rows, the rest few or none)."""
    if kind == "random":
        e = rng.choice([0, 2, 3, 5], size=29)
    elif kind == "one":
        e = np.full(150, 4)
    else:
        e = np.concatenate([np.full(70, 1), rng.choice([3, 5], size=11)])
    return np.sort(e).astype(np.int32)


def _offsets(rows: np.ndarray) -> torch.Tensor:
    counts = np.bincount(rows, minlength=G)
    return torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))


def _q_planes(K: int, N: int, kind: str, fast: bool, rng: np.random.Generator):
    """A Q40 (codes in [-8, 7]) or Q80 ([-127, 127]) expert stack on both
    sides; fast planes keep bf16 scales, as the loader stores them."""
    hi = 8 if kind == "q40" else 128
    codes = rng.integers(-hi + (kind == "q80"), hi, (G, K, N)).astype(np.int8)
    scales = (rng.random((G, K // 32, N)) * 0.02 + 0.001).astype(np.float32)
    jsc = jnp.asarray(scales, jnp.bfloat16 if fast else jnp.float32)
    port = QuantizedWeight(scales=torch.from_numpy(np.array(jsc.astype(jnp.float32)))
                           .to(torch.bfloat16 if fast else torch.float32),
                           codes=torch.from_numpy(codes),
                           kind=Q40_CODES if kind == "q40" else Q80_CODES)
    return JaxQuantizedWeight(scales=jsc, codes=jnp.asarray(codes)), port


def _turbo_planes(K: int, N: int, a8: bool, rng: np.random.Generator):
    """Turbo planes derived on the JAX side from a Q40 stack, and the same
    leaves in the port."""
    jq, _ = _q_planes(K, N, "q40", True, rng)
    jt = jax_derive_turbo(jq, a8=a8)
    return jt, TurboWeight(torch.from_numpy(np.array(jt.w8)),
                           torch.from_numpy(np.array(jt.scale)), a8)


def _jax_ragged(x: np.ndarray, jwe, rows: np.ndarray, dtype) -> np.ndarray:
    """The JAX ragged regime's dot: ``lax.ragged_dot`` over the dense planes
    ``_experts_dense`` makes, rows already sorted by expert."""
    xs = jnp.asarray(x, dtype)
    d = jax_llama._experts_dense(jwe, xs)
    sizes = jnp.asarray(np.bincount(rows, minlength=G).astype(np.int32))
    return np.asarray(jax.lax.ragged_dot(xs.astype(d.dtype), d, sizes,
                                         preferred_element_type=jnp.float32))


def _jax_gather(x: np.ndarray, jwe, rows: np.ndarray, dtype) -> np.ndarray:
    """The JAX gather regime's dot (``_expert_gather_dot``)."""
    return np.asarray(jax_llama._expert_gather_dot(jnp.asarray(x, dtype), jwe,
                                                   jnp.asarray(rows)), np.float32)


def _bf16_bits(t) -> np.ndarray:
    return np.asarray(jnp.asarray(t, jnp.bfloat16)).view(np.uint16)


@pytest.mark.parametrize("routing", ["random", "one", "skewed"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", ["q40", "q80"])
def test_exact_twin_matches_jax(kind, shape, routing):
    """Exact Q planes: the codes as A (exact in bf16), three bf16 parts of
    each f32 activation, each block's f32 scale on the block's sum: within
    1e-5 of max|y| of JAX's f32 ragged dot, and of the port's plain version."""
    K, N = SHAPES[shape]
    rng = np.random.default_rng(101)
    jwe, we = _q_planes(K, N, kind, False, rng)
    rows = _routing(routing, rng)
    x = rng.standard_normal((len(rows), K)).astype(np.float32)
    off = _offsets(rows)
    got = mm.moe_matmul_tc_plain(torch.from_numpy(x), we, off, decoder="q").numpy()
    want = _jax_ragged(x, jwe, rows, jnp.float32)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT_RTOL * scale)
    plain = mm.moe_matmul_plain(torch.from_numpy(x), we, off, decoder="q").numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=EXACT_RTOL * scale)
    # the operand is the codes themselves, exactly
    for g in range(G):
        a = mm.tc_operand(we, g, "q")
        assert a.dtype == torch.bfloat16
        assert torch.equal(a.float(), we.codes[g].float())


@pytest.mark.parametrize("kind", ["q40", "q80"])
def test_exact_twin_matches_jax_gather_regime(kind):
    """One decode token's 8 rows on 8 of 8 experts (the gather regime):
    JAX's per-row einsum over gathered f32 planes."""
    K, N = SHAPES["w1"]
    rng = np.random.default_rng(103)
    jwe, we = _q_planes(K, N, kind, False, rng)
    rows = np.sort(rng.choice(G, size=G, replace=False)).astype(np.int32)
    x = rng.standard_normal((len(rows), K)).astype(np.float32)
    got = mm.moe_matmul_tc_plain(torch.from_numpy(x), we, _offsets(rows), decoder="q").numpy()
    want = _jax_gather(x, jwe, rows, jnp.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT_RTOL * np.abs(want).max())


@pytest.mark.parametrize("routing", ["random", "one", "skewed"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("kind", ["q40", "q80"])
def test_fast_twin_and_operand_match_jax(kind, shape, routing):
    """Fast Q planes: the A operand equals JAX's bf16 plane
    (``bf16(code * bf16(scale))``) bit for bit; the product is within 1e-2
    of max|y| of JAX's bf16 ragged dot, and equal to the plain version's."""
    K, N = SHAPES[shape]
    rng = np.random.default_rng(107)
    jwe, we = _q_planes(K, N, kind, True, rng)
    rows = _routing(routing, rng)
    x = rng.standard_normal((len(rows), K)).astype(np.float32)
    jplanes = jax_llama._experts_dense(jwe, jnp.asarray(x, jnp.bfloat16))
    assert jplanes.dtype == jnp.bfloat16
    for g in range(G):
        np.testing.assert_array_equal(_bf16_bits(mm.tc_operand(we, g, "q", fast=True).float()),
                                      np.asarray(jplanes[g]).view(np.uint16))
    off = _offsets(rows)
    xt = torch.from_numpy(x)
    got = mm.moe_matmul_tc_plain(xt, we, off, decoder="q", fast=True).numpy()
    want = _jax_ragged(x, jwe, rows, jnp.bfloat16)
    assert np.abs(got - want).max() <= FAST_RTOL * np.abs(want).max()
    plain = mm.moe_matmul_plain(xt, we, off, decoder="q", fast=True).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=EXACT_RTOL * np.abs(plain).max())


@pytest.mark.parametrize("routing", ["random", "one", "skewed"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_prescaled_twin_and_operand_match_jax(shape, routing):
    """Turbo planes in the ragged regime: A = ``bf16(bf16(w8) *
    bf16(scale))``, JAX's dense rhs bit for bit; the product within 1e-2."""
    K, N = SHAPES[shape]
    rng = np.random.default_rng(109)
    jt, tw = _turbo_planes(K, N, False, rng)
    rows = _routing(routing, rng)
    x = rng.standard_normal((len(rows), K)).astype(np.float32)
    jplanes = jax_llama._experts_dense(jt, jnp.asarray(x, jnp.bfloat16))
    for g in range(G):
        np.testing.assert_array_equal(_bf16_bits(mm.tc_operand(tw, g, "prescaled").float()),
                                      np.asarray(jplanes[g]).view(np.uint16))
    off = _offsets(rows)
    got = mm.moe_matmul_tc_plain(torch.from_numpy(x), tw, off, decoder="prescaled").numpy()
    want = _jax_ragged(x, jt, rows, jnp.bfloat16)
    assert np.abs(got - want).max() <= FAST_RTOL * np.abs(want).max()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_a16_twin_and_operand_match_jax(shape):
    """Turbo a16 in the gather regime: A = the int8 codes as bf16 (exact,
    JAX's ``w8.astype(bfloat16)``), the column scale in the epilogue."""
    K, N = SHAPES[shape]
    rng = np.random.default_rng(113)
    jt, tw = _turbo_planes(K, N, False, rng)
    for g in range(G):
        np.testing.assert_array_equal(_bf16_bits(mm.tc_operand(tw, g, "a16").float()),
                                      np.asarray(jt.w8[g].astype(jnp.bfloat16)).view(np.uint16))
    rows = np.array([0, 1, 1, 3, 4, 4, 4, 5], dtype=np.int32)
    x = rng.standard_normal((len(rows), K)).astype(np.float32)
    got = mm.moe_matmul_tc_plain(torch.from_numpy(x), tw, _offsets(rows), decoder="a16").numpy()
    want = _jax_gather(x, jt, rows, jnp.float32)
    assert np.abs(got - want).max() <= FAST_RTOL * np.abs(want).max()


@pytest.mark.parametrize("routing", ["random", "one", "skewed"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_dense_bf16_twin_and_operand(shape, routing):
    """Dense bf16 planes: A is the plane as it is; the product within 1e-2
    of JAX's bf16 ragged dot over the same planes."""
    K, N = SHAPES[shape]
    rng = np.random.default_rng(127)
    w = jnp.asarray(rng.standard_normal((G, K, N)).astype(np.float32) * 0.05, jnp.bfloat16)
    we = torch.from_numpy(np.array(w.astype(jnp.float32))).to(torch.bfloat16)
    for g in range(G):
        assert torch.equal(mm.tc_operand(we, g, "dense"), we[g])
    rows = _routing(routing, rng)
    x = rng.standard_normal((len(rows), K)).astype(np.float32)
    got = mm.moe_matmul_tc_plain(torch.from_numpy(x), we, _offsets(rows),
                                 decoder="dense").numpy()
    want = _jax_ragged(x, w, rows, jnp.bfloat16)
    assert np.abs(got - want).max() <= FAST_RTOL * np.abs(want).max()


def test_dense_f32_has_no_tensor_core_operand():
    """Dense f32 planes take the SIMT kernel: the twin refuses them."""
    we = torch.zeros((G, 64, 32))
    with pytest.raises(ValueError, match="SIMT"):
        mm.tc_operand(we, 0, "dense")
    with pytest.raises(ValueError, match="SIMT"):
        mm.moe_matmul_tc_plain(torch.zeros((3, 64)), we, torch.tensor([0, 3, 3, 3, 3, 3, 3],
                                                                      dtype=torch.int32),
                               decoder="dense")


def _split_sums(xq: torch.Tensor, w8: torch.Tensor, k_split: int) -> torch.Tensor:
    """The int32 sums of each K split, added in split order (what the
    kernel's splits and ``moe_reduce_kernel`` compute for a8)."""
    K = xq.shape[1]
    acc = torch.zeros((xq.shape[0], w8.shape[1]), dtype=torch.int64)
    for lo in range(0, K, k_split):
        part = xq[:, lo:lo + k_split].long() @ w8[lo:lo + k_split].long()
        assert part.abs().max() < 2 ** 31
        acc += part
    return acc.to(torch.int32)


@pytest.mark.parametrize("routing", ["random", "one", "skewed", "decode"])
def test_a8_twin_bit_for_bit_with_a_k_split(routing):
    """Turbo a8: integer sums, so the twin, and the kernel's K splits added
    in split order, equal the plain version bit for bit; the gather regime's
    rows also equal the port's ``_expert_gather_dot``."""
    from dllama_tpu_torch.models import llama
    from dllama_tpu_torch.ops.turbo import quantize_activations_a8

    K, N = 1024, 96
    rng = np.random.default_rng(131)
    _, tw = _turbo_planes(K, N, True, rng)
    rows = (np.sort(rng.choice(G, size=G, replace=False)).astype(np.int32)
            if routing == "decode" else _routing(routing, rng))
    x = torch.from_numpy(rng.standard_normal((len(rows), K)).astype(np.float32))
    off = _offsets(rows)
    want = mm.moe_matmul_plain(x, tw, off, decoder="a8")
    assert torch.equal(mm.moe_matmul_tc_plain(x, tw, off, decoder="a8"), want)
    splits, k_split = mm._moe_splits(len(rows), K, N, G, "tc")
    if routing == "decode":
        assert splits > 1  # the narrow case splits K
    xq, sx = quantize_activations_a8(x)
    b = off.tolist()
    for g in range(G):
        lo, hi = b[g], b[g + 1]
        if hi > lo:
            acc = _split_sums(xq[lo:hi], tw.w8[g], k_split)
            y = acc.float() * sx[lo:hi] * tw.scale[g]
            assert torch.equal(y, want[lo:hi])
    if routing == "decode":
        gather = llama._expert_gather_dot(x, tw, torch.from_numpy(rows).long())
        assert torch.equal(want, gather)


@pytest.mark.parametrize("dec,kernel", [(mm._DEC_Q_F32, "tc"), (mm._DEC_Q_BF16, "tc"),
                                        (mm._DEC_D_F32, "simt"), (mm._DEC_D_BF16, "tc"),
                                        (mm._DEC_A8, "tc"), (mm._DEC_A16, "tc"),
                                        (mm._DEC_PRE, "tc")])
def test_kernel_chosen_by_decoder_alone(dec, kernel):
    """D_F32 takes the SIMT kernel, every other decoder the tensor cores,
    whatever the shapes."""
    assert mm._moe_kernel(dec) == kernel


@pytest.mark.parametrize("decoder,dtype,dec", [
    ("q", "exact", mm._DEC_Q_F32), ("q", "fast", mm._DEC_Q_BF16),
    ("dense", torch.float32, mm._DEC_D_F32), ("dense", torch.bfloat16, mm._DEC_D_BF16),
    ("a8", None, mm._DEC_A8), ("a16", None, mm._DEC_A16), ("prescaled", None, mm._DEC_PRE)])
def test_operands_name_the_decoder(decoder, dtype, dec):
    """The C decoder code each wrapper decoder hands the entry, from which
    the kernel follows."""
    rng = np.random.default_rng(7)
    x = torch.randn(3, 64)
    if decoder == "q":
        _, we = _q_planes(64, 32, "q40", dtype == "fast", rng)
        got = mm._operands(x, we, decoder, dtype == "fast")
    elif decoder == "dense":
        got = mm._operands(x, torch.zeros((G, 64, 32), dtype=dtype), decoder, False)
    else:
        _, tw = _turbo_planes(64, 32, decoder == "a8", rng)
        got = mm._operands(x, tw, decoder, False)
    assert got[4] == dec
    # the turbo and dense planes take the general int8 decode; Q40 planes nibbles
    assert got[6] == (0 if decoder == "q" else 1)


@pytest.mark.parametrize("kind,q80", [("q40", 0), ("q80", 1)])
def test_operands_decode_codes_by_kind(kind, q80):
    """Q planes hand the C entry their code kind: Q40 codes are decoded as
    nibbles, Q80 codes as whole bytes; a kind no kernel reads is refused."""
    rng = np.random.default_rng(11)
    _, we = _q_planes(64, 32, kind, False, rng)
    assert mm._operands(torch.randn(3, 64), we, "q", False)[6] == q80
    with pytest.raises(ValueError, match="codes"):
        mm._operands(torch.randn(3, 64), we._replace(kind="q4k"), "q", False)


SPLIT_GRID = [(R, K, N, Gs) for R in (1, 8, 13, 64, 150, 1024, 2048)
              for K, N in ((2048, 768), (768, 2048), (4096, 4096), (4096, 14336), (96, 256))
              for Gs in (1, 128)]


@pytest.mark.parametrize("kernel", ["tc", "simt"])
def test_splits_cover_k_in_whole_chunks(kernel):
    """Every plan the wrapper makes is what the C entry takes: whole 256-row
    chunks a split, every split holding some of K, K covered; the
    tensor-core plan keeps the splits' raw sums under a quarter of the
    weight bytes and never splits the 1024- and 2048-row MoE chunks."""
    for R, K, N, Gs in SPLIT_GRID:
        splits, k_split = mm._moe_splits(R, K, N, Gs, kernel)
        assert splits >= 1 and k_split > 0 and k_split % mm._KC == 0, (R, K, N, Gs)
        assert (splits - 1) * k_split < K <= splits * k_split, (R, K, N, Gs)
        if kernel == "tc" and splits > 1:
            assert splits * R * N * 4 <= min(R, Gs) * K * N // 4, (R, K, N, Gs)
    assert mm._moe_splits(1024, 2048, 768, 128, "tc")[0] == 1
    assert mm._moe_splits(2048, 768, 2048, 128, "tc")[0] == 1
    # one decode token's 8 experts fill the card only with a K split
    assert mm._moe_splits(8, 2048, 768, 128, kernel)[0] > 1
    assert mm._moe_splits(0, 2048, 768, 128, kernel) == (1, 2048)


def test_simt_plan_unchanged():
    """The SIMT kernel (dense f32 planes) keeps its plan: split only while
    the blocks that can hold rows leave SMs idle."""
    for R, K, N, Gs in SPLIT_GRID:
        active = -(-N // mm._BN) * min(R, Gs)
        splits, _ = mm._moe_splits(R, K, N, Gs, "simt")
        if active >= SMS:
            assert splits == 1


@pytest.mark.parametrize("seed", range(6))
def test_grid_holds_every_work_item(seed):
    """The tensor-core grid's rows (``_tc_items``) hold every work item (a
    group's slices, group by group) of any routing: random, skewed, all on
    one group, every group one row."""
    rng = np.random.default_rng(seed)
    for R in (1, 8, 13, 64, 65, 150, 1024, 2048):
        for Gs in (2, 8, 128):
            counts = [rng.multinomial(R, rng.dirichlet(np.full(Gs, 0.3))),
                      np.bincount(np.full(R, Gs - 1), minlength=Gs),
                      np.bincount(np.arange(R) % Gs, minlength=Gs)]
            for c in counts:
                items = sum(len(mm._row_slices(int(n))) for n in c)
                assert items <= mm._tc_items(R, Gs), (R, Gs, c)
    assert mm._tc_items(256, 1) == 4


@pytest.mark.parametrize("n_rows", [0, 1, 7, 8, 9, 16, 17, 33, 63, 64, 65, 150, 512, 1000])
def test_row_slices_cover_the_group(n_rows):
    """The row budget's slices cover a group's rows in order, each at most
    64 rows, each with the least number of 8-row tiles (1, 2, 4 or 8)."""
    sl = mm._row_slices(n_rows)
    at = 0
    for first, n, tiles in sl:
        assert first == at and 0 < n <= mm._ROWS
        assert tiles in (1, 2, 4, 8) and 8 * tiles >= n
        assert tiles == 1 or 8 * (tiles // 2) < n
        at += n
    assert at == n_rows
    assert len(sl) == -(-n_rows // mm._ROWS)
