// Grouped expert matmul for Hopper (sm_90a): kernel K5.
//
//   y[r, :] = x[r, :] @ W[g(r)]      for rows r sorted by group g,
//
// group g owning rows [offsets[g], offsets[g + 1]) of x and y, with the
// offsets (int32, G + 1 of them) on the device. W is a stack of G planes in
// the JAX package's K-major layout, [G, K, N]. The mixture-of-experts FFN
// calls it once per projection with one group per expert; the turbo dense
// linear calls it with G = 1 (a null offsets pointer: one group of all R
// rows).
//
// K5 replaces no Pallas kernel: the JAX package computes the expert dots in
// XLA (dllama_tpu/models/llama.py::_expert_gather_dot, a jnp.einsum over
// gathered planes at <= 32 (token, expert) rows, and one lax.ragged_dot a
// projection over rows sorted by expert above that) and the turbo matmul in
// XLA too (dllama_tpu/ops/turbo.py::turbo_matmul, dot_general). The port
// needs a kernel of its own: its decode, verify and paged steps replay CUDA
// graphs, which cannot read group sizes back to the host, PyTorch has no
// grouped matmul over f32, bf16, Q40/Q80 or int8 planes that takes
// device-side offsets, and gathering each row's dense plane would move
// ~2.7 GB a layer a step at Qwen3-30B-A3B widths.
//
// Plane decoders (the template argument DEC, the C entry's dec), each the
// arithmetic of the plain version (ops/moe_matmul.py::moe_matmul_plain) and
// of the JAX package; only the order of the f32 sums differs:
//   Q_F32   Q40/Q80 block planes, codes int8 [G, K, N] and f32 scales
//           [G, K/32, N], f32 x (exact). On the tensor cores A = the code
//           (exact in bf16), B = each f32 activation as three bf16 parts
//           x = x0 + x1 + x2 (as K2's split3: the sum is x exactly), the
//           products summed in f32 over one Q40 block, then the block's
//           f32 scale applied once to that sum: s * sum(x * code) instead
//           of sum(x * (code * s)), a reassociation within f32 rounding
//           (ops/moe_matmul.py::moe_matmul_tc_plain writes it plainly);
//   Q_BF16  the same planes (scales f32 or bf16: SBF16), A = bf16(code *
//           bf16(scale)) per element, the JAX package's fast dequant (the
//           scale is not factored out of a block's sum), B = bf16 x (fast);
//   D_F32, D_BF16  dense planes [G, K, N] of that dtype, x of that dtype;
//   T_A8    turbo a8: int8 x with a per-row f32 scale sx, int8 planes, int32
//           sums (exact, so the result equals the plain version bit for
//           bit, K splits included), epilogue acc * sx[r] * scale[g, n];
//   T_A16   turbo a16: bf16 x times the int8 codes (A exact in bf16), f32
//           sums, epilogue acc * scale[g, n];
//   T_PRE   turbo pre-scaled (the JAX ragged regime's dense rhs): A =
//           bf16(bf16(w8) * bf16(scale)), bf16 x, f32 sums.
// Every product is exact in f32.
//
// Which kernel a decoder takes, by the decoder alone (takes_tc below;
// ops/moe_matmul.py::_moe_kernel records the same rule): D_F32 the FP32
// SIMT kernel (moe_matmul_kernel, 72% of its bytes bound on an H100 80GB
// HBM3 at 700 W, PERF.md §6), every other decoder the tensor cores
// (moe_tc_kernel).
//
// Bound on the H100: bytes (each routed expert's planes once: K * N bytes
// of codes plus the scales per expert per projection, at 3.35 TB/s) at every
// width the MoE FFN runs, up to the 2048 rows of a 256-token prefill: 2 * R
// * K * N products are far under the tensor cores' 989 TFLOP/s (three bf16
// products a weight in exact mode). The turbo linear's one group crosses
// into operations at about M = 256 rows (a16).
//
// Design of the tensor-core kernel (moe_tc_kernel):
//   * grid (N / 128, work items, K splits): a work item is one slice of up
//     to 64 rows (the row budget) of one group, items numbered group by
//     group; each block finds its item from the offsets on the device (one
//     round of loads and a warp scan of the groups' slice counts for 128
//     groups), so the grid's shape never depends on the routing (graph-safe)
//     and a group of many rows (a skewed routing) spreads over many blocks.
//     The grid holds min(G, R) + R / 64 items (ceil(R / 64) for one
//     group), at least what any routing of R rows makes; blocks past the
//     last item return at once. With no offsets (the turbo linear) grid row
//     y is slice y of the one group;
//   * mma.sync with the product swapped, y^T = W^T x^T: each of the 8 warps
//     owns one m16 tile, 16 of the block's columns, and the slice's rows
//     are the n8 side, all its n8 tiles' f32 accumulators in registers (NT
//     = 1, 2, 4 or 8 tiles, the least that holds the slice), so a block
//     reads its plane tile once: once per group for a group of up to 64
//     rows, once per slice (in parallel, through L2) for a larger one;
//   * the plane tile (32 K rows x 128 columns, one Q40 block), its scale row
//     and the slice's activations stream through a cp.async ring in 108 KB
//     of shared memory (two blocks an SM), as deep as it holds up to 8
//     stages (6 in flight at NT = 1, 2 for exact mode's 64-row slices; 4
//     stages instead of 8 cost up to 26% on an H100, 6 up to 6%); each
//     thread's copy sources are worked out once a slice. One ldmatrix.trans a stage gives a lane
//     its A codes (two K rows x two columns of each of four 8-row matrices,
//     the K rows picked so that each register holds four consecutive K of
//     one column for the int8 mma and two pairs for the bf16 one), and the
//     decoders build the A operand from them in registers (no dequantized
//     weight is stored; Q40 codes by K2's nibble trick, any other int8
//     through f32). Exact mode splits each stage's activations into their
//     three bf16 parts once for the block, while the stage before it
//     multiplies, and runs the three parts' products as independent chains;
//   * when the blocks that can hold rows would leave the card under-filled
//     (a decode token's 8 experts, the paged step, the turbo linear's one
//     group), the K axis is split across blocks too (grid z, whole 256-row
//     chunks a split, the plan in the Python wrapper): each split writes its
//     raw sums (int32 for T_A8) and moe_reduce_kernel adds them in split
//     order and applies the epilogue, so T_A8 stays exact.
// On an H100 80GB HBM3 at 700 W this reaches 71% (fast) and 54% (exact) of
// the bytes bound at a 128-token chunk's 1024 rows, 49% at the paged step's
// 64, 23-24% at a decode token's 8 (PERF.md §6). Per stage the block's warps
// meet at one barrier behind a dependent chain (ldmatrix, decode, mma).
// wgmma and TMA are not used: at these row counts a group rarely fills
// wgmma's 64-row tiles; the turbo linear's prefill (M >= 128, one group)
// would.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

enum Dec { Q_F32 = 0, Q_BF16 = 1, D_F32 = 2, D_BF16 = 3, T_A8 = 4, T_A16 = 5, T_PRE = 6 };

// the kernel a decoder takes: the tensor cores for every decoder but dense
// f32 planes (ops/moe_matmul.py::_moe_kernel records the same rule)
constexpr bool takes_tc(int dec) { return dec != D_F32; }

constexpr int KC = 256;  // K rows of a split's unit (both kernels)

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The epilogue of one output element from its full sum.
template <int DEC, typename acc_t>
__device__ __forceinline__ float epilogue(acc_t sum, const float* __restrict__ sx,
                                          const void* __restrict__ scales, int row, int g,
                                          int n, int N) {
  if constexpr (DEC == T_A8) {
    return static_cast<float>(sum) * sx[row]
           * static_cast<const float*>(scales)[static_cast<size_t>(g) * N + n];
  } else if constexpr (DEC == T_A16) {
    return sum * static_cast<const float*>(scales)[static_cast<size_t>(g) * N + n];
  } else {
    return sum;
  }
}

// --------------------------------------------------------------------------
// The FP32 SIMT kernel (D_F32): grid (N / 128, G, K splits); a block walks
// its group's rows in tiles of up to 16 (1, 2, 4, 8 or 16 rows, the least
// that holds what is left); 8 warps split K into 32-row slices; each lane
// owns 4 neighbouring columns, so a warp reads 512 contiguous bytes of a K
// row; the tile's activations stream through shared memory 256 K rows at a
// time; the warps' partial sums are added in shared memory in a fixed order.
// --------------------------------------------------------------------------

constexpr int BN = 128;            // columns per block: 32 lanes x 4
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SLICE = 32;          // K rows a warp takes per chunk
static_assert(KC == WARPS * SLICE, "a chunk is one slice a warp");
constexpr int MAX_RT = 16;         // rows per tile
constexpr int RED_ROWS = 8;        // rows reduced per pass (shared memory: 32 KB)

// One row tile of RT rows: rows [row0, row0 + nrows) of x and y, columns
// [n_tile, n_tile + BN), group g, K rows [k_lo, k_hi). With ``part``
// (a K split) the raw sums go to part[row][n] instead of y.
template <int RT>
__device__ void simt_tile(const float* __restrict__ x, const float* __restrict__ w,
                          float* __restrict__ y, float* __restrict__ part, int row0, int nrows,
                          int K, int N, int g, int n_tile, int k_lo, int k_hi,
                          unsigned char* smem) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = n_tile + lane * 4;
  const bool col_ok = n < N;
  float acc[RT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  const size_t plane = static_cast<size_t>(g) * K * N;
  for (int kc = k_lo; kc < k_hi; kc += KC) {
    __syncthreads();  // the previous chunk (or tile) is done with smem
    float* xs = reinterpret_cast<float*>(smem);
    for (int i = threadIdx.x; i < RT * KC; i += THREADS) {
      const int r = i / KC, kk = i % KC;
      xs[i] = (r < nrows && kc + kk < k_hi) ? x[static_cast<size_t>(row0 + r) * K + kc + kk]
                                            : 0.f;
    }
    __syncthreads();
    const int k0 = kc + warp * SLICE;
    if (!col_ok || k0 >= k_hi) continue;  // K % 32 == 0: a slice is whole or absent
#pragma unroll 2
    for (int k4 = 0; k4 < SLICE; k4 += 4) {
      const int k = k0 + k4;
      float wv[4][4];  // [K row j][column c]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(w + plane + static_cast<size_t>(k + j) * N + n);
        wv[j][0] = v.x; wv[j][1] = v.y; wv[j][2] = v.z; wv[j][3] = v.w;
      }
      const float4* xs4 = reinterpret_cast<const float4*>(smem);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 xv = xs4[(r * KC + (k - kc)) / 4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[r][c] = fmaf(xv.x, wv[0][c], acc[r][c]);
          acc[r][c] = fmaf(xv.y, wv[1][c], acc[r][c]);
          acc[r][c] = fmaf(xv.z, wv[2][c], acc[r][c]);
          acc[r][c] = fmaf(xv.w, wv[3][c], acc[r][c]);
        }
      }
    }
  }

  // the warps' partial sums, added in warp order, RED_ROWS rows a pass
  float* red = reinterpret_cast<float*>(smem);  // [WARPS][RED_ROWS][BN]
#pragma unroll
  for (int p = 0; p < RT; p += RED_ROWS) {
    constexpr int PR = RT < RED_ROWS ? RT : RED_ROWS;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < PR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[(warp * RED_ROWS + r) * BN + lane * 4 + c] = acc[p + r][c];
    __syncthreads();
    for (int o = threadIdx.x; o < PR * BN; o += THREADS) {
      const int r = o / BN, col = o % BN;
      const int row = p + r, nn = n_tile + col;
      if (row >= nrows || nn >= N) continue;
      float sum = 0.f;
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) sum += red[(wi * RED_ROWS + r) * BN + col];
      const size_t at = static_cast<size_t>(row0 + row) * N + nn;
      if (part != nullptr)
        part[at] = sum;
      else
        y[at] = sum;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
moe_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const int* __restrict__ offsets, float* __restrict__ y,
                  float* __restrict__ part, int R, int K, int N, int k_split) {
  __shared__ __align__(16) unsigned char smem[WARPS * RED_ROWS * BN * 4];
  static_assert(MAX_RT * KC * 4 <= sizeof(smem), "x chunk must fit the reduction buffer");
  const int g = blockIdx.y;
  const int lo = offsets ? offsets[g] : 0;
  const int hi = offsets ? offsets[g + 1] : R;
  const int n_tile = blockIdx.x * BN;
  const int k_lo = blockIdx.z * k_split;
  const int k_hi = min(K, k_lo + k_split);
  // split z's raw sums: part[z][R][N]
  float* out = part == nullptr ? nullptr : part + static_cast<size_t>(blockIdx.z) * R * N;
  for (int row0 = lo; row0 < hi; row0 += MAX_RT) {
    const int nrows = min(MAX_RT, hi - row0);
    // the least tile that holds the rows left (uniform across the block)
    if (nrows == 1)
      simt_tile<1>(x, w, y, out, row0, nrows, K, N, g, n_tile, k_lo, k_hi, smem);
    else if (nrows == 2)
      simt_tile<2>(x, w, y, out, row0, nrows, K, N, g, n_tile, k_lo, k_hi, smem);
    else if (nrows <= 4)
      simt_tile<4>(x, w, y, out, row0, nrows, K, N, g, n_tile, k_lo, k_hi, smem);
    else if (nrows <= 8)
      simt_tile<8>(x, w, y, out, row0, nrows, K, N, g, n_tile, k_lo, k_hi, smem);
    else
      simt_tile<16>(x, w, y, out, row0, nrows, K, N, g, n_tile, k_lo, k_hi, smem);
  }
}

// --------------------------------------------------------------------------
// The tensor-core kernel (every decoder but D_F32). In a warp, lane = 4 gq +
// tq; the warp's m16 tile holds 16 of the block's columns as its A rows
// (int8 planes: row gq = column 2 gq, row gq + 8 = column 2 gq + 1; bf16
// planes: rows gq, gq + 8 = columns gq, gq + 8), and n8 tile u of a slice
// holds its rows 8u .. 8u + 7 as the B columns. Inside an mma the k slots
// are a permutation of the stage's 32 K rows, the same for A and B: a lane
// reads activations at K 4 tq .. 4 tq + 3 and 16 + 4 tq .. (one 4-element
// vector each), and ldmatrix hands it the weights of the same K rows.
// --------------------------------------------------------------------------

constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_BN = TC_WARPS * 16;  // columns a block: one m16 tile a warp
constexpr int TC_BK = 32;             // K rows a stage: one Q40 block
constexpr int TC_ROWS = 64;           // the row budget of a slice: 8 n8 tiles
constexpr int TC_SMEM = 108 * 1024;   // the ring's shared memory: two blocks an SM
constexpr int TC_MAX_STAGES = 8;
static_assert(KC % TC_BK == 0, "a split is whole stages");

// A stage of the ring: the plane tile [32 K rows][128 columns], the Q
// decoders' scale row [128], the slice's activations [NT * 8 rows][32 K]
// as loaded and, for exact mode, their three bf16 parts [3][NT * 8][32]
// (the B operand, split once a stage for the whole block). A slice of NT
// n8 tiles gets as many stages as TC_SMEM holds, at most TC_MAX_STAGES:
// a narrow slice keeps more of the plane in flight.
template <int DEC, bool SBF16>
struct Tc {
  static constexpr bool QDEC = DEC == Q_F32 || DEC == Q_BF16;
  static constexpr int W_ELT = DEC == D_BF16 ? 2 : 1;  // plane bytes a weight
  static constexpr int X_ELT = DEC == Q_F32 ? 4 : DEC == T_A8 ? 1 : 2;
  static constexpr int B_ELT = DEC == T_A8 ? 1 : 2;    // bytes of a B value
  static constexpr int S_ELT = SBF16 ? 2 : 4;
  static constexpr int W_ROW = TC_BN * W_ELT;  // bytes of a K row of the tile
  static constexpr int X_ROW = TC_BK * X_ELT;  // bytes of an activation row
  static constexpr int B_ROW = TC_BK * B_ELT;  // bytes of a B row (a part's, exact)
  static constexpr int W = TC_BK * W_ROW;
  static constexpr int S = QDEC ? TC_BN * S_ELT : 0;
  static constexpr int ROW = X_ROW + (DEC == Q_F32 ? 3 * B_ROW : 0);  // bytes a slice row
};
template <int DEC, bool SBF16, int NT>
struct TcRing {
  using T = Tc<DEC, SBF16>;
  static constexpr int STAGE = T::W + T::S + NT * 8 * T::ROW;
  static constexpr int STAGES = TC_SMEM / STAGE < TC_MAX_STAGES ? TC_SMEM / STAGE : TC_MAX_STAGES;
  static constexpr int PART = NT * 8 * T::B_ROW;  // bytes of one part (exact)
};

// K row r of the plane tile: 16-byte chunk c sits at chunk position c ^
// wswz(r), so the 8 K rows of each ldmatrix matrix (K rows {0, 1, 4, 5, 8,
// 9, 12, 13} or {2, 3, 6, 7, ...} + 16 m) hit distinct banks
__device__ __forceinline__ int wswz(int r) { return ((r >> 1) & 6) | (r & 1); }
// activation (or part) row r of E-byte values: chunk c at c ^ xswz<E>(r),
// so the loads of each warp phase (8 lanes for 16 bytes, 16 for 8, 32 for
// 4) hit distinct banks
template <int E>
__device__ __forceinline__ int xswz(int r) {
  if constexpr (E == 4) return (r & 1) << 2;
  else if constexpr (E == 2) return r & 2;
  else return (r >> 2) & 1;
}

// byte i of v as a float: the int8 code exactly (biased by 128 under an f32
// exponent of 2^23, then the bias taken off)
__device__ __forceinline__ float code_at(uint32_t v, int i) {
  return __uint_as_float(__byte_perm(v ^ 0x80808080u, 0x4B000000u, 0x7440u + i)) -
         8388736.0f;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ uint32_t hmul2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 p = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The codes of ldmatrix'd register v (bytes: (K row a, column 2gq), (a,
// 2gq + 1), (K row a + 1, 2gq), (a + 1, 2gq + 1)) as two bf16 pairs: ca =
// column 2gq at K rows a, a + 1, cb = column 2gq + 1. Q40 codes (in [-8,
// 7]) by K2's nibble trick: (code & 0xF) ^ 8 = code + 8 as the low byte of
// a bf16 of exponent 2^7 is 128 + code + 8 exactly, and one bf16 subtraction
// of 136 a pair leaves the code; any other int8 code through f32.
template <bool NIBBLE>
__device__ __forceinline__ void code_pairs(uint32_t v, uint32_t& ca, uint32_t& cb) {
  if constexpr (NIBBLE) {
    const uint32_t t = (v & 0x0F0F0F0Fu) ^ 0x08080808u;
    const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
    const uint32_t pa = __byte_perm(t, 0x43434343u, 0x4240u);
    const uint32_t pb = __byte_perm(t, 0x43434343u, 0x4341u);
    const __nv_bfloat162 a = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&pa), bias);
    const __nv_bfloat162 b = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&pb), bias);
    ca = *reinterpret_cast<const uint32_t*>(&a);
    cb = *reinterpret_cast<const uint32_t*>(&b);
  } else {
    ca = pack_bf16(code_at(v, 0), code_at(v, 2));
    cb = pack_bf16(code_at(v, 1), code_at(v, 3));
  }
}
// the same pairs times their column's bf16 scale, rounded to bf16: sa2 /
// sb2 hold the scale of column 2gq / 2gq + 1 in both halves. Q40: the bf16
// product of two bf16 values (one rounding of the exact product); other
// codes: the exact f32 product, rounded once.
template <bool NIBBLE>
__device__ __forceinline__ void weight_pairs(uint32_t v, uint32_t sa2, uint32_t sb2,
                                             uint32_t& wa, uint32_t& wb) {
  if constexpr (NIBBLE) {
    uint32_t ca, cb;
    code_pairs<true>(v, ca, cb);
    wa = hmul2(ca, sa2);
    wb = hmul2(cb, sb2);
  } else {
    const float sa = __uint_as_float(sa2 << 16), sb = __uint_as_float(sb2 << 16);
    wa = pack_bf16(code_at(v, 0) * sa, code_at(v, 2) * sa);
    wb = pack_bf16(code_at(v, 1) * sb, code_at(v, 3) * sb);
  }
}

// One 16-byte chunk of a row global -> shared, ``valid`` of its bytes inside
// the row (<= 0: none). vec (N % 16 == 0): a chunk is wholly in or out;
// else four 4-byte pieces, each in or out (N % 4 == 0). What lies past the
// row reads as zeros; ``safe`` is a valid address for the empty copies.
__device__ __forceinline__ void copy_chunk(uint32_t dst, const unsigned char* src, int valid,
                                           bool vec, const void* safe) {
  if (vec) {
    cp_async16(dst, valid > 0 ? src : safe, valid > 0 ? 16 : 0);
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const bool ok = valid >= 4 * p + 4;
      cp_async_ca<4>(dst + 4 * p, ok ? src + 4 * p : safe, ok ? 4 : 0);
    }
  }
}

// A thread's share of the copies of each stage of a slice (the plane tile of
// group g, columns n0 .. n0 + 127; the Q decoders' scale row; the slice's
// first NT * 8 rows of x, rows past ``nrows`` as zeros), its sources worked
// out once: stage j of the slice reads them j stages further along K.
template <int DEC, bool SBF16, int NT>
struct TcFetch {
  using T = Tc<DEC, SBF16>;
  static constexpr int WC = T::W_ROW / 16;                 // chunks a K row of the tile
  static constexpr int NW = TC_BK * WC / TC_THREADS;       // plane chunks a thread
  static constexpr int XC = T::X_ROW / 16;                 // chunks an activation row
  static constexpr int NX = (NT * 8 * XC + TC_THREADS - 1) / TC_THREADS;
  static_assert(TC_BK * WC % TC_THREADS == 0, "whole chunks a thread");
  static_assert(TC_THREADS % XC == 0, "a thread keeps its chunk column");
  const unsigned char* wp;  // plane chunk 0 of stage 0 (chunk i: 256 / WC rows further)
  const unsigned char* sp;  // scale chunk of stage 0
  const unsigned char* xp;  // activation chunk 0 of stage 0 (chunk i: 256 / XC rows further)
  size_t w_step, w_rows, s_step;  // bytes a stage, of 256 / WC plane rows, of a scale row
  int w_valid, s_valid, x_rows;  // bytes of a chunk inside the row; x rows a thread's chunk 0 is at
  int nrows, K;
  bool vec;

  __device__ __forceinline__ TcFetch(const unsigned char* x, const unsigned char* w,
                                     const unsigned char* scales, int g, int row0, int nrows_,
                                     int kb_lo, int K_, int N, int n0, bool vec_)
      : nrows(nrows_), K(K_), vec(vec_) {
    const int tid = threadIdx.x;
    const size_t k0 = static_cast<size_t>(kb_lo) * TC_BK;
    const int wcol = n0 + (tid % WC) * (16 / T::W_ELT);
    w_valid = (N - wcol) * T::W_ELT;
    wp = w + ((static_cast<size_t>(g) * K + k0 + tid / WC) * N + (w_valid > 0 ? wcol : 0))
                 * T::W_ELT;
    w_step = static_cast<size_t>(TC_BK) * N * T::W_ELT;
    w_rows = static_cast<size_t>(TC_THREADS / WC) * N * T::W_ELT;
    s_step = static_cast<size_t>(N) * T::S_ELT;
    s_valid = 0;
    sp = scales;
    if constexpr (T::QDEC) {
      const int scol = n0 + tid * (16 / T::S_ELT);
      s_valid = (N - scol) * T::S_ELT;
      sp = scales + ((static_cast<size_t>(g) * (K / TC_BK) + kb_lo) * N
                     + (s_valid > 0 ? scol : 0)) * T::S_ELT;
    }
    x_rows = tid / XC;
    xp = x + (static_cast<size_t>(row0 + x_rows) * K + k0) * T::X_ELT + (tid % XC) * 16;
  }

  // stage j of the slice into the ring slot at ``st``
  __device__ __forceinline__ void copy(uint32_t st, int j, const unsigned char* x,
                                       const unsigned char* w,
                                       const unsigned char* scales) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int r = tid / WC + i * (TC_THREADS / WC), ch = tid % WC;
      copy_chunk(st + r * T::W_ROW + ((ch ^ wswz(r)) << 4), wp + j * w_step + i * w_rows,
                 w_valid, vec, w);
    }
    if constexpr (T::QDEC) {
      if (tid < T::S / 16)
        copy_chunk(st + T::W + tid * 16, sp + j * s_step, s_valid, vec, scales);
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int r = x_rows + i * (TC_THREADS / XC), ch = tid % XC;
      if (r < NT * 8) {
        const bool ok = r < nrows;
        cp_async16(st + T::W + T::S + r * T::X_ROW + ((ch ^ xswz<T::X_ELT>(r)) << 4),
                   ok ? xp + (j * TC_BK + static_cast<size_t>(i) * (TC_THREADS / XC) * K)
                                 * T::X_ELT
                      : x,
                   ok ? 16 : 0);
      }
    }
  }
};

// Exact mode: the f32 activations of a landed stage as three bf16 parts,
// once for the block (each warp reads them as its B operand): thread t
// takes the values t, t + 256, ... of the stage's [NT * 8 rows][32 K].
template <int NT>
__device__ __forceinline__ void tc_split(unsigned char* stp) {
  using T = Tc<Q_F32, false>;
  const unsigned char* xs = stp + T::W + T::S;
  unsigned char* ps = stp + T::W + T::S + NT * 8 * T::X_ROW;
  constexpr int PART = TcRing<Q_F32, false, NT>::PART;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int v = threadIdx.x + i * TC_THREADS, r = v >> 5, k = v & 31;
    float a = *reinterpret_cast<const float*>(xs + r * T::X_ROW
                                              + (((k >> 2) ^ xswz<4>(r)) << 4) + 4 * (k & 3));
    // K k of a part row: byte 2k, chunk k / 8
    const int at = r * T::B_ROW + (((k >> 3) ^ xswz<2>(r)) << 4) + 2 * (k & 7);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const __nv_bfloat16 h = __float2bfloat16_rn(a);
      *reinterpret_cast<__nv_bfloat16*>(ps + q * PART + at) = h;
      a -= __bfloat162float(h);
    }
  }
}

// One slice: rows [row0, row0 + nrows) (nrows <= 8 NT) of group g against
// columns n0 .. n0 + 127 over stages [kb_lo, kb_hi), through a ring of
// STAGES stages. At iteration i the block waits for stages i and i + 1 (so
// exact mode can split stage i + 1's activations while stage i multiplies)
// and refills the slot of stage i - 1: STAGES - 2 stages stay in flight.
// With ``part`` (a K split) the raw sums go to part[row][n] instead of the
// epilogue to y. Q80: the planes' codes are any int8 (Q80, turbo), else
// Q40 codes in [-8, 7].
template <int DEC, bool SBF16, bool Q80, int NT>
__device__ void tc_slice(const unsigned char* __restrict__ x, const float* __restrict__ sx,
                         const unsigned char* __restrict__ w,
                         const unsigned char* __restrict__ scales, float* __restrict__ y,
                         void* __restrict__ part, int g, int row0, int nrows, int kb_lo,
                         int kb_hi, int K, int N, int n0, bool vec, unsigned char* smem) {
  using T = Tc<DEC, SBF16>;
  using Ring = TcRing<DEC, SBF16, NT>;
  using acc_t = typename std::conditional<DEC == T_A8, int, float>::type;
  constexpr int STAGE = Ring::STAGE, STAGES = Ring::STAGES;
  static_assert(STAGES >= 3, "a stage in flight at least");
  constexpr bool EXACT = DEC == Q_F32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const uint32_t ring = smem_addr(smem);
  const int n_st = kb_hi - kb_lo;
  constexpr bool PAIRED = T::W_ELT == 1;  // int8 planes: A rows = columns 2gq, 2gq + 1
  const int col_a = n0 + 16 * warp + (PAIRED ? 2 * gq : gq);
  const int col_b = col_a + (PAIRED ? 1 : 8);

  // the pre-scaled A operand's per-column scales, rounded to bf16, in both
  // halves of a register
  uint32_t ts_a = 0, ts_b = 0;
  if constexpr (DEC == T_PRE) {
    const float* ts = reinterpret_cast<const float*>(scales) + static_cast<size_t>(g) * N;
    if (col_a < N) ts_a = __float_as_uint(bf16_round(ts[col_a])) >> 16;
    if (col_b < N) ts_b = __float_as_uint(bf16_round(ts[col_b])) >> 16;
    ts_a *= 0x10001u;
    ts_b *= 0x10001u;
  }

  // ldmatrix row addresses in a stage: lane l points at row l % 8 of matrix
  // l / 8. int8 planes: one x4 over the stage, matrix m = K rows 16 (m / 2)
  // + {0, 1, 4, 5, 8, 9, 12, 13} + 2 (m % 2) of the warp's chunk; bf16
  // planes: one x4 a k16 step h, matrix m = K rows 16 h + {...} + 2 (m / 2)
  // of the warp's chunk 2 warp + m % 2.
  uint32_t a_off[T::W_ELT];
  {
    const int m = lane >> 3, j = lane & 7;
    if constexpr (PAIRED) {
      const int kr = 16 * (m >> 1) + 4 * (j >> 1) + 2 * (m & 1) + (j & 1);
      a_off[0] = kr * T::W_ROW + ((warp ^ wswz(kr)) << 4);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kr = 16 * h + 4 * (j >> 1) + 2 * (m >> 1) + (j & 1);
        a_off[h] = kr * T::W_ROW + (((2 * warp + (m & 1)) ^ wswz(kr)) << 4);
      }
    }
  }
  // B loads: row 8u + gq at K 16h + 4tq .. + 3, from the stage's
  // activations (exact: its parts); the offset of u = 0 (xswz depends on
  // gq alone)
  uint32_t b_off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int byte = (16 * h + 4 * tq) * T::B_ELT;
    b_off[h] = T::W + T::S + (EXACT ? NT * 8 * T::X_ROW : 0) + gq * T::B_ROW
               + (((byte >> 4) ^ xswz<T::B_ELT>(gq)) << 4) + (byte & 15);
  }

  acc_t acc[NT][4];
#pragma unroll
  for (int u = 0; u < NT; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0;

  const TcFetch<DEC, SBF16, NT> fetch(x, w, scales, g, row0, nrows, kb_lo, K, N, n0, vec);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_st) fetch.copy(ring + i * STAGE, i, x, w, scales);
    cp_async_commit();
  }
  if constexpr (EXACT) {
    cp_async_wait<STAGES - 2>();  // stage 0 landed
    __syncthreads();
    tc_split<NT>(smem);
  }
  for (int i = 0; i < n_st; ++i) {
    // stages i and i + 1 landed for every thread (stage i's parts are
    // split), and every warp is done with stage i - 1, whose slot takes
    // stage i + STAGES - 1
    cp_async_wait<STAGES - 3>();
    __syncthreads();
    if (i + STAGES - 1 < n_st)
      fetch.copy(ring + ((i + STAGES - 1) % STAGES) * STAGE, i + STAGES - 1, x, w, scales);
    cp_async_commit();
    const int slot = i % STAGES;
    const uint32_t st = ring + slot * STAGE;
    const unsigned char* stp = smem + slot * STAGE;

    if constexpr (!PAIRED) {  // D_BF16: the plane's bf16 values are the A operand
      uint32_t a[2][4];
      ldmatrix_x4_trans(a[0], st + a_off[0]);
      ldmatrix_x4_trans(a[1], st + a_off[1]);
#pragma unroll
      for (int u = 0; u < NT; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint2 xv = *reinterpret_cast<const uint2*>(stp + b_off[h] + u * 8 * T::B_ROW);
          mma_bf16_16816(acc[u], a[h], xv.x, xv.y);
        }
    } else {
      // r[m], bytes: (K row of 2tq, column 2gq), (same row, 2gq + 1), (K row
      // of 2tq + 1, 2gq), (same, 2gq + 1); K rows 4tq, 4tq + 1 (+ 2 for odd
      // m, + 16 for m >= 2)
      uint32_t r[4];
      ldmatrix_x4_trans(r, st + a_off[0]);
      if constexpr (DEC == T_A8) {
        // a register: four consecutive K rows of one column
        const uint32_t a[4] = {__byte_perm(r[0], r[1], 0x6420), __byte_perm(r[0], r[1], 0x7531),
                               __byte_perm(r[2], r[3], 0x6420), __byte_perm(r[2], r[3], 0x7531)};
#pragma unroll
        for (int u = 0; u < NT; ++u) {
          const uint32_t b0 =
              *reinterpret_cast<const uint32_t*>(stp + b_off[0] + u * 8 * T::B_ROW);
          const uint32_t b1 =
              *reinterpret_cast<const uint32_t*>(stp + b_off[1] + u * 8 * T::B_ROW);
          mma_s8_16832(acc[u], a, b0, b1);
        }
      } else {
        // the bf16 A operand of k16 step h: r[2h] holds k slots 2tq, 2tq + 1
        // (K 16h + 4tq, + 1), r[2h + 1] slots 2tq + 8, 2tq + 9 (K + 2, + 3)
        constexpr bool NIBBLE = T::QDEC && !Q80;
        uint32_t a[2][4];
        if constexpr (DEC == Q_F32 || DEC == T_A16) {  // the code alone
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int p = 0; p < 2; ++p)
              code_pairs<NIBBLE>(r[2 * h + p], a[h][2 * p], a[h][2 * p + 1]);
        } else {  // bf16(code * bf16 scale)
          uint32_t sa2 = ts_a, sb2 = ts_b;
          if constexpr (DEC == Q_BF16) {
            if constexpr (SBF16) {
              const uint32_t s2 =
                  *reinterpret_cast<const uint32_t*>(stp + T::W + 2 * (col_a - n0));
              sa2 = (s2 & 0xFFFFu) * 0x10001u;
              sb2 = (s2 >> 16) * 0x10001u;
            } else {
              const float2 s2 = *reinterpret_cast<const float2*>(stp + T::W + 4 * (col_a - n0));
              sa2 = (__float_as_uint(bf16_round(s2.x)) >> 16) * 0x10001u;
              sb2 = (__float_as_uint(bf16_round(s2.y)) >> 16) * 0x10001u;
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int p = 0; p < 2; ++p)
              weight_pairs<NIBBLE>(r[2 * h + p], sa2, sb2, a[h][2 * p], a[h][2 * p + 1]);
        }
        if constexpr (EXACT) {
          // the block's scales of columns col_a, col_b, applied once to the
          // block's sums (A rows gq: c[0], c[1]; gq + 8: c[2], c[3])
          const float2 s2 = *reinterpret_cast<const float2*>(stp + T::W + 4 * (col_a - n0));
#pragma unroll
          for (int u = 0; u < NT; ++u) {
            // one f32 sum a part (three independent mma chains), added in
            // part order
            float blk[3][4] = {};
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int q = 0; q < 3; ++q) {
                const uint2 pv = *reinterpret_cast<const uint2*>(
                    stp + b_off[h] + q * Ring::PART + u * 8 * T::B_ROW);
                mma_bf16_16816(blk[q], a[h], pv.x, pv.y);
              }
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[u][e] = fmaf(e < 2 ? s2.x : s2.y, (blk[0][e] + blk[1][e]) + blk[2][e],
                               acc[u][e]);
          }
        } else {
#pragma unroll
          for (int u = 0; u < NT; ++u)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint2 xv =
                  *reinterpret_cast<const uint2*>(stp + b_off[h] + u * 8 * T::B_ROW);
              mma_bf16_16816(acc[u], a[h], xv.x, xv.y);
            }
        }
      }
    }
    // exact: split stage i + 1 (landed) for the next iteration
    if constexpr (EXACT) {
      if (i + 1 < n_st) tc_split<NT>(smem + ((i + 1) % STAGES) * STAGE);
    }
  }
  cp_async_wait<0>();

  // c[e]: A row gq (e < 2) or gq + 8, slice row 8u + 2tq + e % 2
#pragma unroll
  for (int u = 0; u < NT; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 8 * u + 2 * tq + (e & 1), col = e < 2 ? col_a : col_b;
      if (row >= nrows || col >= N) continue;
      const size_t at = static_cast<size_t>(row0 + row) * N + col;
      if (part != nullptr)
        static_cast<acc_t*>(part)[at] = acc[u][e];
      else
        y[at] = epilogue<DEC>(acc[u][e], sx, scales, row0 + row, g, col, N);
    }
}

// The work item ``item`` of a call with offsets: the slices of every group
// (_row_slices), numbered group by group. Sets the item's group and first
// row; false past the last item. Every warp walks the offsets 128 groups at
// a time, 4 a lane (one round of loads for the 128 experts of a
// Qwen3-30B-A3B layer), with a warp scan of the lanes' slice counts, so the
// whole block agrees without a barrier.
__device__ __forceinline__ bool find_item(const int* __restrict__ offsets, int G, int item,
                                          int& g, int& first) {
  const int lane = threadIdx.x & 31;
  int before = 0;  // the items of the groups already walked
  for (int base = 0; base < G; base += 128) {
    const int g0 = base + 4 * lane;
    int o[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) o[j] = offsets[min(g0 + j, G)];
    int n[4], mine = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      n[j] = (o[j + 1] - o[j] + TC_ROWS - 1) / TC_ROWS;  // 0 past the last group
      mine += n[j];
    }
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += v;
    }
    const unsigned past = __ballot_sync(0xFFFFFFFFu, before + incl > item);
    if (past != 0) {
      const int src = __ffs(past) - 1;
      int at = item - before - (incl - mine), j_at = 0;  // the item within lane src's groups
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (at >= n[j] && j_at == j) {
          at -= n[j];
          j_at = j + 1;
        }
      j_at = __shfl_sync(0xFFFFFFFFu, j_at, src);
      at = __shfl_sync(0xFFFFFFFFu, at, src);
      g = base + 4 * src + j_at;
      first = offsets[g] + at * TC_ROWS;
      return true;
    }
    before += __shfl_sync(0xFFFFFFFFu, incl, 31);
  }
  return false;
}

// grid (ceil(N / 128), tc_items(R, G), splits): block y takes work item y,
// one slice of up to 64 rows of one group, so a group of many rows spreads
// over many blocks; with no offsets (the turbo linear) item y is slice y of
// the one group. Dynamic shared memory TC_SMEM.
template <int DEC, bool SBF16, bool Q80>
__global__ void __launch_bounds__(TC_THREADS, 2)
moe_tc_kernel(const void* __restrict__ x, const float* __restrict__ sx,
              const void* __restrict__ w, const void* __restrict__ scales,
              const int* __restrict__ offsets, float* __restrict__ y, void* __restrict__ part,
              int R, int K, int N, int G, int k_split) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  int g = 0, lo, hi;
  if (offsets != nullptr) {
    if (!find_item(offsets, G, blockIdx.y, g, lo)) return;
    hi = min(offsets[g + 1], lo + TC_ROWS);
  } else {
    lo = static_cast<int>(blockIdx.y) * TC_ROWS;
    hi = min(R, lo + TC_ROWS);
  }
  const int n0 = blockIdx.x * TC_BN;
  const int z = blockIdx.z;
  const int kb_lo = z * (k_split / TC_BK);
  const int kb_hi = min(K, (z + 1) * k_split) / TC_BK;
  // split z's raw sums: part[z][R][N]
  void* out = part == nullptr ? nullptr
      : static_cast<void*>(static_cast<char*>(part) + static_cast<size_t>(z) * R * N * 4);
  const bool vec = (N & 15) == 0;
  const auto* xb = static_cast<const unsigned char*>(x);
  const auto* wb = static_cast<const unsigned char*>(w);
  const auto* sb = static_cast<const unsigned char*>(scales);
  const int nrows = hi - lo;
  // the least number of n8 tiles that holds the slice (uniform across the block)
  if (nrows <= 8)
    tc_slice<DEC, SBF16, Q80, 1>(xb, sx, wb, sb, y, out, g, lo, nrows, kb_lo, kb_hi, K, N, n0,
                                 vec, tc_smem);
  else if (nrows <= 16)
    tc_slice<DEC, SBF16, Q80, 2>(xb, sx, wb, sb, y, out, g, lo, nrows, kb_lo, kb_hi, K, N, n0,
                                 vec, tc_smem);
  else if (nrows <= 32)
    tc_slice<DEC, SBF16, Q80, 4>(xb, sx, wb, sb, y, out, g, lo, nrows, kb_lo, kb_hi, K, N, n0,
                                 vec, tc_smem);
  else
    tc_slice<DEC, SBF16, Q80, 8>(xb, sx, wb, sb, y, out, g, lo, nrows, kb_lo, kb_hi, K, N, n0,
                                 vec, tc_smem);
}

// The K splits' raw sums added in split order, then the epilogue: one
// thread a row and 4 columns; a row's group is found in the offsets.
template <int DEC>
__global__ void __launch_bounds__(256)
moe_reduce_kernel(const void* __restrict__ part, const float* __restrict__ sx,
                  const void* __restrict__ scales, const int* __restrict__ offsets,
                  float* __restrict__ y, int R, int N, int G, int splits) {
  using acc_t = typename std::conditional<DEC == T_A8, int, float>::type;
  const int per_row = N / 4;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(R) * per_row) return;
  const int row = static_cast<int>(i / per_row), n = static_cast<int>(i % per_row) * 4;
  int g = 0;
  if (offsets != nullptr) {  // the last group whose first row is <= row
    int a = 0, b = G;
    while (b - a > 1) {
      const int m = (a + b) / 2;
      if (offsets[m] <= row) a = m; else b = m;
    }
    g = a;
  }
  acc_t sum[4] = {0, 0, 0, 0};
  const acc_t* p = static_cast<const acc_t*>(part);
  for (int z = 0; z < splits; ++z) {
    const size_t at = (static_cast<size_t>(z) * R + row) * N + n;
#pragma unroll
    for (int c = 0; c < 4; ++c) sum[c] += p[at + c];
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
    y[static_cast<size_t>(row) * N + n + c] = epilogue<DEC>(sum[c], sx, scales, row, g,
                                                             n + c, N);
}

template <int DEC>
cudaError_t reduce_splits(void* part, const float* sx, const void* scales, const int* offsets,
                          float* y, int R, int N, int G, int splits, cudaStream_t s) {
  const long long n_threads = static_cast<long long>(R) * (N / 4);
  moe_reduce_kernel<DEC><<<static_cast<unsigned>((n_threads + 255) / 256), 256, 0, s>>>(
      part, sx, scales, offsets, y, R, N, G, splits);
  return cudaGetLastError();
}

cudaError_t launch_simt(const void* x, const void* w, const int* offsets, float* y, void* part,
                        int R, int K, int N, int G, int splits, int k_split, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, G, splits);
  moe_matmul_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), offsets, y,
      splits > 1 ? static_cast<float*>(part) : nullptr, R, K, N, k_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return reduce_splits<D_F32>(part, nullptr, nullptr, offsets, y, R, N, G, splits, s);
}

// the tensor-core grid's rows: an upper bound on a call's work items
// (ops/moe_matmul.py::_tc_items): one group of at most R rows has ceil(R /
// 64) slices; else a non-empty group of r rows has ceil(r / 64) <= 1 + r /
// 64, and at most min(G, R) groups are non-empty
int tc_items(int R, int G) {
  return G == 1 ? (R + TC_ROWS - 1) / TC_ROWS : min(G, R) + R / TC_ROWS;
}

template <int DEC, bool SBF16, bool Q80>
cudaError_t launch_tc(const void* x, const float* sx, const void* w, const void* scales,
                      const int* offsets, float* y, void* part, int R, int K, int N, int G,
                      int splits, int k_split, cudaStream_t s) {
  auto kernel = &moe_tc_kernel<DEC, SBF16, Q80>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       TC_SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + TC_BN - 1) / TC_BN, tc_items(R, G), splits);
  kernel<<<grid, TC_THREADS, TC_SMEM, s>>>(x, sx, w, scales, offsets, y,
                                           splits > 1 ? part : nullptr, R, K, N, G, k_split);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return reduce_splits<DEC>(part, sx, scales, offsets, y, R, N, G, splits, s);
}

}  // namespace

extern "C" {

// K5 entry. x [R, K] (f32 for Q_F32 / D_F32, bf16 for Q_BF16 / D_BF16 /
// T_A16 / T_PRE, int8 for T_A8 with sx f32 [R]), w [G, K, N] (int8 codes,
// or f32 / bf16 dense planes), scales [G, K/32, N] (Q decoders; f32, or
// bf16 when scale_bf16, which Q_F32 refuses) or [G, N] f32 (turbo), offsets
// int32 [G + 1] on the device (null: one group of all R rows), y f32 [R,
// N]; part [splits, R, N] 4-byte scratch (unused when splits == 1), each
// split k_split K rows (a multiple of 256); q80: the Q decoders' codes are
// Q80's (any int8), else Q40's ([-8, 7]). K % 32 == 0, N % 4 == 0, every
// pointer 16-byte aligned. D_F32 takes the SIMT kernel, every other decoder
// the tensor cores (takes_tc).
int dlt_moe_matmul(const void* x, const void* sx, const void* w, const void* scales,
                   const void* offsets, void* y, void* part, int R, int K, int N, int G,
                   int splits, int k_split, int dec, int scale_bf16, int q80, void* stream) {
  if (R < 0 || K <= 0 || N <= 0 || G <= 0 || K % TC_BK != 0 || N % 4 != 0
      || (offsets == nullptr && G != 1) || splits < 1 || k_split <= 0 || k_split % KC != 0
      || static_cast<long long>(splits - 1) * k_split >= K
      || static_cast<long long>(splits) * k_split < K || (splits > 1 && part == nullptr)
      || (scale_bf16 && dec != Q_BF16) || (q80 != 0 && q80 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sxf = static_cast<const float*>(sx);
  const int* off = static_cast<const int*>(offsets);
  float* yf = static_cast<float*>(y);
  if (!takes_tc(dec)) return static_cast<int>(launch_simt(x, w, off, yf, part, R, K, N, G,
                                                          splits, k_split, s));
  cudaError_t e;
#define DLT_TC(D, B, Q) \
  launch_tc<D, B, Q>(x, sxf, w, scales, off, yf, part, R, K, N, G, splits, k_split, s)
  // the turbo planes' codes are any int8 (the Q80 path)
  switch (dec) {
    case Q_F32: e = q80 ? DLT_TC(Q_F32, false, true) : DLT_TC(Q_F32, false, false); break;
    case Q_BF16:
      if (scale_bf16)
        e = q80 ? DLT_TC(Q_BF16, true, true) : DLT_TC(Q_BF16, true, false);
      else
        e = q80 ? DLT_TC(Q_BF16, false, true) : DLT_TC(Q_BF16, false, false);
      break;
    case D_BF16: e = DLT_TC(D_BF16, false, true); break;
    case T_A8: e = DLT_TC(T_A8, false, true); break;
    case T_A16: e = DLT_TC(T_A16, false, true); break;
    case T_PRE: e = DLT_TC(T_PRE, false, true); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DLT_TC
  return static_cast<int>(e);
}

const char* dlt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
