// Q40 dequantizing matmul for Hopper (sm_90a): kernels K1 and K2.
//
//   y[M, N] = x[M, K] @ (codes[K, N] * repeat(scales[K/32, N], 32 along K))
//
// The weight planes are the JAX package's K-major layout: int8 codes in
// [-8, 7] (one byte per weight) and one scale per 32-row block, f32 in
// exact mode and bf16 in fast mode. The dense weight never exists in device
// memory: codes are dequantized right after they are loaded.
//
// K1 (q40_matmul_*) replaces dllama_tpu/ops/quant_matmul.py::_kernel, the
//   (N/bn, K/bk) Pallas grid whose revisited f32 output tile carried the K
//   sum from one grid step to the next. Blocks here run in parallel and in
//   no order, so each block walks its K range itself; partial sums of a K
//   split are added in split order by a second small kernel.
//   Bound on the H100: at prefill widths (M = 32..256) the work is
//   2*M*K*N operations on 1.06 (bf16 scales) to 1.125 (f32) bytes per
//   weight. Exact mode (FP32 SIMT, 67 TFLOP/s) is bound by operations, so
//   its design keeps the FMA pipes fed (q40_matmul_f32_kernel): a 128 x 128
//   tile per block for a 128-row chunk (32 or 64 rows for narrower calls),
//   an 8 x 8 register micro-tile per thread read as 16-byte shared loads
//   (16 FMAs a load), two stages in flight (x by cp.async, the next Q40
//   block's codes in registers, dequantized without conversion
//   instructions), split-K for narrow N. No TF32: the plain version is f32
//   throughout. Fast mode (bf16 tensor cores, 989 TFLOP/s) is bound by the
//   weight bytes up to M ~ 128, where the two bounds meet, so its design
//   streams every weight byte once and keeps the tensor cores fed at the
//   same time (q40_matmul_bf16_kernel):
//   * one weight pass: a block owns 256 columns of N for all rows of the
//     call (slabs of 128 rows; a wider call's slabs are neighbouring blocks
//     and share the weight through L2);
//   * TMA loads: a 5-deep ring of 64-row stages (two Q40 blocks), each
//     filled by one thread with four tensor-map copies onto an mbarrier
//     (16-byte cp.async copies from every thread held an earlier version of
//     this tile far under the HBM rate on the load path alone);
//   * wgmma with the operands swapped, y^T = W^T x^T: the weight is the A
//     operand of m64 tiles, dequantized straight into the A fragment's
//     bf16x2 registers with K2's nibble and byte-permute trick (no int ->
//     float conversions, no round trip of the dense weight through shared
//     memory), the activations the B operand read by the tensor cores from
//     shared memory, K-major and 128-byte swizzled as TMA wrote them;
//   * split-K across blocks when the (N, M) tiles alone leave SMs idle
//     (wq/wk/wv/wo/w2 at 8B widths), the plan in the Python wrapper.
//   Nibble-packed planes (half the bytes) are left for later work.
//
// K2 (q40_gemv_*) replaces dllama_tpu/ops/quant_matmul.py::_decode_kernel,
//   the decode-shaped single pass over the weight planes for M <= 16.
//   Bound on the H100: bytes. One pass over 1.125 bytes per weight (int8
//   code + f32 scale every 32 rows) at 3.35 TB/s; the M <= 16 activation
//   rows ride along from L1/L2. Design against it: neighbouring threads own
//   neighbouring groups of 4 N columns, so a warp reads 128 contiguous code
//   bytes of a row per load; the 8 warps of a block split the K axis and
//   reduce in shared memory (in a fixed order, so results do not change
//   from run to run), and when N alone gives too few blocks (wk/wv: N =
//   1024) the K axis is split across blocks as well, with a second small
//   kernel summing the partial rows in a fixed order. Each warp loads the
//   codes of its next Q40 block into registers before it computes the
//   current one, so the loads stay in flight behind the arithmetic. The
//   dequant uses no int->float or f32->bf16 conversion instructions: those
//   run on a 16-per-clock-per-SM pipe, which at one byte per weight caps a
//   GEMV near the HBM rate in exact mode and below it in fast mode (two
//   conversions per weight), as the first version of this kernel measured.
//   A nibble trick and byte permutes build the values instead (see
//   codes_f32 / codes_bf16x2).
//
// Exact mode: f32 activations, f32 dequant (code * scale), f32 FMA.
// Fast mode: bf16 activations, dequant rounded to bf16 (the bf16 product
// code * scale, as the JAX package's fast path rounds it), products of two
// bf16 values are exact in f32, f32 accumulation.
//
// Every entry point returns cudaGetLastError() after its launches; the
// Python wrapper raises on a non-zero value. Nothing here allocates or
// synchronises: outputs and scratch come from the wrapper (torch.empty).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int QB = 32;  // Q40 block: rows of K sharing one scale

// --------------------------------------------------------------------------
// K2: decode GEMV
// --------------------------------------------------------------------------

constexpr int GEMV_WARPS = 8;
constexpr int GEMV_COLS = 4;                       // N columns per thread
constexpr int GEMV_BN = 32 * GEMV_COLS;            // N columns per block

__device__ __forceinline__ float load_act(const float* x, size_t i) { return __ldg(x + i); }
__device__ __forceinline__ float load_act(const __nv_bfloat16* x, size_t i) {
  return __bfloat162float(x[i]);
}

// The scales of a thread's 4 columns in one Q40 block: exact mode keeps 4
// f32 values, fast mode two bf16x2 pairs (columns 0-1 and 2-3).
struct ScalesF32 { float v[4]; };
struct ScalesBF16 { __nv_bfloat162 lo, hi; };

__device__ __forceinline__ void load_scales(const float* s, size_t i, ScalesF32& out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(s + i));
  out.v[0] = v.x; out.v[1] = v.y; out.v[2] = v.z; out.v[3] = v.w;
}
__device__ __forceinline__ void load_scales(const __nv_bfloat16* s, size_t i, ScalesBF16& out) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(s + i));
  out.lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  out.hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
}

// codes are int8 in [-8, 7], so per byte (code & 0xF) ^ 8 = code + 8 in
// [0, 15] (one LOP3 for four codes)
__device__ __forceinline__ unsigned biased_nibbles(int packed) {
  return (static_cast<unsigned>(packed) & 0x0F0F0F0Fu) ^ 0x08080808u;
}

// exact: code_j * scale_j in f32 (the plain version's rounding). Byte j of
// t under an f32 exponent of 2^23 is the float 2^23 + t_j; subtracting
// 2^23 + 8 leaves the code exactly.
__device__ __forceinline__ void dequant4(unsigned t, const ScalesF32& s, float w[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float code = __uint_as_float(__byte_perm(t, 0x4B000000u, 0x7440u + j)) - 8388616.0f;
    w[j] = code * s.v[j];
  }
}

// fast: the bf16 product code * scale, rounded to nearest even like the
// JAX package's and the plain version's bf16 dequant. Bytes under a bf16
// exponent of 2^7 are 128 + t exactly; subtracting 136 leaves the code.
__device__ __forceinline__ void dequant4(unsigned t, const ScalesBF16& s, float w[4]) {
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
  const unsigned p01 = __byte_perm(t, 0x43434343u, 0x5140u);
  const unsigned p23 = __byte_perm(t, 0x43434343u, 0x5342u);
  const __nv_bfloat162 c01 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&p01), bias);
  const __nv_bfloat162 c23 = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&p23), bias);
  const float2 w01 = __bfloat1622float2(__hmul2(c01, s.lo));
  const float2 w23 = __bfloat1622float2(__hmul2(c23, s.hi));
  w[0] = w01.x; w[1] = w01.y; w[2] = w23.x; w[3] = w23.y;
}

// grid (ceil(N / GEMV_BN), splits); block GEMV_WARPS * 32 threads.
// Split s covers Q40 blocks [s * kb_per_split, min((s+1) * kb_per_split, K/32));
// warp w of the block takes every GEMV_WARPS-th Q40 block of that range.
// out is [splits, M, N] f32 (the final [M, N] when splits == 1).
template <typename XT, typename ST, typename SC, int MM>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
q40_gemv_kernel(const XT* __restrict__ x, const int8_t* __restrict__ codes,
                const ST* __restrict__ scales, float* __restrict__ out,
                int M, int K, int N, int kb_per_split) {
  __shared__ float xs[GEMV_WARPS][MM][QB];
  __shared__ float red[MM][GEMV_BN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * GEMV_BN + lane * GEMV_COLS;
  const bool col_ok = n < N;  // N % 4 == 0, so a group is all-in or all-out
  const int nkb = K / QB;
  const int kb_lo = blockIdx.y * kb_per_split;
  const int kb_hi = min(nkb, kb_lo + kb_per_split);

  float acc[MM][GEMV_COLS];
#pragma unroll
  for (int m = 0; m < MM; ++m)
#pragma unroll
    for (int j = 0; j < GEMV_COLS; ++j) acc[m][j] = 0.f;

  // this thread's 4 code bytes of each of the 32 rows of a Q40 block
  int packed[QB];
  SC sc;
  auto load_block = [&](int kb) {
    const int8_t* base = codes + (size_t)kb * QB * N + n;
#pragma unroll
    for (int r = 0; r < QB; ++r)
      packed[r] = __ldg(reinterpret_cast<const int*>(base + (size_t)r * N));
    load_scales(scales, (size_t)kb * N + n, sc);
  };
  int kb = kb_lo + warp;
  if (col_ok && kb < kb_hi) load_block(kb);

  for (; kb < kb_hi; kb += GEMV_WARPS) {
    const int k0 = kb * QB;
    // this warp's 32 activation columns of every row, staged warp-private
#pragma unroll
    for (int m = 0; m < MM; ++m)
      xs[warp][m][lane] = (m < M) ? load_act(x, (size_t)m * K + k0 + lane) : 0.f;
    __syncwarp();
    if (col_ok) {
      // unpack this block, then put the next block's loads in flight
      unsigned t[QB];
#pragma unroll
      for (int r = 0; r < QB; ++r) t[r] = biased_nibbles(packed[r]);
      const SC cur = sc;
      if (kb + GEMV_WARPS < kb_hi) load_block(kb + GEMV_WARPS);
#pragma unroll
      for (int r = 0; r < QB; ++r) {
        float w[GEMV_COLS];
        dequant4(t[r], cur, w);
#pragma unroll
        for (int m = 0; m < MM; ++m) {
          const float xv = xs[warp][m][r];
#pragma unroll
          for (int j = 0; j < GEMV_COLS; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
        }
      }
    }
    __syncwarp();
  }

  // reduce the warps' partial sums in a fixed order (deterministic)
  for (int w = 0; w < GEMV_WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int m = 0; m < MM; ++m)
#pragma unroll
        for (int j = 0; j < GEMV_COLS; ++j) {
          float* cell = &red[m][lane * GEMV_COLS + j];
          *cell = (w == 0) ? acc[m][j] : *cell + acc[m][j];
        }
    }
    __syncthreads();
  }
  float* dst = out + (size_t)blockIdx.y * M * N;
  for (int i = threadIdx.x; i < M * GEMV_BN; i += blockDim.x) {
    const int m = i / GEMV_BN, c = i % GEMV_BN;
    const int col = blockIdx.x * GEMV_BN + c;
    if (col < N) dst[(size_t)m * N + col] = red[m][c];
  }
}

// y[m, n] = sum over splits of part[s, m, n], summed in split order
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ y,
                                  int splits, int MN) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[(size_t)s * MN + i];
  y[i] = acc;
}

template <typename XT, typename ST, typename SC>
int launch_gemv(const void* x, const int8_t* codes, const void* scales, float* y,
                float* part, int M, int K, int N, int splits, cudaStream_t stream) {
  const int nkb = K / QB;
  const int kb_per_split = (nkb + splits - 1) / splits;
  dim3 grid((N + GEMV_BN - 1) / GEMV_BN, splits);
  dim3 block(GEMV_WARPS * 32);
  float* dst = splits == 1 ? y : part;
  const XT* xp = static_cast<const XT*>(x);
  const ST* sp = static_cast<const ST*>(scales);
#define DLT_GEMV(MMV) \
  q40_gemv_kernel<XT, ST, SC, MMV><<<grid, block, 0, stream>>>(xp, codes, sp, dst, M, K, N, kb_per_split)
  if (M <= 1) DLT_GEMV(1);
  else if (M <= 2) DLT_GEMV(2);
  else if (M <= 4) DLT_GEMV(4);
  else if (M <= 8) DLT_GEMV(8);
  else DLT_GEMV(16);
#undef DLT_GEMV
  if (splits > 1) {
    const int MN = M * N;
    sum_splits_kernel<<<(MN + 255) / 256, 256, 0, stream>>>(part, y, splits, MN);
  }
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------------
// K1 exact: pipelined, register-blocked FP32 tile. A block owns XT_BN = 128
// weight columns and BM = 32, 64 or 128 activation rows (128 for a whole
// 128-token chunk) and walks its K range in stages of one Q40 block (32
// rows, one scale row). 256 threads as 16 x 16; thread (tm, tn) holds a
// (BM / 16) x 8 micro-tile: rows tm * RM + i and BM / 2 + tm * RM + i
// (RM = BM / 32), columns 4 tn + j and 64 + 4 tn + j, so that each
// quarter-warp reads one shared row (x) or 128 contiguous bytes (weights)
// per 16-byte load. Two stages in shared memory: while a stage's FMAs run,
// the next stage's x tile is in flight by 16-byte cp.async and the next
// stage's codes (16 bytes a thread) and scales sit in registers; after the
// FMAs they are dequantized with K2's conversion-free trick (dequant4: code
// * scale rounded in f32, the plain version's weights exactly) into the
// other stage's weight tile. Split z of a K split takes stages [z * per,
// min(n_stages, (z + 1) * per)) and writes its partial y to out + z * M * N.
// --------------------------------------------------------------------------

constexpr int XT_BK = QB;         // K rows per stage: one Q40 block
constexpr int XT_BN = 128;        // weight columns per block
constexpr int XT_THREADS = 2 * XT_BN;  // 16 x (XT_BN / 8) threads

template <int BM>
struct XtSmem {
  static constexpr int X = BM * XT_BK;        // floats: x tile [BM][XT_BK], rows as in x
  static constexpr int W = XT_BK * XT_BN;     // floats: dequantized weights [XT_BK][XT_BN]
  static constexpr int STAGE = X + W;
  static constexpr int BYTES = 2 * STAGE * 4;
};

template <int BM>
__global__ void __launch_bounds__(XT_THREADS)
q40_matmul_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ codes,
                      const float* __restrict__ scales, float* __restrict__ out,
                      int M, int K, int N, int st_per_split) {
  using S = XtSmem<BM>;
  constexpr int RM = BM / 32;  // rows per thread in each half of the tile
  extern __shared__ __align__(16) float xt_smem[];
  const int tid = threadIdx.x;
  const int tn = tid % (XT_BN / 8), tm = tid / (XT_BN / 8);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * XT_BN;
  const int n_stages = K / XT_BK;
  const int st_lo = blockIdx.z * st_per_split;
  const int st_hi = min(n_stages, st_lo + st_per_split);
  const bool vec = (N & 15) == 0;  // 16-byte rows of codes

  // x rows m0.. of a stage: BM x 8 chunks of 16 bytes; rows past M read as 0
  auto load_x = [&](int st, int buf) {
    float* xs = xt_smem + buf * S::STAGE;
#pragma unroll
    for (int i = 0; i < BM * 8 / XT_THREADS; ++i) {
      const int c = i * XT_THREADS + tid;
      const int r = c >> 3, kc = (c & 7) * 4;
      const int m = m0 + r;
      cp_async16(smem_addr(xs + r * XT_BK + kc),
                 x + (size_t)min(m, M - 1) * K + st * XT_BK + kc, m < M ? 16 : 0);
    }
    cp_async_commit();
  };

  // this thread's 16 codes of one K row (row wr of the stage, columns wc..)
  // and their 16 scales; columns past N hold code 0 and scale 0
  const int wr = tid / (XT_BN / 16), wc = tid % (XT_BN / 16) * 16;
  uint32_t craw[4];
  float sc[16];
  auto load_w = [&](int st) {
    const int n = n0 + wc;
    const size_t row = (size_t)(st * XT_BK + wr) * N;
    if (vec && n < N) {
      const uint4 c = __ldg(reinterpret_cast<const uint4*>(codes + row + n));
      craw[0] = c.x; craw[1] = c.y; craw[2] = c.z; craw[3] = c.w;
      const float4* s4 = reinterpret_cast<const float4*>(scales + (size_t)st * N + n);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 s = __ldg(s4 + j);
        sc[4 * j] = s.x; sc[4 * j + 1] = s.y; sc[4 * j + 2] = s.z; sc[4 * j + 3] = s.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) craw[j] = 0u;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const bool ok = n + j < N;
        craw[j / 4] |= (ok ? static_cast<uint32_t>(static_cast<uint8_t>(codes[row + n + j]))
                           : 0u) << (8 * (j % 4));
        sc[j] = ok ? __ldg(scales + (size_t)st * N + n + j) : 0.f;
      }
    }
  };
  auto store_w = [&](int buf) {
    float* ws = xt_smem + buf * S::STAGE + S::X + wr * XT_BN + wc;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const ScalesF32 s = {{sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3]}};
      float w[4];
      dequant4(biased_nibbles(static_cast<int>(craw[j])), s, w);
      *reinterpret_cast<float4*>(ws + 4 * j) = make_float4(w[0], w[1], w[2], w[3]);
    }
  };

  float acc[2 * RM][8];
#pragma unroll
  for (int i = 0; i < 2 * RM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto compute = [&](int buf) {
    const float* xs = xt_smem + buf * S::STAGE;
    const float* ws = xs + S::X;
#pragma unroll
    for (int kq = 0; kq < XT_BK; kq += 4) {
      float a[2 * RM][4];
#pragma unroll
      for (int i = 0; i < 2 * RM; ++i) {
        const int r = i < RM ? tm * RM + i : BM / 2 + tm * RM + (i - RM);
        const float4 v = *reinterpret_cast<const float4*>(xs + r * XT_BK + kq);
        a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* wrow = ws + (kq + kk) * XT_BN + 4 * tn;
        const float4 b0 = *reinterpret_cast<const float4*>(wrow);
        const float4 b1 = *reinterpret_cast<const float4*>(wrow + XT_BN / 2);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 2 * RM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);
      }
    }
  };

  if (st_lo < st_hi) {
    load_x(st_lo, 0);
    load_w(st_lo);
    store_w(0);
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int st = st_lo; st < st_hi; ++st) {
    // stage st is in buffer buf; every thread is done with the other buffer
    // (the barrier that ended the previous iteration)
    const int buf = (st - st_lo) & 1;
    const bool next = st + 1 < st_hi;
    if (next) {
      load_x(st + 1, buf ^ 1);
      load_w(st + 1);
    }
    compute(buf);
    if (next) store_w(buf ^ 1);
    cp_async_wait<0>();
    __syncthreads();
  }

  float* dst = out + (size_t)blockIdx.z * M * N;
  const bool vec4 = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < 2 * RM; ++i) {
    const int m = m0 + (i < RM ? tm * RM + i : BM / 2 + tm * RM + (i - RM));
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + XT_BN / 2 * h + 4 * tn;
      float* p = dst + (size_t)m * N + n;
      if (vec4 && n + 4 <= N) {
        *reinterpret_cast<float4*>(p) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) p[j] = acc[i][4 * h + j];
      }
    }
  }
}

template <int BM>
int launch_matmul_f32(const float* x, const int8_t* codes, const float* scales, float* y,
                      float* part, int M, int K, int N, int splits, cudaStream_t stream) {
  auto kernel = q40_matmul_f32_kernel<BM>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       XtSmem<BM>::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_stages = K / XT_BK;
  const int per = (n_stages + splits - 1) / splits;
  dim3 grid((N + XT_BN - 1) / XT_BN, (M + BM - 1) / BM, splits);
  kernel<<<grid, XT_THREADS, XtSmem<BM>::BYTES, stream>>>(x, codes, scales,
                                                          splits == 1 ? y : part, M, K, N, per);
  if (splits > 1) {
    const int MN = M * N;
    sum_splits_kernel<<<(MN + 255) / 256, 256, 0, stream>>>(part, y, splits, MN);
  }
  return static_cast<int>(cudaGetLastError());
}

// --------------------------------------------------------------------------
// K1 fast: pipelined tensor-core tile. A block owns FT_BN = 256 weight
// columns and a slab of up to MP activation rows, walking its K range in
// FT_BK = 64-row stages (two Q40 blocks) through a FT_STAGES-deep ring in
// shared memory that TMA fills: one thread starts a stage as four tensor
// copies (the activation tile, two 128-column halves of the code tile, the
// scale rows) completing on the stage's mbarrier. Two consumer warpgroups
// each own 128 columns as two m64 tiles of a swapped product,
// y^T[n, m] = W^T[n, k] x^T[k, m]: the dequantized weight is wgmma's A
// operand, built in registers, and the activations its B operand, K-major in
// shared memory (x's own layout) in the 128-byte swizzle.
// --------------------------------------------------------------------------

constexpr int FT_BN = 256;        // weight columns per block
constexpr int FT_BK = 64;         // K rows per stage: two Q40 blocks
constexpr int FT_STAGES = 5;      // ring depth; FT_STAGES - 2 stages in flight
constexpr int FT_THREADS = 256;   // two warpgroups

template <int MP>
struct FtSmem {
  static constexpr int X = MP * FT_BK * 2;          // MP rows of 128 bytes, swizzled
  static constexpr int CODES = FT_BK * FT_BN;       // two halves of 64 rows x 128 bytes
  static constexpr int SCALES = (FT_BK / QB) * FT_BN * 2;
  static constexpr int STAGE = X + CODES + SCALES;  // what TMA writes per stage
  // + the mbarriers, + slack to align the ring to 1024 bytes
  static constexpr int TOTAL = STAGE * FT_STAGES + FT_STAGES * 8 + 1024;
  static_assert(STAGE % 1024 == 0, "stage buffers must keep 1024-byte swizzle atoms");
};

template <int MP>
__device__ __forceinline__ void wgmma_tile(float (&d)[MP / 2], const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (MP == 64) wgmma_m64n64k16(d, a, desc);
  else wgmma_m64n128k16(d, a, desc);
}

// (128 + nibble) as bf16 pairs -> code * scale rounded to bf16 (RNE), the
// plain version's bf16 dequant: 128 + t - 136 is the code exactly, and the
// product of two bf16 values is rounded once
__device__ __forceinline__ uint32_t dequant_pair(uint32_t biased128, uint32_t scale2) {
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
  const __nv_bfloat162 c = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased128), bias);
  const __nv_bfloat162 w = __hmul2(c, *reinterpret_cast<const __nv_bfloat162*>(&scale2));
  return *reinterpret_cast<const uint32_t*>(&w);
}

// grid (ceil(M / MP), ceil(N / FT_BN), splits); block FT_THREADS threads;
// dynamic shared memory FtSmem<MP>::TOTAL. Tensor maps: tm_x over x [M, K]
// (box 64 x MP, 128-byte swizzle), tm_c over codes [K, N] (box 128 x 64,
// 128-byte swizzle), tm_s over scales [K/32, N] (box 256 x 2); TMA fills
// zeros past M, N and K. Split z takes stages [z * st_per_split,
// min(n_stages, (z + 1) * st_per_split)) of K and writes its partial y to
// out + z * M * N (the final y when there is one split).
//
// Thread roles in the product: warpgroup wg, warp w (of 4), lane = 4 g + t.
// In both m64 tiles j of its warpgroup the thread holds A rows 16 w + g and
// 16 w + g + 8, which stand for the 4 adjacent weight columns n_t + 2 j + h
// (n_t = n0 + 128 wg + 32 w + 4 g, h = 0 for row g, 1 for row g + 8): one
// 32-bit load of a code row gives all four, and the epilogue writes them as
// one float4. Its k values in a 16-deep step are 2t, 2t + 1, 2t + 8, 2t + 9.
template <int MP>
__global__ void __launch_bounds__(FT_THREADS, 1)
q40_matmul_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_c,
                       const __grid_constant__ CUtensorMap tm_s, float* __restrict__ out,
                       int M, int K, int N, int st_per_split) {
  using S = FtSmem<MP>;
  extern __shared__ unsigned char ft_smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int warp = tid >> 5, wg = warp >> 2, w = warp & 3;
  const int m0 = blockIdx.x * MP, n0 = blockIdx.y * FT_BN;
  const int n_stages = (K + FT_BK - 1) / FT_BK;
  const int st_lo = blockIdx.z * st_per_split;
  const int st_hi = min(n_stages, st_lo + st_per_split);
  // the ring, 1024-byte aligned for the swizzle atoms; its mbarriers after it
  const uint32_t raw0 = smem_addr(ft_smem);
  const uint32_t ring0 = (raw0 + 1023) & ~1023u;
  unsigned char* ring = ft_smem + (ring0 - raw0);
  const uint32_t bar0 = ring0 + S::STAGE * FT_STAGES;

  if (tid == 0) {
    for (int i = 0; i < FT_STAGES; ++i) mbar_init(bar0 + 8 * i);
    mbar_init_fence();
  }
  __syncthreads();

  // thread 0 starts a stage's four tensor copies onto its slot's mbarrier
  auto load_stage = [&](int st) {
    if (tid != 0 || st >= st_hi) return;
    const int slot = (st - st_lo) % FT_STAGES;
    const uint32_t base = ring0 + slot * S::STAGE, bar = bar0 + 8 * slot;
    const int k0 = st * FT_BK;
    mbar_expect_tx(bar, S::STAGE);
    tma_load_2d(base, &tm_x, bar, k0, m0);
    tma_load_2d(base + S::X, &tm_c, bar, n0, k0);
    tma_load_2d(base + S::X + S::CODES / 2, &tm_c, bar, n0 + FT_BN / 2, k0);
    tma_load_2d(base + S::X + S::CODES, &tm_s, bar, n0, k0 / QB);
  };

  float acc[2][MP / 2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < MP / 2; ++i) acc[j][i] = 0.f;
  uint32_t afrag[2][2][4];  // [buffer][tile][register]: a k16 step's A fragments

  // this thread's 4 columns: in code half wg, 32 w + 4 g bytes into a row,
  // which the swizzle puts in 16-byte chunk (2 w + g / 4) ^ (row % 8)
  const int chunk = 2 * w + (g >> 2), in_chunk = 4 * (g & 3);
  const int col = 128 * wg + 32 * w + 4 * g;
#pragma unroll
  for (int i = 0; i < FT_STAGES - 2; ++i) load_stage(st_lo + i);

  for (int st = st_lo; st < st_hi; ++st) {
    // every warp is done with stage st - 1, and every wgmma of stage st - 2
    // retired (each warpgroup waited for it during stage st - 1): its slot
    // takes stage st + FT_STAGES - 2
    __syncthreads();
    load_stage(st + FT_STAGES - 2);
    const int slot = (st - st_lo) % FT_STAGES;
    mbar_wait(bar0 + 8 * slot, ((st - st_lo) / FT_STAGES) & 1);

    const uint32_t xs = ring0 + slot * S::STAGE;
    const unsigned char* cs = ring + slot * S::STAGE + S::X + wg * (S::CODES / 2) + in_chunk;
    const unsigned char* ss = ring + slot * S::STAGE + S::X + S::CODES + col * 2;
#pragma unroll
    for (int q = 0; q < FT_BK / QB; ++q) {
      // the 4 columns' scales of this Q40 block, each doubled to a bf16 pair
      const uint2 sw = *reinterpret_cast<const uint2*>(ss + q * FT_BN * 2);
      const uint32_t s2[4] = {__byte_perm(sw.x, 0, 0x1010), __byte_perm(sw.x, 0, 0x3232),
                              __byte_perm(sw.y, 0, 0x1010), __byte_perm(sw.y, 0, 0x3232)};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kk = q * 2 + half;  // k16 step in the stage
        const int buf = kk & 1;
        // rows kr, kr + 1, kr + 8, kr + 9 (kr + 8 has kr's swizzle)
        const int kr = kk * 16 + 2 * t;
        const int c0 = (chunk ^ (kr & 7)) * 16, c1 = (chunk ^ ((kr + 1) & 7)) * 16;
        const uint32_t rA = *reinterpret_cast<const uint32_t*>(cs + kr * 128 + c0);
        const uint32_t rB = *reinterpret_cast<const uint32_t*>(cs + (kr + 1) * 128 + c1);
        const uint32_t rC = *reinterpret_cast<const uint32_t*>(cs + (kr + 8) * 128 + c0);
        const uint32_t rD = *reinterpret_cast<const uint32_t*>(cs + (kr + 9) * 128 + c1);
        // (column, k-pair) bytes, then code + 8 in [0, 15] per byte
        const uint32_t p01 = biased_nibbles(__byte_perm(rA, rB, 0x5140));  // cols 0, 1; k 2t..
        const uint32_t p23 = biased_nibbles(__byte_perm(rA, rB, 0x7362));  // cols 2, 3
        const uint32_t q01 = biased_nibbles(__byte_perm(rC, rD, 0x5140));  // cols 0, 1; k 2t+8..
        const uint32_t q23 = biased_nibbles(__byte_perm(rC, rD, 0x7362));
        wgmma_wait<1>();  // the wgmmas that read afrag[buf] retired
        afrag[buf][0][0] = dequant_pair(__byte_perm(p01, 0x43434343u, 0x5140u), s2[0]);
        afrag[buf][0][1] = dequant_pair(__byte_perm(p01, 0x43434343u, 0x5342u), s2[1]);
        afrag[buf][0][2] = dequant_pair(__byte_perm(q01, 0x43434343u, 0x5140u), s2[0]);
        afrag[buf][0][3] = dequant_pair(__byte_perm(q01, 0x43434343u, 0x5342u), s2[1]);
        afrag[buf][1][0] = dequant_pair(__byte_perm(p23, 0x43434343u, 0x5140u), s2[2]);
        afrag[buf][1][1] = dequant_pair(__byte_perm(p23, 0x43434343u, 0x5342u), s2[3]);
        afrag[buf][1][2] = dequant_pair(__byte_perm(q23, 0x43434343u, 0x5140u), s2[2]);
        afrag[buf][1][3] = dequant_pair(__byte_perm(q23, 0x43434343u, 0x5342u), s2[3]);
        const uint64_t desc = x_desc(xs + kk * 32);
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        wgmma_fence();
        wgmma_tile<MP>(acc[0], afrag[buf][0], desc);
        wgmma_tile<MP>(acc[1], afrag[buf][1], desc);
        wgmma_commit();
        fence_regs(acc[0]);
        fence_regs(acc[1]);
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc[0]);
  fence_regs(acc[1]);

  // epilogue: acc[j][4 i + e] is (column n_t + 2 j + e / 2, row m0 + 8 i + 2 t
  // + e % 2), so each row gets its 4 columns as one float4
  const int n = n0 + col;
  if (n >= N) return;  // N % 16 == 0: the 4 columns are all in or all out
  float* dst = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < MP / 8; ++i) {
    const int m = m0 + 8 * i + 2 * t;
    if (m < M)
      *reinterpret_cast<float4*>(dst + (size_t)m * N + n) =
          make_float4(acc[0][4 * i], acc[0][4 * i + 2], acc[1][4 * i], acc[1][4 * i + 2]);
    if (m + 1 < M)
      *reinterpret_cast<float4*>(dst + (size_t)(m + 1) * N + n) =
          make_float4(acc[0][4 * i + 1], acc[0][4 * i + 3], acc[1][4 * i + 1],
                      acc[1][4 * i + 3]);
  }
}

template <int MP>
int launch_matmul_bf16(const __nv_bfloat16* x, const int8_t* codes, const __nv_bfloat16* scales,
                       float* y, float* part, int M, int K, int N, int splits,
                       cudaStream_t stream) {
  CUtensorMap tm_x, tm_c, tm_s;
  if (!tensor_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (uint64_t)K * 2, FT_BK,
                  MP, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tm_c, CU_TENSOR_MAP_DATA_TYPE_UINT8, codes, N, K, N, FT_BN / 2, FT_BK,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tm_s, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, scales, N, K / QB, (uint64_t)N * 2,
                  FT_BN, FT_BK / QB, CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorNotSupported);
  auto kernel = q40_matmul_bf16_kernel<MP>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       FtSmem<MP>::TOTAL);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_stages = (K + FT_BK - 1) / FT_BK;
  const int per = (n_stages + splits - 1) / splits;
  dim3 grid((M + MP - 1) / MP, (N + FT_BN - 1) / FT_BN, splits);
  kernel<<<grid, FT_THREADS, FtSmem<MP>::TOTAL, stream>>>(tm_x, tm_c, tm_s,
                                                          splits == 1 ? y : part, M, K, N, per);
  if (splits > 1) {
    const int MN = M * N;
    sum_splits_kernel<<<(MN + 255) / 256, 256, 0, stream>>>(part, y, splits, MN);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K2 entry: x [M, K] (f32 exact / bf16 fast), codes int8 [K, N], scales
// [K/32, N] (f32 exact / bf16 fast), y f32 [M, N]; part f32 [splits, M, N]
// scratch (unused when splits == 1). M <= 16, K % 32 == 0, N % 4 == 0.
int dlt_q40_gemv(const void* x, const void* codes, const void* scales, void* y,
                 void* part, int M, int K, int N, int splits, int fast, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* c = static_cast<const int8_t*>(codes);
  if (fast)
    return launch_gemv<__nv_bfloat16, __nv_bfloat16, ScalesBF16>(
        x, c, scales, static_cast<float*>(y), static_cast<float*>(part), M, K, N, splits, s);
  return launch_gemv<float, float, ScalesF32>(
      x, c, scales, static_cast<float*>(y), static_cast<float*>(part), M, K, N, splits, s);
}

// K1 entry: same operands, any M; K % 32 == 0. Both modes take the split-K
// scratch part f32 [splits, M, N] (unused when splits == 1). Fast mode also
// needs N % 16 == 0; slab rows MP = 64 for M <= 64, else 128. Exact mode's
// tile has BM = 32, 64 or 128 rows (the least that holds M, up to 128).
int dlt_q40_matmul(const void* x, const void* codes, const void* scales, void* y, void* part,
                   int M, int K, int N, int splits, int fast, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* c = static_cast<const int8_t*>(codes);
  if (fast) {
    if (N % 16 != 0 || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    const __nv_bfloat16* sp = static_cast<const __nv_bfloat16*>(scales);
    float* yp = static_cast<float*>(y);
    float* pp = static_cast<float*>(part);
    return M <= 64 ? launch_matmul_bf16<64>(xp, c, sp, yp, pp, M, K, N, splits, s)
                   : launch_matmul_bf16<128>(xp, c, sp, yp, pp, M, K, N, splits, s);
  }
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  const float* sp = static_cast<const float*>(scales);
  float* yp = static_cast<float*>(y);
  float* pp = static_cast<float*>(part);
  return M <= 32   ? launch_matmul_f32<32>(xp, c, sp, yp, pp, M, K, N, splits, s)
         : M <= 64 ? launch_matmul_f32<64>(xp, c, sp, yp, pp, M, K, N, splits, s)
                   : launch_matmul_f32<128>(xp, c, sp, yp, pp, M, K, N, splits, s);
}

const char* dlt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
