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
//   no order, so each block owns one [BM, BN] output tile and walks the
//   whole K axis itself; there is no cross-block accumulation. BK = 32 is
//   exactly one Q40 block, so a K step needs a single scale row.
//   Bound on the H100: at prefill widths (M = 32..256) the work is
//   2*M*K*N operations on 1.125*K*N weight bytes, so exact mode (FP32 SIMT,
//   67 TFLOP/s peak) is bound by operations, and fast mode (bf16 tensor
//   cores via mma.sync/WMMA, 989 TFLOP/s) by operations at M >= ~256 and
//   by bytes below. Design against it: a 64x64 tile reuses each dequantized
//   weight 64 times from shared memory; exact mode computes a 4x4
//   micro-tile per thread, fast mode a 32x32 warp tile of 16x16x16 bf16
//   fragments with f32 accumulators. wgmma/TMA and nibble-packed planes are
//   left for later work.
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

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
// K1 exact: FP32 SIMT tile, 64x64 per block, 4x4 per thread
// --------------------------------------------------------------------------

constexpr int MT_BM = 64, MT_BN = 64, MT_BK = QB;

__global__ void __launch_bounds__(256)
q40_matmul_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ codes,
                      const float* __restrict__ scales, float* __restrict__ out,
                      int M, int K, int N) {
  __shared__ float As[MT_BK][MT_BM + 4];  // x tile, transposed: As[k][m]
  __shared__ float Bs[MT_BK][MT_BN + 4];  // dequantized weight tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * MT_BM, n0 = blockIdx.x * MT_BN;
  const bool vec_n = (N % 8) == 0;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // load coordinates: A = 64 rows x 32 k (8 floats / thread),
  //                   B = 32 k x 64 cols (8 codes / thread)
  const int a_row = tid / 4, a_k = (tid % 4) * 8;
  const int b_k = tid / 8, b_col = (tid % 8) * 8;

  for (int k0 = 0; k0 < K; k0 += MT_BK) {
    {
      const int m = m0 + a_row;
      float v[8];
      if (m < M) {
        const float4* src = reinterpret_cast<const float4*>(x + (size_t)m * K + k0 + a_k);
        float4 lo = src[0], hi = src[1];
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) As[a_k + i][a_row] = v[i];
    }
    {
      const int n = n0 + b_col;
      const int8_t* crow = codes + (size_t)(k0 + b_k) * N;
      const float* srow = scales + (size_t)(k0 / QB) * N;
      if (vec_n && n + 8 <= N) {
        uint2 raw = __ldg(reinterpret_cast<const uint2*>(crow + n));
        const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int i = 0; i < 8; ++i) Bs[b_k][b_col + i] = static_cast<float>(c[i]) * __ldg(srow + n + i);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          Bs[b_k][b_col + i] = (n + i < N) ? static_cast<float>(crow[n + i]) * srow[n + i] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < MT_BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// --------------------------------------------------------------------------
// K1 fast: bf16 tensor-core tile (WMMA 16x16x16 -> mma.sync), 64x64 per
// block, 4 warps of 32x32
// --------------------------------------------------------------------------

constexpr int WT_LDA = MT_BK + 8;   // bf16 elements; rows stay 32-byte aligned
constexpr int WT_LDB = MT_BN + 8;
constexpr int WT_LDC = MT_BN + 4;   // f32 epilogue staging

constexpr int WT_A_ELEMS = MT_BM * WT_LDA;
constexpr int WT_B_ELEMS = MT_BK * WT_LDB;
constexpr int WT_IN_BYTES = (WT_A_ELEMS + WT_B_ELEMS) * 2;
constexpr int WT_C_BYTES = MT_BM * WT_LDC * 4;
constexpr int WT_SMEM_BYTES = WT_IN_BYTES > WT_C_BYTES ? WT_IN_BYTES : WT_C_BYTES;

__global__ void __launch_bounds__(128)
q40_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ codes,
                       const __nv_bfloat16* __restrict__ scales, float* __restrict__ out,
                       int M, int K, int N) {
  using namespace nvcuda;
  // raw storage: the bf16 input tiles during the K loop, the f32 output
  // tile in the epilogue (WMMA wants 32-byte aligned tile pointers)
  __shared__ __align__(128) unsigned char smem[WT_SMEM_BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + WT_A_ELEMS;
  float* Cs = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // 2x2 warps, 32x32 each
  const int m0 = blockIdx.y * MT_BM, n0 = blockIdx.x * MT_BN;
  const bool vec_n = (N % 16) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // A: 64 rows x 32 k bf16 = 16 per thread; B: 32 k x 64 cols = 16 codes
  const int a_row = tid / 2, a_k = (tid % 2) * 16;
  const int b_k = tid / 4, b_col = (tid % 4) * 16;

  for (int k0 = 0; k0 < K; k0 += MT_BK) {
    {
      const int m = m0 + a_row;
      uint4 lo = make_uint4(0, 0, 0, 0), hi = make_uint4(0, 0, 0, 0);
      if (m < M) {
        const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)m * K + k0 + a_k);
        lo = src[0];
        hi = src[1];
      }
      uint4* dst = reinterpret_cast<uint4*>(&As[a_row * WT_LDA + a_k]);
      dst[0] = lo;
      dst[1] = hi;
    }
    {
      const int n = n0 + b_col;
      const int8_t* crow = codes + (size_t)(k0 + b_k) * N;
      const __nv_bfloat16* srow = scales + (size_t)(k0 / QB) * N;
      __nv_bfloat16* dst = &Bs[b_k * WT_LDB + b_col];
      if (vec_n && n + 16 <= N) {
        uint4 raw = __ldg(reinterpret_cast<const uint4*>(crow + n));
        const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          dst[i] = __float2bfloat16(static_cast<float>(c[i]) * __bfloat162float(srow[n + i]));
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          dst[i] = (n + i < N)
              ? __float2bfloat16(static_cast<float>(crow[n + i]) * __bfloat162float(srow[n + i]))
              : __float2bfloat16(0.f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < MT_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[(wm * 32 + i * 16) * WT_LDA + kk], WT_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[kk * WT_LDB + wn * 32 + j * 16], WT_LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  // epilogue: fragments -> shared (reusing the input tiles) -> masked store
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * WT_LDC + wn * 32 + j * 16],
                              acc[i][j], WT_LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < MT_BM * MT_BN; i += blockDim.x) {
    const int r = i / MT_BN, c = i % MT_BN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) out[(size_t)m * N + n] = Cs[r * WT_LDC + c];
  }
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

// K1 entry: same operands, any M; K % 32 == 0.
int dlt_q40_matmul(const void* x, const void* codes, const void* scales, void* y,
                   int M, int K, int N, int fast, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + MT_BN - 1) / MT_BN, (M + MT_BM - 1) / MT_BM);
  if (fast)
    q40_matmul_bf16_kernel<<<grid, 128, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes),
        static_cast<const __nv_bfloat16*>(scales), static_cast<float*>(y), M, K, N);
  else
    q40_matmul_f32_kernel<<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(codes),
        static_cast<const float*>(scales), static_cast<float*>(y), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

const char* dlt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
