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
//   weight. Exact mode
//   (FP32 SIMT, 67 TFLOP/s) is bound by operations: a 64x64 tile per block,
//   each dequantized weight reused 64 times from shared memory, a 4x4
//   micro-tile per thread. Fast mode (bf16 tensor cores, 989 TFLOP/s) is
//   bound by the weight bytes up to M ~ 128, where the two bounds meet, so
//   its design streams every weight byte once and keeps the tensor cores
//   fed at the same time (q40_matmul_bf16_kernel):
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}
// a 2-D box of a tensor map (coordinates innermost first) -> shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma's shared-memory operand descriptor for the K-major 128-byte-swizzle
// layout TMA writes: rows of 128 bytes (64 k), 8-row atoms 1024 bytes apart
// (stride byte offset); a k16 step starts 32 bytes further into the rows.
__device__ __forceinline__ uint64_t x_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>(1) << 16)
       | (static_cast<uint64_t>(1024 >> 4) << 32)
       | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keep the compiler from moving accumulator accesses across the async ops
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D[64 x 64] += A[64 x 16] (registers) * B[16 x 64] (shared memory, K-major
// descriptor); f32 accumulators, scale-d = 1 (accumulate)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// D[64 x 128] += A[64 x 16] (registers) * B[16 x 128] (shared memory, K-major
// descriptor); f32 accumulators, scale-d = 1 (accumulate)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// cuTensorMapEncodeTiled, a libcuda function, looked up through the CUDA
// runtime (no -lcuda at build time)
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// a row-major [outer, inner] tensor of row pitch row_bytes, read in boxes of
// box_inner x box_outer elements; zeros past its edges
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t inner,
                uint64_t outer, uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer,
                CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// K1 entry: same operands, any M; K % 32 == 0. Fast mode also needs N % 16
// == 0 and takes the split-K scratch part f32 [splits, M, N] (unused when
// splits == 1); slab rows MP = 64 for M <= 64, else 128.
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
  dim3 grid((N + MT_BN - 1) / MT_BN, (M + MT_BM - 1) / MT_BM);
  q40_matmul_f32_kernel<<<grid, 256, 0, s>>>(
      static_cast<const float*>(x), c, static_cast<const float*>(scales),
      static_cast<float*>(y), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

const char* dlt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
