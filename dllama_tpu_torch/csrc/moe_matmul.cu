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
// Plane decoders (the template argument DEC, the C entry's dec):
//   Q_F32   Q40/Q80 block planes, codes int8 [G, K, N] and scales
//           [G, K/32, N] (f32 or bf16: SBF16): f32 dequant, f32 x (exact);
//   Q_BF16  the same planes, bf16 dequant bf16(code * bf16(scale)), bf16 x
//           (fast): the products are exact in f32;
//   D_F32, D_BF16  dense planes [G, K, N] of that dtype, x of that dtype;
//   T_A8    turbo a8: int8 x with a per-row f32 scale sx, int8 planes, int32
//           sums by __dp4a (exact), epilogue acc * sx[r] * scale[g, n];
//   T_A16   turbo a16: bf16 x times the int8 codes (exact in f32), f32 sums,
//           epilogue acc * scale[g, n];
//   T_PRE   turbo pre-scaled (the JAX ragged regime's dense rhs): the
//           weight bf16(bf16(w8) * bf16(scale)), bf16 x, f32 sums.
// Every sum is f32 (int32 for T_A8) over products that are exact where the
// JAX package's are, so only the order of the f32 sums differs from the
// plain version (ops/moe_matmul.py::moe_matmul_plain); T_A8 equals it bit
// for bit.
//
// Bound on the H100: bytes at decode and at the paged step (each routed
// expert's planes once: K * N bytes of codes plus the scales per expert
// per projection), FP32 operations at a 128-token chunk in exact mode.
// Design (a simple SIMT kernel; a wgmma / TMA design is later work):
//   * grid (N / 128, G): one block per (group, 128-column tile); an empty
//     group's blocks return at once, so each routed expert's plane tile is
//     read once per dispatch and the grid's shape never depends on the
//     routing (graph-safe);
//   * a block walks its group's rows in tiles of up to 16 (1, 2, 4, 8 or
//     16 rows, the least that holds what is left, so a decode row does no
//     wasted FMAs); 8 warps split K into 32-row slices (one Q40 block each,
//     so a slice loads its block scale once); each lane owns 4 neighbouring
//     columns, so a warp reads 128 contiguous code bytes of a K row;
//   * the tile's activations stream through shared memory 256 K rows at a
//     time and are read as 16-byte vectors (16 FMAs a load); the warps'
//     partial sums are added in shared memory in a fixed order, so results
//     do not change from run to run;
//   * when the blocks that can hold rows (N / 128 tiles times at most
//     min(R, G) groups) would leave SMs idle (a decode token's 8 experts,
//     the turbo linear's one group), the K axis is split across blocks
//     too (grid z, whole 256-row chunks a split, the plan in the Python
//     wrapper): each split writes its raw sums (int32 for T_A8) and a second
//     small kernel adds them in split order and applies the epilogue, so
//     T_A8 stays exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BN = 128;            // columns per block: 32 lanes x 4
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int SLICE = 32;          // K rows a warp takes per chunk (one Q40 block)
constexpr int KC = WARPS * SLICE;  // K rows per shared-memory chunk
constexpr int MAX_RT = 16;         // rows per tile
constexpr int RED_ROWS = 8;        // rows reduced per pass (shared memory: 32 KB)

enum Dec { Q_F32 = 0, Q_BF16 = 1, D_F32 = 2, D_BF16 = 3, T_A8 = 4, T_A16 = 5, T_PRE = 6 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// 32 bits of 4 int8 codes at rows k..k+3 of one column, byte i = row k + i
__device__ __forceinline__ void transpose4(int a, int b, int c, int d, int out[4]) {
  const int t0 = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const int t1 = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  const int t2 = __byte_perm(c, d, 0x5140);
  const int t3 = __byte_perm(c, d, 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// The four weights of one K row at columns n..n+3 of group g's plane, as
// floats, for the float decoders (codes: exact small integers).
template <int DEC>
__device__ __forceinline__ void load_w4(const void* w, size_t at, float out[4]) {
  if constexpr (DEC == D_F32) {
    const float4 v = *reinterpret_cast<const float4*>(static_cast<const float*>(w) + at);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (DEC == D_BF16) {
    const uint2 v = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(w) + at);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    out[0] = __low2float(lo); out[1] = __high2float(lo);
    out[2] = __low2float(hi); out[3] = __high2float(hi);
  } else {
    const char4 v = *reinterpret_cast<const char4*>(static_cast<const int8_t*>(w) + at);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
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

// One row tile of RT rows: rows [row0, row0 + nrows) of x and y, columns
// [n_tile, n_tile + BN), group g, K rows [k_lo, k_hi). With ``part``
// (a K split) the raw sums go to part[row][n] instead of the epilogue to y.
template <int DEC, bool SBF16, int RT>
__device__ void tile(const void* __restrict__ x, const float* __restrict__ sx,
                     const void* __restrict__ w, const void* __restrict__ scales,
                     float* __restrict__ y, void* __restrict__ part, int row0, int nrows,
                     int K, int N, int g, int n_tile, int k_lo, int k_hi,
                     unsigned char* smem) {
  using acc_t = typename std::conditional<DEC == T_A8, int, float>::type;
  constexpr bool QDEC = DEC == Q_F32 || DEC == Q_BF16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = n_tile + lane * 4;
  const bool col_ok = n < N;
  acc_t acc[RT][4];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;

  const size_t plane = static_cast<size_t>(g) * K * N;
  for (int kc = k_lo; kc < k_hi; kc += KC) {
    __syncthreads();  // the previous chunk (or tile) is done with smem
    if constexpr (DEC == T_A8) {
      // x int8 [R, K]: 4 K values a word, byte i = K row 4 * word + i
      int* xs = reinterpret_cast<int*>(smem);
      for (int i = threadIdx.x; i < RT * (KC / 4); i += THREADS) {
        const int r = i / (KC / 4), kk = (i % (KC / 4)) * 4;
        int v = 0;
        if (r < nrows && kc + kk < k_hi)
          v = *reinterpret_cast<const int*>(static_cast<const int8_t*>(x)
                                            + static_cast<size_t>(row0 + r) * K + kc + kk);
        xs[i] = v;
      }
    } else {
      float* xs = reinterpret_cast<float*>(smem);
      for (int i = threadIdx.x; i < RT * KC; i += THREADS) {
        const int r = i / KC, kk = i % KC;
        float v = 0.f;
        if (r < nrows && kc + kk < k_hi) {
          const size_t at = static_cast<size_t>(row0 + r) * K + kc + kk;
          if constexpr (DEC == Q_F32 || DEC == D_F32)
            v = static_cast<const float*>(x)[at];
          else
            v = bf16_at(static_cast<const __nv_bfloat16*>(x), at);
        }
        xs[i] = v;
      }
    }
    __syncthreads();
    const int k0 = kc + warp * SLICE;
    if (!col_ok || k0 >= k_hi) continue;  // K % 32 == 0: a slice is whole or absent
    float s[4] = {1.f, 1.f, 1.f, 1.f};
    if constexpr (QDEC) {
      const size_t at = (static_cast<size_t>(g) * (K / SLICE) + k0 / SLICE) * N + n;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[c] = SBF16 ? bf16_at(static_cast<const __nv_bfloat16*>(scales), at + c)
                     : static_cast<const float*>(scales)[at + c];
        if constexpr (DEC == Q_BF16) s[c] = bf16_round(s[c]);
      }
    } else if constexpr (DEC == T_PRE) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[c] = bf16_round(static_cast<const float*>(scales)[static_cast<size_t>(g) * N + n + c]);
    }
#pragma unroll 2
    for (int k4 = 0; k4 < SLICE; k4 += 4) {
      const int k = k0 + k4;
      if constexpr (DEC == T_A8) {
        int rows4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          rows4[j] = *reinterpret_cast<const int*>(static_cast<const int8_t*>(w) + plane
                                                   + static_cast<size_t>(k + j) * N + n);
        int cols[4];
        transpose4(rows4[0], rows4[1], rows4[2], rows4[3], cols);
        const int* xs = reinterpret_cast<const int*>(smem);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int xv = xs[r * (KC / 4) + (k - kc) / 4];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = __dp4a(xv, cols[c], acc[r][c]);
        }
      } else {
        float wv[4][4];  // [K row j][column c]
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          load_w4<DEC>(w, plane + static_cast<size_t>(k + j) * N + n, wv[j]);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if constexpr (QDEC) {
              wv[j][c] = wv[j][c] * s[c];
              if constexpr (DEC == Q_BF16) wv[j][c] = bf16_round(wv[j][c]);
            } else if constexpr (DEC == T_PRE) {
              wv[j][c] = bf16_round(wv[j][c] * s[c]);
            }
          }
        }
        const float4* xs = reinterpret_cast<const float4*>(smem);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float4 xv = xs[(r * KC + (k - kc)) / 4];
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
  }

  // the warps' partial sums, added in warp order, RED_ROWS rows a pass
  acc_t* red = reinterpret_cast<acc_t*>(smem);  // [WARPS][RED_ROWS][BN]
#pragma unroll
  for (int p = 0; p < RT; p += RED_ROWS) {
    constexpr int PR = RT < RED_ROWS ? RT : RED_ROWS;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < PR; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[(warp * RED_ROWS + r) * BN + lane * 4 + c] = acc[p + r][c];
    __syncthreads();
    for (int o = threadIdx.x; o < PR * BN; o += THREADS) {
      const int r = o / BN, col = o % BN;
      const int row = p + r, nn = n_tile + col;
      if (row >= nrows || nn >= N) continue;
      acc_t sum = 0;
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) sum += red[(wi * RED_ROWS + r) * BN + col];
      const size_t at = static_cast<size_t>(row0 + row) * N + nn;
      if (part != nullptr)
        static_cast<acc_t*>(part)[at] = sum;
      else
        y[at] = epilogue<DEC>(sum, sx, scales, row0 + row, g, nn, N);
    }
  }
}

template <int DEC, bool SBF16>
__global__ void __launch_bounds__(THREADS)
moe_matmul_kernel(const void* __restrict__ x, const float* __restrict__ sx,
                  const void* __restrict__ w, const void* __restrict__ scales,
                  const int* __restrict__ offsets, float* __restrict__ y,
                  void* __restrict__ part, int R, int K, int N, int k_split) {
  __shared__ __align__(16) unsigned char smem[WARPS * RED_ROWS * BN * 4];
  static_assert(MAX_RT * KC * 4 <= sizeof(smem), "x chunk must fit the reduction buffer");
  const int g = blockIdx.y;
  const int lo = offsets ? offsets[g] : 0;
  const int hi = offsets ? offsets[g + 1] : R;
  const int n_tile = blockIdx.x * BN;
  const int k_lo = blockIdx.z * k_split;
  const int k_hi = min(K, k_lo + k_split);
  // split z's raw sums: part[z][R][N]
  void* out = part == nullptr ? nullptr
      : static_cast<void*>(static_cast<char*>(part)
                           + static_cast<size_t>(blockIdx.z) * R * N * 4);
  for (int row0 = lo; row0 < hi; row0 += MAX_RT) {
    const int nrows = min(MAX_RT, hi - row0);
    // the least tile that holds the rows left (uniform across the block)
    if (nrows == 1)
      tile<DEC, SBF16, 1>(x, sx, w, scales, y, out, row0, nrows, K, N, g, n_tile, k_lo, k_hi,
                          smem);
    else if (nrows == 2)
      tile<DEC, SBF16, 2>(x, sx, w, scales, y, out, row0, nrows, K, N, g, n_tile, k_lo, k_hi,
                          smem);
    else if (nrows <= 4)
      tile<DEC, SBF16, 4>(x, sx, w, scales, y, out, row0, nrows, K, N, g, n_tile, k_lo, k_hi,
                          smem);
    else if (nrows <= 8)
      tile<DEC, SBF16, 8>(x, sx, w, scales, y, out, row0, nrows, K, N, g, n_tile, k_lo, k_hi,
                          smem);
    else
      tile<DEC, SBF16, 16>(x, sx, w, scales, y, out, row0, nrows, K, N, g, n_tile, k_lo,
                           k_hi, smem);
  }
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

template <int DEC, bool SBF16>
cudaError_t launch(const void* x, const float* sx, const void* w, const void* scales,
                   const int* offsets, float* y, void* part, int R, int K, int N, int G,
                   int splits, int k_split, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, G, splits);
  moe_matmul_kernel<DEC, SBF16><<<grid, THREADS, 0, s>>>(
      x, sx, w, scales, offsets, y, splits > 1 ? part : nullptr, R, K, N, k_split);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long n_threads = static_cast<long long>(R) * (N / 4);
  moe_reduce_kernel<DEC><<<static_cast<unsigned>((n_threads + 255) / 256), 256, 0, s>>>(
      part, sx, scales, offsets, y, R, N, G, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K5 entry. x [R, K] (f32 for Q_F32 / D_F32, bf16 for Q_BF16 / D_BF16 /
// T_A16 / T_PRE, int8 for T_A8 with sx f32 [R]), w [G, K, N] (int8 codes,
// or f32 / bf16 dense planes), scales [G, K/32, N] (Q decoders; f32, or
// bf16 when scale_bf16) or [G, N] f32 (turbo), offsets int32 [G + 1] on the
// device (null: one group of all R rows), y f32 [R, N]; part [splits, R, N]
// 4-byte scratch (unused when splits == 1), each split k_split K rows (a
// multiple of 256). K % 32 == 0, N % 4 == 0, every pointer 16-byte aligned.
int dlt_moe_matmul(const void* x, const void* sx, const void* w, const void* scales,
                   const void* offsets, void* y, void* part, int R, int K, int N, int G,
                   int splits, int k_split, int dec, int scale_bf16, void* stream) {
  if (R < 0 || K <= 0 || N <= 0 || G <= 0 || K % SLICE != 0 || N % 4 != 0
      || (offsets == nullptr && G != 1) || splits < 1 || k_split % KC != 0
      || static_cast<long long>(splits - 1) * k_split >= K
      || static_cast<long long>(splits) * k_split < K || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sxf = static_cast<const float*>(sx);
  const int* off = static_cast<const int*>(offsets);
  float* yf = static_cast<float*>(y);
  cudaError_t e;
#define DLT_LAUNCH(D, B) \
  launch<D, B>(x, sxf, w, scales, off, yf, part, R, K, N, G, splits, k_split, s)
  switch (dec) {
    case Q_F32: e = scale_bf16 ? DLT_LAUNCH(Q_F32, true) : DLT_LAUNCH(Q_F32, false); break;
    case Q_BF16: e = scale_bf16 ? DLT_LAUNCH(Q_BF16, true) : DLT_LAUNCH(Q_BF16, false); break;
    case D_F32: e = DLT_LAUNCH(D_F32, false); break;
    case D_BF16: e = DLT_LAUNCH(D_BF16, false); break;
    case T_A8: e = DLT_LAUNCH(T_A8, false); break;
    case T_A16: e = DLT_LAUNCH(T_A16, false); break;
    case T_PRE: e = DLT_LAUNCH(T_PRE, false); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DLT_LAUNCH
  return static_cast<int>(e);
}

const char* dlt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
