// Pieces shared by the attention kernels (K3/K3s in flash_attention.cu, K4
// in paged_attention.cu): widening a 16-byte load of the cache (f32, bf16
// or float8 e4m3, each exactly), warp reductions and pass 2 of split-S. Each source includes this header and
// compiles on its own (one shared library per source), so everything here
// has internal linkage.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <math.h>

namespace {

// the C entries' cache kinds (ops/flash_attention.py::CACHE_KINDS)
constexpr int CACHE_F32 = 0, CACHE_BF16 = 1, CACHE_E4M3 = 2;

// the elements of one 16-byte load of the cache (4 f32, 8 bf16 or 16 e4m3),
// as f32
__device__ __forceinline__ void unpack16(const uint4& raw, const float*, float* out) {
  out[0] = __uint_as_float(raw.x); out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z); out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(const uint4& raw, const __nv_bfloat16*, float* out) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);           // bf16 -> f32 is exact
    out[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// 16 e4m3 values: pairs through the f16x2 conversion (cvt.rn.f16x2.e4m3x2),
// then to f32; both steps are exact, and NaN stays NaN
__device__ __forceinline__ void unpack16(const uint4& raw, const __nv_fp8_e4m3*, float* out) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w[i] >> (16 * hh)), __NV_E4M3);
      const float2 f = __half22float2(__half2(h));
      out[4 * i + 2 * hh] = f.x;
      out[4 * i + 2 * hh + 1] = f.y;
    }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int COMBINE_WARPS = 4;  // rows per block of combine_splits_kernel

// Pass 2 of split-S: one warp per query row merges the n_splits partials
// (acc [n_splits, rows, D], m and l [n_splits, rows]) in split order. STATS
// writes the merged unnormalised (acc, M, L) (K3s); otherwise out = acc / L.
// A row with no visible key in any split: M = -inf, every weight e^(m_s - 0)
// = 0, so acc = 0 and L = 0 exactly, and the normalised out is 0. DM is the
// head-dim capacity (64 or 128), D <= DM the row length.
template <int DM, bool STATS>
__global__ void __launch_bounds__(COMBINE_WARPS * 32)
combine_splits_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_m,
                      const float* __restrict__ part_l, float* __restrict__ out,
                      float* __restrict__ m_out, float* __restrict__ l_out, int rows,
                      int n_splits, int D) {
  constexpr int DC = DM / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * COMBINE_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  float mx = -INFINITY;
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, part_m[(size_t)s * rows + row]);
  const float m_safe = mx == -INFINITY ? 0.f : mx;
  float L = 0.f, acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const size_t sr = (size_t)s * rows + row;
    const float w = expf(part_m[sr] - m_safe);  // -inf partial -> 0
    L = fmaf(part_l[sr], w, L);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (lane + 32 * c < D) acc[c] = fmaf(part_acc[sr * D + lane + 32 * c], w, acc[c]);
  }
  const float inv = STATS ? 1.f : (L > 0.f ? 1.f / L : 1.f);
#pragma unroll
  for (int c = 0; c < DC; ++c)
    if (lane + 32 * c < D) out[(size_t)row * D + lane + 32 * c] = acc[c] * inv;
  if (STATS && lane == 0) {
    m_out[row] = mx;
    l_out[row] = L;
  }
}

}  // namespace
