// Causal GQA flash attention over the dense head-major KV cache for Hopper
// (sm_90a): kernel K3.
//
// Replaces dllama_tpu/ops/flash_attention.py::_kernel (stats=False), the
// Pallas kernel that streamed (S/bs) KV blocks through VMEM on a sequential
// grid axis, keeping the running max / sum / accumulator in scratch between
// grid steps. Here the KV loop lives inside the block, so the online-softmax
// state stays in registers for the whole walk.
//
// Layout (the JAX package's): queries fold the GQA group into rows,
// q_g [B, n_kv, TQ = T * kv_mul, D] f32; caches k/v [B, n_kv, S, D] in f32
// (or bf16 under bf16 compute); out [B, n_kv, TQ, D] f32. Query row r sits
// at absolute position pos[b] + r / kv_mul and sees cache slots
// s <= pos[b] + r / kv_mul; no mask tensor is built.
//
// Bound on the H100: bytes for decode (T = 1: each visible K/V row is read
// once and used for kv_mul query rows) and for short prefills; operations
// (FP32 SIMT, 67 TFLOP/s) for long prefills. Design against it: one block
// per (b, kv head, 16-row query tile), 4 warps of 4 query rows each, rows
// dealt round-robin (row r on warp r % 4) so that a decode tile of kv_mul
// = 4 rows keeps all four warps busy; K/V tiles of 32 rows are staged once
// in shared memory (converted to f32) with 16-byte loads, all issued before
// the first store, and used by all 16 rows of the tile; the walk stops at
// the newest position any row of the tile can see, so fully masked tiles
// are never loaded (the TPU kernel skipped their compute at
// flash_attention.py:71 but still streamed them). Within a warp, lane j
// scores key j of the tile (a padded shared-memory row, so the 32 lanes hit
// 32 banks), the softmax max and sum are warp shuffles, and lane l
// accumulates output columns l, l + 32, ....
//
// Decode at B = 1 occupies only n_kv blocks; splitting S across blocks
// (flash-decoding) is left for later work.
//
// Kernel K3s is the same kernel in its stats mode (STATS = true, entry
// dlt_flash_block_stats). It replaces the stats=True path of the same Pallas
// kernel (flash_attention.py::flash_block_stats), the block step of
// sequence-parallel attention (parallel/ring.py): the cache argument is one
// sequence shard covering absolute positions [kv_pos0, kv_pos0 + S), and the
// kernel returns the unnormalised accumulator with the running max m and sum
// l of every query row, all f32, for the caller's cross-block combine. A
// block that no row of a tile can see (q_pos0 + r / kv_mul < kv_pos0) loads
// nothing and leaves acc = 0, l = 0, m = -inf. Bound and design are K3's.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 16;     // query rows per block
constexpr int BS = 32;     // keys per tile (one per lane)
constexpr int WARPS = 4;
constexpr int ROWS_PER_WARP = BQ / WARPS;

// the KV_PER_LOAD cache elements of one 16-byte load, as f32
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

// grid (ceil(TQ / BQ), n_kv, B); block WARPS * 32 threads. Cache slot c
// holds absolute position kv_pos0 + c (0 for the whole cache, K3). With
// STATS, out receives the unnormalised accumulator and m_out / l_out
// [B, n_kv, TQ] the running max and sum of each row; without, out = acc / l.
template <typename KV, int D, bool STATS>
__global__ void __launch_bounds__(WARPS * 32)
flash_attention_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                       const KV* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       const int* __restrict__ pos, int pos_scalar, int kv_pos0,
                       int n_kv, int TQ, int S, int kv_mul, float scale) {
  constexpr int DC = D / 32;  // output columns per lane
  constexpr int KV_PER_LOAD = 16 / sizeof(KV);
  constexpr int N_LOADS = BS * D / KV_PER_LOAD / (WARPS * 32);  // per thread per tile
  static_assert(N_LOADS * KV_PER_LOAD * WARPS * 32 == BS * D, "tile load split");
  __shared__ float qs[BQ][D];
  __shared__ float ks[BS][D + 1];  // +1: lane j reads row j, conflict-free
  __shared__ float vs[BS][D];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = blockIdx.x * BQ;
  const int q_pos0 = pos != nullptr ? pos[b] : pos_scalar;
  const size_t head = (size_t)b * n_kv + h;
  const float* qh = q + head * TQ * D;
  const KV* kh = k + head * S * D;
  const KV* vh = v + head * S * D;

  const int rows_here = min(BQ, TQ - r0);
  for (int i = tid; i < BQ * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    qs[r][d] = r < rows_here ? qh[(size_t)(r0 + r) * D + d] : 0.f;
  }
  // newest local slot any row of this tile can see: the walk ends there. It
  // is negative when the whole block lies past every row (a mid-sequence
  // shard, K3s): then no tile is loaded (C division would round -1 / BS up
  // to 0 and walk one tile)
  const int last_key = min(S - 1, q_pos0 - kv_pos0 + (r0 + rows_here - 1) / kv_mul);
  const int n_tiles = last_key < 0 ? 0 : last_key / BS + 1;

  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], acc[ROWS_PER_WARP][DC];
  // newest visible local slot per row, at most S - 1 (negative: the row sees
  // nothing of this block, or is absent)
  int limit[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = i * WARPS + warp;
    m[i] = -INFINITY;
    l[i] = 0.f;
    limit[i] = r < rows_here ? min(S - 1, q_pos0 - kv_pos0 + (r0 + r) / kv_mul) : -1;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int s0 = t * BS;
    __syncthreads();  // previous tile fully consumed (and qs written)
    {
      uint4 kr[N_LOADS], vr[N_LOADS];
#pragma unroll
      for (int u = 0; u < N_LOADS; ++u) {
        const int e = (u * WARPS * 32 + tid) * KV_PER_LOAD;  // element in the tile
        const int j = e / D;
        const bool ok = s0 + j < S;
        const size_t off = (size_t)s0 * D + e;
        kr[u] = ok ? __ldg(reinterpret_cast<const uint4*>(kh + off)) : make_uint4(0, 0, 0, 0);
        vr[u] = ok ? __ldg(reinterpret_cast<const uint4*>(vh + off)) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < N_LOADS; ++u) {
        const int e = (u * WARPS * 32 + tid) * KV_PER_LOAD;
        const int j = e / D, d = e % D;
        float kf[KV_PER_LOAD], vf[KV_PER_LOAD];
        unpack16(kr[u], kh, kf);
        unpack16(vr[u], vh, vf);
#pragma unroll
        for (int c = 0; c < KV_PER_LOAD; ++c) {
          ks[j][d + c] = kf[c];
          vs[j][d + c] = vf[c];
        }
      }
    }
    __syncthreads();

    // scores of key (s0 + lane) against this warp's rows
    float sc[ROWS_PER_WARP];
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) sc[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = ks[lane][d];
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i)
        sc[i] = fmaf(qs[i * WARPS + warp][d], kd, sc[i]);
    }
    const int key = s0 + lane;
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      // warp-uniform: nothing visible yet (or absent row). This guard keeps
      // m_new finite below: expf(-inf - -inf) would be NaN
      if (limit[i] < s0) continue;
      const float s = key <= limit[i] ? sc[i] * scale : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(s));  // finite: key s0 <= limit
      const float p = expf(s - m_new);               // masked keys -> 0
      const float corr = expf(m[i] - m_new);         // first tile: exp(-inf) = 0
      l[i] = l[i] * corr + warp_sum(p);
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
#pragma unroll 8
      for (int j = 0; j < BS; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pj, vs[j][lane + 32 * c], acc[i][c]);
      }
      m[i] = m_new;
    }
  }

  float* oh = out + head * TQ * D;
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = i * WARPS + warp;
    if (r >= rows_here) continue;
    // stats: the unnormalised sum (a row that saw nothing keeps acc = 0,
    // l = 0, m = -inf); otherwise normalised here
    const float inv = STATS ? 1.f : (l[i] > 0.f ? 1.f / l[i] : 1.f);
#pragma unroll
    for (int c = 0; c < DC; ++c) oh[(size_t)(r0 + r) * D + lane + 32 * c] = acc[i][c] * inv;
    if (STATS && lane == 0) {
      m_out[head * TQ + r0 + r] = m[i];
      l_out[head * TQ + r0 + r] = l[i];
    }
  }
}

template <typename KV, bool STATS>
void launch(const float* q, const void* k, const void* v, float* out, float* m_out,
            float* l_out, const int* pos, int pos_scalar, int kv_pos0, int B, int n_kv,
            int TQ, int S, int D, int kv_mul, float scale, cudaStream_t stream) {
  dim3 grid((TQ + BQ - 1) / BQ, n_kv, B);
  const KV* kp = static_cast<const KV*>(k);
  const KV* vp = static_cast<const KV*>(v);
  if (D == 64)
    flash_attention_kernel<KV, 64, STATS><<<grid, WARPS * 32, 0, stream>>>(
        q, kp, vp, out, m_out, l_out, pos, pos_scalar, kv_pos0, n_kv, TQ, S, kv_mul, scale);
  else
    flash_attention_kernel<KV, 128, STATS><<<grid, WARPS * 32, 0, stream>>>(
        q, kp, vp, out, m_out, l_out, pos, pos_scalar, kv_pos0, n_kv, TQ, S, kv_mul, scale);
}

}  // namespace

extern "C" {

// q_g f32 [B, n_kv, TQ, D]; k/v [B, n_kv, S, D] f32 (kv_bf16 = 0) or bf16;
// out f32 [B, n_kv, TQ, D]; pos int32 [B] on the device, or null to use
// pos_scalar for every row. D in {64, 128}.
int dlt_flash_attention(const void* q, const void* k, const void* v, void* out,
                        const void* pos, int pos_scalar, int B, int n_kv, int TQ,
                        int S, int D, int kv_mul, float scale, int kv_bf16,
                        void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const int* pp = static_cast<const int*>(pos);
  float* op = static_cast<float*>(out);
  if (kv_bf16)
    launch<__nv_bfloat16, false>(qp, k, v, op, nullptr, nullptr, pp, pos_scalar, 0, B,
                                 n_kv, TQ, S, D, kv_mul, scale, s);
  else
    launch<float, false>(qp, k, v, op, nullptr, nullptr, pp, pos_scalar, 0, B, n_kv, TQ,
                         S, D, kv_mul, scale, s);
  return static_cast<int>(cudaGetLastError());
}

// K3s: the same arguments for one KV block k/v [B, n_kv, S, D] holding
// absolute positions [kv_pos0, kv_pos0 + S); acc f32 [B, n_kv, TQ, D] and
// m, l f32 [B, n_kv, TQ] receive the unnormalised block statistics.
int dlt_flash_block_stats(const void* q, const void* k, const void* v, void* acc,
                          void* m, void* l, const void* pos, int pos_scalar,
                          int kv_pos0, int B, int n_kv, int TQ, int S, int D,
                          int kv_mul, float scale, int kv_bf16, void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const int* pp = static_cast<const int*>(pos);
  float* ap = static_cast<float*>(acc);
  float* mp = static_cast<float*>(m);
  float* lp = static_cast<float*>(l);
  if (kv_bf16)
    launch<__nv_bfloat16, true>(qp, k, v, ap, mp, lp, pp, pos_scalar, kv_pos0, B, n_kv,
                                TQ, S, D, kv_mul, scale, s);
  else
    launch<float, true>(qp, k, v, ap, mp, lp, pp, pos_scalar, kv_pos0, B, n_kv, TQ, S, D,
                        kv_mul, scale, s);
  return static_cast<int>(cudaGetLastError());
}

const char* dlt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
