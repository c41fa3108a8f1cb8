// Causal GQA attention over the paged KV block pool for Hopper (sm_90a):
// kernel K4.
//
// Replaces dllama_tpu/ops/paged_attention.py::_kernel, the Pallas kernel
// whose grid step (b, h, m) DMAs physical block tables[b, m] into VMEM,
// assembles the row's whole logical cache there and runs one softmax at
// the last step (so that it is bit-identical to the gather + oracle). Here
// the walk over the block table lives inside the block, with an online
// softmax whose running max / sum / accumulator stay in registers.
//
// Layout (the JAX package's): queries fold the GQA group into rows,
// q_g [B, n_kv, TQ = T * kv_mul, D] f32; this layer's pools
// k/v [n_blocks, n_kv, bs, D] in f32 or bf16; tables [B, M] int32 of
// physical block ids (0 = the null block); pos [B] int32, the position of
// each row's first query token; out [B, n_kv, TQ, D] f32. Query row r sees
// logical columns s <= pos[b] + r / kv_mul; null entries and partial tail
// blocks are masked by that position rule alone.
//
// Bound on the H100: bytes (each visible K/V row is read once and used for
// kv_mul query rows at decode). Design against it: one block per
// (b, kv head, 16-row query tile), 4 warps of 4 query rows each, rows
// dealt round-robin so that a decode tile of kv_mul = 4 rows keeps all four
// warps busy. For each tile of 32 logical keys one lane per key reads
// tables[b, s / bs] and records its row's offset in the pool (a block's
// [bs, D] tile is contiguous for one head, so a row is D contiguous
// elements); then all threads load the 32 rows with 16-byte loads, issued
// before the first shared-memory store, converted to f32. The walk stops at
// the newest position any row of the tile can see, capped at M * bs - 1,
// so unallocated tail entries and the null entries behind an inactive
// row's stale position are never loaded. Keys past that point are zero in
// shared memory (finite), and masked. Within a warp lane j scores key j of
// the tile (a padded shared row: the 32 lanes hit 32 banks), max and sum
// are warp shuffles, and lane l accumulates output columns l, l + 32, ....
//
// Decode at B = 1 occupies only n_kv blocks; splitting the key walk across
// blocks (flash-decoding) is left for later work, as for K3.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 16;     // query rows per block
constexpr int BS = 32;     // keys per tile (one per lane)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = BQ / WARPS;

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

// grid (ceil(TQ / BQ), n_kv, B); block THREADS threads. DM: the head-dim
// capacity of the shared tiles (64 or 128); D <= DM, D % 8 == 0.
template <typename KV, int DM>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                       const KV* __restrict__ v, float* __restrict__ out,
                       const int* __restrict__ tables, const int* __restrict__ pos,
                       int n_kv, int TQ, int D, int bs, int M, int kv_mul, float scale) {
  constexpr int DC = DM / 32;                 // output columns per lane
  constexpr int KPL = 16 / sizeof(KV);        // elements per 16-byte load
  constexpr int MAX_LOADS = BS * DM / KPL / THREADS;
  static_assert(MAX_LOADS * KPL * THREADS == BS * DM, "tile load split");
  __shared__ float qs[BQ][DM];
  __shared__ float ks[BS][DM + 1];  // +1: lane j reads row j, conflict-free
  __shared__ float vs[BS][DM];
  __shared__ long long row_off[BS];  // pool element offset of key j's row, -1: not loaded

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = blockIdx.x * BQ;
  const int q_pos0 = pos[b];
  const size_t head = (size_t)b * n_kv + h;
  const float* qh = q + head * TQ * D;
  const int* tb = tables + (size_t)b * M;

  const int rows_here = min(BQ, TQ - r0);
  for (int i = tid; i < BQ * DM; i += THREADS) {
    const int r = i / DM, d = i % DM;
    qs[r][d] = (r < rows_here && d < D) ? qh[(size_t)(r0 + r) * D + d] : 0.f;
  }
  // newest position any row of this tile can see, capped at the table's
  // reach: the walk ends there
  const int last_key = min(M * bs - 1, q_pos0 + (r0 + rows_here - 1) / kv_mul);
  const int n_tiles = last_key / BS + 1;
  const int row_chunks = D / KPL;       // 16-byte loads per K/V row
  const int n_chunks = BS * row_chunks;

  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], acc[ROWS_PER_WARP][DC];
  int limit[ROWS_PER_WARP];  // newest visible column per row (-1: row absent)
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = i * WARPS + warp;
    m[i] = -INFINITY;
    l[i] = 0.f;
    limit[i] = r < rows_here ? q_pos0 + (r0 + r) / kv_mul : -1;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int s0 = t * BS;
    __syncthreads();  // previous tile fully consumed (and qs written)
    if (tid < BS) {
      const int s = s0 + tid;
      if (s <= last_key) {
        const long long phys = tb[s / bs];
        row_off[tid] = ((phys * n_kv + h) * bs + s % bs) * (long long)D;
      } else {
        row_off[tid] = -1;
      }
    }
    __syncthreads();
    {
      uint4 kr[MAX_LOADS], vr[MAX_LOADS];
#pragma unroll
      for (int u = 0; u < MAX_LOADS; ++u) {
        const int c = u * THREADS + tid;
        kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
        if (c < n_chunks) {
          const long long off = row_off[c / row_chunks];
          if (off >= 0) {
            const long long e = off + (long long)(c % row_chunks) * KPL;
            kr[u] = __ldg(reinterpret_cast<const uint4*>(k + e));
            vr[u] = __ldg(reinterpret_cast<const uint4*>(v + e));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < MAX_LOADS; ++u) {
        const int c = u * THREADS + tid;
        if (c >= n_chunks) continue;
        const int j = c / row_chunks, d = (c % row_chunks) * KPL;
        float kf[KPL], vf[KPL];
        unpack16(kr[u], k, kf);
        unpack16(vr[u], v, vf);
#pragma unroll
        for (int cc = 0; cc < KPL; ++cc) {
          ks[j][d + cc] = kf[cc];
          vs[j][d + cc] = vf[cc];
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
      if (limit[i] < s0) continue;  // warp-uniform: nothing visible yet (or absent row)
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
    const float inv = l[i] > 0.f ? 1.f / l[i] : 1.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = lane + 32 * c;
      if (col < D) oh[(size_t)(r0 + r) * D + col] = acc[i][c] * inv;
    }
  }
}

template <typename KV>
void launch(const float* q, const void* k, const void* v, float* out, const int* tables,
            const int* pos, int B, int n_kv, int TQ, int D, int bs, int M, int kv_mul,
            float scale, cudaStream_t stream) {
  dim3 grid((TQ + BQ - 1) / BQ, n_kv, B);
  const KV* kp = static_cast<const KV*>(k);
  const KV* vp = static_cast<const KV*>(v);
  if (D <= 64)
    paged_attention_kernel<KV, 64><<<grid, THREADS, 0, stream>>>(
        q, kp, vp, out, tables, pos, n_kv, TQ, D, bs, M, kv_mul, scale);
  else
    paged_attention_kernel<KV, 128><<<grid, THREADS, 0, stream>>>(
        q, kp, vp, out, tables, pos, n_kv, TQ, D, bs, M, kv_mul, scale);
}

}  // namespace

extern "C" {

// q_g f32 [B, n_kv, TQ, D]; k/v [n_blocks, n_kv, bs, D] f32 (kv_bf16 = 0) or
// bf16; out f32 [B, n_kv, TQ, D]; tables int32 [B, M]; pos int32 [B], all
// on the device. D % 8 == 0, D <= 128.
int dlt_paged_attention(const void* q, const void* k, const void* v, void* out,
                        const void* tables, const void* pos, int B, int n_kv, int TQ,
                        int D, int n_blocks, int bs, int M, int kv_mul, float scale,
                        int kv_bf16, void* stream) {
  if (D <= 0 || D > 128 || D % 8 != 0 || bs <= 0 || M <= 0 || n_blocks <= 0 || TQ <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const int* tp = static_cast<const int*>(tables);
  const int* pp = static_cast<const int*>(pos);
  float* op = static_cast<float*>(out);
  if (kv_bf16)
    launch<__nv_bfloat16>(qp, k, v, op, tp, pp, B, n_kv, TQ, D, bs, M, kv_mul, scale, s);
  else
    launch<float>(qp, k, v, op, tp, pp, B, n_kv, TQ, D, bs, M, kv_mul, scale, s);
  return static_cast<int>(cudaGetLastError());
}

const char* dlt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
