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
// k/v [n_blocks, n_kv, bs, D] in f32, bf16 or float8 e4m3; tables [B, M] int32 of
// physical block ids (0 = the null block); pos [B] int32, the position of
// each row's first query token; out [B, n_kv, TQ, D] f32. Query row r sees
// logical columns s <= pos[b] + r / kv_mul; null entries and partial tail
// blocks are masked by that position rule alone.
//
// Bound on the H100: bytes (each visible K/V row is read once and used for
// kv_mul query rows at decode). What the design does about it:
//
// * Split-S (flash-decoding). One block per (b, kv head, 16-row query
//   tile) gives decode only n_kv = 8 blocks at B = 1 and 64 at B = 8, on
//   132 SMs, and one block alone cannot pull a KV head's rows at the HBM
//   rate. The wrapper (ops/paged_attention.py::_paged_splits, from B, n_kv,
//   T * kv_mul and the table's reach M * bs alone, so positions that
//   advance on the device never change the grid) launches n_splits blocks
//   per tile, aiming at about four blocks per SM with at least two 32-key
//   tiles a split. Each block reads its row's position on the device, cuts
//   the tile's visible 32-key tiles [0, newest] into n_splits ranges of
//   whole tiles (K3's rule, ops/flash_attention.py::_split_ranges) and walks
//   its own: a short row's keys are walked once, by few splits, and a split
//   past its end loads nothing and writes m = -inf, l = 0. Pass 1 writes
//   each range's unnormalised (acc, m, l) to an f32 scratch, pass 2 merges
//   them in split order (combine_splits_kernel, attn_common.cuh, K3's), so
//   results do not change from run to run.
// * A cp.async ring. For each tile of 32 logical keys every thread reads
//   tables[b, s / bs] for its 16-byte chunks (a block's [bs, D] tile is
//   contiguous for one head, so a key's row is D contiguous elements) and
//   copies them with 16-byte cp.async into a PA_STAGES-deep ring in shared
//   memory, in the pool's own type (bf16 rows widen exactly to f32 as they
//   are read). Tiles t + 1 and t + 2 are in flight while tile t is scored;
//   one barrier per tile. Rows are padded by 16 bytes, so the 8 lanes of a
//   quarter-warp (lane j reads key j's row) hit distinct banks.
// * Scores: lane j scores key j of the tile against the warp's query rows
//   (rows dealt round-robin to the 4 warps, so a decode tile of kv_mul = 4
//   rows keeps all four busy), four partial sums a row in flight; max and
//   sum are warp shuffles; lane l accumulates output columns l, l + 32, ....
//   The walk stops at the newest position any row of the tile can see,
//   capped at M * bs - 1, so unallocated tail entries and the null entries
//   behind an inactive row's stale position are never loaded; keys past it
//   are zero-filled (finite) and masked.
//
// Numerics: f32 online softmax, f32 sums; the plain version is the gather
// plus the one-shot oracle.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attn_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 16;     // query rows per block
constexpr int BS = 32;     // keys per tile (one per lane)
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = BQ / WARPS;
constexpr int PA_STAGES = 3;  // ring depth: two tiles in flight behind the scored one

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

// Dynamic shared memory: the query tile, then the ring of K/V tiles.
template <typename KV, int DM>
struct PaSmem {
  static constexpr int PITCH = DM + 16 / sizeof(KV);       // elements per shared row
  static constexpr int TILE = BS * PITCH * sizeof(KV);     // bytes of one K or V tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int Q = BQ * DM * 4;
  static constexpr int TOTAL = Q + PA_STAGES * STAGE;
  static_assert(TILE % 16 == 0 && Q % 16 == 0, "16-byte rows");
};

// grid (ceil(TQ / BQ) * n_splits, n_kv, B); block THREADS threads; dynamic
// shared memory PaSmem<KV, DM>::TOTAL. blockIdx.x = query tile * n_splits +
// split. DM: the head-dim capacity (64 or 128); D <= DM, D % 8 == 0.
// SPLIT: out receives the unnormalised accumulator and m_out / l_out the
// running max and sum of each row, split s at offset s * (B * n_kv * TQ)
// rows; otherwise (n_splits = 1) out = acc / l.
template <typename KV, int DM, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                       const KV* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       const int* __restrict__ tables, const int* __restrict__ pos,
                       int n_kv, int TQ, int D, int bs, int M, int kv_mul, float scale,
                       int n_splits) {
  using S = PaSmem<KV, DM>;
  constexpr int DC = DM / 32;                 // output columns per lane
  constexpr int KPL = 16 / sizeof(KV);        // elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char pa_smem[];
  float* qs = reinterpret_cast<float*>(pa_smem);   // [BQ][DM]
  unsigned char* ring = pa_smem + S::Q;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z, h = blockIdx.y;
  const int split = blockIdx.x % n_splits;
  const int r0 = blockIdx.x / n_splits * BQ;
  const int q_pos0 = pos[b];
  const size_t head = (size_t)b * n_kv + h;
  const float* qh = q + head * TQ * D;
  const int* tb = tables + (size_t)b * M;

  const int rows_here = min(BQ, TQ - r0);
  // this warp's rows in the tile (warp-uniform): 1 at decode (kv_mul = 4)
  const int n_rows = max(0, (rows_here - warp + WARPS - 1) / WARPS);
  for (int i = tid; i < BQ * DM; i += THREADS) {
    const int r = i / DM, d = i % DM;
    qs[i] = (r < rows_here && d < D) ? qh[(size_t)(r0 + r) * D + d] : 0.f;
  }
  // newest position any row of this tile can see, capped at the table's
  // reach; this split's whole tiles of [0, last_key]
  const int last_key = min(M * bs - 1, q_pos0 + (r0 + rows_here - 1) / kv_mul);
  const int n_tiles = last_key / BS + 1;
  const int t_lo = split * n_tiles / n_splits;
  const int t_hi = (split + 1) * n_tiles / n_splits;
  const int row_chunks = D / KPL;       // 16-byte chunks per K/V row
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

  // tile t's K/V rows into ring slot (t - t_lo) % PA_STAGES: one 16-byte
  // cp.async per chunk; keys past last_key are zero-filled and not read
  auto fetch = [&](int t) {
    unsigned char* ks = ring + ((t - t_lo) % PA_STAGES) * S::STAGE;
    for (int c = tid; c < n_chunks; c += THREADS) {
      const int j = c / row_chunks, d = (c % row_chunks) * KPL;
      const int s = t * BS + j;
      size_t e = 0;
      if (s <= last_key) {
        const size_t phys = static_cast<size_t>(__ldg(tb + s / bs));
        e = ((phys * n_kv + h) * bs + s % bs) * D + d;
      }
      const uint32_t off = static_cast<uint32_t>((j * S::PITCH + d) * sizeof(KV));
      const int bytes = s <= last_key ? 16 : 0;
      cp_async16(smem_addr(ks + off), k + e, bytes);
      cp_async16(smem_addr(ks + S::TILE + off), v + e, bytes);
    }
  };
#pragma unroll
  for (int i = 0; i < PA_STAGES - 1; ++i) {
    if (t_lo + i < t_hi) fetch(t_lo + i);
    cp_async_commit();
  }

  for (int t = t_lo; t < t_hi; ++t) {
    // tile t landed for this thread, then for all; every warp is done with
    // tile t - 1, whose slot takes tile t + PA_STAGES - 1
    cp_async_wait<PA_STAGES - 2>();
    __syncthreads();
    if (t + PA_STAGES - 1 < t_hi) fetch(t + PA_STAGES - 1);
    cp_async_commit();
    const KV* ks = reinterpret_cast<const KV*>(ring + ((t - t_lo) % PA_STAGES) * S::STAGE);
    const KV* vs = reinterpret_cast<const KV*>(reinterpret_cast<const unsigned char*>(ks) +
                                               S::TILE);
    const int s0 = t * BS;

    // scores of key (s0 + lane) against this warp's rows: four partial
    // sums a row, from 16-byte reads of the key row and the query rows
    float4 part[ROWS_PER_WARP];
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) part[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    const KV* krow = ks + lane * S::PITCH;
#pragma unroll 4
    for (int d = 0; d < D; d += KPL) {
      float kf[KPL];
      unpack16(*reinterpret_cast<const uint4*>(krow + d), krow, kf);
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        if (i >= n_rows) continue;  // warp-uniform
        const float* qr = qs + (i * WARPS + warp) * DM + d;
#pragma unroll
        for (int c = 0; c < KPL; c += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + c);
          part[i].x = fmaf(qv.x, kf[c], part[i].x);
          part[i].y = fmaf(qv.y, kf[c + 1], part[i].y);
          part[i].z = fmaf(qv.z, kf[c + 2], part[i].z);
          part[i].w = fmaf(qv.w, kf[c + 3], part[i].w);
        }
      }
    }
    const int key = s0 + lane;
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      // warp-uniform: nothing visible yet (or absent row). This guard keeps
      // m_new finite below: expf(-inf - -inf) would be NaN
      if (limit[i] < s0) continue;
      const float sc = (part[i].x + part[i].y) + (part[i].z + part[i].w);
      const float s = key <= limit[i] ? sc * scale : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(s));  // finite: key s0 <= limit
      const float p = expf(s - m_new);               // masked keys -> 0
      const float corr = expf(m[i] - m_new);         // first tile: exp(-inf) = 0
      l[i] = l[i] * corr + warp_sum(p);
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
#pragma unroll 8
      for (int j = 0; j < BS; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const KV* vrow = vs + j * S::PITCH + lane;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pj, widen(vrow[32 * c]), acc[i][c]);
      }
      m[i] = m_new;
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (the trailing empty groups)

  const size_t rows_all = (size_t)gridDim.z * n_kv * TQ;  // rows of one split
  float* oh = out + (SPLIT ? split * rows_all * D : 0) + head * TQ * D;
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = i * WARPS + warp;
    if (r >= rows_here) continue;
    // split: the unnormalised sum (a split that saw nothing keeps acc = 0,
    // l = 0, m = -inf); otherwise normalised here
    const float inv = SPLIT ? 1.f : (l[i] > 0.f ? 1.f / l[i] : 1.f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = lane + 32 * c;
      if (col < D) oh[(size_t)(r0 + r) * D + col] = acc[i][c] * inv;
    }
    if (SPLIT && lane == 0) {
      m_out[split * rows_all + head * TQ + r0 + r] = m[i];
      l_out[split * rows_all + head * TQ + r0 + r] = l[i];
    }
  }
}

// One launch: a single pass (n_splits = 1) into out, or pass 1 into the
// scratch part (n_splits * rows * (D + 2) floats, rows = B * n_kv * TQ:
// the acc partials, then m, then l) and pass 2 into out.
template <typename KV, int DM>
int launch(const float* q, const void* k, const void* v, float* out, float* part, int n_splits,
           const int* tables, const int* pos, int B, int n_kv, int TQ, int D, int bs, int M,
           int kv_mul, float scale, cudaStream_t stream) {
  using S = PaSmem<KV, DM>;
  dim3 grid((TQ + BQ - 1) / BQ * n_splits, n_kv, B);
  const KV* kp = static_cast<const KV*>(k);
  const KV* vp = static_cast<const KV*>(v);
  auto kernel = n_splits == 1 ? &paged_attention_kernel<KV, DM, false>
                              : &paged_attention_kernel<KV, DM, true>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       S::TOTAL);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_splits == 1) {
    kernel<<<grid, THREADS, S::TOTAL, stream>>>(q, kp, vp, out, nullptr, nullptr, tables, pos,
                                                n_kv, TQ, D, bs, M, kv_mul, scale, 1);
  } else {
    const int rows = B * n_kv * TQ;
    float* pa = part;
    float* pm = part + (size_t)n_splits * rows * D;
    float* pl = pm + (size_t)n_splits * rows;
    kernel<<<grid, THREADS, S::TOTAL, stream>>>(q, kp, vp, pa, pm, pl, tables, pos, n_kv, TQ,
                                                D, bs, M, kv_mul, scale, n_splits);
    combine_splits_kernel<DM, false>
        <<<(rows + COMBINE_WARPS - 1) / COMBINE_WARPS, COMBINE_WARPS * 32, 0, stream>>>(
            pa, pm, pl, out, nullptr, nullptr, rows, n_splits, D);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q_g f32 [B, n_kv, TQ, D]; k/v [n_blocks, n_kv, bs, D] of kv_kind 0 (f32),
// 1 (bf16) or 2 (float8 e4m3); out f32 [B, n_kv, TQ, D]; tables int32
// [B, M]; pos int32 [B], all on the device. D <= 128, a multiple of 8 (of
// 16 for e4m3). n_splits >= 1 (split-S when > 1, with part the f32 scratch
// of launch() above; unused otherwise).
int dlt_paged_attention(const void* q, const void* k, const void* v, void* out,
                        const void* tables, const void* pos, int B, int n_kv, int TQ,
                        int D, int n_blocks, int bs, int M, int kv_mul, float scale,
                        int kv_kind, void* part, int n_splits, void* stream) {
  if (D <= 0 || D > 128 || D % (kv_kind == CACHE_E4M3 ? 16 : 8) != 0 || bs <= 0 || M <= 0 ||
      n_blocks <= 0 || TQ <= 0 || n_splits < 1 || (n_splits > 1 && part == nullptr) ||
      kv_kind < CACHE_F32 || kv_kind > CACHE_E4M3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const int* tp = static_cast<const int*>(tables);
  const int* pp = static_cast<const int*>(pos);
  float* op = static_cast<float*>(out);
  float* sp = static_cast<float*>(part);
  if (kv_kind == CACHE_E4M3)
    return D <= 64 ? launch<__nv_fp8_e4m3, 64>(qp, k, v, op, sp, n_splits, tp, pp, B, n_kv, TQ,
                                               D, bs, M, kv_mul, scale, s)
                   : launch<__nv_fp8_e4m3, 128>(qp, k, v, op, sp, n_splits, tp, pp, B, n_kv,
                                                TQ, D, bs, M, kv_mul, scale, s);
  if (kv_kind == CACHE_BF16)
    return D <= 64 ? launch<__nv_bfloat16, 64>(qp, k, v, op, sp, n_splits, tp, pp, B, n_kv, TQ,
                                               D, bs, M, kv_mul, scale, s)
                   : launch<__nv_bfloat16, 128>(qp, k, v, op, sp, n_splits, tp, pp, B, n_kv,
                                                TQ, D, bs, M, kv_mul, scale, s);
  return D <= 64 ? launch<float, 64>(qp, k, v, op, sp, n_splits, tp, pp, B, n_kv, TQ, D, bs, M,
                                     kv_mul, scale, s)
                 : launch<float, 128>(qp, k, v, op, sp, n_splits, tp, pp, B, n_kv, TQ, D, bs,
                                      M, kv_mul, scale, s);
}

const char* dlt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
