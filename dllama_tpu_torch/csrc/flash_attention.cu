// Causal GQA flash attention over the dense head-major KV cache for Hopper
// (sm_90a): kernel K3, and its block-statistics mode K3s.
//
// Replaces dllama_tpu/ops/flash_attention.py::_kernel (stats=False), the
// Pallas kernel that streamed (S/bs) KV blocks through VMEM on a sequential
// grid axis, keeping the running max / sum / accumulator in scratch between
// grid steps. Here the KV walk lives inside the block, so the online-softmax
// state stays in registers.
//
// Layout (the JAX package's): queries fold the GQA group into rows,
// q_g [B, n_kv, TQ = T * kv_mul, D] f32; caches k/v [B, n_kv, S, D] in f32
// (or bf16 under bf16 compute, or float8 e4m3 under --kv-dtype f8, widened
// exactly to f32 as a tile is staged); out [B, n_kv, TQ, D] f32. Query row r sits
// at absolute position pos[b] + r / kv_mul and sees cache slots
// s <= pos[b] + r / kv_mul; no mask tensor is built.
//
// Bound on the H100: bytes for decode (T = 1: each visible K/V row is read
// once and used for kv_mul query rows) and short prefills; operations for
// long prefills (FP32 SIMT, 67 TFLOP/s, over an f32 cache; the bf16 tensor
// cores over a bf16 cache). What the design does about it:
//
// * One block per (b, kv head, 16-row query tile, split): 4 warps of 4 query
//   rows, rows dealt round-robin (row r on warp r % 4) so a decode tile of
//   kv_mul = 4 rows keeps all four warps busy. K/V tiles of 32 keys are
//   staged once in shared memory (as f32) and used by all 16 rows. Lane j
//   scores key j with 16-byte reads of its (padded) row and of the query
//   rows, the softmax max and sum are warp shuffles, and lane l accumulates
//   the adjacent output columns D/32 * l, ... from one 16-byte read of each
//   V row. A warp reads shared memory only for the rows it holds: at
//   decode (kv_mul = 4 rows per tile) one of its four, which the walk over
//   a deep cache is bound by once split-S has filled the card.
// * Split-S (flash-decoding). Decode at B = 1 gives only n_kv = 8 (b, head,
//   tile) blocks for 132 SMs, and one block alone cannot pull a KV head's
//   rows at the HBM rate. When the unsplit grid is that small, the wrapper
//   (ops/flash_attention.py::_attn_splits, from the shapes alone) launches
//   n_splits blocks per tile. Each block cuts the tile's visible 32-key
//   tiles [0, newest] into n_splits ranges of whole tiles and takes its own
//   (split * n / n_splits up to (split + 1) * n / n_splits): the range
//   follows the depth read on the device, so the grid does not depend on
//   host position values. Pass 1 writes each range's unnormalised (acc, m,
//   l) to an f32 scratch; pass 2 (combine_splits_kernel, attn_common.cuh,
//   shared with K4) merges them in
//   split order (M = max m_s, L = sum l_s e^(m_s - M), acc = sum acc_s
//   e^(m_s - M)), so results do not change from run to run. A range that
//   sees nothing keeps m = -inf, l = 0, acc = 0 and weighs exactly 0.
// * In a split block, the next tile's 16-byte loads go into registers
//   before the current tile is scored, so they stay in flight behind the
//   arithmetic. A single pass (prefill) loads each tile just before staging
//   it instead: holding f32 K/V for the next tile takes the f32 head-dim-128
//   kernel from 96 to 168 registers a thread, 3 resident blocks an SM
//   instead of 5, and a 256-token chunk's 512 blocks would then need two
//   waves (chip_smoke.py times that chunk at depth 19000 in a 32768-row
//   cache). The walk stops at the newest position any row of the tile can
//   see, so fully masked tiles are never loaded (the TPU kernel skipped
//   their compute at flash_attention.py:71 but still streamed them).
//
// * A single pass over a bf16 cache (prefill chunks, K3s's ring blocks) is
//   bound by bf16 operations at 989 TFLOP/s, which only the tensor cores
//   reach: it runs flash_attention_tc_kernel instead (below: TMA ring,
//   mma.sync scores and P V, f32 online softmax, P rounded to bf16). f32
//   caches (exact mode, the goldens' numerics) and split launches keep the
//   SIMT kernel. The entries pick the path from the cache dtype, the split
//   count and whether the queries are bf16 (use_tc below); the wrapper
//   records the same choice.
// * An e4m3 cache (--kv-dtype f8) under f32 queries takes the SIMT kernel,
//   single pass and split alike: each 16-byte load carries 16 columns,
//   half of bf16's bytes, widened exactly to f32 as the tile is staged, so
//   f32 queries are never rounded. Under bf16 queries its single pass runs
//   on the tensor cores: the TMA lands the e4m3 tile unswizzled at half the
//   bytes, all four warps widen it to bf16 (exact) into the 128-byte
//   swizzled layout the bf16 tile would have arrived in, and the same
//   mma.sync code reads it.
//
// K3s is the same kernel in its stats mode (STATS = true, entry
// dlt_flash_block_stats). It replaces the stats=True path of the same Pallas
// kernel (flash_attention.py::flash_block_stats), the block step of
// sequence-parallel attention (parallel/ring.py): the cache argument is one
// sequence shard covering absolute positions [kv_pos0, kv_pos0 + S), and the
// result is the unnormalised accumulator with the running max m and sum l of
// every query row, all f32, for the caller's cross-block combine; with
// splits, pass 2 writes the merged (acc, M, L) in that same form. A row that
// sees nothing of the block (q_pos0 + r / kv_mul < kv_pos0) gets exactly
// acc = 0, l = 0, m = -inf, split or not.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attn_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 16;     // query rows per block
constexpr int BS = 32;     // keys per tile (one per lane)
constexpr int WARPS = 4;
constexpr int ROWS_PER_WARP = BQ / WARPS;


// DC adjacent f32 columns of a shared row as one 8- or 16-byte load
template <int DC>
__device__ __forceinline__ void load_cols(const float* p, float* out) {
  if constexpr (DC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    static_assert(DC == 2, "head dims 64 and 128");
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  }
}

// grid (ceil(TQ / BQ) * n_splits, n_kv, B); block WARPS * 32 threads.
// blockIdx.x = query tile * n_splits + split. Cache slot c holds absolute
// position kv_pos0 + c (0 for the whole cache, K3). With STATS, out
// receives the unnormalised accumulator and m_out / l_out [B, n_kv, TQ] the
// running max and sum of each row, split s at offset s * (B * n_kv * TQ)
// rows; without (n_splits = 1 only), out = acc / l.
template <typename KV, int D, bool STATS, bool PREFETCH>
__global__ void __launch_bounds__(WARPS * 32)
flash_attention_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                       const KV* __restrict__ v, float* __restrict__ out,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       const int* __restrict__ pos, int pos_scalar, int kv_pos0,
                       int n_kv, int TQ, int S, int kv_mul, float scale, int n_splits) {
  constexpr int DC = D / 32;  // output columns per lane
  constexpr int KV_PER_LOAD = 16 / sizeof(KV);
  constexpr int N_LOADS = BS * D / KV_PER_LOAD / (WARPS * 32);  // per thread per tile
  static_assert(N_LOADS * KV_PER_LOAD * WARPS * 32 == BS * D, "tile load split");
  // rows of 16-byte vectors; K's pitch of D + 4 puts the 8 lanes of each
  // quarter-warp (lane j reads key j's row) on distinct banks
  __shared__ __align__(16) float qs[BQ][D];
  __shared__ __align__(16) float ks[BS][D + 4];
  __shared__ __align__(16) float vs[BS][D];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z, h = blockIdx.y;
  const int split = blockIdx.x % n_splits;
  const int r0 = blockIdx.x / n_splits * BQ;
  const int q_pos0 = pos != nullptr ? pos[b] : pos_scalar;
  const size_t head = (size_t)b * n_kv + h;
  const float* qh = q + head * TQ * D;
  const KV* kh = k + head * S * D;
  const KV* vh = v + head * S * D;

  const int rows_here = min(BQ, TQ - r0);
  // this warp's rows in the tile (warp-uniform): 1 at decode (kv_mul = 4)
  const int n_rows = max(0, (rows_here - warp + WARPS - 1) / WARPS);
  for (int i = tid; i < BQ * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    qs[r][d] = r < rows_here ? qh[(size_t)(r0 + r) * D + d] : 0.f;
  }
  // newest local slot any row of this tile can see. It is negative when the
  // whole block lies past every row (a mid-sequence shard, K3s): then no
  // tile is loaded (C division would round -1 / BS up to 0 and walk one)
  const int last_key = min(S - 1, q_pos0 - kv_pos0 + (r0 + rows_here - 1) / kv_mul);
  const int n_tiles = last_key < 0 ? 0 : last_key / BS + 1;
  // this split's whole tiles: the n_splits ranges cover [0, n_tiles) once
  // (ops/flash_attention.py::_split_ranges is the same rule)
  const int t_lo = split * n_tiles / n_splits;
  const int t_hi = (split + 1) * n_tiles / n_splits;

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

  // tile t's K/V rows in registers: 16-byte loads, N_LOADS per thread each
  uint4 kr[N_LOADS], vr[N_LOADS];
  auto load_tile = [&](int s0) {
#pragma unroll
    for (int u = 0; u < N_LOADS; ++u) {
      const int e = (u * WARPS * 32 + tid) * KV_PER_LOAD;  // element in the tile
      const bool ok = s0 + e / D < S;
      const size_t off = (size_t)s0 * D + e;
      kr[u] = ok ? __ldg(reinterpret_cast<const uint4*>(kh + off)) : make_uint4(0, 0, 0, 0);
      vr[u] = ok ? __ldg(reinterpret_cast<const uint4*>(vh + off)) : make_uint4(0, 0, 0, 0);
    }
  };
  if (PREFETCH && t_lo < t_hi) load_tile(t_lo * BS);

  for (int t = t_lo; t < t_hi; ++t) {
    const int s0 = t * BS;
    __syncthreads();  // previous tile fully consumed (and qs written)
    if (!PREFETCH) load_tile(s0);
#pragma unroll
    for (int u = 0; u < N_LOADS; ++u) {
      const int e = (u * WARPS * 32 + tid) * KV_PER_LOAD;
      const int j = e / D, d = e % D;
      float kf[KV_PER_LOAD], vf[KV_PER_LOAD];
      unpack16(kr[u], kh, kf);
      unpack16(vr[u], vh, vf);
#pragma unroll
      for (int c = 0; c < KV_PER_LOAD; c += 4) {
        *reinterpret_cast<float4*>(&ks[j][d + c]) = make_float4(kf[c], kf[c + 1], kf[c + 2], kf[c + 3]);
        *reinterpret_cast<float4*>(&vs[j][d + c]) = make_float4(vf[c], vf[c + 1], vf[c + 2], vf[c + 3]);
      }
    }
    __syncthreads();
    // split: the next tile's loads go in flight behind this arithmetic
    if (PREFETCH && t + 1 < t_hi) load_tile(s0 + BS);

    // scores of key (s0 + lane) against this warp's rows: one row (decode)
    // reads only its own q row, with four independent sums in flight; a
    // fuller tile scores all its rows, the rows' sums interleaved
    float sc[ROWS_PER_WARP];
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) sc[i] = 0.f;
    if (n_rows == 1) {
      float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int d = 0; d < D; d += 4) {
        const float4 kd = *reinterpret_cast<const float4*>(&ks[lane][d]);
        const float4 qd = *reinterpret_cast<const float4*>(&qs[warp][d]);
        part.x = fmaf(qd.x, kd.x, part.x);
        part.y = fmaf(qd.y, kd.y, part.y);
        part.z = fmaf(qd.z, kd.z, part.z);
        part.w = fmaf(qd.w, kd.w, part.w);
      }
      sc[0] = (part.x + part.y) + (part.z + part.w);
    } else {
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 kd = *reinterpret_cast<const float4*>(&ks[lane][d]);
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
          const float4 qd = *reinterpret_cast<const float4*>(&qs[i * WARPS + warp][d]);
          sc[i] = fmaf(qd.x, kd.x, sc[i]);
          sc[i] = fmaf(qd.y, kd.y, sc[i]);
          sc[i] = fmaf(qd.z, kd.z, sc[i]);
          sc[i] = fmaf(qd.w, kd.w, sc[i]);
        }
      }
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
        float vj[DC];
        load_cols<DC>(&vs[j][DC * lane], vj);
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pj, vj[c], acc[i][c]);
      }
      m[i] = m_new;
    }
  }

  const size_t rows_all = (size_t)gridDim.z * n_kv * TQ;  // rows of one split
  float* oh = out + split * rows_all * D + head * TQ * D;
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = i * WARPS + warp;
    if (r >= rows_here) continue;
    // stats: the unnormalised sum (a row that saw nothing keeps acc = 0,
    // l = 0, m = -inf); otherwise normalised here
    const float inv = STATS ? 1.f : (l[i] > 0.f ? 1.f / l[i] : 1.f);
#pragma unroll
    for (int c = 0; c < DC; ++c) oh[(size_t)(r0 + r) * D + DC * lane + c] = acc[i][c] * inv;
    if (STATS && lane == 0) {
      m_out[split * rows_all + head * TQ + r0 + r] = m[i];
      l_out[split * rows_all + head * TQ + r0 + r] = l[i];
    }
  }
}

// --------------------------------------------------------------------------
// Single pass over a bf16 cache on the tensor cores (K3 and K3s): one block
// per (b, kv head, TC_BQ = 64 folded query rows), four warps of 16 rows.
// K/V tiles of 64 keys arrive by TMA (the cache viewed as 2-D [B * n_kv *
// S, D] bf16 rows, boxes of 64 keys x 64 columns in the 128-byte swizzle)
// into a TC_STAGES-deep ring under mbarriers, issued by thread 0 as soon as
// every warp has left a slot. The scores S = Q K^T and the update P V run
// on mma.sync m16n8k16 (bf16 in, f32 accumulate): each warp holds its 16
// query rows as A fragments rounded to bf16 once, reads K (B operand) with
// ldmatrix and V (B operand, transposed) with ldmatrix.trans, undoing the
// swizzle in the addresses it gives. The online softmax runs in f32 on the
// accumulator fragments (row max and sum over the 4 lanes of a row, exp2
// with scale * log2 e folded in), and P is rounded to bf16 in registers to
// become the A operand of P V (the one rounding the plain single pass does
// not make; ops/flash_attention.py::flash_attention_tc_plain makes it the
// same way). Only tiles that cross a warp's diagonal are masked, and a warp
// skips the tiles none of its rows sees. Over an e4m3 cache (F8, under
// bf16 queries) the ring holds the tiles as they land, 64 whole e4m3 rows
// a box, and every warp widens its share into one bf16 stage in the
// swizzled layout above before any warp reads it (widen_e4m3_tiles).
// --------------------------------------------------------------------------

constexpr int TC_BQ = 64;      // folded query rows per block
constexpr int TC_BS = 64;      // keys per tile
constexpr int TC_WARPS = 4;    // 16 query rows each
constexpr int TC_STAGES = 3;   // ring depth: the tiles in flight

// F8: the ring holds e4m3 tiles as they land (LAND bytes a stage, row-major
// [64 keys][D]), and one bf16 stage (STAGE bytes, the swizzled K and V
// tiles) receives the widened tile that the mma code reads
template <int D, bool F8 = false>
struct TcSmem {
  static constexpr int HALVES = D / 64;      // 128-byte swizzle boxes across a row
  static constexpr int BOX = TC_BS * 128;    // 64 keys x 64 columns: 8 KB
  static constexpr int TILE = HALVES * BOX;  // the K (or V) tile
  static constexpr int STAGE = 2 * TILE;     // K, then V
  static constexpr int LAND_TILE = TC_BS * D;          // an e4m3 K (or V) tile
  static constexpr int SLOT = F8 ? 2 * LAND_TILE : STAGE;  // one ring slot
  static constexpr int RING = TC_STAGES * SLOT + (F8 ? STAGE : 0);
  // + the mbarriers, + slack to align the ring to 1024 bytes
  static constexpr int TOTAL = RING + TC_STAGES * 8 + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}
// One landed e4m3 K and V tile pair (row-major [64 keys][D] each) widened
// to bf16 into the swizzled layout a bf16 tile lands in by TMA: each thread
// turns 16 values (one 16-byte load) into two 16-byte bf16 chunks. e4m3 has
// 3 mantissa bits and an exponent range inside bf16's, so the widening is
// exact (NaN stays NaN)
template <int D>
__device__ __forceinline__ void widen_e4m3_tiles(const unsigned char* land, unsigned char* stage,
                                                 int tid) {
  using St = TcSmem<D, true>;
  constexpr int PER_TILE = TC_BS * D / 16;
  for (int c = tid; c < 2 * PER_TILE; c += TC_WARPS * 32) {
    const int kv = c / PER_TILE, rem = c % PER_TILE;
    const int key = rem / (D / 16), col = rem % (D / 16) * 16;
    float f[16];
    unpack16(*reinterpret_cast<const uint4*>(land + kv * St::LAND_TILE + key * D + col),
             static_cast<const __nv_fp8_e4m3*>(nullptr), f);
    const uint4 lo = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                                pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
    const uint4 hi = make_uint4(pack_bf16(f[8], f[9]), pack_bf16(f[10], f[11]),
                                pack_bf16(f[12], f[13]), pack_bf16(f[14], f[15]));
    unsigned char* box = stage + kv * St::TILE + (col >> 6) * St::BOX;
    const int ch = (col & 63) >> 3;  // even: two adjacent 16-byte chunks of the row
    *reinterpret_cast<uint4*>(box + swizzle128(key, ch)) = lo;
    *reinterpret_cast<uint4*>(box + swizzle128(key, ch + 1)) = hi;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// grid (ceil(TQ / TC_BQ), n_kv, B); block TC_WARPS * 32 threads; dynamic
// shared memory TcSmem<D, F8>::TOTAL. Same row rule and outputs as
// flash_attention_kernel with one split; scale_log2 = scale * log2 e. F8:
// the tensor maps are of e4m3 rows, widened in shared memory per tile.
template <int D, bool STATS, bool F8>
__global__ void __launch_bounds__(TC_WARPS * 32)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ q, float* __restrict__ out,
                          float* __restrict__ m_out, float* __restrict__ l_out,
                          const int* __restrict__ pos, int pos_scalar, int kv_pos0, int n_kv,
                          int TQ, int S, int kv_mul, float scale_log2) {
  using St = TcSmem<D, F8>;
  extern __shared__ unsigned char tc_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * TC_BQ;
  const int q_pos0 = pos != nullptr ? pos[b] : pos_scalar;
  const size_t head = (size_t)b * n_kv + h;
  const int kv_row0 = static_cast<int>(head) * S;  // the head's first row in the 2-D view
  const uint32_t raw0 = smem_addr(tc_smem);
  const uint32_t ring0 = (raw0 + 1023) & ~1023u;
  const uint32_t stage0 = ring0 + TC_STAGES * St::SLOT;  // F8: the widened bf16 tiles
  const uint32_t bar0 = ring0 + St::RING;
  unsigned char* const ring_p = tc_smem + (ring0 - raw0);

  // local slot of the newest key each row sees (rows past TQ get a finite
  // limit too; they are never written); negative: the row sees nothing
  const int base = q_pos0 - kv_pos0;
  const int rows_here = min(TC_BQ, TQ - r0);
  const int last_key = min(S - 1, base + (r0 + rows_here - 1) / kv_mul);
  const int n_tiles = last_key < 0 ? 0 : last_key / TC_BS + 1;
  const int ra = r0 + 16 * warp + g, rb = ra + 8;  // this thread's two rows
  const int lim_a = min(S - 1, base + ra / kv_mul);
  const int lim_b = min(S - 1, base + rb / kv_mul);
  // the warp's least and greatest limits; a warp with no row of the call
  // (past TQ) walks nothing
  const int w_lo = min(S - 1, base + (r0 + 16 * warp) / kv_mul);
  const int w_hi = 16 * warp < rows_here ? min(S - 1, base + (r0 + 16 * warp + 15) / kv_mul)
                                         : -1;

  if (tid == 0) {
    for (int i = 0; i < TC_STAGES; ++i) mbar_init(bar0 + 8 * i);
    mbar_init_fence();
  }
  __syncthreads();

  auto load_tile = [&](int tile) {
    if (tid != 0 || tile >= n_tiles) return;
    const int slot = tile % TC_STAGES;
    const uint32_t ks = ring0 + slot * St::SLOT, bar = bar0 + 8 * slot;
    const int row = kv_row0 + tile * TC_BS;
    mbar_expect_tx(bar, St::SLOT);
    if constexpr (F8) {  // one box of 64 whole e4m3 rows each
      tma_load_2d(ks, &tm_k, bar, 0, row);
      tma_load_2d(ks + St::LAND_TILE, &tm_v, bar, 0, row);
    } else {
#pragma unroll
      for (int hh = 0; hh < St::HALVES; ++hh) {
        tma_load_2d(ks + hh * St::BOX, &tm_k, bar, 64 * hh, row);
        tma_load_2d(ks + St::TILE + hh * St::BOX, &tm_v, bar, 64 * hh, row);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < TC_STAGES - 1; ++i) load_tile(i);

  // the warp's 16 query rows as A fragments, rounded to bf16 once
  uint32_t qf[D / 16][4];
  const float* qh = q + head * TQ * D;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d = 16 * kk + 8 * half + 2 * t;
      const float2 va = ra < TQ ? *reinterpret_cast<const float2*>(qh + (size_t)ra * D + d)
                                : make_float2(0.f, 0.f);
      const float2 vb = rb < TQ ? *reinterpret_cast<const float2*>(qh + (size_t)rb * D + d)
                                : make_float2(0.f, 0.f);
      qf[kk][2 * half] = pack_bf16(va.x, va.y);
      qf[kk][2 * half + 1] = pack_bf16(vb.x, vb.y);
    }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;  // l: this lane's part

  for (int tile = 0; tile < n_tiles; ++tile) {
    __syncthreads();  // every warp has left tile - 1: its slot takes tile + TC_STAGES - 1
    load_tile(tile + TC_STAGES - 1);
    const int s0 = tile * TC_BS;
    const int slot = tile % TC_STAGES;
    uint32_t ks;
    if constexpr (F8) {
      // every warp widens its share of the landed tile, then reads the
      // widened one (the barrier at the top keeps the stage until all left)
      mbar_wait(bar0 + 8 * slot, (tile / TC_STAGES) & 1);
      widen_e4m3_tiles<D>(ring_p + slot * St::SLOT, ring_p + (stage0 - ring0), tid);
      __syncthreads();
      if (s0 > w_hi) continue;  // warp-uniform: none of its rows sees this tile
      ks = stage0;
    } else {
      if (s0 > w_hi) continue;  // warp-uniform: none of its rows sees this tile
      mbar_wait(bar0 + 8 * slot, (tile / TC_STAGES) & 1);
      ks = ring0 + slot * St::SLOT;
    }
    const uint32_t vs = ks + St::TILE;

    // S = Q K^T: per 16 keys, one ldmatrix.x4 gives two n8 tiles' B
    float s[TC_BS / 8][4];
#pragma unroll
    for (int j = 0; j < TC_BS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int p = 0; p < TC_BS / 16; ++p) {
        const int key = 16 * p + ((lane >> 4) << 3) + (lane & 7);
        const int d = 16 * kk + (((lane >> 3) & 1) << 3);
        uint32_t r[4];
        ldmatrix_x4(r, ks + (d >> 6) * St::BOX + swizzle128(key, (d & 63) >> 3));
        mma_bf16_16816(s[2 * p], qf[kk], r[0], r[1]);
        mma_bf16_16816(s[2 * p + 1], qf[kk], r[2], r[3]);
      }

    // online softmax in log2 units; only tiles crossing the diagonal mask
    const bool full = s0 + TC_BS - 1 <= w_lo;
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < TC_BS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = s0 + 8 * j + 2 * t + e;
        float va = s[j][e] * scale_log2, vb = s[j][2 + e] * scale_log2;
        if (!full) {
          va = key <= lim_a ? va : -INFINITY;
          vb = key <= lim_b ? vb : -INFINITY;
        }
        s[j][e] = va;
        s[j][2 + e] = vb;
        mx_a = fmaxf(mx_a, va);
        mx_b = fmaxf(mx_b, vb);
      }
    const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
    // a row that has seen nothing yet keeps m = -inf: exponents against 0
    // give p = 0 and corr = 0, never NaN
    const float mu_a = mn_a == -INFINITY ? 0.f : mn_a, mu_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float corr_a = exp2f(m_a - mu_a), corr_b = exp2f(m_b - mu_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
    uint32_t pf[TC_BS / 16][4];  // P as the A fragments of P V, bf16
#pragma unroll
    for (int j = 0; j < TC_BS / 8; ++j) {
      const float p0 = exp2f(s[j][0] - mu_a), p1 = exp2f(s[j][1] - mu_a);
      const float p2 = exp2f(s[j][2] - mu_b), p3 = exp2f(s[j][3] - mu_b);
      sum_a += p0 + p1;
      sum_b += p2 + p3;
      pf[j >> 1][2 * (j & 1)] = pack_bf16(p0, p1);
      pf[j >> 1][2 * (j & 1) + 1] = pack_bf16(p2, p3);
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= corr_a; o[j][1] *= corr_a;
      o[j][2] *= corr_b; o[j][3] *= corr_b;
    }

    // O += P V: per 16 keys x 16 columns, one ldmatrix.x4.trans
#pragma unroll
    for (int kk = 0; kk < TC_BS / 16; ++kk)
#pragma unroll
      for (int qd = 0; qd < D / 16; ++qd) {
        const int key = 16 * kk + (((lane >> 3) & 1) << 3) + (lane & 7);
        const int d = 16 * qd + ((lane >> 4) << 3);
        uint32_t r[4];
        ldmatrix_x4_trans(r, vs + (d >> 6) * St::BOX + swizzle128(key, (d & 63) >> 3));
        mma_bf16_16816(o[2 * qd], pf[kk], r[0], r[1]);
        mma_bf16_16816(o[2 * qd + 1], pf[kk], r[2], r[3]);
      }
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? rb : ra;
    if (row >= TQ) continue;
    const float m = half ? m_b : m_a, l = half ? l_b : l_a;
    // stats: the unnormalised sum (a row that saw nothing: acc = 0, l = 0,
    // m = -inf); otherwise normalised here
    const float inv = STATS ? 1.f : (l > 0.f ? 1.f / l : 1.f);
    float* orow = out + (head * TQ + row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) =
          make_float2(o[j][2 * half] * inv, o[j][2 * half + 1] * inv);
    if (STATS && t == 0) {
      m_out[head * TQ + row] = m * 0.6931471805599453f;  // back to natural units
      l_out[head * TQ + row] = l;
    }
  }
}

template <int D, bool STATS, bool F8>
int launch_tc_d(const float* q, const void* k, const void* v, float* out, float* m_out,
                float* l_out, const int* pos, int pos_scalar, int kv_pos0, int B, int n_kv,
                int TQ, int S, int kv_mul, float scale, cudaStream_t stream) {
  using St = TcSmem<D, F8>;
  CUtensorMap tm_k, tm_v;
  const uint64_t rows = (uint64_t)B * n_kv * S;
  // bf16: boxes of 64 keys x 64 columns in the 128-byte swizzle; e4m3: one
  // box of 64 whole rows (D bytes), unswizzled (widen_e4m3_tiles swizzles)
  const CUtensorMapDataType type =
      F8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint64_t row_bytes = F8 ? D : D * 2;
  const uint32_t box = F8 ? D : 64;
  const CUtensorMapSwizzle swz = F8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map(&tm_k, type, k, D, rows, row_bytes, box, TC_BS, swz) ||
      !tensor_map(&tm_v, type, v, D, rows, row_bytes, box, TC_BS, swz))
    return static_cast<int>(cudaErrorNotSupported);
  auto kernel = flash_attention_tc_kernel<D, STATS, F8>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, St::TOTAL);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((TQ + TC_BQ - 1) / TC_BQ, n_kv, B);
  kernel<<<grid, TC_WARPS * 32, St::TOTAL, stream>>>(
      tm_k, tm_v, q, out, m_out, l_out, pos, pos_scalar, kv_pos0, n_kv, TQ, S, kv_mul,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <bool STATS>
int launch_tc(int kv_kind, const float* q, const void* k, const void* v, float* out,
              float* m_out, float* l_out, const int* pos, int pos_scalar, int kv_pos0, int B,
              int n_kv, int TQ, int S, int D, int kv_mul, float scale, cudaStream_t stream) {
  if (kv_kind == CACHE_E4M3)
    return D == 64 ? launch_tc_d<64, STATS, true>(q, k, v, out, m_out, l_out, pos, pos_scalar,
                                                  kv_pos0, B, n_kv, TQ, S, kv_mul, scale, stream)
                   : launch_tc_d<128, STATS, true>(q, k, v, out, m_out, l_out, pos,
                                                   pos_scalar, kv_pos0, B, n_kv, TQ, S, kv_mul,
                                                   scale, stream);
  return D == 64 ? launch_tc_d<64, STATS, false>(q, k, v, out, m_out, l_out, pos, pos_scalar,
                                                 kv_pos0, B, n_kv, TQ, S, kv_mul, scale, stream)
                 : launch_tc_d<128, STATS, false>(q, k, v, out, m_out, l_out, pos, pos_scalar,
                                                  kv_pos0, B, n_kv, TQ, S, kv_mul, scale,
                                                  stream);
}

// One launch of K3 (STATS = false) or K3s (true). n_splits > 1 runs pass 1
// into the scratch `part` (n_splits * rows * (D + 2) floats, rows = B * n_kv
// * TQ: the acc partials, then m, then l) and pass 2 into out / m_out / l_out.
template <typename KV, bool STATS>
void launch(const float* q, const void* k, const void* v, float* out, float* m_out,
            float* l_out, float* part, int n_splits, const int* pos, int pos_scalar,
            int kv_pos0, int B, int n_kv, int TQ, int S, int D, int kv_mul, float scale,
            cudaStream_t stream) {
  const KV* kp = static_cast<const KV*>(k);
  const KV* vp = static_cast<const KV*>(v);
  dim3 grid((TQ + BQ - 1) / BQ * n_splits, n_kv, B);
  const int rows = B * n_kv * TQ;
  if constexpr (!std::is_same<KV, __nv_bfloat16>::value) {
    // the grid fills the card: one pass (over a bf16 cache: launch_tc)
    if (n_splits == 1) {
      if (D == 64)
        flash_attention_kernel<KV, 64, STATS, false><<<grid, WARPS * 32, 0, stream>>>(
            q, kp, vp, out, m_out, l_out, pos, pos_scalar, kv_pos0, n_kv, TQ, S, kv_mul, scale,
            1);
      else
        flash_attention_kernel<KV, 128, STATS, false><<<grid, WARPS * 32, 0, stream>>>(
            q, kp, vp, out, m_out, l_out, pos, pos_scalar, kv_pos0, n_kv, TQ, S, kv_mul, scale,
            1);
      return;
    }
  }
  float* pa = part;
  float* pm = part + (size_t)n_splits * rows * D;
  float* pl = pm + (size_t)n_splits * rows;
  const int cblocks = (rows + COMBINE_WARPS - 1) / COMBINE_WARPS;
  if (D == 64) {
    flash_attention_kernel<KV, 64, true, true><<<grid, WARPS * 32, 0, stream>>>(
        q, kp, vp, pa, pm, pl, pos, pos_scalar, kv_pos0, n_kv, TQ, S, kv_mul, scale, n_splits);
    combine_splits_kernel<64, STATS><<<cblocks, COMBINE_WARPS * 32, 0, stream>>>(
        pa, pm, pl, out, m_out, l_out, rows, n_splits, 64);
  } else {
    flash_attention_kernel<KV, 128, true, true><<<grid, WARPS * 32, 0, stream>>>(
        q, kp, vp, pa, pm, pl, pos, pos_scalar, kv_pos0, n_kv, TQ, S, kv_mul, scale, n_splits);
    combine_splits_kernel<128, STATS><<<cblocks, COMBINE_WARPS * 32, 0, stream>>>(
        pa, pm, pl, out, m_out, l_out, rows, n_splits, 128);
  }
}

// The path of a launch: the tensor cores for a single pass over a bf16
// cache (the SIMT kernel has no bf16 single pass), or over an e4m3 cache
// under bf16 queries (q_bf16: the f32 q rows hold bf16 values, so rounding
// them to bf16 changes nothing); the SIMT kernel for f32 caches, e4m3
// caches under f32 queries, and split launches.
// ops/flash_attention.py::_attn_path records it.
bool use_tc(int kv_kind, int q_bf16, int n_splits) {
  return n_splits == 1 && (kv_kind == CACHE_BF16 || (kv_kind == CACHE_E4M3 && q_bf16));
}

// K3 (STATS = false) or K3s through the SIMT kernel, by cache kind
template <bool STATS>
int launch_kind(int kv_kind, const float* q, const void* k, const void* v, float* out,
                float* m_out, float* l_out, float* part, int n_splits, const int* pos,
                int pos_scalar, int kv_pos0, int B, int n_kv, int TQ, int S, int D, int kv_mul,
                float scale, cudaStream_t stream) {
  if (kv_kind == CACHE_F32)
    launch<float, STATS>(q, k, v, out, m_out, l_out, part, n_splits, pos, pos_scalar, kv_pos0,
                         B, n_kv, TQ, S, D, kv_mul, scale, stream);
  else if (kv_kind == CACHE_BF16)
    launch<__nv_bfloat16, STATS>(q, k, v, out, m_out, l_out, part, n_splits, pos, pos_scalar,
                                 kv_pos0, B, n_kv, TQ, S, D, kv_mul, scale, stream);
  else if (kv_kind == CACHE_E4M3)
    launch<__nv_fp8_e4m3, STATS>(q, k, v, out, m_out, l_out, part, n_splits, pos, pos_scalar,
                                 kv_pos0, B, n_kv, TQ, S, D, kv_mul, scale, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q_g f32 [B, n_kv, TQ, D] (q_bf16: its values are bf16's); k/v [B, n_kv,
// S, D] of kv_kind 0 (f32), 1 (bf16) or 2 (float8 e4m3); out f32 [B, n_kv,
// TQ, D]; pos int32 [B] on the device, or null to use pos_scalar for every
// row. D in {64, 128}. n_splits >= 1 (split-S when > 1, with part the f32
// scratch of launch() above; unused otherwise). use_tc picks the
// tensor-core single pass or the SIMT kernel.
int dlt_flash_attention(const void* q, const void* k, const void* v, void* out,
                        const void* pos, int pos_scalar, int B, int n_kv, int TQ,
                        int S, int D, int kv_mul, float scale, int kv_kind, int q_bf16,
                        void* part, int n_splits, void* stream) {
  if ((D != 64 && D != 128) || n_splits < 1 || (n_splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const int* pp = static_cast<const int*>(pos);
  float* op = static_cast<float*>(out);
  float* sp = static_cast<float*>(part);
  if (use_tc(kv_kind, q_bf16, n_splits))
    return launch_tc<false>(kv_kind, qp, k, v, op, nullptr, nullptr, pp, pos_scalar, 0, B, n_kv,
                            TQ, S, D, kv_mul, scale, s);
  return launch_kind<false>(kv_kind, qp, k, v, op, nullptr, nullptr, sp, n_splits, pp,
                            pos_scalar, 0, B, n_kv, TQ, S, D, kv_mul, scale, s);
}

// K3s: the same arguments for one KV block k/v [B, n_kv, S, D] holding
// absolute positions [kv_pos0, kv_pos0 + S); acc f32 [B, n_kv, TQ, D] and
// m, l f32 [B, n_kv, TQ] receive the unnormalised block statistics.
int dlt_flash_block_stats(const void* q, const void* k, const void* v, void* acc,
                          void* m, void* l, const void* pos, int pos_scalar,
                          int kv_pos0, int B, int n_kv, int TQ, int S, int D,
                          int kv_mul, float scale, int kv_kind, int q_bf16, void* part,
                          int n_splits, void* stream) {
  if ((D != 64 && D != 128) || n_splits < 1 || (n_splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const int* pp = static_cast<const int*>(pos);
  float* ap = static_cast<float*>(acc);
  float* mp = static_cast<float*>(m);
  float* lp = static_cast<float*>(l);
  float* sp = static_cast<float*>(part);
  if (use_tc(kv_kind, q_bf16, n_splits))
    return launch_tc<true>(kv_kind, qp, k, v, ap, mp, lp, pp, pos_scalar, kv_pos0, B, n_kv, TQ,
                           S, D, kv_mul, scale, s);
  return launch_kind<true>(kv_kind, qp, k, v, ap, mp, lp, sp, n_splits, pp, pos_scalar,
                           kv_pos0, B, n_kv, TQ, S, D, kv_mul, scale, s);
}

const char* dlt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
