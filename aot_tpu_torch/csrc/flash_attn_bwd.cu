// Flash-attention backward for Hopper (sm_90a): every product on wgmma,
// fp32-accurate (3xTF32) for fp32 operands, bf16 products for bf16 ones.
//
// Replaces aot_tpu/ops/pallas/flash_attn_vjp.py:267 _flash_heads_bwd: the
// TPU kernels _bwd_dq_kernel (:104) and _bwd_dkv_kernel (:148) behind the
// custom VJP of flash_attention (:338), which every global attention of the
// training program runs (self-attention and the long-term read). It reads
// the forward's layout (csrc/flash_attn_fwd.cu) and the forward's lse:
//   q, k, v   (B, L, h*d / h*dv)  rows of E, batch/row strides given
//   valid     (B,) int32 live key counts, or null (then `valid_all` for all)
//   dout      (B, Lq, h*dv)       contiguous
//   lse       (B*h, Lq)           the forward's log-sum-exp (-1e30: no key)
//   out       (B, Lq, h*dv)       the forward's output, row strides given:
//                                 bwd_delta_kernel computes D = rowsum(dout *
//                                 out) from it, as the JAX package does
//                                 outside the Pallas calls (:274-276)
//   dq, dk    (B, Lq|Lk, h*d)     contiguous outputs
//   dv        (B, Lk, h*dv)       contiguous output
// With S = scale q k^T over the live keys j < min(valid[b], Lk):
//   P = exp(S - lse);  dV = P^T dO;  dS = P o (dO V^T - D);
//   dQ = scale dS K;   dK = scale dS^T Q.
// Keys at or beyond the live length get exact zeros in dK and dV and add
// nothing to dQ (dead key tiles are skipped); a row with no live key (lse
// -1e30) gives zeros. E = fp32: fp32 in, out and accumulation, every
// product three TF32 products of hi/lo splits (3xTF32), as the TPU kernels
// compute at Precision.HIGHEST (:41-43). E = bf16 (TRAIN_DTYPE=bfloat16):
// each product one bf16 product into fp32 accumulators; P is rounded to
// bf16 before dV = P^T dO (`p.astype(v.dtype)`, :177), dS before dQ and dK
// (:135, :184); D, lse, S, P, dP and every sum stay fp32; the gradients
// are rounded to bf16 once (:140, :189-190).
//
// What bounds it (bounds as chip_smoke.py computes them: the function's
// FLOPs, 2 (3d + 2dv) a (query, live key, head), over 165 TFLOP/s of
// fp32-accurate products, 3xTF32 at 495 / 3, or 989 at bf16, against each
// input read and output written once over 3.35 TB/s; every shape is
// bound by operations):
//   shape            (B, h, Lq, Lk, d, dv)          GFLOP  bound fp32 / bf16
//   AOTT training    (16, 8, 900, 900, 32, 32)        33.2  0.201 / 0.034 ms
//   DeAOT GPM self   (16, 1, 900, 900, 128, 1024)     63.0  0.382 / 0.064
//   DeAOT LT read    (16, 1, 900, 2700, 128, 1024)   189.1  1.146 / 0.191
//   DeAOTL LT read   (1, 1, 900, 19800, 128, 1024)    86.7  0.525
//   DAVIS 1080p      (1, 1, 7232, 14464, 128, 1024)  508.8  3.084
// The mma.sync kernels these replace ran 8-28x those bounds (PERF.md
// section 6, "study"): at dv = 1024 half their time was the dQ kernel,
// which summed dP = dO V^T in 32-column chunks, a barrier each, and split
// every operand fragment into TF32 hi and lo again for every product; the
// other half re-read the kept P and dS once per 128 output columns.
//
// Design (wgmma.cuh holds the building blocks and the packed layout).
//   bwd_delta_kernel  D, a warp a (b, query, head), into the workspace.
//   bwd_pack_kernel   one launch: q, k, v and dO, each into the packed
//                 K-major layout of the products that read it (rows of
//                 tokens, and transposed: rows of channels), split into hi
//                 and lo TF32 copies for fp32 (once an element, not once a
//                 fragment: `.tf32` wgmma reads shared memory K-major only,
//                 so the transposes cost nothing beyond the split),
//                 zero-padded to whole tiles. Every operand tile of the
//                 kernels below is then one contiguous block: a 1-D bulk
//                 copy (cp.async.bulk, the TMA unit; no tensor map needed)
//                 lands it in shared memory under an mbarrier, in a ring of
//                 2-4 stages, and wgmma reads it there without swizzle.
//   d, dv <= 32 (AOT's heads): one pass, two kernels, no scratch.
//     bwd_rows_kernel<dQ>  a warpgroup per (b*h, 64 queries): over the
//                 live key tiles S = Q K^T and dP = dO V^T (shared-memory
//                 operands), P and dS in the accumulators, dQ += dS K with
//                 dS the left operand straight from the accumulator
//                 registers (bf16: the accumulators of 16 columns are the
//                 register fragment; fp32: the summation index taken in
//                 the order 2t, 2t + 1 of each 8, so K^T is packed with its
//                 rows of keys permuted the same way). For a grid under two
//                 waves the key loop is split over blocks whose fp32
//                 partials bwd_dq_sum_kernel adds in split order.
//     bwd_rows_kernel<dK>  a warpgroup per (b*h, 64 keys) over the query
//                 tiles: S^T, dP^T, then dK += dS^T Q and dV += P^T dO, P
//                 and dS from the registers. S and dP are computed twice
//                 (46 GFLOP where the function needs 33 at AOT's training
//                 shape): at d = 32 every product is a few wgmma, the time
//                 is latency and exp, and this keeps dQ out of any scratch
//                 (a key-major form would write B*h*Lq*d fp32 partials a
//                 key tile, 221 MB at that shape, and sum them again).
//   dv > 32 (DeAOT's dv = 1024): two passes over slabs of query rows, FLOP
//   minimal (S and dP once).
//     bwd_scores_kernel  two warpgroups per (b*h, 128 queries, group of key
//                 tiles), a key tile (128 keys at bf16, 64 at fp32) at a
//                 time: dP over dv in 128-byte chunks through the ring as
//                 one product a chunk for the whole tile, folded in fp32,
//                 then S over d for each 64-key half; P and dS written to a
//                 scratch in the packed layouts the second pass reads: P^T
//                 and dS^T (rows of keys) and dS (rows of queries); hi/lo
//                 copies for fp32, bf16 for bf16. They go through device
//                 memory because the second pass's products need them
//                 K-major over the queries (P^T dO, dS^T Q), which no
//                 register fragment gives across 128 output columns of
//                 dv = 1024 without recomputing S and dP per column tile
//                 (a one-pass form that does runs 164 GFLOP where the
//                 function needs 87 at DeAOTL's LT read).
//     bwd_gemm_kernel    one launch per slab for dV += P^T dO, dK += scale
//                 dS^T Q and dQ = scale dS K: two warpgroups per 128 x 128
//                 output tile, the summation in 128-byte chunks
//                 through the ring, each chunk's product folded in fp32;
//                 dQ's summation over the keys split to the length of dV's
//                 (partials summed in split order). Each slab adds its dV
//                 and dK to the slabs before (fp32; at bf16 in an fp32
//                 scratch, rounded once by the last slab).
// No atomics anywhere: two runs give the same bits. Long sums are folded in
// fp32, because the tensor core rounds its fp32 accumulator toward zero: a
// tile's (or a chunk's) product is summed in an accumulator of its own
// (scale-d 0) and added to the running one in fp32. For d > 32 the score's
// hi hi term is summed apart from the two small ones.
//
// Measured (chip_smoke.py phases 9 and 24, CUDA events around one call;
// NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6 keeps the latest):
//   fp32 AOTT 0.98 ms (bound 0.20), GPM 1.83 (0.38), LT read 4.77 (1.15),
//   DeAOTL LT 1.49 (0.53), 1080p 8.12 (3.08); bf16 AOTT 0.42 (0.034), GPM
//   0.49 (0.064), LT read 1.05 (0.19). What holds them there
//   (`chip_smoke.py --profile-bwd`): at dv = 1024 the scores kernel, 59-69%
//   of a call's kernel time at fp32 and 43-49% at bf16, streams each dO
//   and V chunk from L2 once per tile pair, the hi/lo copies doubling the
//   bytes at fp32; then the second pass's products (21-33%) and the pack
//   (2-20%). At d = 32 the one-pass kernels wait on each product: no
//   second tile is in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_mma.cuh"
#include "flash_attn_bwd_plan.h"
#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace {

using namespace bwdplan;   // the plan's fields and the tiles it pads to
using bf16mma::bf16;
using bf16mma::kIsBf16;
using bf16mma::store2;

constexpr float kEmptyLse = -1e29f;  // lse below this: the row has no key
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRowBytes = wg::kChunkBytes;   // a packed row of one chunk
static_assert(kRowBytes == bwdplan::kChunkBytes,
              "the plan packs the layout wgmma.cuh reads");

__device__ __forceinline__ int live_keys(const int* valid, int valid_all,
                                         int b, int lk) {
  return max(0, min(valid != nullptr ? valid[b] : valid_all, lk));
}

// A packed operand in device memory (wgmma.cuh's layout)
struct Packed {
  const char* hi;
  const char* lo;        // null at bf16
  long long bh_bytes;    // one (b, head)
  long long chunk_bytes; // one chunk: rows * 128
};

__device__ __forceinline__ long long tile_at(const Packed& p, int bh,
                                             int chunk, int row0) {
  return bh * p.bh_bytes + chunk * p.chunk_bytes + (long long)row0 * kRowBytes;
}

// Issue the bulk copies of rows [row0, row0 + rows) of `chunk` (both
// copies at fp32: lo right after hi in shared memory)
template <typename E>
__device__ __forceinline__ void copy_tile(char* dst, const Packed& p, int bh,
                                          int chunk, int row0, int rows,
                                          uint64_t* bar) {
  const long long at = tile_at(p, bh, chunk, row0);
  const uint32_t bytes = rows * kRowBytes;
  wg::bulk_copy(dst, p.hi + at, bytes, bar);
  if constexpr (!kIsBf16<E>) wg::bulk_copy(dst + bytes, p.lo + at, bytes, bar);
}

template <typename E>
constexpr int kCopies = kIsBf16<E> ? 1 : 2;

// k-steps of a chunk that hold any of `left` remaining columns
template <typename E>
__device__ __forceinline__ int steps_of(int left) {
  constexpr int kStep = kIsBf16<E> ? 16 : 8;
  return max(0, min(4, (left + kStep - 1) / kStep));
}

template <int R>
__device__ __forceinline__ void fold(float* acc, const float* part) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] += part[i];
}

template <int R>
__device__ __forceinline__ void zero(float* x) {
#pragma unroll
  for (int i = 0; i < R; ++i) x[i] = 0.f;
}

// ---- pack ------------------------------------------------------------------

struct PackJob {
  const void* src;       // (B, tokens, h*width) rows, element strides
  long long sb, sl;
  char* hi;
  char* lo;              // null at bf16
  int tokens, width, rows_p, cols_p;
  int transposed;        // rows of channels, columns of tokens
  int perm;              // fp32 transposed: each 8 columns in 2t, 2t+1 order
};

struct PackJobs {
  PackJob j[7];
  int heads, bh;
};

__device__ __forceinline__ int perm8(int p) {
  return p < 4 ? 2 * p : 2 * (p - 4) + 1;
}

// One 16-byte unit of the packed layout a thread: E elements of one row,
// gathered from the source (zeros outside it), split at fp32.
template <typename E>
__global__ void __launch_bounds__(256) bwd_pack_kernel(const PackJobs jobs) {
  const PackJob& J = jobs.j[blockIdx.y];
  constexpr int kE = 16 / (int)sizeof(E);
  constexpr int kKC = wg::kChunk<E>;
  const long long per_bh = (long long)J.rows_p * J.cols_p / kE;
  const long long chunk_units = (long long)J.rows_p * (kKC / kE);
  const long long total = per_bh * jobs.bh;
  for (long long u = blockIdx.x * 256LL + threadIdx.x; u < total;
       u += (long long)gridDim.x * 256) {
    const int bh = (int)(u / per_bh);
    const long long w = u - bh * per_bh;
    const int chunk = (int)(w / chunk_units);
    const int rem = (int)(w - chunk * chunk_units);
    const int r = (rem >> 6) * 8 + (rem & 7);       // 8 units of 8 rows
    const int c0 = chunk * kKC + ((rem >> 3) & 7) * kE;
    const int b = bh / jobs.heads, head = bh - b * jobs.heads;
    const E* src = static_cast<const E*>(J.src) + b * J.sb +
                   (long long)head * J.width;
    if (!J.transposed && r < J.tokens && c0 + kE <= J.width) {
      // E adjacent channels of one row: one aligned 16-byte load
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * J.sl + c0);
      if constexpr (kIsBf16<E>) {
        reinterpret_cast<uint4*>(J.hi)[u] = raw;
      } else {
        const float x[4] = {__uint_as_float(raw.x), __uint_as_float(raw.y),
                            __uint_as_float(raw.z), __uint_as_float(raw.w)};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hi[e] = tf32x3::tf32_hi(x[e]);
          lo[e] = tf32x3::tf32_lo(x[e], hi[e]);
        }
        reinterpret_cast<uint4*>(J.hi)[u] =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        reinterpret_cast<uint4*>(J.lo)[u] =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      continue;
    }
    float x[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int c = J.perm ? (c0 & ~7) + perm8((c0 & 7) + e) : c0 + e;
      const int tok = J.transposed ? c : r;
      const int ch = J.transposed ? r : c;
      float val = 0.f;
      if (tok < J.tokens && ch < J.width) {
        if constexpr (kIsBf16<E>)
          val = __bfloat162float(src[tok * J.sl + ch]);
        else
          val = src[tok * J.sl + ch];
      }
      x[e] = val;
    }
    if constexpr (kIsBf16<E>) {
      uint4 o;
      o.x = bf16mma::pack_bf16(x[0], x[1]);
      o.y = bf16mma::pack_bf16(x[2], x[3]);
      o.z = bf16mma::pack_bf16(x[4], x[5]);
      o.w = bf16mma::pack_bf16(x[6], x[7]);
      reinterpret_cast<uint4*>(J.hi)[u] = o;
    } else {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[e] = tf32x3::tf32_hi(x[e]);
        lo[e] = tf32x3::tf32_lo(x[e], hi[e]);
      }
      reinterpret_cast<uint4*>(J.hi)[u] =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      reinterpret_cast<uint4*>(J.lo)[u] =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
}

// D = rowsum(dO o O) of each (b, query, head), in fp32, as the JAX
// package computes it outside the Pallas calls (:274-276): a warp a row,
// the lanes' partial sums added in a fixed order (deterministic). Written
// (B*h, Lq).
template <typename E>
__global__ void __launch_bounds__(256)
bwd_delta_kernel(const E* __restrict__ dout, const E* __restrict__ out,
             long long out_sb, long long out_sl, float* __restrict__ delta,
             int batch, int lq, int heads, int dv) {
  const long long row = blockIdx.x * 8LL + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)batch * lq * heads) return;
  const int head = (int)(row % heads);
  const long long bq = row / heads;
  const int b = (int)(bq / lq), qi = (int)(bq - (long long)b * lq);
  const E* o = out + b * out_sb + qi * out_sl + (long long)head * dv;
  const E* g = dout + bq * heads * dv + (long long)head * dv;
  float sum = 0.f;
  for (int c = lane; c < dv; c += 32) {
    if constexpr (kIsBf16<E>)
      sum = fmaf(__bfloat162float(g[c]), __bfloat162float(o[c]), sum);
    else
      sum = fmaf(g[c], o[c], sum);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[((long long)b * heads + head) * lq + qi] = sum;
}

// ---- one pass (d, dv <= 32) ------------------------------------------------

template <typename E>
struct RowsTiles {
  static constexpr int kNC = kCopies<E>;
  static constexpr int kCT = wg::kChunk<E>;   // column tokens a tile
  static_assert(kCT == chunk_cols(kIsBf16<E>) && kTokenPad % kCT == 0 &&
                kTokenPad % kOnePassRows == 0);
  // two stages: three blocks a multiprocessor at bf16 (two at fp32) hide
  // more latency than a third stage would (PERF.md section 6)
  static constexpr int kStages = 2;
  static constexpr int kBlocks = kIsBf16<E> ? 3 : 2;   // a multiprocessor
  static constexpr int kRow = kOnePassRows * kRowBytes;  // row tile, a copy
  static constexpr int kCol = kCT * kRowBytes;      // column tile, a copy
  static constexpr int kColT = kOnePassMax * kRowBytes;  // 32 channel rows
  static constexpr int kStage = kNC * (2 * kCol + 2 * kColT);
  static constexpr size_t kSmem =
      2 * kNC * kRow + kStages * kStage + (1 + kStages) * sizeof(uint64_t);
};

template <typename E>
struct RowsArgs {
  // row side (Q, dO for dQ; K, V for dK), column side natural (K, V; Q,
  // dO) and transposed-permuted (K^T; Q^T, dO^T)
  Packed r1, r2, c1, c2, c1t, c2t;
  const int* valid;
  const float* lse;
  const float* delta;
  E* out1;           // dQ or dK
  E* out2;           // dV (dK kernel)
  float* dq_part;    // (splits, B, Lq, h*d) unscaled partials, or null
  long long split_stride;
  int heads, lq, lk, d, dv, valid_all, tiles_per_split;
  float scale;
};

// KEY_ROWS false: dQ, rows are queries, the loop runs over key tiles.
// KEY_ROWS true: dK and dV, rows are keys, the loop runs over query tiles.
template <typename E, bool KEY_ROWS>
__global__ void __launch_bounds__(128, RowsTiles<E>::kBlocks)
    bwd_rows_kernel(const RowsArgs<E> a) {
  using T = RowsTiles<E>;
  constexpr int kCT = T::kCT, kNC = T::kNC, kS = T::kStages;
  constexpr bool kBf16 = kIsBf16<E>;
  extern __shared__ __align__(128) char smem[];
  char* s_r1 = smem;
  char* s_r2 = s_r1 + kNC * T::kRow;
  char* s_st = s_r2 + kNC * T::kRow;
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_st + kS * T::kStage);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int bh = blockIdx.x;
  const int b = bh / a.heads, head = bh - b * a.heads;
  const int r0 = blockIdx.y * 64;
  const int n_live = live_keys(a.valid, a.valid_all, b, a.lk);
  const int col_end = KEY_ROWS ? a.lq : n_live;
  int ct_begin = 0, ct_end = (col_end + kCT - 1) / kCT;
  if (KEY_ROWS && r0 >= n_live) ct_end = 0;
  if (!KEY_ROWS) {
    ct_begin = blockIdx.z * a.tiles_per_split;
    ct_end = min(ct_end, ct_begin + a.tiles_per_split);
  }
  const int n_t = max(0, ct_end - ct_begin);
  constexpr uint32_t kStageBytes =
      kNC * (2 * T::kCol + (KEY_ROWS ? 2 : 1) * T::kColT);

  if (tid == 0) {
    for (int i = 0; i <= kS; ++i) wg::bar_init(&bars[i], 1);
    wg::bar_init_fence();
  }
  __syncthreads();
  auto load = [&](int i) {   // column tile ct_begin + i into stage i % kS
    char* st = s_st + (i % kS) * T::kStage;
    uint64_t* bar = &bars[1 + i % kS];
    const int ct = ct_begin + i;
    wg::bar_expect(bar, kStageBytes);
    copy_tile<E>(st, a.c1, bh, 0, ct * kCT, kCT, bar);
    copy_tile<E>(st + kNC * T::kCol, a.c2, bh, 0, ct * kCT, kCT, bar);
    copy_tile<E>(st + 2 * kNC * T::kCol, a.c1t, bh, ct, 0, 32, bar);
    if (KEY_ROWS)
      copy_tile<E>(st + 2 * kNC * T::kCol + kNC * T::kColT, a.c2t, bh, ct, 0,
                   32, bar);
  };
  if (tid == 0 && n_t > 0) {
    wg::bar_expect(&bars[0], 2 * kNC * T::kRow);
    copy_tile<E>(s_r1, a.r1, bh, 0, r0, 64, &bars[0]);
    copy_tile<E>(s_r2, a.r2, bh, 0, r0, 64, &bars[0]);
    for (int i = 0; i < kS && i < n_t; ++i) load(i);
  }

  const float scale2 = a.scale * kLog2e;
  const float* lse = a.lse + (long long)bh * a.lq;
  const float* delta = a.delta + (long long)bh * a.lq;
  float lse2_r[2] = {0.f, 0.f}, dd_r[2] = {0.f, 0.f};
  bool live_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + warp * 16 + g + 8 * i;
    if (KEY_ROWS) {
      live_r[i] = row < n_live;
    } else {
      live_r[i] = row < a.lq && lse[min(row, a.lq - 1)] > kEmptyLse;
      if (row < a.lq) {
        lse2_r[i] = lse[row] * kLog2e;
        dd_r[i] = delta[row];
      }
    }
  }
  const int steps_d = steps_of<E>(a.d), steps_dv = steps_of<E>(a.dv);
  const uint32_t u_r1 = wg::smem_u32(s_r1), u_r2 = wg::smem_u32(s_r2);

  float acc1[16], acc2[16];
  zero<16>(acc1);
  zero<16>(acc2);
  if (n_t > 0) wg::bar_wait(&bars[0], 0);
  for (int i = 0; i < n_t; ++i) {
    const int c0 = (ct_begin + i) * kCT;
    // dK: each column's (query's) lse and D, loaded before the wait
    float lse_c[KEY_ROWS ? kCT / 4 : 1], dd_c[KEY_ROWS ? kCT / 4 : 1];
    if (KEY_ROWS) {
#pragma unroll
      for (int j = 0; j < kCT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * j + 2 * t + e;
          lse_c[2 * j + e] = col < a.lq ? lse[col] : -1e30f;
          dd_c[2 * j + e] = col < a.lq ? delta[col] : 0.f;
        }
    }
    wg::bar_wait(&bars[1 + i % kS], (i / kS) & 1);
    const uint32_t st = wg::smem_u32(s_st + (i % kS) * T::kStage);
    const uint32_t u_c1 = st, u_c2 = st + kNC * T::kCol;
    const uint32_t u_c1t = st + 2 * kNC * T::kCol;
    const uint32_t u_c2t = u_c1t + kNC * T::kColT;
    // every accumulator defined before the fence (an undefined one gets
    // its definition from the compiler between the products, which then
    // run serialized)
    float s[kCT / 2], dp[kCT / 2];
    zero<kCT / 2>(s);
    zero<kCT / 2>(dp);
    wg::keep<kCT / 2>(s);
    wg::keep<kCT / 2>(dp);
    wg::fence();
    wg::chunk_ss<E, kCT>(s, nullptr, u_r1, u_r1 + T::kRow, u_c1,
                         u_c1 + T::kCol, steps_d, 0);
    wg::chunk_ss<E, kCT>(dp, nullptr, u_r2, u_r2 + T::kRow, u_c2,
                         u_c2 + T::kCol, steps_dv, 0);
    wg::commit();
    wg::wait<0>();
    wg::keep<kCT / 2>(s);
    wg::keep<kCT / 2>(dp);
    // P = exp(scale S - lse) over the live (query, key) pairs; dS in dp
#pragma unroll
    for (int j = 0; j < kCT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * j + 2 * t + e;
        bool live_c = col < col_end;
        float sub_c = 0.f, ddc = 0.f;
        if (KEY_ROWS) {
          const float l = lse_c[KEY_ROWS ? 2 * j + e : 0];
          live_c = live_c && l > kEmptyLse;
          sub_c = l * kLog2e;
          ddc = dd_c[KEY_ROWS ? 2 * j + e : 0];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int x = 4 * j + 2 * r + e;
          const float sub = KEY_ROWS ? sub_c : lse2_r[r];
          const float dd = KEY_ROWS ? ddc : dd_r[r];
          const float p = (live_c && live_r[r])
                              ? exp2f(fmaf(s[x], scale2, -sub)) : 0.f;
          s[x] = p;
          dp[x] = p * (dp[x] - dd);
        }
      }
    // dQ += dS K, or dK += dS^T Q and dV += P^T dO: this tile's products
    // from the registers, summed apart and added in fp32
    float part1[16], part2[16];
    zero<16>(part1);
    zero<16>(part2);
    wg::keep<16>(part1);
    wg::keep<16>(part2);
    wg::Frags<E> f1, f2;
    wg::frags_from_acc(f1, dp);
    if (KEY_ROWS) wg::frags_from_acc(f2, s);
    wg::fence();
    wg::chunk_rs<E, 32>(part1, f1, u_c1t, u_c1t + T::kColT, 4, 0);
    if (KEY_ROWS)
      wg::chunk_rs<E, 32>(part2, f2, u_c2t, u_c2t + T::kColT, 4, 0);
    wg::commit();
    wg::wait<0>();
    wg::keep<16>(part1);
    fold<16>(acc1, part1);
    if (KEY_ROWS) {
      wg::keep<16>(part2);
      fold<16>(acc2, part2);
    }
    __syncthreads();   // every warp is done with this stage
    if (tid == 0 && i + kS < n_t) {
      wg::fence_async_smem();
      load(i + kS);
    }
  }

  // dQ of a split launch: the unscaled fp32 partial of this split's keys
  const bool partial = !KEY_ROWS && a.dq_part != nullptr;
  const float mul = partial ? 1.f : a.scale;
  const int n_rows = KEY_ROWS ? a.lk : a.lq;
  const long long o_stride = (long long)a.heads * a.d;
  const long long v_stride = (long long)a.heads * a.dv;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + warp * 16 + g + 8 * r;
    if (row >= n_rows) continue;
    const long long o_row =
        ((long long)b * n_rows + row) * o_stride + (long long)head * a.d;
    const long long v_row =
        ((long long)b * n_rows + row) * v_stride + (long long)head * a.dv;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * j + 2 * t;
      const float x = acc1[4 * j + 2 * r] * mul;
      const float y = acc1[4 * j + 2 * r + 1] * mul;
      if (col < a.d) {
        if (partial)
          store2(a.dq_part + blockIdx.z * a.split_stride, o_row + col, false,
                 x, y);
        else
          store2(a.out1, o_row + col, kBf16, x, y);
      }
      if (KEY_ROWS && col < a.dv)
        store2(a.out2, v_row + col, kBf16, acc2[4 * j + 2 * r],
               acc2[4 * j + 2 * r + 1]);
    }
  }
}

// ---- two passes (dv > 32): the scores ---------------------------------------

template <typename E>
struct ScoreTiles {
  static constexpr int kNC = kCopies<E>;
  static constexpr int kKT = score_key_tile(kIsBf16<E>);   // keys a tile
  static_assert(kTokenPad % kKT == 0 && kTokenPad % kScoreRows == 0);
  static constexpr int kStages = 4;
  static constexpr int kA = kScoreRows * kRowBytes;   // query rows, a copy
  static constexpr int kB = kKT * kRowBytes;   // a tile's key rows, a copy
  static constexpr int kStage = kNC * (kA + kB);
  static constexpr size_t kSmem =
      kStages * kStage + kStages * sizeof(uint64_t);
};

template <typename E>
struct ScoreArgs {
  Packed q, k, dout, v;      // natural: rows of tokens
  char* pt[2];               // P^T:  rows of keys (Lk_p), K = the slab
  char* dst[2];              // dS^T: the same layout
  char* ds[2];               // dS:   rows of the slab, K = keys (Lk_p)
  long long kept_bh;         // bytes of each a (b, head)
  int lkp, slab, row0;       // the slab's first query row
  int heads, lq, lk, d, dv, valid_all, tiles_per_group;
  const int* valid;
  const float* lse;
  const float* delta;
  float scale;
};

// Byte offset of element (r, c) in a packed array of `rows_p` rows
template <typename E>
__device__ __forceinline__ long long packed_at(int r, int c, int rows_p) {
  constexpr int kE = 16 / (int)sizeof(E);
  constexpr int kKC = wg::kChunk<E>;
  return (long long)(c / kKC) * rows_p * kRowBytes + (r >> 3) * 1024 +
         ((c % kKC) / kE) * 128 + (r & 7) * 16 + (c % kE) * (int)sizeof(E);
}

template <typename E>
__device__ __forceinline__ void put1(char* const* dst, long long at, float x) {
  if constexpr (kIsBf16<E>) {
    *reinterpret_cast<bf16*>(dst[0] + at) = __float2bfloat16_rn(x);
  } else {
    const uint32_t hi = tf32x3::tf32_hi(x);
    *reinterpret_cast<uint32_t*>(dst[0] + at) = hi;
    *reinterpret_cast<uint32_t*>(dst[1] + at) = tf32x3::tf32_lo(x, hi);
  }
}

template <typename E>
__device__ __forceinline__ void put2(char* const* dst, long long at, float x,
                                     float y) {
  if constexpr (kIsBf16<E>) {
    *reinterpret_cast<uint32_t*>(dst[0] + at) = bf16mma::pack_bf16(x, y);
  } else {
    const uint32_t hx = tf32x3::tf32_hi(x), hy = tf32x3::tf32_hi(y);
    *reinterpret_cast<uint2*>(dst[0] + at) = make_uint2(hx, hy);
    *reinterpret_cast<uint2*>(dst[1] + at) =
        make_uint2(tf32x3::tf32_lo(x, hx), tf32x3::tf32_lo(y, hy));
  }
}

// A block: two warpgroups of 64 query rows, one key tile (kKT keys) at a
// time. dP first, dO V^T over the dv chunks as one m64n(kKT) product a
// chunk (each chunk's folded in fp32), so a dO chunk serves the whole
// tile; then S for each 64-key half over the d chunks, the half's P and dS
// written as soon as its S is complete (at most dP, S and its small terms
// live at once).
template <typename E, bool APART>
__global__ void __launch_bounds__(256, 1)
    bwd_scores_kernel(const ScoreArgs<E> a) {
  using T = ScoreTiles<E>;
  constexpr int kNC = T::kNC, kS = T::kStages, kKT = T::kKT;
  constexpr int kHalves = kKT / 64;
  constexpr int kKC = wg::kChunk<E>;
  extern __shared__ __align__(128) char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kS * T::kStage);

  const int tid = threadIdx.x;
  const int wgi = tid >> 7, warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int bh = blockIdx.x;
  const int b = bh / a.heads;
  const int ql0 = blockIdx.y * 128;          // in the slab
  const int q0 = a.row0 + ql0;
  const int n_live = live_keys(a.valid, a.valid_all, b, a.lk);
  const int n_kt = (n_live + kKT - 1) / kKT;
  const int kt0 = blockIdx.z * a.tiles_per_group;
  const int kt1 = min(n_kt, kt0 + a.tiles_per_group);
  const int nd = (a.d + kKC - 1) / kKC, nv = (a.dv + kKC - 1) / kKC;
  const int nst = nv + kHalves * nd;         // steps a key tile
  const int n_steps = max(0, kt1 - kt0) * nst;

  if (tid == 0) {
    for (int i = 0; i < kS; ++i) wg::bar_init(&bars[i], 1);
    wg::bar_init_fence();
  }
  __syncthreads();
  // step s: key tile kt0 + s / nst; i = s % nst < nv: dP chunk i, else S
  // chunk (i - nv) % nd of the 64-key half (i - nv) / nd
  auto load = [&](int s) {
    const int kt = kt0 + s / nst, i = s % nst;
    char* st = smem + (s % kS) * T::kStage;
    uint64_t* bar = &bars[s % kS];
    const bool dp_step = i < nv;
    const int rows = dp_step ? kKT : 64;
    wg::bar_expect(bar, kNC * (T::kA + rows * kRowBytes));
    if (dp_step) {
      copy_tile<E>(st, a.dout, bh, i, q0, 128, bar);
      copy_tile<E>(st + kNC * T::kA, a.v, bh, i, kt * kKT, kKT, bar);
    } else {
      const int h = (i - nv) / nd, ch = (i - nv) % nd;
      copy_tile<E>(st, a.q, bh, ch, q0, 128, bar);
      copy_tile<E>(st + kNC * T::kA, a.k, bh, ch, kt * kKT + 64 * h, 64,
                   bar);
    }
  };
  if (tid == 0)
    for (int s = 0; s < kS && s < n_steps; ++s) load(s);

  const float scale2 = a.scale * kLog2e;
  const long long bhq = (long long)bh * a.lq;
  float lse2_r[2] = {0.f, 0.f}, dd_r[2] = {0.f, 0.f};
  bool live_r[2];
  int ql_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ql_r[i] = ql0 + wgi * 64 + warp * 16 + g + 8 * i;
    const int row = a.row0 + ql_r[i];
    live_r[i] = row < a.lq && a.lse[bhq + min(row, a.lq - 1)] > kEmptyLse;
    if (row < a.lq) {
      lse2_r[i] = a.lse[bhq + row] * kLog2e;
      dd_r[i] = a.delta[bhq + row];
    }
  }

  float dp[kKT / 2], sb[32], ss[APART ? 32 : 1];
  for (int s = 0; s < n_steps; ++s) {
    const int kt = kt0 + s / nst, i = s % nst;
    wg::bar_wait(&bars[s % kS], (s / kS) & 1);
    const uint32_t st = wg::smem_u32(smem + (s % kS) * T::kStage);
    const uint32_t ua = st + wgi * 64 * kRowBytes;    // this warpgroup's rows
    const uint32_t ub = st + kNC * T::kA;
    if (i < nv) {
      // dP += dO V^T over this dv chunk, summed apart and folded in fp32
      float part[kKT / 2];
      zero<kKT / 2>(part);
      wg::keep<kKT / 2>(part);
      wg::fence();
      wg::chunk_ss<E, kKT>(part, nullptr, ua, ua + T::kA, ub, ub + T::kB,
                           steps_of<E>(a.dv - i * kKC), 0);
      wg::commit();
      wg::wait<0>();
      wg::keep<kKT / 2>(part);
      if (i == 0) {
#pragma unroll
        for (int x = 0; x < kKT / 2; ++x) dp[x] = part[x];
      } else {
        fold<kKT / 2>(dp, part);
      }
    } else {
      const int h = (i - nv) / nd, ch = (i - nv) % nd;
      if (ch == 0) {
        zero<32>(sb);
        if constexpr (APART) zero<32>(ss);
      }
      wg::keep<32>(sb);
      if constexpr (APART) wg::keep<32>(ss);
      wg::fence();
      wg::chunk_ss<E, 64, APART>(sb, ss, ua, ua + T::kA, ub,
                                 ub + 64 * kRowBytes,
                                 steps_of<E>(a.d - ch * kKC), ch == 0 ? 0 : 1);
      wg::commit();
      wg::wait<0>();
      wg::keep<32>(sb);
      if constexpr (APART) wg::keep<32>(ss);
      if (ch == nd - 1) {
        // P and dS of this 64-key half, into the scratch
        if constexpr (APART) fold<32>(sb, ss);
#pragma unroll
        for (int hh = 0; hh < kHalves; ++hh) {   // dP by constant index
          if (hh != h) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int key = kt * kKT + 64 * hh + 8 * j + 2 * t;
            float p[2], d2[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 4 * j + 2 * r + e;
              p[e] = (live_r[r] && key + e < n_live)
                         ? exp2f(fmaf(sb[x], scale2, -lse2_r[r])) : 0.f;
              d2[e] = p[e] * (dp[32 * hh + x] - dd_r[r]);
            }
            const int ql = ql_r[r];
            const long long bh_at = bh * a.kept_bh;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const long long at = bh_at + packed_at<E>(key + e, ql, a.lkp);
              put1<E>(a.pt, at, p[e]);
              put1<E>(a.dst, at, d2[e]);
            }
            put2<E>(a.ds, bh_at + packed_at<E>(ql, key, a.slab), d2[0],
                    d2[1]);
          }
        }
      }
    }
    __syncthreads();   // both warpgroups are done with this stage
    if (tid == 0 && s + kS < n_steps) {
      wg::fence_async_smem();
      load(s + kS);
    }
  }
}

// ---- two passes: the products of the kept P and dS --------------------------

struct GemmJob {
  const char* a[2];        // A (M x K) packed: hi, lo
  long long a_bh, a_chunk;
  const char* b[2];        // B (N x K) packed
  long long b_bh, b_chunk;
  int b_chunk0;            // B's first chunk (the slab's, for K = queries)
  void* out;               // (B, out_rows, h*ncols), fp32 or bf16
  const float* prev;       // the earlier slabs' sum (fp32), or null
  float* part;             // split partials (fp32), or null
  long long part_stride;
  int m_rows;              // output rows (M) of this launch
  int m_by_valid;          // rows at or beyond the live keys are zeros
  int out_rows, out_row0, ncols;
  int k_chunks;            // chunks of K, or
  int k_by_valid;          // ... as many as the live keys fill
  int splits, m_tiles, n_tiles, tiles;
  float mul;
  int out_bf16;
};

struct GemmJobs {
  GemmJob j[3];
  int n;
  const int* valid;
  int valid_all, heads, lk;
};

constexpr int kGemmN = kGemmTile;   // output columns a warpgroup

template <typename E>
struct GemmTiles {
  static constexpr int kNC = kCopies<E>;
  static constexpr int kStages = kIsBf16<E> ? 4 : 3;
  static constexpr int kA = kGemmTile * kRowBytes;
  static constexpr int kB = kGemmN * kRowBytes;
  static constexpr int kStage = kNC * (kA + kB);
  static constexpr size_t kSmem =
      kStages * kStage + kStages * sizeof(uint64_t);
};

template <typename E>
__global__ void __launch_bounds__(256, 1)
    bwd_gemm_kernel(const GemmJobs jobs) {
  constexpr int NT = kGemmN;
  using T = GemmTiles<E>;
  constexpr int kNC = T::kNC, kS = T::kStages;
  constexpr int kKC = wg::kChunk<E>;
  constexpr int kR = NT / 2;
  extern __shared__ __align__(128) char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kS * T::kStage);

  int tile = blockIdx.x, ji = 0;
  while (ji + 1 < jobs.n && tile >= jobs.j[ji].tiles)
    tile -= jobs.j[ji++].tiles;
  const GemmJob& J = jobs.j[ji];
  const int split = tile / (J.m_tiles * J.n_tiles);
  const int mn = tile - split * J.m_tiles * J.n_tiles;
  const int m0 = (mn / J.n_tiles) * 128, n0 = (mn % J.n_tiles) * NT;
  const int tid = threadIdx.x;
  const int wgi = tid >> 7, warp = (tid >> 5) & 3;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const int bh = blockIdx.y;
  const int b = bh / jobs.heads, head = bh - b * jobs.heads;
  const int n_live = live_keys(jobs.valid, jobs.valid_all, b, jobs.lk);
  const int m_live = J.m_by_valid ? min(n_live, J.m_rows) : J.m_rows;
  const int kc = J.k_by_valid ? (n_live + kKC - 1) / kKC : J.k_chunks;
  const int per = (kc + J.splits - 1) / J.splits;
  const int c_begin = split * per;
  const int n_c = m0 < m_live ? max(0, min(kc, c_begin + per) - c_begin) : 0;

  if (tid == 0) {
    for (int i = 0; i < kS; ++i) wg::bar_init(&bars[i], 1);
    wg::bar_init_fence();
  }
  __syncthreads();
  const Packed pa{J.a[0], J.a[1], J.a_bh, J.a_chunk};
  const Packed pb{J.b[0], J.b[1], J.b_bh, J.b_chunk};
  auto load = [&](int i) {
    char* st = smem + (i % kS) * T::kStage;
    uint64_t* bar = &bars[i % kS];
    wg::bar_expect(bar, T::kStage);
    copy_tile<E>(st, pa, bh, c_begin + i, m0, 128, bar);
    copy_tile<E>(st + kNC * T::kA, pb, bh, J.b_chunk0 + c_begin + i, n0, NT,
                 bar);
  };
  if (tid == 0)
    for (int i = 0; i < kS && i < n_c; ++i) load(i);

  float acc[kR], part[kR];
  zero<kR>(acc);
  for (int i = 0; i < n_c; ++i) {
    wg::bar_wait(&bars[i % kS], (i / kS) & 1);
    const uint32_t st = wg::smem_u32(smem + (i % kS) * T::kStage);
    const uint32_t ua = st + wgi * 64 * kRowBytes;
    const uint32_t ub = st + kNC * T::kA;
    zero<kR>(part);
    wg::keep<kR>(part);
    wg::fence();
    wg::chunk_ss<E, NT>(part, nullptr, ua, ua + T::kA, ub, ub + T::kB, 4, 0);
    wg::commit();
    wg::wait<0>();
    wg::keep<kR>(part);
    fold<kR>(acc, part);
    __syncthreads();
    if (tid == 0 && i + kS < n_c) {
      wg::fence_async_smem();
      load(i + kS);
    }
  }

  const long long o_stride = (long long)jobs.heads * J.ncols;
  const bool partial = J.part != nullptr;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + wgi * 64 + warp * 16 + g + 8 * r;
    if (m >= J.m_rows) continue;
    const bool live = m < m_live;
    const long long o_row =
        ((long long)b * J.out_rows + J.out_row0 + m) * o_stride +
        (long long)head * J.ncols + n0;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (n0 + col >= J.ncols) continue;
      float x = 0.f, y = 0.f;
      if (live) {
        x = acc[4 * j + 2 * r];
        y = acc[4 * j + 2 * r + 1];
        if (!partial) {
          x *= J.mul;
          y *= J.mul;
          if (J.prev != nullptr) {
            const float2 old =
                *reinterpret_cast<const float2*>(J.prev + o_row + col);
            x += old.x;
            y += old.y;
          }
        }
      }
      if (partial)
        store2(J.part + split * J.part_stride, o_row + col, false, x, y);
      else
        store2(J.out, o_row + col, J.out_bf16 != 0, x, y);
    }
  }
}

// dq = scale * sum over splits of dq_part, in split order (deterministic),
// written in E
template <typename E>
__global__ void __launch_bounds__(256)
bwd_dq_sum_kernel(const float* __restrict__ part, E* __restrict__ dq,
                  long long n, int splits, float scale) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += (long long)gridDim.x * 256) {
    float t = 0.f;
    for (int s = 0; s < splits; ++s) t += part[s * n + i];
    if constexpr (kIsBf16<E>)
      dq[i] = __float2bfloat16_rn(t * scale);
    else
      dq[i] = t * scale;
  }
}

template <typename Kernel, typename A>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
           cudaStream_t stream, const A& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The plan's view of packed array `i` in the workspace `w`
template <typename E>
Packed packed(const long long* p, char* w, int i) {
  const long long* f = p + kArrays + 4 * i;
  return Packed{w + f[0], f[1] < 0 ? nullptr : w + f[1],
                f[2] * f[3] * (long long)sizeof(E), f[2] * kRowBytes};
}

template <typename E>
PackJob pack_job(const long long* p, char* w, int i, const void* src,
                 long long sb, long long sl, int tokens, int width,
                 int transposed, int perm) {
  const long long* f = p + kArrays + 4 * i;
  return PackJob{src, sb, sl, w + f[0], f[1] < 0 ? nullptr : w + f[1],
                 tokens, width, (int)f[2], (int)f[3], transposed, perm};
}

template <typename E>
int gemm_launch(const GemmJobs& jobs, int bh, cudaStream_t s) {
  int tiles = 0;
  for (int i = 0; i < jobs.n; ++i) tiles += jobs.j[i].tiles;
  if (tiles == 0) return 0;
  return launch(bwd_gemm_kernel<E>, dim3(tiles, bh), 256, GemmTiles<E>::kSmem,
                s, jobs);
}

template <typename E>
GemmJob gemm_job(const Packed& pa, const Packed& pb, int b_chunk0, void* out,
                 const float* prev, float* part, long long part_stride,
                 int m_rows, int m_by_valid, int out_rows, int out_row0,
                 int ncols, int k_chunks, int k_by_valid, int splits,
                 float mul, int out_bf16) {
  GemmJob j{};
  j.a[0] = pa.hi;
  j.a[1] = pa.lo;
  j.a_bh = pa.bh_bytes;
  j.a_chunk = pa.chunk_bytes;
  j.b[0] = pb.hi;
  j.b[1] = pb.lo;
  j.b_bh = pb.bh_bytes;
  j.b_chunk = pb.chunk_bytes;
  j.b_chunk0 = b_chunk0;
  j.out = out;
  j.prev = prev;
  j.part = part;
  j.part_stride = part_stride;
  j.m_rows = m_rows;
  j.m_by_valid = m_by_valid;
  j.out_rows = out_rows;
  j.out_row0 = out_row0;
  j.ncols = ncols;
  j.k_chunks = k_chunks;
  j.k_by_valid = k_by_valid;
  j.splits = splits;
  j.m_tiles = (m_rows + 127) / 128;
  j.n_tiles = (ncols + kGemmN - 1) / kGemmN;
  j.tiles = j.m_tiles * j.n_tiles * splits;
  j.mul = mul;
  j.out_bf16 = out_bf16;
  return j;
}

template <typename E>
int bwd(const long long* p, const void* q, const void* k, const void* v,
        const void* valid, const void* dout, const void* lse,
        const void* out, void* dq, void* dk, void* dv, void* work,
        float scale, cudaStream_t s) {
  constexpr bool kBf16 = kIsBf16<E>;
  constexpr int kKC = wg::kChunk<E>;
  const int batch = (int)p[kB], heads = (int)p[kH], lq = (int)p[kLq],
            lk = (int)p[kLk], d = (int)p[kD], dvw = (int)p[kDv];
  const int bh = batch * heads, splits = (int)p[kSplits];
  const bool one_pass = p[kForm] == 0;
  if (batch < 1 || heads < 1 || lq < 1 || lk < 1 || d < 1 || dvw < 1 ||
      splits < 1 || (splits > 1) != (p[kDqPart] >= 0) ||
      one_pass != is_one_pass(d, dvw) ||
      (!one_pass && (p[kSlab] < 128 || p[kSlab] % 128 != 0 || p[kGroups] < 1)))
    return (int)cudaErrorInvalidValue;
  char* w = static_cast<char*>(work);
  const int* vp = static_cast<const int*>(valid);
  const int valid_all = (int)p[kValidAll];
  const long long do_sl = (long long)heads * dvw;
  const long long do_sb = (long long)lq * do_sl;
  float* dq_part = p[kDqPart] >= 0 ? (float*)(w + p[kDqPart]) : nullptr;
  const long long split_stride = (long long)batch * lq * heads * d;

  // pack q, k, v and dO into the layouts the products read
  PackJobs pj{};
  pj.heads = heads;
  pj.bh = bh;
  const int perm = one_pass && !kBf16 ? 1 : 0;
  pj.j[0] = pack_job<E>(p, w, aQ, q, p[kQsb], p[kQsl], lq, d, 0, 0);
  pj.j[1] = pack_job<E>(p, w, aK, k, p[kKsb], p[kKsl], lk, d, 0, 0);
  pj.j[2] = pack_job<E>(p, w, aV, v, p[kVsb], p[kVsl], lk, dvw, 0, 0);
  pj.j[3] = pack_job<E>(p, w, aDO, dout, do_sb, do_sl, lq, dvw, 0, 0);
  pj.j[4] = pack_job<E>(p, w, aQT, q, p[kQsb], p[kQsl], lq, d, 1, perm);
  pj.j[5] = pack_job<E>(p, w, aKT, k, p[kKsb], p[kKsl], lk, d, 1, perm);
  pj.j[6] = pack_job<E>(p, w, aDOT, dout, do_sb, do_sl, lq, dvw, 1, perm);
  long long most = 0;
  for (int i = 0; i < 7; ++i) {
    const long long units = (long long)bh * pj.j[i].rows_p * pj.j[i].cols_p /
                            (16 / (int)sizeof(E));
    most = units > most ? units : most;
  }
  const int pack_blocks = (int)((most + 255) / 256 < 2048 ? (most + 255) / 256
                                                          : 2048);
  int err = launch(bwd_pack_kernel<E>, dim3(pack_blocks, 7), 256, 0, s, pj);
  if (err != 0) return err;
  float* delta = (float*)(w + p[kDelta]);
  const long long d_rows = (long long)batch * lq * heads;
  bwd_delta_kernel<E><<<(unsigned)((d_rows + 7) / 8), 256, 0, s>>>(
      static_cast<const E*>(dout), static_cast<const E*>(out), p[kOutSb],
      p[kOutSl], delta, batch, lq, heads, dvw);
  err = (int)cudaGetLastError();
  if (err != 0) return err;

  if (one_pass) {
    RowsArgs<E> a{};
    a.valid = vp;
    a.lse = static_cast<const float*>(lse);
    a.delta = delta;
    a.heads = heads;
    a.lq = lq;
    a.lk = lk;
    a.d = d;
    a.dv = dvw;
    a.valid_all = valid_all;
    a.scale = scale;
    a.split_stride = split_stride;
    constexpr int kCT = RowsTiles<E>::kCT;
    const int key_tiles = (lk + kCT - 1) / kCT;
    // dQ: rows of queries, columns of keys
    a.r1 = packed<E>(p, w, aQ);
    a.r2 = packed<E>(p, w, aDO);
    a.c1 = packed<E>(p, w, aK);
    a.c2 = packed<E>(p, w, aV);
    a.c1t = packed<E>(p, w, aKT);
    a.c2t = a.c1t;
    a.out1 = static_cast<E*>(dq);
    a.dq_part = dq_part;
    a.tiles_per_split = (key_tiles + splits - 1) / splits;
    err = launch(bwd_rows_kernel<E, false>, dim3(bh, (lq + 63) / 64, splits),
                 128, RowsTiles<E>::kSmem, s, a);
    if (err != 0) return err;
    // dK and dV: rows of keys, columns of queries
    a.r1 = packed<E>(p, w, aK);
    a.r2 = packed<E>(p, w, aV);
    a.c1 = packed<E>(p, w, aQ);
    a.c2 = packed<E>(p, w, aDO);
    a.c1t = packed<E>(p, w, aQT);
    a.c2t = packed<E>(p, w, aDOT);
    a.out1 = static_cast<E*>(dk);
    a.out2 = static_cast<E*>(dv);
    a.dq_part = nullptr;
    err = launch(bwd_rows_kernel<E, true>, dim3(bh, (lk + 63) / 64, 1), 128,
                 RowsTiles<E>::kSmem, s, a);
    if (err != 0) return err;
  } else {
    const int slab = (int)p[kSlab];
    const int lkp = (int)p[kArrays + 4 * aPT + 2];
    ScoreArgs<E> sa{};
    sa.q = packed<E>(p, w, aQ);
    sa.k = packed<E>(p, w, aK);
    sa.dout = packed<E>(p, w, aDO);
    sa.v = packed<E>(p, w, aV);
    const Packed ppt = packed<E>(p, w, aPT), pdst = packed<E>(p, w, aDST),
                 pds = packed<E>(p, w, aDS);
    sa.pt[0] = const_cast<char*>(ppt.hi);
    sa.pt[1] = const_cast<char*>(ppt.lo);
    sa.dst[0] = const_cast<char*>(pdst.hi);
    sa.dst[1] = const_cast<char*>(pdst.lo);
    sa.ds[0] = const_cast<char*>(pds.hi);
    sa.ds[1] = const_cast<char*>(pds.lo);
    sa.kept_bh = ppt.bh_bytes;
    sa.lkp = lkp;
    sa.slab = slab;
    sa.heads = heads;
    sa.lq = lq;
    sa.lk = lk;
    sa.d = d;
    sa.dv = dvw;
    sa.valid_all = valid_all;
    sa.valid = vp;
    sa.lse = static_cast<const float*>(lse);
    sa.delta = delta;
    sa.scale = scale;
    const int groups = (int)p[kGroups];
    const int key_tiles =
        (lk + ScoreTiles<E>::kKT - 1) / ScoreTiles<E>::kKT;
    sa.tiles_per_group = (key_tiles + groups - 1) / groups;
    const Packed pdot = packed<E>(p, w, aDOT), pqt = packed<E>(p, w, aQT),
                 pkt = packed<E>(p, w, aKT);
    float* acc = p[kAcc] >= 0 ? (float*)(w + p[kAcc]) : nullptr;
    float* acc_dv = acc;
    float* acc_dk = acc != nullptr ? acc + (long long)batch * lk * heads * dvw
                                   : nullptr;
    for (int r0 = 0; r0 < lq && err == 0; r0 += slab) {
      const int rows = lq - r0 < slab ? lq - r0 : slab;
      const bool first = r0 == 0, last = r0 + slab >= lq;
      sa.row0 = r0;
      const dim3 sgrid(bh, (rows + 127) / 128, groups);
      err = d > 32 ? launch(bwd_scores_kernel<E, !kBf16>, sgrid, 256,
                            ScoreTiles<E>::kSmem, s, sa)
                   : launch(bwd_scores_kernel<E, false>, sgrid, 256,
                            ScoreTiles<E>::kSmem, s, sa);
      if (err != 0) break;
      // fp32: each slab adds to the output in place; bf16: to the fp32
      // sums, the last slab writing bf16
      void* out_v = kBf16 && !last ? (void*)acc_dv : dv;
      void* out_k = kBf16 && !last ? (void*)acc_dk : dk;
      const float* prev_v =
          first ? nullptr : kBf16 ? acc_dv : (const float*)dv;
      const float* prev_k =
          first ? nullptr : kBf16 ? acc_dk : (const float*)dk;
      const int bf_out = kBf16 && last ? 1 : 0;
      const int kq = (rows + kKC - 1) / kKC;   // chunks of the slab's queries
      const GemmJob jv = gemm_job<E>(ppt, pdot, r0 / kKC, out_v, prev_v,
                                     nullptr, 0, lk, 1, lk, 0, dvw, kq, 0, 1,
                                     1.f, bf_out);
      const GemmJob jk = gemm_job<E>(pdst, pqt, r0 / kKC, out_k, prev_k,
                                     nullptr, 0, lk, 1, lk, 0, d, kq, 0, 1,
                                     scale, bf_out);
      const GemmJob jq = gemm_job<E>(pds, pkt, 0, dq, nullptr, dq_part,
                                     split_stride, rows, 0, lq, r0, d, 0, 1,
                                     splits, scale, kBf16 ? 1 : 0);
      GemmJobs gj{};
      gj.valid = vp;
      gj.valid_all = valid_all;
      gj.heads = heads;
      gj.lk = lk;
      gj.j[0] = jv;
      gj.j[1] = jk;
      gj.j[2] = jq;
      gj.n = 3;
      err = gemm_launch<E>(gj, bh, s);
    }
    if (err != 0) return err;
  }
  if (splits == 1) return 0;
  const long long n = split_stride;
  const long long blocks = (n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024;
  bwd_dq_sum_kernel<E><<<(int)blocks, 256, 0, s>>>(dq_part, (E*)dq, n, splits,
                                                   scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound from Python with ctypes: flash_attn_bwd for
// fp32 q, k, v, dout and gradients, flash_attn_bwd_bf16 for bf16 ones (lse
// and delta fp32 in both). `plan` holds kPlanLen integers in PlanField
// order as flash_attn_bwd_plan (flash_attn_bwd_plan.h) filled it for
// this shape and dtype, and `work` is the workspace of the size it
// returned (the packed operands, the kept P and dS of a slab, dQ's split
// partials, the bf16 slabs' fp32 sums and D, at the byte offsets it
// gives). Strides are in elements. Launches the kernels on `stream` in
// order and returns the first non-zero cudaGetLastError() (0 on success),
// or cudaErrorInvalidValue for a plan it does not take; allocates nothing.
// Every output element is written (zeros where no live key reaches it).
extern "C" int flash_attn_bwd(const long long* plan, const void* q,
                              const void* k, const void* v, const void* valid,
                              const void* dout, const void* lse,
                              const void* out, void* dq, void* dk, void* dv,
                              void* work, float scale, void* stream) {
  return bwd<float>(plan, q, k, v, valid, dout, lse, out, dq, dk, dv, work,
                    scale, (cudaStream_t)stream);
}

extern "C" int flash_attn_bwd_bf16(const long long* plan, const void* q,
                                   const void* k, const void* v,
                                   const void* valid, const void* dout,
                                   const void* lse, const void* out,
                                   void* dq, void* dk, void* dv, void* work,
                                   float scale, void* stream) {
  return bwd<bf16>(plan, q, k, v, valid, dout, lse, out, dq, dk, dv, work,
                   scale, (cudaStream_t)stream);
}
