// Flash-attention forward for Hopper (sm_90a), fp32-accurate on the TF32
// tensor cores.
//
// Replaces aot_tpu/ops/pallas/flash_attn_vjp.py:51 _fwd_kernel, the TPU
// kernel behind _flash_fwd_raw (:211) and flash_attention (:338), which
// serves the global attention over a long-term memory ring once it holds
// many keys, and every global attention of training. Same function, at the
// port's public layout (no head-major copy, no padding):
//   q      (B, Lq, h*d)   rows of h*d floats, batch/row strides given
//   k      (B, Lk, h*d)   likewise
//   v      (B, Lk, h*dv)  likewise
//   valid  (B,) int32 live key counts, or null (then `valid_all` for all)
//   out    (B, Lq, h*dv)  contiguous
//   lse    (B*h, Lq)      log-sum-exp of the scaled scores over live keys
// For each (b, head, query) over the live keys j < min(valid[b], Lk):
//   s_j = (q * scale) . k_j;  out = sum_j softmax(s)_j v_j;  lse = logsumexp(s)
// A row with no live key gives out 0 and lse -1e30, as the TPU kernel does
// (:89-96). fp32 in, out and accumulation. The TPU kernel computes at
// Precision.HIGHEST (:41-43), so both products, S = (scale q) K^T and P V,
// run as three TF32 tensor-core products each (3xTF32, tf32x3.cuh).
//
// Design, one pass (dv <= 128: AOT's heads, every attention of training).
// A block of 4 warps takes one (b*h, 64-query tile, key split) and all of
// dv (one value tile of 32 or 128 columns); each warp owns 16 query rows. The key loop runs over 32- or
// 64-key tiles and stops at the live length, so dead keys are never read
// and the ragged last tile is masked. K and V tiles go through a ring of
// two stages in shared memory, filled with cp.async: the next tile's
// copies are in flight while this tile's products run. A warp computes its
// 16 x BK score tile with mma.sync m16n8k8 (3xTF32), keeps it in the
// accumulator registers, runs the online softmax there (a thread holds
// parts of two rows; a row's max and sum are reduced over the 4 threads of
// a quad with shuffles) and feeds the probabilities from the same
// registers into P V as A fragments (the key order inside each 8-key block
// is permuted the same way on both sides, see tf32x3::a_from_acc). Each
// tile's P V goes into its own accumulator fragment and is folded once per
// tile, acc = acc * alpha + pv: a running fp32 sum over ~20,000 near-equal
// weights (one add per key, or per 8-key mma step) cost 2.8e-4 of error in
// the first fp32 version of this kernel, beyond the 1e-4 gate; the row sum
// l is folded per tile likewise. For d > 32 the score's large term is kept
// apart from its small ones (tf32x3::mma3_apart), as pass 1 below and the
// backward compute it.
// Where the grid is under two blocks an SM, the key loop is split over
// `splits` blocks; each writes its partial (out_i, lse_i) and merge_kernel
// combines them in split order,
//   lse = logsumexp_i lse_i,  out = sum_i exp(lse_i - lse) out_i,
// so the result does not depend on which block ran first.
//
// Design, two passes (dv > 128: DeAOT's dv = 1024). A 64 x 1024 fp32
// accumulator (256 KB) fits no block, so dv is tiled over the grid, and in
// one pass each value tile would recompute the scores (at d = 128 and a
// 256-column tile, a quarter of the products again, 3 x 45.9 GFLOP more a
// 107,136-key read). score_kernel computes the scaled scores once into a
// scratch with each key split's row max and sum (3xTF32 mma.sync, as
// above); pv_kernel takes lse from those and computes out = exp(S - lse) V
// over 256-column value tiles on wgmma, reading the scores back through
// L2. The two passes run over slabs of `slab` query rows (a multiple of 64,
// the wrapper's choice), one slab after the other, so the scratch is
// bounded; each pass splits its key loop to fill the card, and the
// wrapper picks the slab and the P V splits together so that a slab's P V
// grid fills whole waves of one block a multiprocessor (a DeAOTL read at
// 480p, Lq = 1,674 over 107,136 keys: 9 slabs of 192 rows, 3 query tiles x
// 4 value tiles x 11 splits = 132 blocks). Each slab's output splits are
// added in order by sum_splits_kernel.
//
// pv_kernel's layout of V. A block is 64 query rows x 256 value columns,
// two warpgroups of 128 columns each, a key tile 32 keys. A ring of two
// stages is filled by TMA: the tile's V rows as one box (32 rows
// of 1 KB, as in memory) and its 64 score rows as one box (rows of 128
// bytes, 16-byte chunks XOR-swizzled over 8 rows, so that the A
// fragments' reads hit 32 banks). `.tf32` wgmma reads B K-major only, and
// P V sums over keys, so each thread takes one value column of the box and
// writes it transposed and split, once, as hi and lo TF32 copies in
// wgmma.cuh's packed layout: 8 columns x 4 keys a 128-byte core matrix,
// 1,024 bytes between groups of 8 columns (SBO), 128 between the two core
// matrices of an 8-key k-step (LBO); 64 KB a tile, into one of two buffers.
// Every query row of the block shares the split tile; neither copy exists
// in device memory. A warpgroup's product of a k-step is three m64n128k8
// products, lo hi + hi lo + hi hi, P's hi and lo from registers: P = exp2(S
// log2e - lse log2e) of the warpgroup's 64 rows, split in registers (each
// warpgroup exponentiates its own: a 64 x 256 accumulator with its
// per-tile fold would need 256 registers a thread, over the limit of 255,
// so a score is exponentiated 8 times a read). While tile i's products run,
// each thread splits its column of tile i + 1 and builds tile i + 1's P
// (straight-line code: ptxas serializes the products around any branch
// there); then tile i's products, summed apart, are added to the output in
// fp32. A warpgroup splits the columns it reads, so the two meet only when
// they release a ring stage: the second to release it refills it, so
// neither waits for the other. Shared memory: 2 x 64 KB split + 2 x 40 KB
// ring = 215 KB, one block a multiprocessor.
//
// What bounds it: arithmetic. P V at that read is 2 x 1,674 x 107,136 x
// 1,024 = 367 GFLOP, 2.23 ms at 165 TFLOP/s of fp32-accurate products
// (3xTF32: 495 / 3), 6.7 ms a frame of three reads. pv_kernel takes 4.6-4.7
// ms a read (48% of that bound; the mma.sync version took 10.05 ms), ~14
// ms a frame, on an H100 80GB HBM3 at 700 W. In the way, by timing the
// kernel with parts taken out: the products with their copies, fold and
// barriers alone take 2.7 ms (82% of the bound), the split of V and the
// building of P alone 2.9 ms, and the two overlap only to 4.6 ms. The
// split and P are latency-bound: two warps a scheduler, with 214 registers
// a thread (128 of them accumulators) leaving little room to keep loads in
// flight. A transposer warpgroup of its own (384 threads, setmaxnreg) ran
// 8.2 ms: ptxas held every thread to 168 registers and the consumers
// spilled. The one-pass
// fwd_kernel (mma.sync) is bound the same way: each operand element a warp
// reads costs a shared-memory load and four instructions for its split,
// and 305 TFLOP/s of TF32 is mma.sync's own rate on this card; at AOTT's
// training shape (B = 16, h = 8, Lq = Lk = 900, d = dv = 32) the bound is
// 0.080 ms and the kernel runs 0.37-0.44 ms.
//
// bf16 q, k and v go to flash_attn_fwd_bf16.cu (wgmma).

#include <cuda.h>   // CUtensorMap (the encoder is found at run time)
#include <cuda_runtime.h>

#include "bf16_mma.cuh"
#include "tf32x3.cuh"
#include "wgmma.cuh"

namespace {

using namespace tf32x3;
using namespace bf16mma;

constexpr int kBQ = 64;          // queries per block, 16 per warp
constexpr int kThreads = 128;    // 4 warps
constexpr int kMaxD = 256;       // q/k channels per head
constexpr float kNegInf = -1e30f;
constexpr float kEmptyLse = -1e29f;   // lse below this: no live key
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const int* valid;
  void* out;               // (B, Lq, h*dv), or the out partials of a split
  float* lse;              // (B*h, Lq), or the lse partials
  long long out_split;     // floats between two splits' partials of out
  long long lse_split;     // ... of lse
  int heads, lq, lk, d, dv, valid_all;
  int dv_tiles;            // pv_kernel: value-column tiles (gridDim.z =
                           // dv_tiles * splits); one pass: 1
  int tiles_per_split;     // key tiles of each split
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;
  float scale;
  // two passes: the slab's first query row and rows a slab, the scaled
  // scores of the slab (B*h*slab rows of `lds` floats) and each score
  // split's row max and sum (score_splits x B*h*Lq each)
  int row0;
  int slab;
  float* scores;
  long long lds;
  float* stat_m;
  float* stat_l;
  int score_splits;
  int score_tiles_per_split;
};

// D: q/k channels padded to 32, 128 or 256 (zero-filled); DVT: value
// columns a block; BK: keys a tile. Strides in elements of T.
template <typename T, int D, int DVT, int BK>
struct Tiles {
  // row strides = 4 mod 32 words, fragment reads hit 32 banks
  static constexpr int kPad = 4;
  static constexpr int kLdQ = D + kPad;
  static constexpr int kLdV = DVT + kPad;
  static constexpr int kQ = kBQ * kLdQ;
  static constexpr int kK = BK * kLdQ;
  static constexpr int kV = BK * kLdV;
  static constexpr size_t kSmem = sizeof(T) * (kQ + 2 * (kK + kV));
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One box of a 3-D (or 2-D) tensor map at coordinates (c0, c1, c2) into
// shared memory, completing on `bar`
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int c0, int c1, int c2,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          wg::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(wg::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_box_2d(void* dst, const CUtensorMap* map,
                                           int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          wg::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(wg::smem_u32(bar))
      : "memory");
}

template <typename E, int D, int DVT, int BK>
__global__ void __launch_bounds__(kThreads, 2) fwd_kernel(Args<E> a) {
  using T = Tiles<E, D, DVT, BK>;
  constexpr int kNB = BK / 8;     // 8-key blocks of a tile
  constexpr int kNV = DVT / 8;    // 8-column blocks of a value tile
  // the score's hi.hi term summed apart
  constexpr bool kApart = D > 32;
  extern __shared__ float4 smem4[];
  E* s_q = reinterpret_cast<E*>(smem4);
  E* s_k = s_q + T::kQ;           // two stages
  E* s_v = s_k + 2 * T::kK;       // two stages

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int bh = blockIdx.x;
  const int b = bh / a.heads;
  const int head = bh % a.heads;
  const int q0 = blockIdx.y * kBQ;
  const int split = blockIdx.z;
  int n_live = a.valid != nullptr ? a.valid[b] : a.valid_all;
  n_live = max(0, min(n_live, a.lk));
  const int k_begin = split * a.tiles_per_split * BK;
  const int k_end = min(n_live, k_begin + a.tiles_per_split * BK);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  const E* q_base = a.q + b * a.q_sb + (long long)head * a.d + q0 * a.q_sl;
  const E* k_base = a.k + b * a.k_sb + (long long)head * a.d;
  const E* v_base = a.v + b * a.v_sb + (long long)head * a.dv;

  stage<kBQ, D, T::kLdQ, kThreads>(s_q, q_base, a.q_sl, a.lq - q0, a.d);
  auto load_tile = [&](int i) {   // key tile i of this split -> stage i & 1
    const int k0 = k_begin + i * BK;
    stage<BK, D, T::kLdQ, kThreads>(s_k + (i & 1) * T::kK,
                                         k_base + k0 * a.k_sl, a.k_sl,
                                         k_end - k0, a.d);
    stage<BK, DVT, T::kLdV, kThreads>(s_v + (i & 1) * T::kV,
                                           v_base + k0 * a.v_sl, a.v_sl,
                                           k_end - k0, a.dv);
  };
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();

  // rows g and g + 8 of the warp's 16: running max, sum and output
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kNV][4];
#pragma unroll
  for (int n = 0; n < kNV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // a warp whose rows all lie beyond Lq skips the products (warp-uniform)
  const bool active = q0 + warp * 16 < a.lq;
  const int k_steps = (a.d + 7) / 8;
  const E* q_frag = s_q + (warp * 16 + g) * T::kLdQ + t;

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_tile(i + 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile i (and the q tile) have landed
    __syncthreads();
    if (active) {
      const E* tk = s_k + (i & 1) * T::kK;
      const E* tv = s_v + (i & 1) * T::kV;
      float s[kNB][4], s_small[kApart ? kNB : 1][4];
#pragma unroll
      for (int n = 0; n < kNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      if constexpr (kApart) {
#pragma unroll
        for (int n = 0; n < kNB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s_small[n][e] = 0.f;
      }
      // S = Q K^T: A = q rows, B(k = channel, n = key) = k rows
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        if (ks < k_steps) {
          const E* qa = q_frag + ks * 8;
          const FragA fa = frag_a(qa[0], qa[8 * T::kLdQ], qa[4],
                                  qa[8 * T::kLdQ + 4]);
#pragma unroll
          for (int n = 0; n < kNB; ++n) {
            const E* kb = tk + (n * 8 + g) * T::kLdQ + ks * 8 + t;
            if constexpr (kApart)
              mma3_apart(s[n], s_small[n], fa, frag_b(kb[0], kb[4]));
            else
              mma3(s[n], fa, frag_b(kb[0], kb[4]));
          }
        }
      }

      if constexpr (kApart) {
#pragma unroll
        for (int n = 0; n < kNB; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] += s_small[n][e];
      }
      // scale and mask; this tile holds a live key (k0 < k_end), so the
      // new max is finite and exp2(-1e30 * log2e - ...) is exactly 0
      const int k0 = k_begin + i * BK;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < kNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          s[n][e] = key < k_end ? s[n][e] * a.scale : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
      }
#pragma unroll
      for (int n = 0; n < kNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2f((s[n][e] - m[e >> 1]) * kLog2e);
          rs[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);

      // pv = P V for this tile alone: A = P from the score registers,
      // B(k = key, n = value column) = v rows 2t and 2t + 1 of each block
      float pv[kNV][4];
#pragma unroll
      for (int n = 0; n < kNV; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
      for (int kb = 0; kb < kNB; ++kb) {
        const FragA fp = a_from_acc(s[kb]);
        const E* vb = tv + (kb * 8 + 2 * t) * T::kLdV + g;
#pragma unroll
        for (int n = 0; n < kNV; ++n)
          mma3(pv[n], fp, frag_b(vb[n * 8], vb[T::kLdV + n * 8]));
      }

#pragma unroll
      for (int n = 0; n < kNV; ++n) {
        acc[n][0] = fmaf(acc[n][0], alpha[0], pv[n][0]);
        acc[n][1] = fmaf(acc[n][1], alpha[0], pv[n][1]);
        acc[n][2] = fmaf(acc[n][2], alpha[1], pv[n][2]);
        acc[n][3] = fmaf(acc[n][3], alpha[1], pv[n][3]);
      }
    }
    __syncthreads();   // every warp is done with stage i & 1
  }
  cp_async_wait<0>();

  if (!active) return;
  const long long o_stride = (long long)a.heads * a.dv;
  float* lse = a.lse + split * a.lse_split + (long long)bh * a.lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= a.lq) continue;
    const bool empty = l[r] == 0.f;
    const long long o_row = split * a.out_split +
                            ((long long)b * a.lq + row) * o_stride +
                            (long long)head * a.dv;
#pragma unroll
    for (int n = 0; n < kNV; ++n) {
      const int col = n * 8 + 2 * t;   // dv % 4 == 0: both columns or none
      if (col < a.dv)
        store2(a.out, o_row + col, false,
               empty ? 0.f : acc[n][2 * r] / l[r],
               empty ? 0.f : acc[n][2 * r + 1] / l[r]);
    }
    if (t == 0) lse[row] = empty ? kNegInf : m[r] + logf(l[r]);
  }
}

// Merge the key splits' partials in split order: out and lse of each
// (b, query, head) from (out_i, lse_i), i < splits. An empty split has
// lse_i = -1e30 and out_i = 0 and weighs exactly 0; a row with no live key
// in any split gives out 0 and lse -1e30.
__global__ void __launch_bounds__(256)
merge_kernel(const float* __restrict__ part, const float* __restrict__ part_lse,
             void* __restrict__ out, float* __restrict__ lse, int splits,
             int heads, int lq, int dv, long long n4, long long out_split,
             long long lse_split) {
  const int hd = heads * dv;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n4;
       i += (long long)gridDim.x * 256) {
    const long long e = i * 4;
    const long long row = e / hd;               // b * Lq + query
    const int col = (int)(e - row * hd);
    const int head = col / dv;
    const long long b = row / lq;
    const long long li = (b * heads + head) * lq + (row - b * lq);
    float mx = kNegInf;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_lse[s * lse_split + li]);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    float total = kNegInf;
    if (mx > kEmptyLse) {
      float sum = 0.f;
      for (int s = 0; s < splits; ++s) sum += expf(part_lse[s * lse_split + li] - mx);
      total = mx + logf(sum);
      for (int s = 0; s < splits; ++s) {
        const float w = expf(part_lse[s * lse_split + li] - total);
        const float4 x = *reinterpret_cast<const float4*>(part + s * out_split + e);
        o.x = fmaf(w, x.x, o.x);
        o.y = fmaf(w, x.y, o.y);
        o.z = fmaf(w, x.z, o.z);
        o.w = fmaf(w, x.w, o.w);
      }
    }
    store2(out, e, false, o.x, o.y);
    store2(out, e + 2, false, o.z, o.w);
    if (col % dv == 0) lse[li] = total;
  }
}


// Two passes, for value widths above one tile (DeAOT's dv = 1024), where a
// single pass would recompute the scores once per value tile.
// Pass 1: the scaled scores S of a 64-query tile of the slab over one split
// of the live keys, written to `scores`, and the split's row max and sum of
// exp(S - max) (folded per 64-key tile). 4 warps, 16 rows each; K through a
// cp.async ring.
constexpr int kBKS = 64;   // keys a tile, pass 1
constexpr int kBKP = 32;   // keys a tile, pass 2

template <typename E, int D>
struct ScoreTiles {
  static constexpr int kLd = D + 4;
  static constexpr int kQ = kBQ * kLd;
  static constexpr int kK = kBKS * kLd;
  static constexpr size_t kSmem = sizeof(E) * (kQ + 2 * kK);
};

template <typename E, int D>
__global__ void __launch_bounds__(kThreads, 2) score_kernel(Args<E> a) {
  using T = ScoreTiles<E, D>;
  constexpr int kNB = kBKS / 8;
  extern __shared__ float4 smem4[];
  E* s_q = reinterpret_cast<E*>(smem4);
  E* s_k = s_q + T::kQ;           // two stages

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int bh = blockIdx.x;
  const int b = bh / a.heads;
  const int head = bh % a.heads;
  const int q0 = a.row0 + blockIdx.y * kBQ;
  const int split = blockIdx.z;
  int n_live = a.valid != nullptr ? a.valid[b] : a.valid_all;
  n_live = max(0, min(n_live, a.lk));
  const int k_begin = split * a.score_tiles_per_split * kBKS;
  const int k_end = min(n_live, k_begin + a.score_tiles_per_split * kBKS);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBKS - 1) / kBKS : 0;

  const E* q_base = a.q + b * a.q_sb + (long long)head * a.d + q0 * a.q_sl;
  const E* k_base = a.k + b * a.k_sb + (long long)head * a.d;
  stage<kBQ, D, T::kLd, kThreads>(s_q, q_base, a.q_sl, a.lq - q0, a.d);
  auto load_tile = [&](int i) {
    const int k0 = k_begin + i * kBKS;
    stage<kBKS, D, T::kLd, kThreads>(s_k + (i & 1) * T::kK,
                                          k_base + k0 * a.k_sl, a.k_sl,
                                          k_end - k0, a.d);
  };
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const bool active = q0 + warp * 16 < a.lq;
  const int k_steps = (a.d + 7) / 8;
  const E* q_frag = s_q + (warp * 16 + g) * T::kLd + t;
  const int row0 = q0 + warp * 16 + g;
  float* s_row0 =
      a.scores + ((long long)bh * a.slab + row0 - a.row0) * a.lds;
  float* s_row1 = s_row0 + 8 * a.lds;

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_tile(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const E* tk = s_k + (i & 1) * T::kK;
      float s[kNB][4], s_small[kNB][4];
#pragma unroll
      for (int n = 0; n < kNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = s_small[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) {
        if (ks < k_steps) {
          const E* qa = q_frag + ks * 8;
          const FragA fa = frag_a(qa[0], qa[8 * T::kLd], qa[4],
                                  qa[8 * T::kLd + 4]);
#pragma unroll
          for (int n = 0; n < kNB; ++n) {
            const E* kb = tk + (n * 8 + g) * T::kLd + ks * 8 + t;
            mma3_apart(s[n], s_small[n], fa, frag_b(kb[0], kb[4]));
          }
        }
      }

#pragma unroll
      for (int n = 0; n < kNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += s_small[n][e];
      const int k0 = k_begin + i * kBKS;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < kNB; ++n) {
        const int key = k0 + n * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = key + (e & 1) < k_end ? s[n][e] * a.scale : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
        // key even, split bounds a multiple of 64: key + 1 < lds, and no
        // other block writes it
        if (key < k_end) {
          if (row0 < a.lq)
            *reinterpret_cast<float2*>(s_row0 + key) = make_float2(s[n][0], s[n][1]);
          if (row0 + 8 < a.lq)
            *reinterpret_cast<float2*>(s_row1 + key) = make_float2(s[n][2], s[n][3]);
        }
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
      }
#pragma unroll
      for (int n = 0; n < kNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rs[e >> 1] += exp2f((s[n][e] - m[e >> 1]) * kLog2e);
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  if (!active || t != 0) return;
  const long long st = ((long long)split * gridDim.x + bh) * a.lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row < a.lq) {
      a.stat_m[st + row] = m[r];
      a.stat_l[st + row] = l[r];
    }
  }
}

// Pass 2: out = exp(S - lse) V for a 64-query tile of the slab, one value
// tile of kPvCols columns and one split of the live keys, lse from pass 1's
// statistics (so no running rescale). Two warpgroups, each the tile's 64
// rows over 128 of its columns, on wgmma (3xTF32, P from registers, V from
// shared memory). A ring of two stages is filled by tensor-map copies
// (TMA): a stage is one key tile's V rows (a box of kPvCols x 32
// floats) and its 64 score rows (a box of 32 x 64 floats, its 16-byte
// chunks XOR-swizzled by TMA in atoms of 8 rows of 128 bytes, so that the
// A fragments' reads hit 32 banks). Each thread splits one column of each
// V tile once into hi and lo TF32 copies of V^T, K-major in wgmma.cuh's
// packed layout, into one of two buffers, and builds the next tile's P,
// while the products of this tile run from the other buffer. A column is
// split by a thread of the warpgroup that reads it, so the two warpgroups
// meet only where a ring stage is released: thread 0 issues the first
// copies, and the second warpgroup to release a stage refills it.
// Each tile's P V is summed in its own accumulator and added to the output
// in fp32.
constexpr int kPvCols = 256;      // value columns a block
constexpr int kPvThreads = 256;   // two warpgroups
constexpr int kPvStages = 2;

// V (columns, keys, batch) and the slab's scores (keys, B*h*slab rows)
struct PvMaps {
  CUtensorMap v, s;
};

struct PvTiles {
  static constexpr int kHalf = kPvCols * kBKP * 4;   // bytes of hi (or lo)
  static constexpr int kSplit = 2 * kHalf;           // a split V tile
  static constexpr int kRawV = kBKP * kPvCols * 4;   // a stage's V box
  static constexpr int kStage = kRawV + kBQ * kBKP * 4;
  // the split buffers, the ring, its barriers and release counts
  static constexpr size_t kSmem = 2 * kSplit + kPvStages * kStage +
                                  kPvStages * (sizeof(uint64_t) + 4);
};

template <typename E>
__global__ void __launch_bounds__(kPvThreads, 1)
    pv_kernel(Args<E> a, const __grid_constant__ PvMaps maps) {
  static_assert(sizeof(E) == 4, "fp32 values");
  using T = PvTiles;
  using Frag = uint32_t[kBKP / 8][4];   // A fragments of a tile's k-steps
  constexpr int kR = 64;   // accumulators a thread: 64 rows x 128 columns
  extern __shared__ __align__(1024) char smem[];   // the swizzle's atom
  char* ring = smem + 2 * T::kSplit;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kPvStages * T::kStage);
  unsigned* released = reinterpret_cast<unsigned*>(full + kPvStages);

  const int tid = threadIdx.x;
  const int wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / a.heads;
  const int head = bh % a.heads;
  const int q0 = a.row0 + blockIdx.y * kBQ;
  const int vt = blockIdx.z % a.dv_tiles;
  const int split = blockIdx.z / a.dv_tiles;
  const int c0 = vt * kPvCols;
  const int ncols = min(kPvCols, a.dv - c0);
  int n_live = a.valid != nullptr ? a.valid[b] : a.valid_all;
  n_live = max(0, min(n_live, a.lk));
  const int k_begin = split * a.tiles_per_split * kBKP;
  const int k_end = min(n_live, k_begin + a.tiles_per_split * kBKP);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBKP - 1) / kBKP : 0;

  // the slab is a multiple of 64 rows: this tile's rows lie in it
  const int s_row = bh * a.slab + q0 - a.row0;
  if (tid == 0) {
    for (int i = 0; i < kPvStages; ++i) {
      wg::bar_init(&full[i], 1);
      released[i] = 0;
    }
    wg::bar_init_fence();
  }
  __syncthreads();
  // key tile i's boxes into stage i % kPvStages (keys past Lk and columns
  // past h*dv read 0; dead keys' scores and V rows are read, never used)
  auto load = [&](int i) {
    char* st = ring + (i % kPvStages) * T::kStage;
    uint64_t* bar = &full[i % kPvStages];
    const int k0 = k_begin + i * kBKP;
    wg::fence_async_smem();
    wg::bar_expect(bar, T::kStage);
    tma_box(st, &maps.v, head * a.dv + c0, k0, b, bar);
    tma_box_2d(st + T::kRawV, &maps.s, k0, s_row, bar);
  };
  if (tid == 0)
    for (int i = 0; i < kPvStages && i < n_tiles; ++i) load(i);

  // lse of rows g and g + 8 from the score splits' (max, sum)
  const int row0 = q0 + warp * 16 + g;
  float lse2[2];
  bool live_r[2];
  const long long bhl = (long long)gridDim.x * a.lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    float total = kNegInf;
    if (row < a.lq) {
      const long long i0 = (long long)bh * a.lq + row;
      float mx = kNegInf;
      for (int sp = 0; sp < a.score_splits; ++sp)
        mx = fmaxf(mx, a.stat_m[sp * bhl + i0]);
      if (mx > kEmptyLse) {
        float sum = 0.f;
        for (int sp = 0; sp < a.score_splits; ++sp)
          sum += a.stat_l[sp * bhl + i0] * expf(a.stat_m[sp * bhl + i0] - mx);
        total = mx + logf(sum);
      }
      if (vt == 0 && split == 0 && wgi == 0 && t == 0) a.lse[i0] = total;
    }
    live_r[r] = total > kEmptyLse;
    lse2[r] = total * kLog2e;
  }

  // Key tile j, from its stage: split V^T once (thread = value column, 4
  // keys a 16-byte core-matrix row of hi and of lo; keys past the live ones
  // 0) into buffer j & 1, then build P = exp(S - lse) over the live keys
  // (unread scores are never selected), split into hi and lo, into the A
  // fragments ph, pl. Straight-line code: it runs while the products of
  // tile j - 1 are in flight, and ptxas serializes the products around any
  // branch there. Past the last tile it writes stale words into buffers
  // nothing reads.
  char* const split_at =
      smem + (tid >> 3) * wg::kGroupBytes + (tid & 7) * 16;
  auto prepare = [&](int j, Frag& ph, Frag& pl) {
    const char* st = ring + (j % kPvStages) * T::kStage;
    const int k0 = k_begin + j * kBKP;
    const int nk = k_end - k0;
    const float* src = reinterpret_cast<const float*>(st) + tid;
    char* dst = split_at + (j & 1) * T::kSplit;
#pragma unroll
    for (int c = 0; c < kBKP / 4; ++c) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = src[(4 * c + e) * kPvCols];
        hi[e] = tf32_hi(4 * c + e < nk ? x : 0.f);
        lo[e] = tf32_lo(4 * c + e < nk ? x : 0.f, hi[e]);
      }
      *reinterpret_cast<uint4*>(dst + c * wg::kChunkBytes) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(dst + T::kHalf + c * wg::kChunkBytes) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    wg::fence_async_smem();   // before the products read them
    // rows r = 16 warp + g and r + 8 (r % 8 = g): 16-byte chunk c of a row
    // lies at chunk c ^ g; element e of a k-step: row + 8 (e & 1), key
    // 8s + t + 4 (e >> 1)
    const char* ts = st + T::kRawV + (warp * 16 + g) * (kBKP * 4) + t * 4;
#pragma unroll
    for (int s = 0; s < kBKP / 8; ++s) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sv = *reinterpret_cast<const float*>(
            ts + (e & 1) * 8 * (kBKP * 4) + (((2 * s + (e >> 1)) ^ g) << 4));
        const bool ok = k0 + 8 * s + t + 4 * (e >> 1) < k_end && live_r[e & 1];
        const float x = exp2f(fmaf(sv, kLog2e, -lse2[e & 1]));
        const float p = ok ? x : 0.f;
        ph[s][e] = tf32_hi(p);
        pl[s][e] = tf32_lo(p, ph[s][e]);
      }
    }
  };

  float acc[kR], pv[kR];
#pragma unroll
  for (int n = 0; n < kR; ++n) acc[n] = pv[n] = 0.f;
  // this warpgroup's 128 columns of a split tile
  const uint32_t b_wg = wg::smem_u32(smem) + wgi * (128 / 8) * wg::kGroupBytes;
  // this warpgroup's threads wrote its half of a split tile: a barrier of
  // its own (1 + wgi; 0 is __syncthreads)
  auto wg_sync = [&]() {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
  };
  // Every thread of the warpgroup is done with tile j's stage (its columns
  // split, its scores taken) and its half of split tile j is whole. The
  // second warpgroup to get here refills the stage with tile j +
  // kPvStages, so neither waits for the other.
  auto release = [&](int j) {
    wg_sync();
    if ((tid & 127) == 0) {
      __threadfence_block();
      if ((atomicAdd(&released[j % kPvStages], 1u) & 1u) != 0 &&
          j + kPvStages < n_tiles)
        load(j + kPvStages);
    }
  };
  // Tile i: its products from ph, pl and split buffer i & 1; meanwhile tile
  // i + 1 into nh, nl and buffer (i + 1) & 1; then fold.
  auto step = [&](int i, Frag& ph, Frag& pl, Frag& nh, Frag& nl) {
    if (i + 1 < n_tiles)
      wg::bar_wait_bounded(&full[(i + 1) % kPvStages],
                           ((i + 1) / kPvStages) & 1);
    wg::keep_u<kBKP / 2>(&ph[0][0]);
    wg::keep_u<kBKP / 2>(&pl[0][0]);
    wg::fence();
    const uint32_t b_t = b_wg + (i & 1) * T::kSplit;
#pragma unroll
    for (int s = 0; s < kBKP / 8; ++s) {
      const uint64_t dh = wg::desc(b_t + s * wg::kStepBytes);
      const uint64_t dl = wg::desc(b_t + T::kHalf + s * wg::kStepBytes);
      wg::rs_tf32_n128(pv, pl[s], dh, s == 0 ? 0 : 1);
      wg::rs_tf32_n128(pv, ph[s], dl, 1);
      wg::rs_tf32_n128(pv, ph[s], dh, 1);
    }
    wg::commit();
    prepare(i + 1, nh, nl);
    wg::wait<0>();
    wg::keep<kR>(pv);
    // fold once a tile in fp32: the tensor core's own accumulation rounds
    // toward zero at every step (see tf32x3::mma3_apart)
#pragma unroll
    for (int n = 0; n < kR; ++n) acc[n] += pv[n];
    release(i + 1);
  };

  Frag p0_hi, p0_lo, p1_hi, p1_lo;
  if (n_tiles > 0) wg::bar_wait_bounded(&full[0], 0);
  prepare(0, p0_hi, p0_lo);
  release(0);
  for (int i = 0; i < n_tiles; i += 2) {
    step(i, p0_hi, p0_lo, p1_hi, p1_lo);
    if (i + 1 < n_tiles) step(i + 1, p1_hi, p1_lo, p0_hi, p0_lo);
  }

  const long long o_stride = (long long)a.heads * a.dv;
  const int wc = wgi * 128;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.lq) continue;
    // a split's partial holds a slab's rows (at most Lq)
    const long long o_row =
        split * a.out_split +
        (a.out_split != 0 ? (long long)b * min(a.slab, a.lq) + row - a.row0
                          : (long long)b * a.lq + row) * o_stride +
        (long long)head * a.dv + c0 + wc;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * t;   // ncols % 4 == 0: both or none
      if (wc + col < ncols)
        store2(a.out, o_row + col, false, acc[4 * j + 2 * r],
               acc[4 * j + 2 * r + 1]);
    }
  }
}

// out's rows [row0, row0 + rows) of each batch element = the sum of pass
// 2's key splits of the slab (each B x prow rows of hd = h*dv floats), in
// split order
__global__ void __launch_bounds__(256)
sum_splits_kernel(const float* __restrict__ part, void* __restrict__ out,
                  int splits, int batch, int rows, int prow, int lq, int row0,
                  int hd) {
  const long long per_b = (long long)rows * hd;
  const long long n = batch * per_b;
  const long long split_stride = (long long)batch * prow * hd;
  for (long long i = 2 * (blockIdx.x * 256LL + threadIdx.x); i < n;
       i += 2LL * gridDim.x * 256) {
    const long long b = i / per_b, rest = i - b * per_b;   // hd even
    const long long src = b * prow * hd + rest;
    float x = 0.f, y = 0.f;
    for (int s = 0; s < splits; ++s) {
      x += part[s * split_stride + src];
      y += part[s * split_stride + src + 1];
    }
    store2(out, (b * lq + row0) * hd + rest, false, x, y);
  }
}


// cuTensorMapEncodeTiled, looked up at run time through the runtime's
// entry-point query (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// An fp32 tensor map of `rank` dims (sizes dims, byte strides of dims 1..,
// boxes `box`), zeros outside the tensor
bool make_map(CUtensorMap* map, const void* base, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encoder();
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// pv_kernel's maps: v as (h*dv columns, Lk keys, B), the slab's scores as
// (lds keys, B*h*slab rows)
bool make_pv_maps(PvMaps* maps, const float* v, const float* scores,
                  int batch, int heads, int lk, int dv, long long v_sb,
                  long long v_sl, int slab, long long lds) {
  const long long rows = lk > 0 ? lk : 1;
  const cuuint64_t v_dims[3] = {(cuuint64_t)heads * dv, (cuuint64_t)rows,
                                (cuuint64_t)batch};
  const cuuint64_t v_strides[2] = {
      (cuuint64_t)v_sl * 4, (cuuint64_t)(batch > 1 ? v_sb : rows * v_sl) * 4};
  const cuuint32_t v_box[3] = {kPvCols, kBKP, 1};
  const cuuint64_t s_dims[2] = {(cuuint64_t)lds,
                                (cuuint64_t)batch * heads * slab};
  const cuuint64_t s_strides[1] = {(cuuint64_t)lds * 4};
  const cuuint32_t s_box[2] = {kBKP, kBQ};
  return make_map(&maps->v, v, 3, v_dims, v_strides, v_box,
                  CU_TENSOR_MAP_SWIZZLE_NONE) &&
         make_map(&maps->s, scores, 2, s_dims, s_strides, s_box,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename Kernel, typename E>
int launch_k(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
             const Args<E>& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename E, int D, int DVT, int BK>
int launch(const Args<E>& a, int batch, int splits, cudaStream_t stream) {
  const dim3 grid(batch * a.heads, (a.lq + kBQ - 1) / kBQ, splits);
  return launch_k(fwd_kernel<E, D, DVT, BK>, grid,
                  Tiles<E, D, DVT, BK>::kSmem, stream, a);
}

// the value tile, all of dv: 32 columns for AOT's heads, else 128 (one
// width of each kind on the paths; a narrower head runs zero-padded)
template <typename E, int D>
int launch_d(const Args<E>& a, int batch, int splits, cudaStream_t stream) {
  if (a.dv <= 32)
    return launch<E, D, 32, (D == 32 ? 64 : 32)>(a, batch, splits, stream);
  return launch<E, D, 128, 32>(a, batch, splits, stream);
}


// both passes over the `rows` query rows of the slab from a.row0
template <typename E, int D>
int launch_two_pass(const Args<E>& a, const PvMaps& maps, int batch,
                    int rows, int splits, cudaStream_t stream) {
  const int tiles = (rows + kBQ - 1) / kBQ;
  const dim3 s_grid(batch * a.heads, tiles, a.score_splits);
  int err = launch_k(score_kernel<E, D>, s_grid, ScoreTiles<E, D>::kSmem,
                     stream, a);
  if (err != 0) return err;
  const dim3 p_grid(batch * a.heads, tiles, a.dv_tiles * splits);
  cudaError_t e = cudaFuncSetAttribute(
      pv_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)PvTiles::kSmem);
  if (e != cudaSuccess) return (int)e;
  pv_kernel<E><<<p_grid, kPvThreads, PvTiles::kSmem, stream>>>(a, maps);
  return (int)cudaGetLastError();
}

template <typename E>
int fwd(const void* q, const void* k, const void* v, const void* valid,
        void* out, void* lse, void* part, int splits, int score_splits,
        int slab, int batch, int heads, int lq, int lk, int d, int dv,
        int valid_all, long long q_sb, long long q_sl, long long k_sb,
        long long k_sl, long long v_sb, long long v_sl, float scale,
        void* stream) {
  // elements of a 16-byte copy: widths and strides are multiples of it
  constexpr int kVec = 16 / sizeof(E);
  const bool two_pass = dv > 128;
  if (batch < 1 || heads < 1 || lq < 1 || lk < 0 || d < 4 || d > kMaxD ||
      d % 4 != 0 || dv < 4 || dv % 4 != 0 || d % kVec != 0 ||
      dv % kVec != 0 || splits < 1 ||
      (two_pass && (score_splits < 1 || slab < kBQ || slab % kBQ != 0 ||
                    part == nullptr)) ||
      (!two_pass && (splits > 1) != (part != nullptr)) ||
      (q_sb | q_sl | k_sb | k_sl | v_sb | v_sl) % kVec != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_out = (long long)batch * lq * heads * dv;
  const long long n_lse = (long long)batch * heads * lq;
  cudaStream_t s = (cudaStream_t)stream;
  if (two_pass) {
    const long long lds = (lk + kBKP - 1) / kBKP * kBKP;
    float* scores = (float*)part;
    float* part_out = scores + (long long)batch * heads * slab * lds;
    // the output's splits: each a slab's rows (B x prow x h*dv floats)
    const int prow = lq < slab ? lq : slab;
    const long long n_part = (long long)batch * prow * heads * dv;
    float* stat_m = part_out + (splits > 1 ? splits * n_part : 0);
    float* stat_l = stat_m + score_splits * n_lse;
    const int score_tiles = (lk + kBKS - 1) / kBKS;
    const int pv_tiles = (lk + kBKP - 1) / kBKP;
    Args<E> a{(const E*)q, (const E*)k, (const E*)v,
              (const int*)valid, splits > 1 ? (void*)part_out : out,
              (float*)lse, splits > 1 ? n_part : 0, 0,
              heads, lq, lk, d, dv, valid_all, (dv + kPvCols - 1) / kPvCols,
              (pv_tiles + splits - 1) / splits,
              q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale,
              0, slab, scores, lds, stat_m, stat_l, score_splits,
              (score_tiles + score_splits - 1) / score_splits};
    PvMaps maps;
    if (!make_pv_maps(&maps, (const float*)v, scores, batch, heads, lk, dv,
                      v_sb, v_sl, slab, lds))
      return (int)cudaErrorInvalidValue;
    int err = 0;
    for (int r0 = 0; r0 < lq && err == 0; r0 += slab) {
      a.row0 = r0;
      const int rows = lq - r0 < slab ? lq - r0 : slab;
      err = d <= 32 ? launch_two_pass<E, 32>(a, maps, batch, rows, splits, s)
          : d <= 128 ? launch_two_pass<E, 128>(a, maps, batch, rows, splits, s)
                     : launch_two_pass<E, 256>(a, maps, batch, rows, splits, s);
      if (err != 0 || splits == 1) continue;
      const long long n = (long long)batch * rows * heads * dv;
      const long long blocks = (n + 511) / 512 < 2048 ? (n + 511) / 512 : 2048;
      sum_splits_kernel<<<(int)blocks, 256, 0, s>>>(
          part_out, out, splits, batch, rows, prow, lq, r0, heads * dv);
      err = (int)cudaGetLastError();
    }
    return err;
  }
  const int bk = (d <= 32 && dv <= 32) ? 64 : 32;   // launch_d's
  const int key_tiles = (lk + bk - 1) / bk;
  float* part_out = (float*)part;
  float* part_lse = part_out + (splits > 1 ? splits * n_out : 0);
  Args<E> a{(const E*)q, (const E*)k, (const E*)v, (const int*)valid,
            splits > 1 ? (void*)part_out : out,
            splits > 1 ? part_lse : (float*)lse,
            splits > 1 ? n_out : 0, splits > 1 ? n_lse : 0,
            heads, lq, lk, d, dv, valid_all, 1,
            (key_tiles + splits - 1) / splits,
            q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale,
            0, 0, nullptr, 0, nullptr, nullptr, 0, 0};
  int err = d <= 32 ? launch_d<E, 32>(a, batch, splits, s)
          : d <= 128 ? launch_d<E, 128>(a, batch, splits, s)
                     : launch_d<E, 256>(a, batch, splits, s);
  if (err != 0 || splits == 1) return err;
  const long long n4 = n_out / 4;
  const long long blocks = (n4 + 255) / 256 < 2048 ? (n4 + 255) / 256 : 2048;
  merge_kernel<<<(int)blocks, 256, 0, s>>>(part_out, part_lse, out,
                                           (float*)lse, splits, heads, lq, dv,
                                           n4, n_out, n_lse);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound from Python with ctypes: flash_attn_fwd for
// fp32 q, k, v and out (lse and every scratch fp32). Strides are in
// elements; every stride and pointer must be 16-byte aligned (the wrapper
// checks).
// One pass (dv <= 128): `splits` > 1 splits the key loop over that many
// blocks a query tile, for grids too small to fill the card; the blocks
// write their partials into `part` (splits x B*Lq*h*dv floats of out, then
// splits x B*h*Lq of lse) and merge_kernel combines them. `score_splits`
// and `slab` are not read.
// Two passes (dv > 128), over slabs of `slab` query rows (a multiple of
// 64) one after the other: score_kernel writes the slab's scaled scores
// (B*h*slab rows of lds = Lk rounded up to 32 floats, at the start of
// `part`) and the row max and sum of each of `score_splits` (>= 1) key
// splits (score_splits x B*h*Lq of each, at the end of `part`); pv_kernel
// computes out over `splits` key splits, with splits > 1 into partials
// between the two (splits x B*min(slab, Lq)*h*dv) that sum_splits_kernel
// adds in order after each slab.
// The caller allocates `part` (ops/kernels/flash_attn.py fwd_plan). Launches
// on `stream` and returns the first non-zero cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a shape it does not take;
// allocates nothing.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* valid, void* out, void* lse,
                              void* part, int splits, int score_splits,
                              int slab, int batch, int heads, int lq, int lk,
                              int d, int dv, int valid_all, long long q_sb,
                              long long q_sl, long long k_sb, long long k_sl,
                              long long v_sb, long long v_sl, float scale,
                              void* stream) {
  return fwd<float>(q, k, v, valid, out, lse, part, splits, score_splits,
                    slab, batch, heads, lq, lk, d, dv, valid_all, q_sb, q_sl,
                    k_sb, k_sl, v_sb, v_sl, scale, stream);
}
