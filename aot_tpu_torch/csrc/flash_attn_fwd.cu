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
// 128-column tile, half of the products; 1.97 ms against 1.15 ms for the
// two passes at Lk = 19,800 on an H100 80GB HBM3 at 700 W). score_kernel
// computes the scaled scores once into a scratch (71 MB at Lq = 900,
// Lk = 19,800) with each key split's row max and sum; pv_kernel takes lse
// from those and computes out = exp(S - lse) V per 128-column value tile,
// reading the scores back through L2. Both passes split their key loops
// to fill the card (one DeAOTL video: 15 query tiles, 120 value-tile
// blocks), and the output's splits are added in order by
// sum_splits_kernel. The scratch is bounded: the two passes run over slabs
// of `slab` query rows (a multiple of 64, the wrapper's choice), one slab
// after the other, so a 1080p read (Lq = 7,232, 418 MB of scores at 14,464
// keys) takes the same kernels in two slabs.
//
// What bounds it: arithmetic. The function is 41 GFLOP at DeAOTL's longest
// memory (Lq = 900, Lk = 19,800, d = 128, dv = 1024), 123 GFLOP of TF32
// tensor-core products in 3xTF32; at 495 TFLOP/s of dense TF32 (165
// TFLOP/s of fp32-accurate products) that is 0.249 ms. mma.sync reaches
// 305 TFLOP/s of TF32 on an H100 80GB HBM3 (a loop of independent
// products), so this design can come no closer than 0.40 ms; it runs
// 1.1-1.3 ms: each operand element a warp reads costs a shared-memory load
// and four integer and fp32 instructions for its split, which share the
// issue slots with the products, and only 8 warps an SM (registers,
// shared memory) hide their latency. K and V (81 MB at Lk = 19,800) are
// read from device memory once and from L2 by each query tile. At AOTT's
// training shape (B = 16, h = 8, Lq = Lk = 900, d = dv = 32) the bound is
// 0.080 ms and the kernel runs 0.37-0.44 ms. wgmma with TMA and warp
// specialisation is the next step.
//
// bf16 q, k and v go to flash_attn_fwd_bf16.cu (wgmma).

#include <cuda_runtime.h>

#include "bf16_mma.cuh"
#include "tf32x3.cuh"

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
// tile of DVT columns and one split of the live keys, lse from pass 1's
// statistics (so no running rescale). Each 32-key tile's P V is summed apart and added to
// the output in fp32. S and V tiles go through a cp.async ring; P enters
// the product as A fragments read from the S tile in shared memory.
template <typename E, int DVT>
struct PvTiles {
  static constexpr int kLdS = kBKP + 4;   // = 4 mod 32: A reads conflict-free
  static constexpr int kLdV = DVT + 8;    // = 8 mod 32: B reads (rows t, t + 4)
  static constexpr int kS = kBQ * kLdS;   // fp32 scores
  static constexpr int kV = kBKP * kLdV;  // values in E
  static constexpr size_t kSmem = 2 * (sizeof(float) * kS + sizeof(E) * kV);
};

template <typename E, int DVT>
__global__ void __launch_bounds__(kThreads, 2) pv_kernel(Args<E> a) {
  using T = PvTiles<E, DVT>;
  constexpr int kNV = DVT / 8;
  extern __shared__ float4 smem4[];
  float* s_s = reinterpret_cast<float*>(smem4);       // two stages
  E* s_v = reinterpret_cast<E*>(s_s + 2 * T::kS);     // two stages

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int bh = blockIdx.x;
  const int b = bh / a.heads;
  const int head = bh % a.heads;
  const int q0 = a.row0 + blockIdx.y * kBQ;
  const int vt = blockIdx.z % a.dv_tiles;
  const int split = blockIdx.z / a.dv_tiles;
  const int c0 = vt * DVT;
  int n_live = a.valid != nullptr ? a.valid[b] : a.valid_all;
  n_live = max(0, min(n_live, a.lk));
  const int k_begin = split * a.tiles_per_split * kBKP;
  const int k_end = min(n_live, k_begin + a.tiles_per_split * kBKP);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBKP - 1) / kBKP : 0;

  // the slab is a multiple of 64 rows: this tile's rows lie in it
  const float* s_base =
      a.scores + ((long long)bh * a.slab + q0 - a.row0) * a.lds;
  const E* v_base = a.v + b * a.v_sb + (long long)head * a.dv + c0;
  auto load_tile = [&](int i) {
    const int k0 = k_begin + i * kBKP;
    stage<kBQ, kBKP, T::kLdS, kThreads>(s_s + (i & 1) * T::kS, s_base + k0,
                                        a.lds, a.lq - q0, k_end - k0);
    stage<kBKP, DVT, T::kLdV, kThreads>(s_v + (i & 1) * T::kV,
                                             v_base + k0 * a.v_sl, a.v_sl,
                                             k_end - k0, a.dv - c0);
  };
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();

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
      if (vt == 0 && split == 0 && t == 0) a.lse[i0] = total;
    }
    live_r[r] = total > kEmptyLse;
    lse2[r] = total * kLog2e;
  }

  float acc[kNV][4];
#pragma unroll
  for (int n = 0; n < kNV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const bool active = q0 + warp * 16 < a.lq;

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_tile(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const int k0 = k_begin + i * kBKP;
      float pv[kNV][4];
#pragma unroll
      for (int n = 0; n < kNV; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
      const float* ts = s_s + (i & 1) * T::kS + (warp * 16 + g) * T::kLdS + t;
      const E* tv = s_v + (i & 1) * T::kV + t * T::kLdV + g;
#pragma unroll
      for (int kb = 0; kb < kBKP / 8; ++kb) {
      // P = exp(S - lse) over live keys; unread scores are never selected
      const bool k_lo = k0 + kb * 8 + t < k_end;
      const bool k_hi = k0 + kb * 8 + t + 4 < k_end;
      const float* ps = ts + kb * 8;
      const float p0 = (k_lo && live_r[0]) ? exp2f(fmaf(ps[0], kLog2e, -lse2[0])) : 0.f;
      const float p1 = (k_lo && live_r[1]) ? exp2f(fmaf(ps[8 * T::kLdS], kLog2e, -lse2[1])) : 0.f;
      const float p2 = (k_hi && live_r[0]) ? exp2f(fmaf(ps[4], kLog2e, -lse2[0])) : 0.f;
      const float p3 = (k_hi && live_r[1]) ? exp2f(fmaf(ps[8 * T::kLdS + 4], kLog2e, -lse2[1])) : 0.f;
      const FragA fp = frag_a(p0, p1, p2, p3);
      const E* vb = tv + kb * 8 * T::kLdV;
#pragma unroll
      for (int n = 0; n < kNV; ++n)
        mma3(pv[n], fp, frag_b(vb[n * 8], vb[4 * T::kLdV + n * 8]));
      }

      // fold once per tile in fp32: the mma's own accumulation rounds
      // toward zero at every step (see tf32x3::mma3_apart)
#pragma unroll
      for (int n = 0; n < kNV; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += pv[n][e];
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  if (!active) return;
  const long long o_stride = (long long)a.heads * a.dv;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.lq) continue;
    const long long o_row = split * a.out_split +
                            ((long long)b * a.lq + row) * o_stride +
                            (long long)head * a.dv + c0;
#pragma unroll
    for (int n = 0; n < kNV; ++n) {
      const int col = n * 8 + 2 * t;
      if (c0 + col < a.dv)
        store2(a.out, o_row + col, false, acc[n][2 * r],
               acc[n][2 * r + 1]);
    }
  }
}

// out = the sum of pass 2's key splits, in split order (n even)
__global__ void __launch_bounds__(256)
sum_splits_kernel(const float* __restrict__ part, void* __restrict__ out,
                  long long n, int splits) {
  for (long long i = 2 * (blockIdx.x * 256LL + threadIdx.x); i < n;
       i += 2LL * gridDim.x * 256) {
    float x = 0.f, y = 0.f;
    for (int s = 0; s < splits; ++s) {
      x += part[s * n + i];
      y += part[s * n + i + 1];
    }
    store2(out, i, false, x, y);
  }
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
int launch_two_pass(const Args<E>& a, int batch, int rows, int splits,
                    cudaStream_t stream) {
  const int tiles = (rows + kBQ - 1) / kBQ;
  const dim3 s_grid(batch * a.heads, tiles, a.score_splits);
  int err = launch_k(score_kernel<E, D>, s_grid, ScoreTiles<E, D>::kSmem,
                     stream, a);
  if (err != 0) return err;
  const dim3 p_grid(batch * a.heads, tiles, a.dv_tiles * splits);
  return launch_k(pv_kernel<E, 128>, p_grid, PvTiles<E, 128>::kSmem, stream,
                  a);
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
    float* stat_m = part_out + (splits > 1 ? splits * n_out : 0);
    float* stat_l = stat_m + score_splits * n_lse;
    const int score_tiles = (lk + kBKS - 1) / kBKS;
    const int pv_tiles = (lk + kBKP - 1) / kBKP;
    Args<E> a{(const E*)q, (const E*)k, (const E*)v,
              (const int*)valid, splits > 1 ? (void*)part_out : out,
              (float*)lse, splits > 1 ? n_out : 0, 0,
              heads, lq, lk, d, dv, valid_all, (dv + 127) / 128,
              (pv_tiles + splits - 1) / splits,
              q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale,
              0, slab, scores, lds, stat_m, stat_l, score_splits,
              (score_tiles + score_splits - 1) / score_splits};
    int err = 0;
    for (int r0 = 0; r0 < lq && err == 0; r0 += slab) {
      a.row0 = r0;
      const int rows = lq - r0 < slab ? lq - r0 : slab;
      err = d <= 32 ? launch_two_pass<E, 32>(a, batch, rows, splits, s)
          : d <= 128 ? launch_two_pass<E, 128>(a, batch, rows, splits, s)
                     : launch_two_pass<E, 256>(a, batch, rows, splits, s);
    }
    if (err != 0 || splits == 1) return err;
    const long long blocks = (n_out + 511) / 512 < 2048 ? (n_out + 511) / 512 : 2048;
    sum_splits_kernel<<<(int)blocks, 256, 0, s>>>(part_out, out, n_out,
                                                  splits);
    return (int)cudaGetLastError();
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
// between the two (splits x B*Lq*h*dv) that sum_splits_kernel adds in
// order once every slab is done.
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
