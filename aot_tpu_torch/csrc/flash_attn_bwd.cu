// Flash-attention backward for Hopper (sm_90a), fp32-accurate on the TF32
// tensor cores.
//
// Replaces aot_tpu/ops/pallas/flash_attn_vjp.py:267 _flash_heads_bwd: the
// TPU kernels _bwd_dq_kernel (:104) and _bwd_dkv_kernel (:148) behind the
// custom VJP of flash_attention (:338), which every global attention of the
// training program runs (self-attention and the long-term read). It reads
// the forward's layout (csrc/flash_attn_fwd.cu) and the forward's lse:
//   q, k, v   (B, L, h*d / h*dv)  rows of floats, batch/row strides given
//   valid     (B,) int32 live key counts, or null (then `valid_all` for all)
//   dout      (B, Lq, h*dv)       contiguous
//   lse       (B*h, Lq)           the forward's log-sum-exp (-1e30: no key)
//   delta     (B*h, Lq)           D = rowsum(dout * out), a plain torch
//                                 reduction, as the JAX package computes it
//                                 outside the Pallas calls (:274-276)
//   dq, dk    (B, Lq|Lk, h*d)     contiguous outputs
//   dv        (B, Lk, h*dv)       contiguous output
// With S = scale q k^T over the live keys j < min(valid[b], Lk):
//   P = exp(S - lse);  dV = P^T dO;  dS = P o (dO V^T - D);
//   dQ = scale dS K;   dK = scale dS^T Q.
// Keys at or beyond the live length get exact zeros in dK and dV and add
// nothing to dQ; a row with no live key (lse -1e30) gives zeros. fp32 in,
// out and accumulation; all five products (S, dP, dQ, dK, dV) run as three
// TF32 tensor-core products each (3xTF32, tf32x3.cuh), as the TPU kernels
// compute at Precision.HIGHEST (:41-43).
//
// Design. Blocks of 4 warps own one 64-row tile of an output (16 rows a
// warp) and loop over the other side's tiles inside the block, so no two
// blocks write the same element: no atomics, and two runs give the same
// bits.
//   grad_qk_kernel<dQ>  block per (b*h, query tile): S, P, dP, dS and
//                       dQ += dS K over the live key tiles (for a grid of
//                       fewer than two waves, as one video at h = 1 gives,
//                       the key loop is split over `splits` blocks whose
//                       partials sum_splits_kernel adds in split order);
//                       for dv > 32 it also keeps P and dS in a scratch;
//   grad_qk_kernel<dK>  then, for dv <= 32 (AOT's d = dv = 32), a block per
//                       (b*h, key tile): S, P, dP, dS with rows and columns
//                       swapped, dK += dS^T Q and dV += P^T dO together
//                       over the query tiles;
//   grad_t_kernel       or, for dv > 32 (DeAOT's dv = 1024), dV = P^T dO
//                       and dK = scale dS^T Q from the kept P and dS, a
//                       block per (b*h, key tile, 128 output columns): S
//                       and dP are computed once.
// The kept P and dS are bounded: the dQ kernel and grad_t_kernel run over
// slabs of `slab` query rows (a multiple of 64, the wrapper's choice), one
// slab after the other, and grad_t_kernel adds each slab's dV and dK to the
// last in slab order.
// dP = dO V^T is summed over dv in 32-column chunks staged through shared
// memory, so no block holds a dv-wide row. The score tile, P, dP and dS
// stay in the mma accumulator registers; P and dS enter the next product
// as A fragments straight from them (tf32x3::a_from_acc). Every tile
// (the column tile of q or k, the dv chunks of dO and v) is staged with
// cp.async through a ring of two stages, so the next step's copies are in
// flight while this step's products run.
// Long sums are folded in fp32: the tensor core rounds its fp32
// accumulator toward zero after every product, so a sum over thousands of
// products in one accumulator drifts one way (dQ over 19,800 keys: ~1,900
// mma steps). Each column tile's dQ (dK, dV) product, each dv chunk's dP
// and each query tile's grad_t product is summed in an accumulator of its
// own and added to the running one in fp32; for d > 32 the score's large
// term is kept apart (tf32x3::mma3_apart), as the forward computes it. At
// d = 256 the tile accumulators spill to local memory (no path runs it);
// the d = 32 dQ kernel spills 12 bytes at three blocks a multiprocessor.
//
// What bounds it: arithmetic. At AOTT's training shape (B = 16, h = 8,
// Lq = Lk = 900, d = dv = 32) the function is 33 GFLOP, 0.201 ms at the
// card's 495 TFLOP/s of dense TF32 in 3xTF32 (165 TFLOP/s of fp32-accurate
// products); the two kernels run 46 GFLOP (S and dP twice, dQ, dK, dV
// once), 139 GFLOP of TF32 products, in ~1.6 ms on an H100 80GB HBM3 at
// 700 W: as in the forward, the operand splits and fragment reads share
// the issue slots with mma.sync, whose own peak there is 305 TFLOP/s of
// TF32. q, k, v and dO are 7.4 MB a tensor and stay in L2. At DeAOTL's
// long-term shape (Lq = 900, Lk = 19,800, d = 128, dv = 1024) the function
// is 87 GFLOP (0.525 ms), dP and dV 36 GFLOP each; the two passes run
// exactly that, in ~4.4 ms (a one-pass form, which computes dP twice and
// S ten times, 164 GFLOP, took ~7.8 ms). wgmma with TMA is the next step.
//
// bf16 (entry flash_attn_bwd_bf16; bf16 training, TRAIN_DTYPE=bfloat16).
// The same kernels instantiated for bf16 q, k, v, dO and dq, dk, dv (lse
// and D fp32) compute what `_bwd_dq_kernel` and `_bwd_dkv_kernel` compute
// at bf16 (flash_attn_vjp.py:104-190): every product is one mma.sync
// m16n8k16 on bf16 operands into fp32 accumulators (each product of two
// bf16 values is exact in fp32) in place of the 3xTF32 triple; S, P, dP
// and dS are fp32 in the accumulators; P is rounded to bf16 before
// dV = P^T dO (`p.astype(v.dtype)`, :177), dS before dQ = dS K and
// dK = dS^T Q (:135, :184), dO is bf16 already (:131, :180); D and every
// running sum stay fp32, folded per tile as above, and dq, dk, dv are
// rounded to bf16 once (:140, :189-190). P and dS enter the next product
// packed into bf16 pairs straight from the score accumulators (two 8-key
// blocks make one 16-key A fragment, bf16_mma.cuh). For dv > 32 the kept
// P and dS are bf16 (the values the products read; half the scratch), and
// when the query rows take more than one slab dV and dK are summed over
// the slabs in an fp32 scratch and rounded once, by the last slab. Tiles
// hold bf16 in shared memory, 8 elements a 16-byte cp.async, so d and dv
// are multiples of 8. The bound is 2x the FLOPs at 989 TFLOP/s and half
// the bytes of q, k, v, dO and the gradients.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_mma.cuh"
#include "tf32x3.cuh"

namespace {

using namespace tf32x3;
using namespace bf16mma;

constexpr int kT = 64;           // rows of a block's output tile
constexpr int kThreads = 128;    // 4 warps, 16 rows each
constexpr int kCH = 32;          // dv chunk of the dP product
constexpr int kMaxD = 256;       // q/k channels per head
constexpr float kEmptyLse = -1e29f;  // lse below this: the row has no key
constexpr float kLog2e = 1.4426950408889634f;

// Row padding of a staged tile, in elements: fp32 rows = 4 mod 32 words
// (fragment reads hit 32 banks); bf16 16 bytes, rows stay 16-byte aligned
template <typename E>
constexpr int kPad = kIsBf16<E> ? 8 : 4;

template <typename E>
struct Args {
  const E* q;
  const E* k;
  const E* v;
  const int* valid;
  const E* dout;
  const float* lse;
  const float* delta;
  E* dq;
  E* dk;
  E* dv;
  float* dq_part;   // (splits, B, Lq, h*d) unscaled partial dQ, or null
  int heads, lq, lk, d, dv_w, valid_all;
  int tiles_per_split;       // dQ: key tiles of each blockIdx.z
  long long split_stride;    // floats between two splits of dq_part
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;
  float scale;
  // dQ kernel of the two-pass backward: the slab's first query row and
  // rows a slab, and P and dS of every (query of the slab, live key),
  // B*h*slab rows of `lds` elements each, for the dK and dV products
  int row0;
  int slab;
  E* p_out;
  E* ds_out;
  long long lds;
};

__device__ __forceinline__ int live_keys(int valid_b, int lk) {
  return max(0, min(valid_b, lk));
}

template <int N>
__device__ __forceinline__ void zero(float (*x)[4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
}

// acc += part, in fp32 (round to nearest), once per tile
template <int N>
__device__ __forceinline__ void fold(float (*acc)[4], const float (*part)[4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// The column tile: 64 rows at AOT's d = 32, 32 above (shared memory).
template <int D>
constexpr int col_tile() { return D == 32 ? 64 : 32; }

template <typename E, int D>
struct QkTiles {
  static constexpr int kBC = col_tile<D>();
  static constexpr int kLd = D + kPad<E>;
  static constexpr int kLdX = kCH + kPad<E>;   // row stride of a dP chunk
  static constexpr int kR = kT * kLd;
  static constexpr int kC = kBC * kLd;
  static constexpr int kXr = kT * kLdX;
  static constexpr int kXc = kBC * kLdX;
  // two stages of the column tile and its dv chunks in E, then (dK) two
  // stages of its lse and D in fp32
  static constexpr size_t kSmem = sizeof(E) * (kR + 2 * (kC + kXr + kXc)) +
                                  sizeof(float) * 2 * 2 * kBC;
};

// acc[n] += X_rows . C^T over `steps` (<= KS) 8-channel steps: A = rows of
// `xr` (ld LDA, the warp's 16 rows), B(k = channel, n = column) = rows of
// `xc` (ld LDB). APART: the large term goes to acc, the small ones to
// small (tf32x3::mma3_apart).
template <int NB, int KS, int LDA, int LDB, bool APART = false>
__device__ __forceinline__ void rows_dot_cols(float (*acc)[4],
                                              float (*small)[4],
                                              const float* xr,
                                              const float* xc, int steps,
                                              int g, int t) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks < steps) {
      const float* pa = xr + g * LDA + ks * 8 + t;
      const FragA fa = frag_a(pa[0], pa[8 * LDA], pa[4], pa[8 * LDA + 4]);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const float* pb = xc + (n * 8 + g) * LDB + ks * 8 + t;
        if constexpr (APART)
          mma3_apart(acc[n], small[n], fa, frag_b(pb[0], pb[4]));
        else
          mma3(acc[n], fa, frag_b(pb[0], pb[4]));
      }
    }
  }
}

// The same product on bf16 rows, over `steps` (<= KS) 16-channel steps
// (one bf16 product: nothing to keep apart)
template <int NB, int KS, int LDA, int LDB, bool APART = false>
__device__ __forceinline__ void rows_dot_cols(float (*acc)[4], float (*)[4],
                                              const bf16* xr, const bf16* xc,
                                              int steps, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks < steps) {
      const bf16* pa = xr + g * LDA + ks * 16 + 2 * t;
      const uint32_t fa[4] = {ld_pair(pa), ld_pair(pa + 8 * LDA),
                              ld_pair(pa + 8), ld_pair(pa + 8 * LDA + 8)};
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const bf16* pb = xc + (n * 8 + g) * LDB + ks * 16 + 2 * t;
        mma_bf16(acc[n], fa, ld_pair(pb), ld_pair(pb + 8));
      }
    }
  }
}

// acc[n] += W . Y over the KB 8-column blocks of the score-shaped W (in
// accumulator registers): B(k = column, n = channel) = rows 2t, 2t + 1 of
// each 8-row block of `y` (ld LDB), channels n * 8 + g for n < `nblocks`.
template <int KB, int NB, int LDB>
__device__ __forceinline__ void scores_dot(float (*acc)[4],
                                           const float (*w)[4], const float* y,
                                           int nblocks, int g, int t) {
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    const FragA fa = a_from_acc(w[kb]);
    const float* pb = y + (kb * 8 + 2 * t) * LDB + g;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      if (n < nblocks) mma3(acc[n], fa, frag_b(pb[n * 8], pb[LDB + n * 8]));
  }
}

// The same product with W rounded to bf16 and bf16 rows of `y`: blocks
// 2kb and 2kb + 1 of W are the 16 columns of one product's A fragment,
// B = rows 2t, 2t + 1, 2t + 8, 2t + 9 of each 16-row block of `y`
template <int KB, int NB, int LDB>
__device__ __forceinline__ void scores_dot(float (*acc)[4],
                                           const float (*w)[4], const bf16* y,
                                           int nblocks, int g, int t) {
#pragma unroll
  for (int kb = 0; kb < KB / 2; ++kb) {
    uint32_t fa[4];
    a_from_acc_bf16(fa, w[2 * kb], w[2 * kb + 1]);
    const bf16* pb = y + (kb * 16 + 2 * t) * LDB + g;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      if (n < nblocks)
        mma_bf16(acc[n], fa, pack_bf16(pb[n * 8], pb[LDB + n * 8]),
                 pack_bf16(pb[8 * LDB + n * 8], pb[9 * LDB + n * 8]));
  }
}

// KEY_ROWS false: dQ, rows are queries and the loop runs over key tiles.
// KEY_ROWS true:  dK and dV (dv <= kCH, one chunk), rows are keys and the
// loop runs over query tiles.
template <typename E, bool KEY_ROWS, int D>
__global__ void __launch_bounds__(kThreads, D == 32 ? 3 : 2)
    grad_qk_kernel(Args<E> a) {
  using T = QkTiles<E, D>;
  constexpr bool kBf16 = kIsBf16<E>;
  constexpr int kBC = T::kBC;
  constexpr int kLdX = T::kLdX;
  constexpr int kNC = kBC / 8;    // 8-column blocks of a score tile
  constexpr int kND = D / 8;      // 8-channel blocks of q/k
  constexpr int kNV = kCH / 8;    // 8-channel blocks of a dv chunk
  constexpr int kStep = kBf16 ? 16 : 8;   // channels an mma step
  // fp32: the score's hi.hi term summed apart
  constexpr bool kApart = D > 32 && !kBf16;
  extern __shared__ float4 smem4[];
  E* s_r = reinterpret_cast<E*>(smem4);   // row tile (q or k)
  E* s_c = s_r + T::kR;                    // column tile, 2 stages
  E* s_xr = s_c + 2 * T::kC;               // row side dv chunk, 2
  E* s_xc = s_xr + 2 * T::kXr;             // column side chunk, 2
  float* s_lc = reinterpret_cast<float*>(s_xc + 2 * T::kXc);  // dK: lse, 2
  float* s_dc = s_lc + 2 * kBC;                               // dK: D, 2

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int bh = blockIdx.x;
  const int b = bh / a.heads;
  const int head = bh % a.heads;
  const int r0 = a.row0 + blockIdx.y * kT;
  const int n_live =
      live_keys(a.valid != nullptr ? a.valid[b] : a.valid_all, a.lk);
  const long long do_sl = (long long)a.heads * a.dv_w;
  const E* q_base = a.q + b * a.q_sb + (long long)head * a.d;
  const E* k_base = a.k + b * a.k_sb + (long long)head * a.d;
  const E* v_base = a.v + b * a.v_sb + (long long)head * a.dv_w;
  const E* do_base = a.dout + (long long)b * a.lq * do_sl +
                     (long long)head * a.dv_w;
  const float* lse = a.lse + (long long)bh * a.lq;
  const float* delta = a.delta + (long long)bh * a.lq;

  const int row_end = KEY_ROWS ? n_live : a.lq;
  const int col_end = KEY_ROWS ? a.lq : n_live;
  const E* r_src = KEY_ROWS ? k_base : q_base;
  const long long r_ld = KEY_ROWS ? a.k_sl : a.q_sl;
  const E* c_src = KEY_ROWS ? q_base : k_base;
  const long long c_ld = KEY_ROWS ? a.q_sl : a.k_sl;
  const E* xr_src = KEY_ROWS ? v_base : do_base;   // dP rows
  const long long xr_ld = KEY_ROWS ? a.v_sl : do_sl;
  const E* xc_src = KEY_ROWS ? do_base : v_base;   // dP columns
  const long long xc_ld = KEY_ROWS ? do_sl : a.v_sl;

  // the loop's column range: a dK block of dead keys skips it and writes
  // zeros; a dQ block takes its split's range of key tiles
  int c_begin = 0, c_end = col_end;
  if (KEY_ROWS && r0 >= n_live) c_end = 0;
  if (!KEY_ROWS) {
    c_begin = blockIdx.z * a.tiles_per_split * kBC;
    c_end = min(col_end, c_begin + a.tiles_per_split * kBC);
  }
  const int n_ct = c_end > c_begin ? (c_end - c_begin + kBC - 1) / kBC : 0;
  const int n_ch = (a.dv_w + kCH - 1) / kCH;
  const int n_steps = n_ct * n_ch;

  stage_t<E, kT, D, T::kLd, kThreads>(s_r, r_src + r0 * r_ld, r_ld,
                                      row_end - r0, a.d);
  auto load_step = [&](int s) {   // column tile s / n_ch, chunk s % n_ch
    const int ct = s / n_ch;
    const int ch = s - ct * n_ch;
    const int c0 = c_begin + ct * kBC;
    if (ch == 0) {
      stage_t<E, kBC, D, T::kLd, kThreads>(s_c + (ct & 1) * T::kC,
                                           c_src + c0 * c_ld, c_ld,
                                           c_end - c0, a.d);
      if (KEY_ROWS) {
        stage_vec<kBC, kThreads>(s_lc + (ct & 1) * kBC, lse + c0, c_end - c0);
        stage_vec<kBC, kThreads>(s_dc + (ct & 1) * kBC, delta + c0,
                                 c_end - c0);
      }
    }
    const int e0 = ch * kCH;
    if (n_ch > 1 || s == 0)   // one chunk: the row side is staged once
      stage_t<E, kT, kCH, kLdX, kThreads>(s_xr + (s & 1) * T::kXr,
                                          xr_src + r0 * xr_ld + e0, xr_ld,
                                          row_end - r0, a.dv_w - e0);
    stage_t<E, kBC, kCH, kLdX, kThreads>(s_xc + (s & 1) * T::kXc,
                                         xc_src + c0 * xc_ld + e0, xc_ld,
                                         c_end - c0, a.dv_w - e0);
  };
  if (n_steps > 0) load_step(0);
  cp_async_commit();

  const bool active = r0 + warp * 16 < row_end;   // warp-uniform
  const int d_steps = (a.d + kStep - 1) / kStep;
  const int x_steps = min(kCH / kStep, (a.dv_w + kStep - 1) / kStep);
  const int d_blocks = (a.d + 7) / 8;
  const int x_blocks = min(kNV, (a.dv_w + 7) / 8);
  const float scale2 = a.scale * kLog2e;
  // dQ: each row's lse and D, read once
  float lse2_r[2] = {0.f, 0.f}, dd_r[2] = {0.f, 0.f};
  bool live_r[2] = {false, false};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + warp * 16 + g + 8 * r;
    if (!KEY_ROWS && row < a.lq) {
      lse2_r[r] = lse[row] * kLog2e;
      dd_r[r] = delta[row];
      live_r[r] = lse[row] > kEmptyLse;
    }
    if (KEY_ROWS) live_r[r] = row < n_live;
  }

  float acc[kND][4], accv[kNV][4], p[kNC][4], dp[kNC][4];
  zero<kND>(acc);
  zero<kNV>(accv);

  for (int s = 0; s < n_steps; ++s) {
    if (s + 1 < n_steps) load_step(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int ct = s / n_ch;
    const int ch = s - ct * n_ch;
    const int c0 = c_begin + ct * kBC;
    const E* tc = s_c + (ct & 1) * T::kC;
    const E* xc = s_xc + (s & 1) * T::kXc;
    if (active) {
      if (ch == 0) {
        // P = exp(scale S - lse) over the live (query, key) pairs
        float p_small[kApart ? kNC : 1][4];
        zero<kNC>(p);
        zero<kNC>(dp);
        if constexpr (kApart) zero<kNC>(p_small);
        rows_dot_cols<kNC, D / kStep, T::kLd, T::kLd, kApart>(
            p, p_small, s_r + warp * 16 * T::kLd, tc, d_steps, g, t);
        if constexpr (kApart) fold<kNC>(p, p_small);
#pragma unroll
        for (int n = 0; n < kNC; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = n * 8 + 2 * t + e;
            float l2 = 0.f;
            bool live = c0 + cc < c_end;
            if (KEY_ROWS) {
              const float l = s_lc[(ct & 1) * kBC + cc];
              live = live && l > kEmptyLse;
              l2 = l * kLog2e;
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float sub = KEY_ROWS ? l2 : lse2_r[r];
              p[n][2 * r + e] = (live && live_r[r])
                  ? exp2f(fmaf(p[n][2 * r + e], scale2, -sub)) : 0.f;
            }
          }
      }
      // dP += X_rows . X_cols^T over this dv chunk; dK's single chunk goes
      // straight into dP, each of dQ's chunks (32 at dv = 1024) is summed
      // apart and added in fp32
      const E* xr = s_xr + (n_ch > 1 ? s & 1 : 0) * T::kXr + warp * 16 * kLdX;
      if constexpr (KEY_ROWS) {
        rows_dot_cols<kNC, kCH / kStep, kLdX, kLdX>(dp, nullptr, xr, xc,
                                                    x_steps, g, t);
      } else {
        float x[kNC][4];
        zero<kNC>(x);
        rows_dot_cols<kNC, kCH / kStep, kLdX, kLdX>(x, nullptr, xr, xc,
                                                    x_steps, g, t);
        fold<kNC>(dp, x);
      }
      if (ch == n_ch - 1) {
        // dS = P o (dP - D), in place of dP
#pragma unroll
        for (int n = 0; n < kNC; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float dd_c =
                KEY_ROWS ? s_dc[(ct & 1) * kBC + n * 8 + 2 * t + e] : 0.f;
#pragma unroll
            for (int r = 0; r < 2; ++r)
              dp[n][2 * r + e] =
                  p[n][2 * r + e] * (dp[n][2 * r + e] - (KEY_ROWS ? dd_c : dd_r[r]));
          }
        if (!KEY_ROWS && a.ds_out != nullptr) {
          // keys even, split bounds a multiple of the tile: key + 1 < lds
          const int row0 = r0 + warp * 16 + g;
          const long long base =
              ((long long)bh * a.slab + row0 - a.row0) * a.lds;
#pragma unroll
          for (int n = 0; n < kNC; ++n) {
            const int key = c0 + n * 8 + 2 * t;
            if (key >= c_end) continue;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              if (row0 + 8 * r >= a.lq) continue;
              const long long at = base + 8 * r * a.lds + key;
              store2(a.p_out, at, kBf16, p[n][2 * r], p[n][2 * r + 1]);
              store2(a.ds_out, at, kBf16, dp[n][2 * r], dp[n][2 * r + 1]);
            }
          }
        }
        // dQ += dS K, or dK += dS^T Q (scaled at the end), and dV += P^T dO
        // (the chunk is all of dv): this tile's products summed apart
        float part[kND][4];
        zero<kND>(part);
        scores_dot<kNC, kND, T::kLd>(part, dp, tc, d_blocks, g, t);
        fold<kND>(acc, part);
        if constexpr (KEY_ROWS) {
          float partv[kNV][4];
          zero<kNV>(partv);
          scores_dot<kNC, kNV, kLdX>(partv, p, xc, x_blocks, g, t);
          fold<kNV>(accv, partv);
        }
      }
    }
    __syncthreads();   // every warp is done with this step's stages
  }
  cp_async_wait<0>();

  // dQ of a split launch: the unscaled fp32 partial of this split's keys
  const bool partial = !KEY_ROWS && a.dq_part != nullptr;
  const float out_mul = partial ? 1.f : a.scale;
  const int n_rows = KEY_ROWS ? a.lk : a.lq;
  const long long o_stride = (long long)a.heads * a.d;
  const long long v_stride = (long long)a.heads * a.dv_w;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + warp * 16 + g + 8 * r;
    if (row >= n_rows) continue;
    const long long o_row =
        ((long long)b * n_rows + row) * o_stride + (long long)head * a.d;
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      const int col = n * 8 + 2 * t;   // d % 4 == 0: both columns or none
      if (col >= a.d) continue;
      const float x = acc[n][2 * r] * out_mul, y = acc[n][2 * r + 1] * out_mul;
      if (partial)
        store2(a.dq_part + blockIdx.z * a.split_stride, o_row + col, false,
               x, y);
      else
        store2(KEY_ROWS ? a.dk : a.dq, o_row + col, kBf16, x, y);
    }
    if constexpr (KEY_ROWS) {
      const long long v_row = ((long long)b * a.lk + row) * v_stride +
                              (long long)head * a.dv_w;
#pragma unroll
      for (int n = 0; n < kNV; ++n) {
        const int col = n * 8 + 2 * t;
        if (col < a.dv_w)
          store2(a.dv, v_row + col, kBf16, accv[n][2 * r],
                 accv[n][2 * r + 1]);
      }
    }
  }
}


// Second pass of the two-pass backward (dv > 32, DeAOT's dv = 1024): the
// dQ kernel has written P and dS of a slab of queries, so dV += P^T dO and
// dK += scale dS^T Q over the slab are products with no recompute of S or
// dP. A block per (b*h, 64-key tile, 128-column tile of the output) loops
// over the slab's 32-query tiles: X (P or dS, queries x keys) and Y (dO or
// q, queries x columns) go through a cp.async ring, X enters as the
// transposed A operand (keys as rows), and each tile's product is folded
// into the output in fp32. Each slab adds its product to the sum of the
// slabs before it (`prev`, fp32: the output itself at fp32, a scratch at
// bf16, or none for the first slab) and writes the sum to `out` (fp32, or
// bf16 for the last slab of a bf16 backward). Keys at or beyond the live
// length get zeros.
template <typename E>
struct TArgs {
  const E* x;         // P or dS: B*h*x_rows rows of lds elements
  const E* y;         // dO or q, at the slab's first query row
  void* out;          // dV or dK: (B, Lk, h*ncols), fp32 or bf16
  const float* prev;  // the earlier slabs' sum (fp32), or null
  const int* valid;
  long long lds, y_sb, y_sl;
  int heads, lq, lk, ncols, valid_all;   // lq: the slab's query rows
  float mul;          // 1 for dV, scale for dK
  int x_rows;         // rows of X a b*h (the slab)
  int out_bf16;       // `out` holds bf16
};

constexpr int kTQ = 32;            // queries a tile
constexpr int kTCols = 128;        // output columns a block

template <typename E>
struct TTiles {
  // fp32: = 8 mod 32 words (transposed A reads; B reads, rows t, t + 4)
  static constexpr int kLdX = kT + 8;
  static constexpr int kLdY = kTCols + 8;
  static constexpr int kX = kTQ * kLdX;
  static constexpr int kY = kTQ * kLdY;
  static constexpr size_t kSmem = sizeof(E) * 2 * (kX + kY);
};

template <typename E>
__global__ void __launch_bounds__(kThreads, 2) grad_t_kernel(TArgs<E> a) {
  using T = TTiles<E>;
  constexpr int kNV = kTCols / 8;
  constexpr int kLdX = T::kLdX, kLdY = T::kLdY;
  extern __shared__ float4 smem4[];
  E* s_x = reinterpret_cast<E*>(smem4);   // two stages
  E* s_y = s_x + 2 * T::kX;                // two stages

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int bh = blockIdx.x;
  const int b = bh / a.heads;
  const int head = bh % a.heads;
  const int k0 = blockIdx.y * kT;
  const int c0 = blockIdx.z * kTCols;
  const int n_live =
      live_keys(a.valid != nullptr ? a.valid[b] : a.valid_all, a.lk);
  const int n_tiles = k0 >= n_live ? 0 : (a.lq + kTQ - 1) / kTQ;
  const E* x_base = a.x + (long long)bh * a.x_rows * a.lds + k0;
  const E* y_base = a.y + b * a.y_sb + (long long)head * a.ncols + c0;
  auto load_tile = [&](int i) {
    const int q0 = i * kTQ;
    stage_t<E, kTQ, kT, kLdX, kThreads>(s_x + (i & 1) * T::kX,
                                        x_base + q0 * a.lds, a.lds,
                                        a.lq - q0, (int)(a.lds - k0));
    stage_t<E, kTQ, kTCols, kLdY, kThreads>(s_y + (i & 1) * T::kY,
                                            y_base + q0 * a.y_sl, a.y_sl,
                                            a.lq - q0, a.ncols - c0);
  };
  if (n_tiles > 0) load_tile(0);
  cp_async_commit();

  const bool active = k0 + warp * 16 < n_live;
  const int nblocks = min(kNV, (a.ncols - c0 + 7) / 8);
  float acc[kNV][4];
  zero<kNV>(acc);

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_tile(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      float part[kNV][4];
      zero<kNV>(part);
      if constexpr (kIsBf16<E>) {
        // A = X^T: rows keys g, g + 8; k = queries 2t, 2t + 1 (+ 8)
        const E* tx = s_x + (i & 1) * T::kX + 2 * t * kLdX + warp * 16 + g;
        const E* ty = s_y + (i & 1) * T::kY + 2 * t * kLdY + g;
#pragma unroll
        for (int kb = 0; kb < kTQ / 16; ++kb) {
          const E* px = tx + kb * 16 * kLdX;   // X[query][key]
          const uint32_t fa[4] = {pack_bf16(px[0], px[kLdX]),
                                  pack_bf16(px[8], px[kLdX + 8]),
                                  pack_bf16(px[8 * kLdX], px[9 * kLdX]),
                                  pack_bf16(px[8 * kLdX + 8],
                                            px[9 * kLdX + 8])};
          const E* py = ty + kb * 16 * kLdY;
#pragma unroll
          for (int n = 0; n < kNV; ++n)
            if (n < nblocks)
              mma_bf16(part[n], fa, pack_bf16(py[n * 8], py[kLdY + n * 8]),
                       pack_bf16(py[8 * kLdY + n * 8], py[9 * kLdY + n * 8]));
        }
      } else {
        const E* tx = s_x + (i & 1) * T::kX + t * kLdX + warp * 16 + g;
        const E* ty = s_y + (i & 1) * T::kY + t * kLdY + g;
#pragma unroll
        for (int kb = 0; kb < kTQ / 8; ++kb) {
          const E* px = tx + kb * 8 * kLdX;   // X[query][key], A = X^T
          const FragA fa = frag_a(px[0], px[8], px[4 * kLdX], px[4 * kLdX + 8]);
          const E* py = ty + kb * 8 * kLdY;
#pragma unroll
          for (int n = 0; n < kNV; ++n)
            if (n < nblocks)
              mma3(part[n], fa, frag_b(py[n * 8], py[4 * kLdY + n * 8]));
        }
      }
      fold<kNV>(acc, part);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  const long long o_stride = (long long)a.heads * a.ncols;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + warp * 16 + g + 8 * r;
    if (row >= a.lk) continue;
    const bool live = row < n_live;   // dead keys: zeros, not what X held
    const long long o_row = ((long long)b * a.lk + row) * o_stride +
                            (long long)head * a.ncols + c0;
#pragma unroll
    for (int n = 0; n < kNV; ++n) {
      const int col = n * 8 + 2 * t;
      if (c0 + col < a.ncols) {
        float x = 0.f, y = 0.f;
        if (live) {
          x = acc[n][2 * r] * a.mul;
          y = acc[n][2 * r + 1] * a.mul;
          if (a.prev != nullptr) {
            const float2 old =
                *reinterpret_cast<const float2*>(a.prev + o_row + col);
            x += old.x;
            y += old.y;
          }
        }
        store2(a.out, o_row + col, a.out_bf16, x, y);
      }
    }
  }
}

// dq = scale * sum over splits of dq_part, in split order (deterministic),
// written in E
template <typename E>
__global__ void __launch_bounds__(256)
sum_splits_kernel(const float* __restrict__ part, E* __restrict__ dq,
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
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           const A& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// `acc` (bf16 with more than one slab): fp32 sums of dV and dK over the
// slabs, (B, Lk, h*dv) then (B, Lk, h*d); null otherwise
template <typename E, int D>
int launch_d(const Args<E>& a, int batch, int splits, float* acc,
             cudaStream_t stream) {
  constexpr bool kBf16 = kIsBf16<E>;
  const int bh = batch * a.heads;
  const int key_tiles = (a.lk + kT - 1) / kT;
  constexpr size_t qk_smem = QkTiles<E, D>::kSmem;
  constexpr size_t t_smem = TTiles<E>::kSmem;
  if (a.ds_out == nullptr) {   // dv <= kCH: dQ, then dK and dV together
    const dim3 q_grid(bh, (a.lq + kT - 1) / kT, splits);
    int err = launch(grad_qk_kernel<E, false, D>, q_grid, qk_smem, stream, a);
    if (err != 0) return err;
    return launch(grad_qk_kernel<E, true, D>, dim3(bh, key_tiles, 1), qk_smem,
                  stream, a);
  }
  // two passes, slab by slab: dQ with P and dS kept, then dV and dK
  const long long do_sl = (long long)a.heads * a.dv_w;
  float* acc_dv = acc;
  float* acc_dk = acc != nullptr
                      ? acc + (long long)batch * a.lk * a.heads * a.dv_w
                      : nullptr;
  int err = 0;
  for (int r0 = 0; r0 < a.lq && err == 0; r0 += a.slab) {
    Args<E> s = a;
    s.row0 = r0;
    const int rows = a.lq - r0 < a.slab ? a.lq - r0 : a.slab;
    const bool first = r0 == 0, last = r0 + a.slab >= a.lq;
    err = launch(grad_qk_kernel<E, false, D>,
                 dim3(bh, (rows + kT - 1) / kT, splits), qk_smem, stream, s);
    if (err != 0) break;
    // fp32: each slab adds to the output in place; bf16: to the fp32 sums,
    // the last slab writing bf16
    void* out_v = kBf16 && !last ? (void*)acc_dv : (void*)a.dv;
    void* out_k = kBf16 && !last ? (void*)acc_dk : (void*)a.dk;
    const float* prev_v =
        first ? nullptr : kBf16 ? acc_dv : (const float*)a.dv;
    const float* prev_k =
        first ? nullptr : kBf16 ? acc_dk : (const float*)a.dk;
    const int bf_out = kBf16 && last ? 1 : 0;
    const TArgs<E> tv{a.p_out, a.dout + r0 * do_sl, out_v, prev_v, a.valid,
                      a.lds, (long long)a.lq * do_sl, do_sl, a.heads, rows,
                      a.lk, a.dv_w, a.valid_all, 1.f, a.slab, bf_out};
    err = launch(grad_t_kernel<E>,
                 dim3(bh, key_tiles, (a.dv_w + kTCols - 1) / kTCols), t_smem,
                 stream, tv);
    if (err != 0) break;
    const TArgs<E> td{a.ds_out, a.q + r0 * a.q_sl, out_k, prev_k, a.valid,
                      a.lds, a.q_sb, a.q_sl, a.heads, rows, a.lk, a.d,
                      a.valid_all, a.scale, a.slab, bf_out};
    err = launch(grad_t_kernel<E>,
                 dim3(bh, key_tiles, (a.d + kTCols - 1) / kTCols), t_smem,
                 stream, td);
  }
  return err;
}

template <typename E>
int bwd(const void* q, const void* k, const void* v, const void* valid,
        const void* dout, const void* lse, const void* delta, void* dq,
        void* dk, void* dv, void* dq_part, int splits, void* scratch,
        int slab, int batch, int heads, int lq, int lk, int d, int dv_w,
        int valid_all, long long q_sb, long long q_sl, long long k_sb,
        long long k_sl, long long v_sb, long long v_sl, float scale,
        void* stream) {
  // elements of a 16-byte copy: widths and strides are multiples of it
  constexpr int kVec = 16 / sizeof(E);
  const bool two_pass = dv_w > kCH;
  if (batch < 1 || heads < 1 || lq < 1 || lk < 1 || d < 4 || d > kMaxD ||
      d % kVec != 0 || dv_w < 4 || dv_w % kVec != 0 || splits < 1 ||
      (splits > 1) != (dq_part != nullptr) ||
      (two_pass && (scratch == nullptr || slab < kT || slab % kT != 0)) ||
      (q_sb | q_sl | k_sb | k_sl | v_sb | v_sl) % kVec != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int bc = d <= 32 ? 64 : 32;   // col_tile<D>()
  const int key_tiles = (lk + bc - 1) / bc;
  const long long lds = (lk + 31) / 32 * 32;
  const long long kept = (long long)batch * heads * slab * lds;
  E* p_out = two_pass ? (E*)scratch : nullptr;
  E* ds_out = two_pass ? p_out + kept : nullptr;
  // bf16 over more than one slab: dV and dK summed in fp32 after P and dS
  float* acc = kIsBf16<E> && two_pass && lq > slab
                   ? (float*)(ds_out + kept) : nullptr;
  Args<E> a{(const E*)q, (const E*)k, (const E*)v,
            (const int*)valid, (const E*)dout, (const float*)lse,
            (const float*)delta, (E*)dq, (E*)dk, (E*)dv,
            (float*)dq_part, heads, lq, lk, d, dv_w, valid_all,
            (key_tiles + splits - 1) / splits,
            (long long)batch * lq * heads * d,
            q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale, 0, slab, p_out, ds_out,
            lds};
  cudaStream_t s = (cudaStream_t)stream;
  int err = d <= 32 ? launch_d<E, 32>(a, batch, splits, acc, s)
          : d <= 128 ? launch_d<E, 128>(a, batch, splits, acc, s)
                     : launch_d<E, 256>(a, batch, splits, acc, s);
  if (err != 0 || splits == 1) return err;
  const long long n = (long long)batch * lq * heads * d;
  const long long blocks = (n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024;
  sum_splits_kernel<E><<<(int)blocks, 256, 0, s>>>((const float*)dq_part,
                                                   (E*)dq, n, splits, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound from Python with ctypes: flash_attn_bwd for
// fp32 q, k, v, dout and gradients, flash_attn_bwd_bf16 for bf16 ones
// (lse, delta and dq_part fp32 in both). Strides are in elements; every
// stride and pointer must be 16-byte aligned (the wrapper checks), and for
// bf16 d and dv are multiples of 8.
// `splits` > 1 splits the dQ kernel's key loop over that many blocks a
// query tile, for grids too small to fill the card (one video at h = 1):
// each writes its fp32 partial into `dq_part` (splits x B x Lq x h*d
// floats, which the caller allocates) and sum_splits_kernel adds them in
// order.
// For dv > 32 the two-pass form runs over slabs of `slab` query rows (a
// multiple of 64): `scratch` takes the slab's P and dS from the dQ kernel
// (2 x B*h*slab rows of Lk rounded up to 32 elements, in the input type),
// and grad_t_kernel computes dV and dK from them; at bf16 with Lq > slab
// it then holds the fp32 sums of dV and dK over the slabs (B*Lk*h*dv, then
// B*Lk*h*d floats; ops/kernels/flash_attn_bwd.py scratch_plan). For
// dv <= 32 `scratch` and `slab` are not read. Launches the kernels on
// `stream` in order and returns the first non-zero cudaGetLastError() (0
// on success), or cudaErrorInvalidValue for a shape it does not take;
// allocates nothing. Every output element is written (zeros where no live
// key reaches it).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* valid, const void* dout,
                              const void* lse, const void* delta, void* dq,
                              void* dk, void* dv, void* dq_part, int splits,
                              void* scratch, int slab, int batch, int heads,
                              int lq, int lk, int d, int dv_w, int valid_all,
                              long long q_sb, long long q_sl, long long k_sb,
                              long long k_sl, long long v_sb, long long v_sl,
                              float scale, void* stream) {
  return bwd<float>(q, k, v, valid, dout, lse, delta, dq, dk, dv, dq_part,
                    splits, scratch, slab, batch, heads, lq, lk, d, dv_w,
                    valid_all, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale,
                    stream);
}

extern "C" int flash_attn_bwd_bf16(const void* q, const void* k,
                                   const void* v, const void* valid,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dq, void* dk,
                                   void* dv, void* dq_part, int splits,
                                   void* scratch, int slab, int batch,
                                   int heads, int lq, int lk, int d, int dv_w,
                                   int valid_all, long long q_sb,
                                   long long q_sl, long long k_sb,
                                   long long k_sl, long long v_sb,
                                   long long v_sl, float scale,
                                   void* stream) {
  return bwd<bf16>(q, k, v, valid, dout, lse, delta, dq, dk, dv, dq_part,
                   splits, scratch, slab, batch, heads, lq, lk, d, dv_w,
                   valid_all, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale,
                   stream);
}
