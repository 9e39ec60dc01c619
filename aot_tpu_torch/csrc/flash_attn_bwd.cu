// Flash-attention backward for Hopper (sm_90a), fp32.
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
// out and accumulation; plain FMAs, no TF32.
//
// Design (simple first). Three kernels, each a block of 256 threads
// (16 x 16) that owns one 64-row tile of its output and loops over the
// other side's 64-wide tiles inside the block, so no two blocks write the
// same element: no atomics, and the gradients are the same from run to run.
//   dq_kernel  block per (b*h, query tile), loops over the live key tiles
//              (for a grid of fewer than two waves, as one video at h = 1
//              gives, the key loop is split over `splits` blocks whose
//              partials a last kernel adds in a fixed order);
//   dk_kernel  block per (b*h, key tile), loops over the query tiles;
//   dv_kernel  block per (b*h, key tile, dv column tile), loops over the
//              query tiles.
// (dq_kernel and dk_kernel are one template, `grad_qk_kernel`, with the
// roles of rows and columns swapped.) Each block recomputes its 64 x 64
// score tile from q and k in shared memory and P = exp(S - lse), as the TPU
// kernels do. Why three and not the JAX split's two: at DeAOT's dv = 1024 a
// 64-key fp32 dV accumulator is 256 KB, more than a block's 227 KB, and dK
// needs dP = dO V^T summed over all of dv. So dV, which needs no dP, tiles
// dv across the grid (a 32-, 64- or 128-column accumulator in registers),
// while
// dQ and dK take dP in a loop over 32-column chunks of dO and V staged
// through shared memory, and never hold a dv-wide row. Each tile's partial
// products are summed apart and folded into the accumulator once per tile
// (on the forward, a per-key running fp32 sum over ~11,700 keys cost a
// 2.8e-4 error). Shared memory: the row tile and the column tile of q/k (64 x
// (d + 4) each), the two dP chunks (64 x 36 each) and the dS or P tile
// (64 x 68): 169 KB at d = 256, 54 KB at AOT's d = 32.
//
// What bounds it: arithmetic. At AOTT's training shape (B = 16, h = 8,
// Lq = Lk = 900, d = dv = 32) the three kernels run ~53 GFLOP of fp32 FMAs
// a call (S three times, dP twice, dQ, dK, dV once each), against the
// card's ~67 TFLOP/s of fp32 outside the tensor cores; q, k, v and dO are
// 7.4 MB a tensor and stay in L2. At DeAOTL's long-term shape (Lq = 900,
// Lk = 19,800, d = 128, dv = 1024) dP dominates (36 GFLOP, twice) and the
// dV kernel recomputes S once per column tile (8 tiles). Later work for
// speed: tensor cores (TF32 or bf16 wgmma, as a declared precision mode),
// fusing dK and dV where dv is small, and cp.async double buffering.

#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;           // rows and columns of a score tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kC = 32;           // dv chunk of the dP product
constexpr int kCS = kC + 4;      // row stride of a dP chunk
constexpr int kPS = kT + 4;      // row stride of the P / dS tile
constexpr int kMaxD = 256;       // q/k channels per head
constexpr float kNegInf = -1e30f;
constexpr float kEmptyLse = -1e29f;  // lse below this: the row has no key

// Stage rows [r0, r0 + kT) of a tile `width` floats wide (a multiple of 4)
// into shared memory with row stride `ld_dst`, scaled by `mul`. Rows at or
// beyond `r_end` and columns at or beyond `c_end` are zero. `src` points
// at row 0, column 0 of the tile's columns; `ld` is the row stride.
__device__ __forceinline__ void stage(float* dst, int ld_dst,
                                      const float* src, long long ld, int r0,
                                      int r_end, int width, int c_end,
                                      float mul) {
  const int w4 = width >> 2;
  for (int i = threadIdx.x; i < kT * w4; i += kThreads) {
    const int r = i / w4;
    const int c = (i - r * w4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < r_end && c < c_end) {
      x = *reinterpret_cast<const float4*>(src + (r0 + r) * ld + c);
      x.x *= mul; x.y *= mul; x.z *= mul; x.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * ld_dst + c) = x;
  }
}

// acc[i][j] += sum_c a[ty + 16 i][c] * b[tx + 16 j][c], c < width
__device__ __forceinline__ void dot_tile(float acc[4][4], const float* a,
                                         int lda, const float* b, int ldb,
                                         int width, int ty, int tx) {
  for (int c = 0; c < width; c += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * lda + c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * ldb + c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = acc[i][j];
        t = fmaf(x[i].x, y[j].x, t);
        t = fmaf(x[i].y, y[j].y, t);
        t = fmaf(x[i].z, y[j].z, t);
        acc[i][j] = fmaf(x[i].w, y[j].w, t);
      }
  }
}

// acc[i][n] += sum_kk p[ty + 16 i][kk] * b[kk][tx + 16 n] over the kT
// columns of the P / dS tile: one tile's products summed apart, then added
// to the accumulator once. Columns at or beyond `ncols` are left alone.
template <int NJ>
__device__ __forceinline__ void fold_tile(float acc[4][NJ], const float* p,
                                          const float* b, int ldb, int ncols,
                                          int ty, int tx) {
#pragma unroll
  for (int n = 0; n < NJ; ++n) {
    const int col = tx + 16 * n;
    if (col >= ncols) continue;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kk = 0; kk < kT; kk += 4) {
      const float b0 = b[(kk + 0) * ldb + col];
      const float b1 = b[(kk + 1) * ldb + col];
      const float b2 = b[(kk + 2) * ldb + col];
      const float b3 = b[(kk + 3) * ldb + col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 w =
            *reinterpret_cast<const float4*>(p + (ty + 16 * i) * kPS + kk);
        float t = part[i];
        t = fmaf(w.x, b0, t);
        t = fmaf(w.y, b1, t);
        t = fmaf(w.z, b2, t);
        part[i] = fmaf(w.w, b3, t);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][n] += part[i];
  }
}

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const int* valid;
  const float* dout;
  const float* lse;
  const float* delta;
  float* dq;
  float* dk;
  float* dv;
  float* dq_part;   // (splits, B, Lq, h*d) unscaled partial dQ, or null
  int heads, lq, lk, d, dv_w, valid_all;
  int key_tiles_per_split;   // dq_kernel: key tiles of each blockIdx.z
  long long split_stride;    // floats between two splits of dq_part
  long long q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;
  float scale;
};

__device__ __forceinline__ int live_keys(const Args& a, int b) {
  const int n = a.valid != nullptr ? a.valid[b] : a.valid_all;
  return max(0, min(n, a.lk));
}

// KEY_ROWS false: dQ, rows are queries and the loop runs over key tiles.
// KEY_ROWS true:  dK, rows are keys and the loop runs over query tiles.
// NJ: output columns per thread (d <= 16 NJ).
template <int NJ, bool KEY_ROWS>
__global__ void __launch_bounds__(kThreads)
grad_qk_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int ds = a.d + 4;
  float* s_row = reinterpret_cast<float*>(smem4);   // kT x ds
  float* s_col = s_row + kT * ds;                    // kT x ds
  float* s_c0 = s_col + kT * ds;                     // kT x kCS
  float* s_c1 = s_c0 + kT * kCS;                     // kT x kCS
  float* s_p = s_c1 + kT * kCS;                      // kT x kPS

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int b = bh / a.heads;
  const int head = bh % a.heads;
  const int r0 = blockIdx.y * kT;
  const int n_live = live_keys(a, b);
  const long long do_sl = (long long)a.heads * a.dv_w;
  const float* q_base = a.q + b * a.q_sb + (long long)head * a.d;
  const float* k_base = a.k + b * a.k_sb + (long long)head * a.d;
  const float* v_base = a.v + b * a.v_sb + (long long)head * a.dv_w;
  const float* do_base = a.dout + (long long)b * a.lq * do_sl +
                         (long long)head * a.dv_w;
  const float* lse = a.lse + (long long)bh * a.lq;
  const float* delta = a.delta + (long long)bh * a.lq;

  // rows: scaled q (dQ) or k (dK); the product with the other side's tile
  // is the score S = (scale q) . k either way
  const int row_end = KEY_ROWS ? n_live : a.lq;
  const int col_end = KEY_ROWS ? a.lq : n_live;
  stage(s_row, ds, KEY_ROWS ? k_base : q_base, KEY_ROWS ? a.k_sl : a.q_sl,
        r0, row_end, a.d, a.d, KEY_ROWS ? 1.f : a.scale);

  // dQ: each row's lse and D, read once
  float lse_r[4], dd_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    lse_r[i] = (!KEY_ROWS && r < a.lq) ? lse[r] : kNegInf;
    dd_r[i] = (!KEY_ROWS && r < a.lq) ? delta[r] : 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NJ; ++n) acc[i][n] = 0.f;

  // a dK block of dead keys skips the loop and writes zeros; a dQ block
  // takes its split's range of key tiles
  int loop_begin = 0, loop_end = col_end;
  if (KEY_ROWS && r0 >= n_live) loop_end = 0;
  if (!KEY_ROWS) {
    loop_begin = blockIdx.z * a.key_tiles_per_split * kT;
    loop_end = min(col_end, loop_begin + a.key_tiles_per_split * kT);
  }
  for (int c0 = loop_begin; c0 < loop_end; c0 += kT) {
    __syncthreads();   // the last tile's readers are done; row tile stored
    stage(s_col, ds, KEY_ROWS ? q_base : k_base, KEY_ROWS ? a.q_sl : a.k_sl,
          c0, col_end, a.d, a.d, KEY_ROWS ? a.scale : 1.f);
    __syncthreads();

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = 0.f;
    dot_tile(p, s_row, ds, s_col, ds, a.d, ty, tx);

    float lse_c[4], dd_c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      lse_c[j] = (KEY_ROWS && c < a.lq) ? lse[c] : kNegInf;
      dd_c[j] = (KEY_ROWS && c < a.lq) ? delta[c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + ty + 16 * i;
        const int c = c0 + tx + 16 * j;
        const int qi = KEY_ROWS ? c : r;
        const int ki = KEY_ROWS ? r : c;
        const float l = KEY_ROWS ? lse_c[j] : lse_r[i];
        const bool live = qi < a.lq && ki < n_live && l > kEmptyLse;
        p[i][j] = live ? expf(p[i][j] - l) : 0.f;
      }

    // dP over dv in chunks: rows x cols of dO . v (dQ) or v . dO (dK)
    float dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = 0.f;
    for (int e0 = 0; e0 < a.dv_w; e0 += kC) {
      __syncthreads();
      const int e_end = a.dv_w - e0;
      stage(s_c0, kCS, (KEY_ROWS ? v_base : do_base) + e0,
            KEY_ROWS ? a.v_sl : do_sl, r0, row_end, kC, e_end, 1.f);
      stage(s_c1, kCS, (KEY_ROWS ? do_base : v_base) + e0,
            KEY_ROWS ? do_sl : a.v_sl, c0, col_end, kC, e_end, 1.f);
      __syncthreads();
      dot_tile(dp, s_c0, kCS, s_c1, kCS, kC, ty, tx);
    }

    // dS = P o (dP - D), stored for the fold
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dd = KEY_ROWS ? dd_c[j] : dd_r[i];
        s_p[(ty + 16 * i) * kPS + tx + 16 * j] = p[i][j] * (dp[i][j] - dd);
      }
    __syncthreads();
    // dQ += dS K (k tile unscaled) or dK += dS^T (scale q) (q tile scaled)
    fold_tile<NJ>(acc, s_p, s_col, ds, a.d, ty, tx);
  }

  // dQ of a split launch: the unscaled partial of this split's keys
  const bool partial = !KEY_ROWS && a.dq_part != nullptr;
  const float out_mul = (KEY_ROWS || partial) ? 1.f : a.scale;
  const int n_rows = KEY_ROWS ? a.lk : a.lq;
  float* out = KEY_ROWS ? a.dk
               : partial ? a.dq_part + blockIdx.z * a.split_stride
               : a.dq;
  const long long o_stride = (long long)a.heads * a.d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= n_rows) continue;
    float* o_row = out + ((long long)b * n_rows + r) * o_stride +
                   (long long)head * a.d;
#pragma unroll
    for (int n = 0; n < NJ; ++n) {
      const int col = tx + 16 * n;
      if (col < a.d) o_row[col] = acc[i][n] * out_mul;
    }
  }
}

// dV for one (b*h, key tile, column tile of 16 NJ value columns).
template <int NJ>
__global__ void __launch_bounds__(kThreads)
grad_v_kernel(Args a) {
  constexpr int kBV = 16 * NJ;
  constexpr int kVS = kBV + 4;
  extern __shared__ float4 smem4[];
  const int ds = a.d + 4;
  float* s_k = reinterpret_cast<float*>(smem4);   // kT x ds
  float* s_q = s_k + kT * ds;                      // kT x ds
  float* s_do = s_q + kT * ds;                     // kT x kVS
  float* s_p = s_do + kT * kVS;                    // kT x kPS

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int b = bh / a.heads;
  const int head = bh % a.heads;
  const int k0 = blockIdx.y * kT;
  const int v0 = blockIdx.z * kBV;
  const int n_live = live_keys(a, b);
  const long long do_sl = (long long)a.heads * a.dv_w;
  const float* q_base = a.q + b * a.q_sb + (long long)head * a.d;
  const float* k_base = a.k + b * a.k_sb + (long long)head * a.d;
  const float* do_base = a.dout + (long long)b * a.lq * do_sl +
                         (long long)head * a.dv_w + v0;
  const float* lse = a.lse + (long long)bh * a.lq;

  stage(s_k, ds, k_base, a.k_sl, k0, n_live, a.d, a.d, 1.f);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NJ; ++n) acc[i][n] = 0.f;

  const int loop_end = k0 >= n_live ? 0 : a.lq;
  for (int q0 = 0; q0 < loop_end; q0 += kT) {
    __syncthreads();
    stage(s_q, ds, q_base, a.q_sl, q0, a.lq, a.d, a.d, a.scale);
    stage(s_do, kVS, do_base, do_sl, q0, a.lq, kBV, a.dv_w - v0, 1.f);
    __syncthreads();

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = 0.f;
    dot_tile(p, s_k, ds, s_q, ds, a.d, ty, tx);   // rows keys, cols queries
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qi = q0 + tx + 16 * j;
      const float l = qi < a.lq ? lse[qi] : kNegInf;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool live = qi < a.lq && k0 + ty + 16 * i < n_live &&
                          l > kEmptyLse;
        s_p[(ty + 16 * i) * kPS + tx + 16 * j] =
            live ? expf(p[i][j] - l) : 0.f;
      }
    }
    __syncthreads();
    fold_tile<NJ>(acc, s_p, s_do, kVS, kBV, ty, tx);   // dV += P^T dO
  }

  const long long o_stride = (long long)a.heads * a.dv_w;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= a.lk) continue;
    float* o_row = a.dv + ((long long)b * a.lk + r) * o_stride +
                   (long long)head * a.dv_w + v0;
#pragma unroll
    for (int n = 0; n < NJ; ++n) {
      const int col = tx + 16 * n;
      if (v0 + col < a.dv_w) o_row[col] = acc[i][n];
    }
  }
}

// dq = scale * sum over splits of dq_part, in split order (deterministic)
__global__ void __launch_bounds__(kThreads)
sum_splits_kernel(const float* __restrict__ part, float* __restrict__ dq,
                  long long n, int splits, float scale) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    float t = 0.f;
    for (int s = 0; s < splits; ++s) t += part[s * n + i];
    dq[i] = t * scale;
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool KEY_ROWS>
int launch_qk(const Args& a, int batch, int splits, cudaStream_t stream) {
  const int rows = KEY_ROWS ? a.lk : a.lq;
  const dim3 grid(batch * a.heads, (rows + kT - 1) / kT,
                  KEY_ROWS ? 1 : splits);
  const size_t smem = sizeof(float) * (size_t)(2 * kT * (a.d + 4) +
                                               2 * kT * kCS + kT * kPS);
  if (a.d <= 32)
    return launch(grad_qk_kernel<2, KEY_ROWS>, grid, smem, stream, a);
  if (a.d <= 64)
    return launch(grad_qk_kernel<4, KEY_ROWS>, grid, smem, stream, a);
  if (a.d <= 128)
    return launch(grad_qk_kernel<8, KEY_ROWS>, grid, smem, stream, a);
  return launch(grad_qk_kernel<16, KEY_ROWS>, grid, smem, stream, a);
}

template <int NJ>
int launch_v(const Args& a, int batch, cudaStream_t stream) {
  constexpr int kBV = 16 * NJ;
  const dim3 grid(batch * a.heads, (a.lk + kT - 1) / kT,
                  (a.dv_w + kBV - 1) / kBV);
  const size_t smem = sizeof(float) * (size_t)(2 * kT * (a.d + 4) +
                                               kT * (kBV + 4) + kT * kPS);
  return launch(grad_v_kernel<NJ>, grid, smem, stream, a);
}

}  // namespace

// Plain C entry point, bound from Python with ctypes. Strides are in floats;
// every stride and pointer must be 16-byte aligned (the wrapper checks).
// `splits` > 1 splits dq_kernel's key loop over that many blocks a query
// tile, for grids too small to fill the card (one video at h = 1): each
// writes its partial into `dq_part` (splits x B x Lq x h*d floats, which
// the caller allocates) and sum_splits_kernel adds them in order. Launches
// the kernels on `stream` in order and returns the first non-zero
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// it does not take; allocates nothing. Every output element is written
// (zeros where no live key reaches it).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* valid, const void* dout,
                              const void* lse, const void* delta, void* dq,
                              void* dk, void* dv, void* dq_part, int splits,
                              int batch, int heads, int lq, int lk, int d,
                              int dv_w, int valid_all, long long q_sb,
                              long long q_sl, long long k_sb, long long k_sl,
                              long long v_sb, long long v_sl, float scale,
                              void* stream) {
  if (batch < 1 || heads < 1 || lq < 1 || lk < 1 || d < 4 || d > kMaxD ||
      d % 4 != 0 || dv_w < 4 || dv_w % 4 != 0 || splits < 1 ||
      (splits > 1) != (dq_part != nullptr) ||
      (q_sb | q_sl | k_sb | k_sl | v_sb | v_sl) % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int key_tiles = (lk + kT - 1) / kT;
  Args a{(const float*)q, (const float*)k, (const float*)v,
         (const int*)valid, (const float*)dout, (const float*)lse,
         (const float*)delta, (float*)dq, (float*)dk, (float*)dv,
         (float*)dq_part, heads, lq, lk, d, dv_w, valid_all,
         (key_tiles + splits - 1) / splits,
         (long long)batch * lq * heads * d,
         q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale};
  cudaStream_t s = (cudaStream_t)stream;
  int err = launch_qk<false>(a, batch, splits, s);
  if (err != 0) return err;
  err = launch_qk<true>(a, batch, 1, s);
  if (err != 0) return err;
  err = dv_w <= 32 ? launch_v<2>(a, batch, s)
      : dv_w <= 64 ? launch_v<4>(a, batch, s) : launch_v<8>(a, batch, s);
  if (err != 0 || splits == 1) return err;
  const long long n = (long long)batch * lq * heads * d;
  const int blocks = (int)((n + kThreads - 1) / kThreads < 1024
                               ? (n + kThreads - 1) / kThreads : 1024);
  sum_splits_kernel<<<blocks, kThreads, 0, s>>>((const float*)dq_part,
                                                (float*)dq, n, splits, scale);
  return (int)cudaGetLastError();
}
