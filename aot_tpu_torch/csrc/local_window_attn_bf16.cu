// Local-window attention forward at bf16 for Hopper (sm_90a), on bf16
// tensor-core products.
//
// Replaces, for bf16 q, k and v, both TPU kernels of
// aot_tpu/ops/pallas/local_window_attn.py that serve dilation-1
// short-term attention: `_kernel_flat` (:414, behind
// local_window_attention_flat :475: up to 2,500 query tokens) and
// `_kernel_wide` (:236, behind local_window_attention_wide :294: the
// full-resolution grids). Layouts as local_window_attn_tc.cu (the fp32
// kernel): q, k (B, HW, h*d), v and out (B, HW, h*dv) bf16; rel_bias
// (B, h, HW, win2) and rel_v (h, dv, win2) fp32. The function is the TPU
// kernels' at bf16 (:420-469): q, k and v widened exactly, q.k scaled, the
// masked softmax over the window, P V and the rel_v product in fp32, the
// output rounded to bf16 once.
//
// Design (the launch plan: local_window_attn_bf16_plan.h). A block owns a
// tile of `rows` (4, 2 or 1) query rows x 16 pixels of one (b, head) and
// one value tile of 32, 128 or 256 columns, in one pass: no scratch, one
// launch. `warps_per_row` warps share a query row (each takes every such
// 8-key block of a score product and a contiguous slice of the value
// tile). The key halo of a query row's window row dy is the 32 keys of
// image row y + dy - M from column x0 - M, so
//   S_dy = Q_row (16 x d) . K_halo^T (d x 32)
// is one banded product, as in the fp32 kernel; the block walks the halo
// rows of its tile in order through a two-stage cp.async ring, twice: K,
// then V.
//   1. scores: each S_dy by mma.sync m16n8k16 on the bf16 operands as
//      staged: every product of two bf16 values is exact in fp32, so S
//      is the fp32 dot product of the widened operands up to the order of
//      the sums; scaled after (the TPU kernel scales q first: the scale
//      rounds in another place, <= 2^-24 relative).
//   2. rel_bias and the masked softmax in fp32, a warp a query, P kept in
//      the fp32 score block (exactly 0 off the image).
//   3. values: out += P_dy V_halo for each halo row, P split into a bf16
//      high part and a bf16 low part (P = hi + lo + O(2^-16 P)), two bf16
//      products against the bf16 value rows, B fragments by
//      ldmatrix.trans from the rows as staged (keys x columns). One bf16
//      rounding of P would keep 8 bits (2^-9, the output's own rounding):
//      tests/test_torch_port_bf16_fwd.py holds the two choices against the
//      TPU kernel.
//   4. rel_v: P (16 x win2) rel_v^T in 3xTF32 (tf32x3.cuh; rel_v is fp32),
//      folded every 32 slots.
// At dv = 1024 (DeAOT) a block takes 256 value columns, so the four value
// tiles of a tile each stage a quarter of every value row; the scores are
// computed once a value tile (a quarter of the value products' work).
//
// What bounds it. The function does 2(d + dv (+ dv)) FLOPs a (query,
// in-image slot) and reads q, k, v, rel_bias once: at the AOT head
// (d = dv = 32, rel_v) 0.0026 ms of bytes at 30x30 against far fewer of
// bf16 operations; at DeAOT's head 0.0015 ms of bytes (30x30, B = 1),
// 0.0119 at 64x113 (chip_smoke.py local_bound; NVIDIA H100 80GB HBM3, 700
// W). The kernel reads each halo row from L2 once per tile of `rows` query
// rows (16 + 2M of its 32 keys used), about (rows + 2M) / rows x 2 times
// the bytes, and at B = 1 the grid is a few hundred blocks of short
// dependent product chains: latency and L2 traffic, not the tensor cores,
// hold it. What the design does about it: one product a score step and two
// a value step, one pass at dv = 1024 (no P scratch, no second launch),
// 256-column value tiles, and tiles as tall as the grid allows. Rows are
// staged by 16-byte cp.async (8 bytes where d or dv is no multiple of 8),
// padded (conflict-free fragment reads), off-image keys zero-filled: no
// bulk copy or TMA box lands a halo row so.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_mma.cuh"
#include "local_window_attn_bf16_plan.h"
#include "tf32x3.cuh"

namespace {

using namespace lwaplan;
using bf16mma::bf16;
using bf16mma::ld_pair;
using bf16mma::mma_bf16;
using bf16mma::pack_bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* rel_bias;
  const float* rel_v;
  bf16* out;
  int heads, height, width, d, dv, max_dis, win, win2;
  int rows, tiles_x, dpad;
  int ld_s, ld_q, ld_rv;     // in elements (ld_v is the value tile's)
  int q_off, region_off;     // shared-memory bytes
  float scale;
};

// copy VEC consecutive bf16 (8 or 16 bytes); zero if !ok
template <int VEC>
__device__ __forceinline__ void cp_async_vec(bf16* dst, const bf16* src,
                                             bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 8)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(ok ? 8 : 0)
                 : "memory");
}

// Start the copies of the 32 halo keys of one image row, channels
// [0, cols) (cols a multiple of VEC), into dst[key][c] with row stride ld.
// `src` points at the row's column-0 key (channel offset included); keys
// outside the image and channels at or beyond c_end are zero.
template <int VEC>
__device__ __forceinline__ void stage_halo_row(bf16* dst, int ld,
                                               const bf16* src,
                                               long long tstride, int kx0,
                                               int width, int cols,
                                               int c_end, int nthreads) {
  const int cv = cols / VEC;
  for (int i = threadIdx.x; i < kHalo * cv; i += nthreads) {
    const int j = i / cv;
    const int c = (i - j * cv) * VEC;
    const int kx = kx0 + j;
    const bool ok = kx >= 0 && kx < width && c < c_end;
    cp_async_vec<VEC>(dst + j * ld + c,
                      ok ? src + (long long)kx * tstride + c : src, ok);
  }
}

// The B fragments (m16n8k16: b0 keys 2t..2t+1, b1 keys 2t+8..2t+9, column
// g) of two 8-column blocks at columns n0 and n1 of a 16-key step whose
// first key row is `rows` (row stride ld elements), from rows of keys x
// columns: lane l addresses key (l & 7) + 8 ((l >> 3) & 1) of block
// n0 (l < 16) or n1, and ldmatrix.trans hands each lane its pairs.
__device__ __forceinline__ void ldsm_b2(uint32_t* b, const bf16* rows,
                                        int ld, int n0, int n1) {
  const int l = threadIdx.x & 31;
  const bf16* p = rows + ((l & 7) + 8 * ((l >> 3) & 1)) * ld +
                  8 * (l < 16 ? n0 : n1);
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(s));
}

// ... of one 8-column block (lanes 0-15 address it)
__device__ __forceinline__ void ldsm_b1(uint32_t* b, const bf16* rows,
                                        int ld, int n0) {
  const int l = threadIdx.x & 15;
  const bf16* p = rows + ((l & 7) + 8 * (l >> 3)) * ld + 8 * n0;
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(s));
}

// P split into bf16 hi and lo parts, packed as an A fragment pair
__device__ __forceinline__ void split_pair(uint32_t& hi, uint32_t& lo,
                                           float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The plan's tiles of one instantiation, tied to the plan header
template <int VT, int WN>
struct Tiles {
  static constexpr int kR = chunk_rows(VT);   // halo rows a ring stage
  static constexpr int kNK = 4 / WN;          // 8-key blocks of a warp
  static constexpr int kNV = VT / 8 / WN;     // 8-column value blocks
  static_assert((VT == 32 || VT == 128 || VT == 256) && kNK >= 1 && kNV >= 1 &&
                WN * kNK == kHalo / 8 && kHalo == 2 * kKStep &&
                (WN == warps_per_row(4) || WN == warps_per_row(2)));
};

// VT value columns a block, WN warps a query row: warp part p owns the
// 8-key blocks n = p, p + WN, ... of each score product, the queries
// x = p, p + WN, ... of the softmax and the value columns
// [p VT / WN, (p + 1) VT / WN) of the tile.
template <int VT, int WN, int VEC>
__global__ void __launch_bounds__(kMaxThreads, 2) local_bf16_kernel(Args a) {
  constexpr int kR = Tiles<VT, WN>::kR;
  constexpr int kNK = Tiles<VT, WN>::kNK;
  constexpr int kNV = Tiles<VT, WN>::kNV;
  constexpr int kLdV = VT + 8;            // the plan's kLdV
  const int rows = a.rows;
  const int nthreads = rows * WN * 32;
  extern __shared__ __align__(128) char smem[];
  float* sc = reinterpret_cast<float*>(smem);
  bf16* s_q = reinterpret_cast<bf16*>(smem + a.q_off);
  bf16* u = reinterpret_cast<bf16*>(smem + a.region_off);  // rings, rel_v

  const int warp = threadIdx.x >> 5;
  const int qrow = warp / WN;                   // the warp's query row
  const int part = warp - qrow * WN;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int tile_y = blockIdx.x / a.tiles_x;
  const int y0 = tile_y * rows;
  const int x0 = (blockIdx.x - tile_y * a.tiles_x) * kTileX;
  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int head = bh - b * a.heads;
  const int M = a.max_dis;
  const int win = a.win;
  const int win2 = a.win2;
  const int hw = a.height * a.width;
  const int y = y0 + qrow;
  const bool row_ok = y < a.height;             // warp-uniform
  // band columns in use: 16 + 2M keys, in 8-key blocks
  const int nb = (kTileX + 2 * M + 7) >> 3;
  // halo rows in the image, ky = y0 - M + r, in ring stages of kR rows
  const int r_lo = max(0, M - y0);
  const int r_hi = min(rows + 2 * M, a.height - y0 + M);
  const int n_chunks = (r_hi - r_lo + kR - 1) / kR;
  float* srow = sc + qrow * kTileX * a.ld_s;    // the warp's 16 score rows
  const long long run0 = ((long long)bh * hw + (long long)y0 * a.width + x0) *
                         win2;
  const long long hw_row = (long long)a.width * win2;

  // 1. scores
  const long long qk_stride = (long long)a.heads * a.d;
  const bf16* k_img = a.k + (long long)b * hw * qk_stride +
                      (long long)head * a.d;
  {
    const int cv = a.dpad / VEC;
    const bf16* q_img = a.q + (long long)b * hw * qk_stride +
                        (long long)head * a.d;
    for (int i = threadIdx.x; i < rows * kTileX * cv; i += nthreads) {
      const int qi = i / cv;
      const int c = (i - qi * cv) * VEC;
      const int qy = y0 + qi / kTileX;
      const int qx = x0 + (qi & (kTileX - 1));
      const bool ok = qy < a.height && qx < a.width && c < a.d;
      cp_async_vec<VEC>(
          s_q + qi * a.ld_q + c,
          ok ? q_img + (long long)(qy * a.width + qx) * qk_stride + c : q_img,
          ok);
    }
  }
  const int k_rows = kHalo * a.ld_q;            // elements of a staged row
  auto stage_k = [&](int c) {
    if (c < n_chunks) {
      for (int rr = 0; rr < kR; ++rr) {
        const int r = r_lo + c * kR + rr;
        if (r >= r_hi) break;
        const int ky = y0 - M + r;
        stage_halo_row<VEC>(u + ((c & 1) * kR + rr) * k_rows, a.ld_q,
                       k_img + (long long)ky * a.width * qk_stride, qk_stride,
                       x0 - M, a.width, a.dpad, a.d, nthreads);
      }
    }
    tf32x3::cp_async_commit();
  };
  stage_k(0);
  const int ksteps = a.dpad / kKStep;
  const bf16* q_frag = s_q + (qrow * kTileX + g) * a.ld_q + 2 * t;
  for (int c = 0; c < n_chunks; ++c) {
    stage_k(c + 1);
    tf32x3::cp_async_wait<1>();
    __syncthreads();
    const int dy0 = r_lo + c * kR - qrow;
    bool ok[kR];
#pragma unroll
    for (int rr = 0; rr < kR; ++rr)
      ok[rr] = row_ok && dy0 + rr >= 0 && dy0 + rr < win &&
               r_lo + c * kR + rr < r_hi;      // warp-uniform
    float s[kR][kNK][4];
#pragma unroll
    for (int rr = 0; rr < kR; ++rr)
#pragma unroll
      for (int i = 0; i < kNK; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[rr][i][e] = 0.f;
    const bf16* kt = u + (c & 1) * kR * k_rows;
    // S_dy = Q K_halo^T: A(query, channel), B(channel, key)
#pragma unroll 2
    for (int ks = 0; ks < ksteps; ++ks) {
      const bf16* qa = q_frag + ks * kKStep;
      const uint32_t fa[4] = {ld_pair(qa), ld_pair(qa + 8 * a.ld_q),
                              ld_pair(qa + 8), ld_pair(qa + 8 * a.ld_q + 8)};
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        if (ok[rr]) {
#pragma unroll
          for (int i = 0; i < kNK; ++i) {
            const int n = part + i * WN;
            if (n < nb) {
              const bf16* kb = kt + rr * k_rows + (n * 8 + g) * a.ld_q +
                               ks * kKStep + 2 * t;
              mma_bf16(s[rr][i], fa, ld_pair(kb), ld_pair(kb + 8));
            }
          }
        }
      }
    }
    // band extraction: accumulator (x, column c) is slot (dy, c - x)
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      if (!ok[rr]) continue;
      float* sdy = srow + (dy0 + rr) * win;
#pragma unroll
      for (int i = 0; i < kNK; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = g + 8 * (e >> 1);
          const int dx = (part + i * WN) * 8 + 2 * t + (e & 1) - x;
          if ((unsigned)dx < (unsigned)win)
            sdy[x * a.ld_s + dx] = s[rr][i][e] * a.scale;
        }
    }
    __syncthreads();                            // the stage is free
  }
  tf32x3::cp_async_wait<0>();

  // the value pass's first copies go out before the softmax runs
  const long long v_stride = (long long)a.heads * a.dv;
  const int vt0 = blockIdx.z * VT;              // this block's value tile
  const bf16* v_img = a.v + (long long)b * hw * v_stride +
                      (long long)head * a.dv + vt0;
  constexpr int kVRow = kHalo * kLdV;           // elements of a staged row
  auto stage_v = [&](int c) {
    if (c < n_chunks) {
      for (int rr = 0; rr < kR; ++rr) {
        const int r = r_lo + c * kR + rr;
        if (r >= r_hi) break;
        const int ky = y0 - M + r;
        stage_halo_row<VEC>(u + ((c & 1) * kR + rr) * kVRow, kLdV,
                       v_img + (long long)ky * a.width * v_stride, v_stride,
                       x0 - M, a.width, VT, a.dv - vt0, nthreads);
      }
    }
    tf32x3::cp_async_commit();
  };
  stage_v(0);

  // 2. rel_bias and the softmax over each query's win2 slots: lane l holds
  //    slots l + 32i, so its rel_bias reads are one coalesced run a query;
  //    every slot is written (exactly 0 where the key is off the image)
  {
    int slot_dx[8];
    unsigned slot_ok = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = lane + 32 * i;
      const int dy = j / win;
      slot_dx[i] = j - dy * win - M;
      const int ky = y + dy - M;
      if (row_ok && j < win2 && ky >= 0 && ky < a.height) slot_ok |= 1u << i;
    }
#pragma unroll 2
    for (int xi = 0; xi < kTileX / WN; ++xi) {
      const int x = part + xi * WN;
      const int gx = x0 + x;
      float* sq = srow + x * a.ld_s;
      const float* rb =
          a.rel_bias + run0 + qrow * hw_row + (long long)x * win2;
      float e[8];
      unsigned ok = gx < a.width ? slot_ok : 0u;
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int kx = gx + slot_dx[i];
        if (kx < 0 || kx >= a.width) ok &= ~(1u << i);
        e[i] = (ok >> i) & 1u ? sq[lane + 32 * i] + __ldg(rb + lane + 32 * i)
                              : kNegInf;
        mx = fmaxf(mx, e[i]);
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        e[i] = (ok >> i) & 1u ? exp2f((e[i] - mx) * kLog2e) : 0.f;
        sum += e[i];
      }
      sum = warp_sum(sum);
      const float inv = sum > 0.f ? 1.f / sum : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int j = lane + 32 * i;
        if (j < win2) sq[j] = e[i] * inv;
      }
    }
  }
  __syncwarp();

  // 3. values: out += P_dy (banded, 16 x 32, as hi + lo) V_halo(dy) per
  //    halo row
  float acc[kNV][4];
#pragma unroll
  for (int i = 0; i < kNV; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const int n_first = part * kNV;               // the warp's first block
  const float* p0 = srow + g * a.ld_s;          // rows g and g + 8
  const float* p1 = p0 + 8 * a.ld_s;
  const int vsteps = (nb * 8 + kKStep - 1) / kKStep;   // 1 or 2
  for (int c = 0; c < n_chunks; ++c) {
    stage_v(c + 1);
    tf32x3::cp_async_wait<1>();
    __syncthreads();
    const int dy0 = r_lo + c * kR - qrow;
    const bf16* vt = u + (c & 1) * kR * kVRow;
#pragma unroll
    for (int rr = 0; rr < kR; ++rr) {
      const int dy = dy0 + rr;
      if (!(row_ok && dy >= 0 && dy < win && r_lo + c * kR + rr < r_hi))
        continue;                               // warp-uniform
      const int s0 = dy * win;
      const bf16* vr = vt + rr * kVRow;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        if (ks < vsteps) {
          // A(x, key column cc) = P[x][dy, cc - x] on the band, else 0:
          // rows g, g + 8 (r) and columns 2t, 2t + 1, 2t + 8, 2t + 9 (j)
          float p[2][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int cc = ks * kKStep + 2 * t + (j & 1) + 8 * (j >> 1);
            const int d0 = cc - g, d1 = cc - g - 8;
            p[0][j] = (unsigned)d0 < (unsigned)win ? p0[s0 + d0] : 0.f;
            p[1][j] = (unsigned)d1 < (unsigned)win ? p1[s0 + d1] : 0.f;
          }
          uint32_t hi[4], lo[4];
          split_pair(hi[0], lo[0], p[0][0], p[0][1]);
          split_pair(hi[1], lo[1], p[1][0], p[1][1]);
          split_pair(hi[2], lo[2], p[0][2], p[0][3]);
          split_pair(hi[3], lo[3], p[1][2], p[1][3]);
          const bf16* vk = vr + ks * kKStep * kLdV;
#pragma unroll
          for (int i = 0; i < kNV; i += 2) {
            uint32_t fb[4];
            if (i + 1 < kNV)
              ldsm_b2(fb, vk, kLdV, n_first + i, n_first + i + 1);
            else
              ldsm_b1(fb, vk, kLdV, n_first + i);
            // the small term first
            mma_bf16(acc[i], lo, fb[0], fb[1]);
            mma_bf16(acc[i], hi, fb[0], fb[1]);
            if (i + 1 < kNV) {
              mma_bf16(acc[i + 1], lo, fb[2], fb[3]);
              mma_bf16(acc[i + 1], hi, fb[2], fb[3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  tf32x3::cp_async_wait<0>();

  // 4. rel_v: out += P (16 x win2, slot order) rel_v[head]^T in 3xTF32,
  //    32 value columns (4 blocks) a staged chunk, folded every 32 slots
  if (a.rel_v != nullptr) {                     // block-uniform
    const int rsteps = (win2 + 7) >> 3;
#pragma unroll
    for (int cc = 0; cc < VT / 32; ++cc) {
      const int c_base = vt0 + cc * 32;
      if (c_base >= a.dv) break;
      __syncthreads();                          // the region is free
      const float* src = a.rel_v + ((long long)head * a.dv + c_base) * win2;
      float* u_rv = reinterpret_cast<float*>(u);
      const int n_cols = min(32, a.dv - c_base);
      for (int i = threadIdx.x; i < 32 * a.ld_rv; i += nthreads) {
        const int col = i / a.ld_rv;
        const int j = i - col * a.ld_rv;
        const bool ok = col < n_cols && j < win2;
        tf32x3::cp_async4(u_rv + i, ok ? src + (long long)col * win2 + j : src,
                          ok);
      }
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<0>();
      __syncthreads();
      if (row_ok) {
#pragma unroll
        for (int i = 0; i < kNV; ++i) {
          const int n = n_first + i;
          if ((n >> 2) != cc) continue;         // not in this chunk
          const float* rvb = u_rv + ((n & 3) * 8 + g) * a.ld_rv;
          float part_acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          for (int ks0 = 0; ks0 < rsteps; ks0 += 4) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int ks = ks0 + kk;
              if (ks >= rsteps) break;
              const int j = ks * 8 + t;
              const tf32x3::FragA fa = tf32x3::frag_a(
                  j < win2 ? p0[j] : 0.f, j < win2 ? p1[j] : 0.f,
                  j + 4 < win2 ? p0[j + 4] : 0.f,
                  j + 4 < win2 ? p1[j + 4] : 0.f);
              tf32x3::mma3(part_acc[kk & 1], fa,
                           tf32x3::frag_b(rvb[j], rvb[j + 4]));
            }
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                acc[i][e] += part_acc[jj][e];
                part_acc[jj][e] = 0.f;
              }
          }
        }
      }
    }
  }

  if (!row_ok) return;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int gx = x0 + g + 8 * h2;
    if (gx >= a.width) continue;
    bf16* o_row = a.out + ((long long)b * hw + (long long)y * a.width + gx) *
                              v_stride +
                  (long long)head * a.dv;
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      const int col = vt0 + (n_first + i) * 8 + 2 * t;   // dv % 4 == 0
      if (col < a.dv)
        *reinterpret_cast<__nv_bfloat162*>(o_row + col) =
            __floats2bfloat162_rn(acc[i][2 * h2], acc[i][2 * h2 + 1]);
    }
  }
}

template <int VT, int WN>
int launch(const Args& a, const long long* plan, cudaStream_t stream) {
  auto kernel = plan[kCopy] == 8 ? local_bf16_kernel<VT, WN, 8>
                                 : local_bf16_kernel<VT, WN, 4>;
  const int smem = (int)plan[kSmem];
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)plan[kTiles], (unsigned)(plan[kB] * plan[kH]),
                (unsigned)plan[kValueTiles]),
           (unsigned)(plan[kWarps] * 32), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry, bound from Python with ctypes: `plan` as lwa_bf16_plan
// filled it for this shape (local_window_attn_bf16_plan.h), q, k, v and out
// bf16, rel_bias and rel_v (or null) fp32, in the layouts above. Launches
// on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a plan it does not take; allocates nothing.
extern "C" int local_window_attn_bf16(const long long* plan, const void* q,
                                      const void* k, const void* v,
                                      const void* rel_bias,
                                      const void* rel_v, void* out,
                                      float scale, void* stream) {
  const int rows = (int)plan[kRows], vt = (int)plan[kValueTile];
  if (plan[kSmem] < 1 || plan[kSmem] > kMaxSmem ||
      plan[kWarps] != rows * warps_per_row(rows) ||
      (rel_v != nullptr) != (plan[kRelV] != 0) ||
      plan[kLdV] != vt + 8 || vt != value_tile(plan[kDv], plan[kDPad]) ||
      plan[kCopy] != copy_elems(plan[kD], plan[kDv]))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.rel_bias = (const float*)rel_bias;
  a.rel_v = (const float*)rel_v;
  a.out = (bf16*)out;
  a.heads = (int)plan[kH];
  a.height = (int)plan[kHeight];
  a.width = (int)plan[kWidth];
  a.d = (int)plan[kD];
  a.dv = (int)plan[kDv];
  a.max_dis = (int)plan[kMaxDis];
  a.win = 2 * a.max_dis + 1;
  a.win2 = a.win * a.win;
  a.rows = rows;
  a.tiles_x = (int)plan[kTilesX];
  a.dpad = (int)plan[kDPad];
  a.ld_s = (int)plan[kLdS];
  a.ld_q = (int)plan[kLdQ];
  a.ld_rv = (int)plan[kLdRv];
  a.q_off = (int)plan[kQOff];
  a.region_off = (int)plan[kRegionOff];
  a.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (vt == 32)
    return rows == 4 ? launch<32, 2>(a, plan, s) : launch<32, 4>(a, plan, s);
  if (rows == 4) return (int)cudaErrorInvalidValue;
  return vt == 128 ? launch<128, 4>(a, plan, s) : launch<256, 4>(a, plan, s);
}
