// Local-window attention forward for Hopper (sm_90a), fp32-accurate on the
// TF32 tensor cores, with banded halo products.
//
// Replaces both TPU kernels of aot_tpu/ops/pallas/local_window_attn.py that
// serve dilation-1 short-term attention (aot_tpu/ops/attention.py:376-383):
// `_kernel_flat` (:414, behind local_window_attention_flat :475: the grids
// up to 2,500 query tokens, 30x30 at 465x465) and `_kernel_wide` (:236,
// behind local_window_attention_wide :294: the full-resolution grids, 43x76
// at 720p, 64x113 at DAVIS 1080p). One kernel template computes both, at
// the port's public layout:
//   q, k      (B, HW, h*d)      contiguous fp32, 16-byte aligned
//   v         (B, HW, h*dv)
//   rel_bias  (B, h, HW, win2)  per-query relative key bias
//   rel_v     (h, dv, win2)     relative value bias, or null
//   out       (B, HW, h*dv)
// with win = 2*max_dis+1, win2 = win*win, d and dv multiples of 4. For each
// (b, head, query):
//   s[slot] = (q . k[key(slot)]) * scale + rel_bias[slot]   (key in image)
//   p = softmax(s) over the in-image slots; off-image slots get exactly 0
//   out = sum_slot p * v[key] (+ sum_slot p * rel_v[:, slot])
//
// Design. A block owns a tile of `rows` (1, 2 or 4) query rows x 16
// consecutive pixels of one (b, head); the 16 queries of a row are the 16
// rows of an mma.sync m16n8k8 tile, and WN warps share a row (2 in a 4-row
// tile, else 4: 8 warps a block, 4 in a 1-row tile), each taking every
// WN-th 8-column block of each product. The key halo of a
// query row's window row dy is the 32 keys of image row y+dy-M from column
// x0-M on (16 + 2M <= 30 of them used, M = max_dis), so
//   S_dy = Q_row (16 x d) . K_halo^T (d x 32)
// is one banded product: query x finds its slot (dy, dx) in accumulator
// column x + dx. 47% of the products are used (15 of 32 columns), but every
// operand comes from a fragment, where the first fp32 kernels read one
// operand from shared memory for every FMA. Every product is three TF32
// mma.sync products of hi/lo splits (3xTF32, tf32x3.cuh), so the result
// keeps fp32's accuracy. The block walks the halo rows of its tile in
// order (rows + 2M of them, rows outside the image skipped), a stage of
// `chunk_rows` rows at a time through a ring of two shared-memory stages
// filled with 16-byte cp.async: the next stage loads while the warps run
// the products of this one's rows back to back (independent accumulators,
// one q fragment shared), so a barrier and a load wait come once a stage.
//   1. scores: each S_dy is scaled and stored into the score block in slot
//      order (band extraction: slot dy*win + dx <- accumulator column
//      x + dx).
//   2. rel_bias and softmax in fp32 over each query's win2 slots, a warp a
//      query (lane l holds slots l + 32i, so a query's rel_bias is one
//      coalesced run; max and sum by shuffles), masked by position (slots
//      whose key lies outside the image get exactly 0); the normalised P
//      stays in the score block.
//   3. values: for each halo row, P_dy is read back as a banded 16 x 32 A
//      operand (zeros off the band) and multiplied by the staged value
//      row, one value tile of 32 or 128 columns; a stage's products are
//      folded into the fp32 output once (the tensor core rounds its
//      accumulator toward zero, so long sums are not left in it).
//   4. rel_v: a dense product P (16 x win2, slot order) . rel_v[head]^T
//      (win2 x 32 columns a chunk, staged once a block), folded every 32
//      slots.
// For dv > 128 (DeAOT's dv = 1024 at h = 1) a block cannot hold the
// output, and recomputing the scores per value tile would repeat the most
// expensive part, so there are two passes, as in flash_attn_fwd.cu (also
// for d > 128, whose q rows and k ring leave no room for the values):
//   pass 1 (kScores): steps 1-2, then P is written to a scratch
//     (B*h, HW, win2) the wrapper allocates (0.8 MB at 30x30, 6.5 MB at
//     64x113);
//   pass 2 (kValues): P is read back into the score block, then steps 3-4
//     for one 128-column value tile, on a grid of tiles x value tiles.
// The wrapper's launch plan (ops/kernels/local_window_attn.py
// `launch_plan`) picks each pass's rows a tile so that one video's grid
// gives every multiprocessor a block: 2 x 16 tiles give 30 tiles x 8 heads
// = 240 blocks at the AOT head at 30x30, 4 x 16 tiles 1,024 at 64x113. The
// kernel derives the rest from the rows: warps, ring stages, shared memory
// (a launch whose layout does not fit a block's shared memory fails).
//
// What bounds it. Counting only the in-image slots, the function does
// 2(d + dv (+ dv)) FLOPs a (query, slot) and reads q, k, v, rel_bias once:
// at the AOT head (d = dv = 32, rel_v) that is 0.0031 ms of bytes at 30x30
// against 0.0023 ms of fp32-accurate tensor-core operations (165 TFLOP/s),
// so bytes bound it; at DeAOT's head (d = 128, dv = 1024) bytes and
// operations are near balance (0.0218 ms at 64x113; NVIDIA H100 80GB HBM3,
// 700 W). The design does about 2x the needed products (the band) and
// reads each halo row from L2 once per tile and value tile (9-16x the
// value bytes at DeAOT's head); what limits it on the card is latency:
// 8-16 warps an SM, each product a chain of dependent mma.sync steps and
// each stage a barrier. wgmma over wider tiles is the next step.
//
// bf16 q, k and v go to local_window_attn_bf16.cu (bf16 products).

#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

__device__ __forceinline__ float ldf(float x) { return x; }

// copy 4 consecutive elements (16 bytes); zero if !ok
__device__ __forceinline__ void cp_async_4el(float* dst, const float* src,
                                             bool ok) {
  cp_async16(dst, src, ok);
}

// two adjacent output columns
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

constexpr int kTX = 16;        // queries a tile row: the mma tile's 16 rows
constexpr int kHalo = 32;      // halo keys a row (16 + 2 * max_dis <= 30)
constexpr int kMaxDis = 7;
constexpr int kMaxSmem = 232448;
constexpr float kNegInf = -1e30f;

enum Mode { kOnePass = 0, kScores = 1, kValues = 2 };

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  const float* rel_bias;
  const float* rel_v;
  T* out;
  float* p;             // two passes: P, (B*h, HW, win2)
  int heads, height, width, d, dv, max_dis;
  int rows;             // query rows a tile
  int tiles_x;
  float scale;
  int win, win2;
  int ld_s;             // score block row stride: = 9 mod 32
  int ld_qk;            // q and k rows: round_up(d, 8) + 4, = 4 mod 8
  int ld_rv;            // staged rel_v rows: round_up(win2, 8) + 4
};

// Halo rows a ring stage holds: the products of a stage's rows run back to
// back between two barriers. Four at the AOT head's 32-column rows, two at
// 128-column value rows; one at the scores of the two-pass form, whose
// d >= 128 gives each row's product 16 steps or more of its own.
template <int MODE, int DVT>
__host__ __device__ constexpr int chunk_rows() {
  return MODE == kScores ? 1 : MODE == kOnePass && DVT == 32 ? 4 : 2;
}

// Shared-memory layout: the score block (rows*16 x ld_s floats), the q
// tile (rows*16 x ld_qk elements of T; not in kValues) and one region
// that holds in turn the k ring, the v ring (two stages of `chunk` halo
// rows each, in T) and an fp32 rel_v chunk. sc and q count their
// elements, u its bytes.
struct Layout {
  int sc, q, u;
  template <typename T>
  __host__ __device__ Layout(int mode, int dvt, int chunk, const Args<T>& a,
                             bool with_rv) {
    const int et = (int)sizeof(T);
    sc = a.rows * kTX * a.ld_s;
    q = mode != kValues ? a.rows * kTX * a.ld_qk : 0;
    const int ring_k = mode != kValues ? 2 * chunk * kHalo * a.ld_qk * et : 0;
    const int ring_v =
        mode != kScores ? 2 * chunk * kHalo * (dvt + 8) * et : 0;
    const int rv = mode != kScores && with_rv ? 32 * a.ld_rv * 4 : 0;
    u = ring_k > ring_v ? ring_k : ring_v;
    u = u > rv ? u : rv;
  }
  template <typename T>
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * (size_t)sc + sizeof(T) * (size_t)q + (size_t)u;
  }
};

// Start the 16-byte copies of the 32 halo keys of one image row, channels
// [0, cols) (cols a multiple of 4) into dst[key][c] with row stride ld.
// `src` points at the row's column-0 key (channel offset included);
// keys outside the image and channels at or beyond c_end are zero.
template <typename T>
__device__ __forceinline__ void stage_halo_row(T* dst, int ld, const T* src,
                                               long long tstride, int kx0,
                                               int width, int cols, int c_end,
                                               int nthreads) {
  const int c4 = cols >> 2;
  for (int i = threadIdx.x; i < kHalo * c4; i += nthreads) {
    const int j = i / c4;
    const int c = (i - j * c4) << 2;
    const int kx = kx0 + j;
    const bool ok = kx >= 0 && kx < width && c < c_end;
    cp_async_4el(dst + j * ld + c,
                 ok ? src + (long long)kx * tstride + c : src, ok);
  }
}

// Start the 4-byte copies of the win2-float runs of the tile's queries
// (P, in the value pass) into the score block: query x of
// row-tile row qr reads src + qr * row_stride + x * win2. Warp w takes the
// queries w, w + warps, ...; its lanes the run's floats.
__device__ __forceinline__ void stage_score_rows(float* sc, int ld_s,
                                                 const float* src,
                                                 long long row_stride,
                                                 int n_rows, int nx, int win2,
                                                 int warps) {
  const int lane = threadIdx.x & 31;
  for (int qi = threadIdx.x >> 5; qi < n_rows * nx; qi += warps) {
    const int qr = qi / nx;
    const int x = qi - qr * nx;
    const float* run = src + qr * row_stride + (long long)x * win2;
    float* dst = sc + (qr * kTX + x) * ld_s;
    for (int j = lane; j < win2; j += 32) cp_async4(dst + j, run + j, true);
  }
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

constexpr float kLog2e = 1.4426950408889634f;

// WN warps share a query row: warp part p owns the 8-column blocks
// n = p, p + WN, ... of every product (keys, value columns) and the queries
// x = p, p + WN, ... of the softmax.
template <typename T, int MODE, int DVT, int WN>
__global__ void __launch_bounds__(256, 2) local_attn_kernel(Args<T> a) {
  constexpr int kR = chunk_rows<MODE, DVT>();
  constexpr int kNK = 4 / WN;           // key blocks of a warp
  constexpr int kNV = DVT / 8 / WN;     // value blocks of a warp
  const int rows = a.rows;
  const int nthreads = rows * WN * 32;
  const Layout lay(MODE, DVT, kR, a, a.rel_v != nullptr);
  extern __shared__ float4 smem4[];
  float* sc = reinterpret_cast<float*>(smem4);
  T* s_q = reinterpret_cast<T*>(sc + lay.sc);
  T* u = s_q + lay.q;                   // the k and v rings, or rel_v

  const int warp = threadIdx.x >> 5;
  const int qrow = warp / WN;                   // the warp's query row
  const int part = warp - qrow * WN;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int tile_y = blockIdx.x / a.tiles_x;
  const int y0 = tile_y * rows;
  const int x0 = (blockIdx.x - tile_y * a.tiles_x) * kTX;
  const int bh = blockIdx.y;
  const int b = bh / a.heads;
  const int head = bh - b * a.heads;
  const int M = a.max_dis;
  const int win = a.win;
  const int win2 = a.win2;
  const int hw = a.height * a.width;
  const int y = y0 + qrow;
  const bool row_ok = y < a.height;             // warp-uniform
  const int nx = min(kTX, a.width - x0);
  const int n_rows = min(rows, a.height - y0);  // query rows in the image
  // band columns in use: 16 + 2M keys, in 8-key blocks
  const int nb = (kTX + 2 * M + 7) >> 3;
  // halo rows in the image, ky = y0 - M + r, in ring stages of kR rows
  const int r_lo = max(0, M - y0);
  const int r_hi = min(rows + 2 * M, a.height - y0 + M);
  const int n_chunks = (r_hi - r_lo + kR - 1) / kR;
  float* srow = sc + qrow * kTX * a.ld_s;       // the warp's 16 score rows
  // the tile's first query's rel_bias / P run; a row's is hw_row further
  const long long run0 = ((long long)bh * hw + (long long)y0 * a.width + x0) *
                         win2;
  const long long hw_row = (long long)a.width * win2;

  if constexpr (MODE != kValues) {
    // 1. scores
    const long long qk_stride = (long long)a.heads * a.d;
    const int dpad = a.ld_qk - 4;
    const T* k_img = a.k + (long long)b * hw * qk_stride +
                     (long long)head * a.d;
    {
      const int c4 = dpad >> 2;
      const T* q_img = a.q + (long long)b * hw * qk_stride +
                       (long long)head * a.d;
      for (int i = threadIdx.x; i < rows * kTX * c4; i += nthreads) {
        const int qi = i / c4;
        const int c = (i - qi * c4) << 2;
        const int qy = y0 + qi / kTX;
        const int qx = x0 + (qi & (kTX - 1));
        const bool ok = qy < a.height && qx < a.width && c < a.d;
        cp_async_4el(s_q + qi * a.ld_qk + c,
                     ok ? q_img + (long long)(qy * a.width + qx) * qk_stride +
                              c
                        : q_img,
                     ok);
      }
    }
    const int k_rows = kHalo * a.ld_qk;         // floats of a staged row
    auto stage_k = [&](int c) {
      if (c < n_chunks) {
        for (int rr = 0; rr < kR; ++rr) {
          const int r = r_lo + c * kR + rr;
          if (r >= r_hi) break;
          const int ky = y0 - M + r;
          stage_halo_row(u + ((c & 1) * kR + rr) * k_rows, a.ld_qk,
                         k_img + (long long)ky * a.width * qk_stride,
                         qk_stride, x0 - M, a.width, dpad, a.d, nthreads);
        }
      }
      cp_async_commit();
    };
    stage_k(0);
    const int ksteps = dpad >> 3;
    const T* q_frag = s_q + (qrow * kTX + g) * a.ld_qk + t;
    for (int c = 0; c < n_chunks; ++c) {
      stage_k(c + 1);
      cp_async_wait<1>();
      __syncthreads();
      // the products of the stage's rows are independent: they run back to
      // back, sharing each q fragment
      const int dy0 = r_lo + c * kR - qrow;
      bool ok[kR];
#pragma unroll
      for (int rr = 0; rr < kR; ++rr)
        ok[rr] = row_ok && dy0 + rr >= 0 && dy0 + rr < win &&
                 r_lo + c * kR + rr < r_hi;      // warp-uniform
      float s[kR][kNK][4], s_small[kR][kNK][4];
#pragma unroll
      for (int rr = 0; rr < kR; ++rr)
#pragma unroll
        for (int i = 0; i < kNK; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[rr][i][e] = s_small[rr][i][e] = 0.f;
      const T* kt = u + (c & 1) * kR * k_rows;
      // S_dy = Q K_halo^T: A(query, channel), B(channel, key)
#pragma unroll 2
      for (int ks = 0; ks < ksteps; ++ks) {
        const T* qa = q_frag + ks * 8;
        const FragA fa = frag_a(ldf(qa[0]), ldf(qa[8 * a.ld_qk]), ldf(qa[4]),
                                ldf(qa[8 * a.ld_qk + 4]));
#pragma unroll
        for (int rr = 0; rr < kR; ++rr) {
          if (ok[rr]) {
#pragma unroll
            for (int i = 0; i < kNK; ++i) {
              const int n = part + i * WN;
              if (n < nb) {
                const T* kb =
                    kt + rr * k_rows + (n * 8 + g) * a.ld_qk + ks * 8 + t;
                mma3_apart(s[rr][i], s_small[rr][i], fa,
                           frag_b(ldf(kb[0]), ldf(kb[4])));
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
              sdy[x * a.ld_s + dx] = (s[rr][i][e] + s_small[rr][i][e]) * a.scale;
          }
      }
      __syncthreads();                          // the stage is free
    }
    cp_async_wait<0>();
  }

  // the value pass's first copies go out before the softmax runs
  const long long v_stride = (long long)a.heads * a.dv;
  const int vt0 = blockIdx.z * DVT;             // this block's value tile
  const T* v_img = a.v + (long long)b * hw * v_stride +
                   (long long)head * a.dv + vt0;
  constexpr int kLdV = DVT + 8;                 // = 8 mod 32: B reads
  constexpr int kVRow = kHalo * kLdV;           // floats of a staged row
  auto stage_v = [&](int c) {
    if (c < n_chunks) {
      for (int rr = 0; rr < kR; ++rr) {
        const int r = r_lo + c * kR + rr;
        if (r >= r_hi) break;
        const int ky = y0 - M + r;
        stage_halo_row(u + ((c & 1) * kR + rr) * kVRow, kLdV,
                       v_img + (long long)ky * a.width * v_stride, v_stride,
                       x0 - M, a.width, DVT, a.dv - vt0, nthreads);
      }
    }
    cp_async_commit();
  };
  if constexpr (MODE == kValues)
    stage_score_rows(sc, a.ld_s, a.p + run0, hw_row, n_rows, nx, win2,
                     rows * WN);
  if constexpr (MODE != kScores) stage_v(0);

  if constexpr (MODE != kValues) {
    // 2. rel_bias and the softmax over each query's win2 slots: lane l
    //    holds slots l + 32i, so its rel_bias reads are one coalesced run a
    //    query; every slot is written (exactly 0 where the key is off the
    //    image)
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
    for (int xi = 0; xi < kTX / WN; ++xi) {
      const int x = part + xi * WN;
      const int gx = x0 + x;
      float* sq = srow + x * a.ld_s;
      const float* rb = a.rel_bias + run0 + qrow * hw_row + (long long)x * win2;
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
    __syncwarp();
    if constexpr (MODE == kScores) {
      // the warp's own queries' P, one coalesced run each
      if (row_ok) {
        float* dst = a.p + run0 + qrow * hw_row;
        for (int x = part; x < nx; x += WN)
          for (int j = lane; j < win2; j += 32)
            dst[(long long)x * win2 + j] = srow[x * a.ld_s + j];
      }
      return;
    }
  }

  if constexpr (MODE != kScores) {
    // 3. values: out += P_dy (banded, 16 x 32) V_halo(dy) per halo row; the
    //    rows of a stage go into two accumulators (alternate rows), folded
    //    into the fp32 output once a stage
    float acc[kNV][4];
#pragma unroll
    for (int i = 0; i < kNV; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    const float* p0 = srow + g * a.ld_s;        // rows g and g + 8
    const float* p1 = p0 + 8 * a.ld_s;
    constexpr int kPV = kR < 2 ? kR : 2;
    for (int c = 0; c < n_chunks; ++c) {
      stage_v(c + 1);
      cp_async_wait<1>();
      __syncthreads();
      const int dy0 = r_lo + c * kR - qrow;
      float pv[kPV][kNV][4];
#pragma unroll
      for (int j = 0; j < kPV; ++j)
#pragma unroll
        for (int i = 0; i < kNV; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[j][i][e] = 0.f;
      const T* vt = u + (c & 1) * kR * kVRow;
#pragma unroll
      for (int rr = 0; rr < kR; ++rr) {
        const int dy = dy0 + rr;
        if (!(row_ok && dy >= 0 && dy < win && r_lo + c * kR + rr < r_hi))
          continue;                               // warp-uniform
        const int s0 = dy * win;
        const T* vr = vt + rr * kVRow;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks < nb) {
            // A(x, key column c) = P[x][dy, c - x] on the band, else 0
            const int cc = ks * 8 + t;
            const int d0 = cc - g, d1 = cc - g - 8, d2 = cc + 4 - g,
                      d3 = cc + 4 - g - 8;
            const FragA fa = frag_a(
                (unsigned)d0 < (unsigned)win ? p0[s0 + d0] : 0.f,
                (unsigned)d1 < (unsigned)win ? p1[s0 + d1] : 0.f,
                (unsigned)d2 < (unsigned)win ? p0[s0 + d2] : 0.f,
                (unsigned)d3 < (unsigned)win ? p1[s0 + d3] : 0.f);
            const T* vb = vr + (ks * 8 + t) * kLdV + g;
#pragma unroll
            for (int i = 0; i < kNV; ++i) {
              const int n = part + i * WN;
              mma3(pv[rr % kPV][i], fa,
                   frag_b(ldf(vb[n * 8]), ldf(vb[4 * kLdV + n * 8])));
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kPV; ++j)
#pragma unroll
        for (int i = 0; i < kNV; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] += pv[j][i][e];
      __syncthreads();
    }
    cp_async_wait<0>();

    // 4. rel_v: out += P (16 x win2, slot order) rel_v[head]^T, 32 value
    //    columns (4 blocks) a staged chunk; the warp's blocks of chunk cc
    //    are its i in [cc * 4 / WN, (cc + 1) * 4 / WN)
    if (a.rel_v != nullptr) {                   // block-uniform
      const int ksteps = (win2 + 7) >> 3;
#pragma unroll
      for (int cc = 0; cc < DVT / 32; ++cc) {
        const int c_base = vt0 + cc * 32;
        if (c_base >= a.dv) break;
        __syncthreads();                        // the region is free
        const float* src = a.rel_v + ((long long)head * a.dv + c_base) * win2;
        float* u_rv = reinterpret_cast<float*>(u);   // fp32 rel_v chunk
        const int n_cols = min(32, a.dv - c_base);
        for (int i = threadIdx.x; i < 32 * a.ld_rv; i += nthreads) {
          const int c = i / a.ld_rv;
          const int j = i - c * a.ld_rv;
          const bool ok = c < n_cols && j < win2;
          cp_async4(u_rv + i, ok ? src + (long long)c * win2 + j : src, ok);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        if (row_ok) {
          constexpr int kNC = 4 / WN;           // blocks of the chunk a warp
          float part_acc[2][kNC][4];            // even and odd 8-slot steps
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < kNC; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e) part_acc[j][i][e] = 0.f;
          for (int ks0 = 0; ks0 < ksteps; ks0 += 4) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int ks = ks0 + kk;
              if (ks >= ksteps) break;
              const int j = ks * 8 + t;
              const FragA fa = frag_a(j < win2 ? p0[j] : 0.f,
                                      j < win2 ? p1[j] : 0.f,
                                      j + 4 < win2 ? p0[j + 4] : 0.f,
                                      j + 4 < win2 ? p1[j + 4] : 0.f);
#pragma unroll
              for (int i = 0; i < kNC; ++i) {
                // the chunk's block part + i * WN of this warp
                const float* rb =
                    u_rv + ((part + i * WN) * 8 + g) * a.ld_rv + j;
                mma3(part_acc[kk & 1][i], fa, frag_b(rb[0], rb[4]));
              }
            }
            // fold every 32 slots
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
#pragma unroll
              for (int i = 0; i < kNC; ++i)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  acc[cc * kNC + i][e] += part_acc[jj][i][e];
                  part_acc[jj][i][e] = 0.f;
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
      T* o_row = a.out + ((long long)b * hw + (long long)y * a.width + gx) *
                             v_stride +
                 (long long)head * a.dv;
#pragma unroll
      for (int i = 0; i < kNV; ++i) {
        const int col = vt0 + (part + i * WN) * 8 + 2 * t;  // dv % 4 == 0
        if (col < a.dv) store2(o_row + col, acc[i][2 * h2], acc[i][2 * h2 + 1]);
      }
    }
  }
}

template <typename T, int MODE, int DVT, int WN>
int launch(const Args<T>& a, int batch_heads, int value_tiles,
           cudaStream_t stream) {
  const size_t smem = Layout(MODE, DVT, chunk_rows<MODE, DVT>(), a,
                             a.rel_v != nullptr).template bytes<T>();
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = local_attn_kernel<T, MODE, DVT, WN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = a.tiles_x * ((a.height + a.rows - 1) / a.rows);
  kernel<<<dim3(tiles, batch_heads, value_tiles), a.rows * WN * 32, smem,
           stream>>>(a);
  return (int)cudaGetLastError();
}

// One pass at a.rows query rows a tile: 2 warps a row in a 4-row tile, else
// 4. 4-row tiles are built only where a block's values are 32 columns wide
// (the one pass at dv <= 32, and the scores, which hold no values).
template <typename T, int MODE, int DVT>
int launch_pass(const Args<T>& a, int batch_heads, int value_tiles,
                cudaStream_t s) {
  if (a.rows == 4) {
    if constexpr (DVT == 32)
      return launch<T, MODE, DVT, 2>(a, batch_heads, value_tiles, s);
    return (int)cudaErrorInvalidValue;
  }
  if (a.rows != 1 && a.rows != 2) return (int)cudaErrorInvalidValue;
  return launch<T, MODE, DVT, 4>(a, batch_heads, value_tiles, s);
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, const void* rel_bias,
        const void* rel_v, void* out, void* p, int batch, int heads,
        int height, int width, int d, int dv, int max_dis, const int* plan,
        float scale, void* stream) {
  const bool two = d > 128 || dv > 128;
  if (batch < 1 || heads < 1 || height < 1 || width < 1 || d < 4 ||
      d % 4 != 0 || dv < 4 || dv % 4 != 0 || max_dis < 0 ||
      max_dis > kMaxDis || batch * heads > 65535 ||
      (two && p == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Args<T> a;
  a.q = (const T*)q;
  a.k = (const T*)k;
  a.v = (const T*)v;
  a.rel_bias = (const float*)rel_bias;
  a.rel_v = (const float*)rel_v;
  a.out = (T*)out;
  a.p = (float*)p;
  a.heads = heads;
  a.height = height;
  a.width = width;
  a.d = d;
  a.dv = dv;
  a.max_dis = max_dis;
  a.scale = scale;
  a.win = 2 * max_dis + 1;
  a.win2 = a.win * a.win;
  a.ld_s = a.win2 + ((9 - a.win2) % 32 + 32) % 32;
  a.ld_qk = (d + 7) / 8 * 8 + 4;
  a.ld_rv = (a.win2 + 7) / 8 * 8 + 4;
  a.tiles_x = (width + kTX - 1) / kTX;
  const int bh = batch * heads;
  cudaStream_t s = (cudaStream_t)stream;
  a.rows = plan[0];
  if (!two) {
    return dv <= 32 ? launch_pass<T, kOnePass, 32>(a, bh, 1, s)
                    : launch_pass<T, kOnePass, 128>(a, bh, 1, s);
  }
  const int err = launch_pass<T, kScores, 32>(a, bh, 1, s);
  if (err != 0) return err;
  a.rows = plan[1];
  return launch_pass<T, kValues, 128>(a, bh, (dv + 127) / 128, s);
}

}  // namespace

// Plain C entry point, bound from Python with ctypes: local_window_attn_tc_fwd
// for fp32 q, k, v and out (rel_bias, rel_v and the scratch fp32).
// plan[0] is the query rows a tile (1, 2 or 4) of the first pass (the only
// one for d, dv <= 128, else the scores), plan[1] that of the value pass
// (two passes), and `p` the value pass's (B*h, HW, win2) fp32 scratch; the
// wrapper's launch plan chooses them. Launches on `stream` and returns
// cudaGetLastError() (0 on success); allocates nothing.
extern "C" int local_window_attn_tc_fwd(
    const void* q, const void* k, const void* v, const void* rel_bias,
    const void* rel_v, void* out, void* p, int batch, int heads, int height,
    int width, int d, int dv, int max_dis, const int* plan, float scale,
    void* stream) {
  return fwd<float>(q, k, v, rel_bias, rel_v, out, p, batch, heads, height,
                    width, d, dv, max_dis, plan, scale, stream);
}
