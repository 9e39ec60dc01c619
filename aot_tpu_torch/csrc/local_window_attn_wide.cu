// Local-window attention forward for Hopper (sm_90a), fp32, tiled over a
// 2-D block of queries with the key/value halo staged in shared memory.
//
// Replaces aot_tpu/ops/pallas/local_window_attn.py:236 _kernel_wide, the
// TPU kernel behind local_window_attention_wide (:294), which serves every
// short-term attention above 2,500 query tokens at dilation 1
// (aot_tpu/ops/attention.py:376-383): the full-resolution grids (43x76 at
// 720p, 64x113 at DAVIS 1080p). Same function as csrc/local_window_attn.cu,
// at the port's public layout:
//   q, k      (B, HW, h*d)      contiguous fp32
//   v         (B, HW, h*dv)
//   rel_bias  (B, h, HW, win2)  per-query relative key bias
//   rel_v     (h, dv, win2)     relative value bias, or null
//   out       (B, HW, h*dv)
// with win = 2*max_dis+1 and win2 = win*win. For each (b, head, query):
//   s[slot] = (q*scale) . k[key(slot)] + rel_bias[slot]   (key in image)
//   s[slot] = -1e30 (probability exactly 0)                (key outside)
//   p = softmax(s);  out = sum_slot p * v[key] (+ p * rel_v[:, slot])
//
// Design. A block owns a kTY x kTX = 4 x 32 tile of queries of one
// (b, head): 128 queries, 256 threads, two per query (`half`), one warp per
// tile row so a warp's 32 queries are 32 consecutive pixels. The TPU kernel
// materialises overlapping k/v row bands in device memory (`to_bands`,
// :340-347) and keeps a (win2, rq, W) score scratch in VMEM; here the
// (kTY+2m) x (kTX+2m) halo of keys (828 at m = 7) is staged in shared
// memory once per channel chunk and read by every query of the tile, and
// the tile's win2 x 128 score block stays in shared memory. The halo is
// channel-major, so a warp reading one channel of 32 neighbouring keys
// reads 32 consecutive words (no bank conflict); its plane stride is odd,
// so staging writes spread over the banks. Staging is cp.async (4-byte
// copies, zero-filled outside the image and past the last channel): a
// thread issues all its copies of a chunk before it waits once. The
// window radius is a template parameter, so every halo and score offset
// in the unrolled slot loops is an immediate.
//   1. scores: for each 32-channel chunk of d, stage the k halo, hold the
//      thread's query chunk (pre-scaled) in registers, and add q.k into the
//      score block; the two threads of a query take alternate slots.
//   2. rel_bias is added in one coalesced pass (each tile row's biases are
//      one contiguous run of 32 x win2 floats); the score block's row
//      stride is kQ+1 so that this transposed write is conflict-free too.
//   3. softmax over the window, masked by position: slots whose key lies
//      outside the image get probability 0 without being read, and the
//      two threads of a query combine their max and sum through shared
//      memory. The division by the sum is left to the output.
//   4. values: for each 16-channel chunk of dv, stage the v halo and the
//      chunk's rel_v rows (win2 floats each) into the buffer the k halo
//      used; each thread sums 8 channels of its query over the window,
//      adding p * rel_v[c, slot] (one address for the whole warp: a
//      broadcast) in the same loop.
// DeAOT's head (h = 1, d = 128, dv = 1024) gives one video far fewer tiles
// than the card has SMs (64 at 64x113); its dv is then split over
// gridDim.z, each split recomputing the (cheaper) scores, so that the
// grid fills one wave. Shared memory at m = 7: score block 116,100 B +
// buffer 106,112 B + 2,048 B = 224,260 B of the 232,448 a block may use,
// so one block (8 warps) runs on an SM.
//
// What bounds it: shared-memory bandwidth. Every FMA reads one operand
// from shared memory (q, p and the output sit in registers), so the SM
// issues at most one warp-wide FMA per shared-memory wavefront, a quarter
// of its fp32 rate. Later work for speed: register tiles over neighbouring
// queries (query x at slot dx+1 reads the key of query x+1 at slot dx),
// double buffering of the halo, and tensor cores for the two products.

#include <cuda_runtime.h>

namespace {

constexpr int kTY = 4;                 // query rows per tile
constexpr int kTX = 32;                // query columns per tile (one warp)
constexpr int kQ = kTY * kTX;          // queries per block
constexpr int kThreads = 2 * kQ;       // two threads per query
constexpr int kQp = kQ + 1;            // score-block row stride (floats)
constexpr int kCk = 32;                // k channels per chunk
constexpr int kCv = 16;                // v channels per chunk
constexpr int kCvT = kCv / 2;          // v channels per thread
constexpr int kMaxDis = 7;
constexpr float kNegInf = -1e30f;

template <int M>
struct Win {
  static constexpr int win = 2 * M + 1;
  static constexpr int win2 = win * win;
  static constexpr int hh = kTY + 2 * M;          // halo rows
  static constexpr int hw = kTX + 2 * M;          // halo columns
  static constexpr int plane = (hh * hw) | 1;     // odd channel-plane stride
  static constexpr int buffer = kCk * plane > kCv * plane + kCv * win2
                                    ? kCk * plane
                                    : kCv * plane + kCv * win2;
  static constexpr size_t smem_bytes =
      sizeof(float) * ((size_t)win2 * kQp + buffer + 4 * kQ);
};

struct Dims {
  int heads, height, width, d, dv;
  int tiles_x;
  int dv_split;                        // value channels per gridDim.z slice
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Issue the copies of channels [c0, c0 + C) of the halo at image (y0, x0)
// into halo[c * plane + hy * hw + hx]; zeros outside the image and past
// `channels`. The caller waits and synchronises.
template <int M, int C>
__device__ __forceinline__ void stage_halo(float* halo, const float* src,
                                           long long token_stride, int c0,
                                           int channels, int y0, int x0,
                                           const Dims& g) {
  using W = Win<M>;
  constexpr int n = C * W::hh * W::hw;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int c = idx % C;             // C neighbouring threads: one key
    const int r = idx / C;
    const int hy = r / W::hw;
    const int iy = y0 + hy;
    const int ix = x0 + (r - hy * W::hw);
    const bool ok = c0 + c < channels && iy >= 0 && iy < g.height &&
                    ix >= 0 && ix < g.width;
    const float* p =
        ok ? src + (long long)(iy * g.width + ix) * token_stride + c0 + c : src;
    cp_async4(halo + c * W::plane + r, p, ok);
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads, 1)
local_window_attn_wide_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ rel_bias,
                              const float* __restrict__ rel_v,
                              float* __restrict__ out, Dims g, float scale) {
  using W = Win<M>;
  constexpr int win = W::win;
  constexpr int win2 = W::win2;
  extern __shared__ float smem[];
  float* scores = smem;                           // [win2][kQp]
  float* buf = scores + win2 * kQp;               // k halo, or v halo + rel_v
  float* red_max = buf + W::buffer;               // [2][kQ]
  float* red_sum = red_max + 2 * kQ;              // [2][kQ]

  const int tid = threadIdx.x;
  const int half = tid / kQ;                      // warp-uniform
  const int qi = tid - half * kQ;
  const int qy = qi / kTX;                        // warp-uniform
  const int qx = qi - qy * kTX;
  const int tile_y = blockIdx.x / g.tiles_x;
  const int ty0 = tile_y * kTY;
  const int tx0 = (blockIdx.x - tile_y * g.tiles_x) * kTX;
  const int bh = blockIdx.y;
  const int b = bh / g.heads;
  const int head = bh - b * g.heads;
  const int hw_img = g.height * g.width;
  const int gy = ty0 + qy;                        // the query's pixel
  const int gx = tx0 + qx;
  const bool q_ok = gy < g.height && gx < g.width;
  const int token = gy * g.width + gx;

  const long long qk_stride = (long long)g.heads * g.d;
  const long long v_stride = (long long)g.heads * g.dv;
  const float* k_head = k + (long long)b * hw_img * qk_stride + (long long)head * g.d;
  const float* v_head = v + (long long)b * hw_img * v_stride + (long long)head * g.dv;
  float* col = scores + qi;                       // this query's scores
  // the window's rows start at halo row qy, column qx (the query sits at
  // halo (qy + M, qx + M))
  const int h0 = qy * W::hw + qx;

  // 1. scores, one kCk-channel chunk of d at a time
  for (int c0 = 0; c0 < g.d; c0 += kCk) {
    __syncthreads();                              // the last chunk is read
    stage_halo<M, kCk>(buf, k_head, qk_stride, c0, g.d, ty0 - M, tx0 - M, g);
    float qr[kCk];
    const float* q_row = q + ((long long)b * hw_img + token) * qk_stride +
                         (long long)head * g.d + c0;
#pragma unroll
    for (int c = 0; c < kCk; ++c) {
      qr[c] = (q_ok && c0 + c < g.d) ? __ldg(q_row + c) * scale : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();
    for (int dy = 0; dy < win; ++dy) {
      const float* hrow = buf + h0 + dy * W::hw;
      float* crow = col + dy * win * kQp;
#pragma unroll
      for (int dx = 0; dx < win; ++dx) {
        if (((dy * win + dx) & 1) != half) continue;   // warp-uniform
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int c = 0; c < kCk; c += 2) {
          a0 = fmaf(qr[c], hrow[dx + c * W::plane], a0);
          a1 = fmaf(qr[c + 1], hrow[dx + (c + 1) * W::plane], a1);
        }
        crow[dx * kQp] = (c0 == 0 ? 0.f : crow[dx * kQp]) + (a0 + a1);
      }
    }
  }
  __syncthreads();

  // 2. rel_bias, coalesced: tile row r is the contiguous run
  //    rel_bias[bh, (ty0 + r) * W + tx0 .. + nx, 0 .. win2)
  {
    const int nx = min(kTX, g.width - tx0);
    constexpr int row_len = kTX * win2;
    for (int idx = tid; idx < kTY * row_len; idx += kThreads) {
      const int r = idx / row_len;
      const int rem = idx - r * row_len;
      const int xl = rem / win2;
      const int w = rem - xl * win2;
      const int iy = ty0 + r;
      if (iy < g.height && xl < nx) {
        const long long base =
            ((long long)bh * hw_img + (long long)iy * g.width + tx0) * win2;
        scores[w * kQp + r * kTX + xl] += __ldg(rel_bias + base + rem);
      }
    }
  }
  __syncthreads();

  // 3. softmax over the window; slots whose key lies outside the image
  //    are skipped by position and get probability exactly 0
  float mx = kNegInf;
  for (int dy = 0; dy < win; ++dy) {
    const int ky = gy + dy - M;
    const bool row_ok = ky >= 0 && ky < g.height;
    const float* crow = col + dy * win * kQp;
#pragma unroll
    for (int dx = 0; dx < win; ++dx) {
      if (((dy * win + dx) & 1) != half) continue;
      const int kx = gx + dx - M;
      if (row_ok && kx >= 0 && kx < g.width) mx = fmaxf(mx, crow[dx * kQp]);
    }
  }
  red_max[half * kQ + qi] = mx;
  __syncthreads();
  mx = fmaxf(red_max[qi], red_max[kQ + qi]);
  float sum = 0.f;
  for (int dy = 0; dy < win; ++dy) {
    const int ky = gy + dy - M;
    const bool row_ok = ky >= 0 && ky < g.height;
    float* crow = col + dy * win * kQp;
#pragma unroll
    for (int dx = 0; dx < win; ++dx) {
      if (((dy * win + dx) & 1) != half) continue;
      const int kx = gx + dx - M;
      float e = 0.f;
      if (row_ok && kx >= 0 && kx < g.width) e = expf(crow[dx * kQp] - mx);
      crow[dx * kQp] = e;
      sum += e;
    }
  }
  red_sum[half * kQ + qi] = sum;
  __syncthreads();
  // a query outside the image (tile overhang) has no slot; its output is
  // never written
  const float total = q_ok ? red_sum[qi] + red_sum[kQ + qi] : 1.f;

  // 4. values, one kCv-channel chunk of this block's dv slice at a time;
  //    this thread sums channels [cb, cb + kCvT) of the chunk
  const int cv_lo = blockIdx.z * g.dv_split;
  const int cv_hi = min(g.dv, cv_lo + g.dv_split);
  float* o_row = out + ((long long)b * hw_img + token) * v_stride +
                 (long long)head * g.dv;
  float* rvs = buf + kCv * W::plane;              // [kCv][win2]
  for (int cv0 = cv_lo; cv0 < cv_hi; cv0 += kCv) {
    __syncthreads();                              // the last chunk is read
    stage_halo<M, kCv>(buf, v_head, v_stride, cv0, cv_hi, ty0 - M, tx0 - M, g);
    if (rel_v != nullptr) {
      // rows cv0 .. cv0 + kCv of rel_v[head] are one contiguous run
      const float* src = rel_v + ((long long)head * g.dv + cv0) * win2;
      const int n_ok = (min(cv_hi, cv0 + kCv) - cv0) * win2;
      for (int idx = tid; idx < kCv * win2; idx += kThreads) {
        const bool ok = idx < n_ok;
        cp_async4(rvs + idx, ok ? src + idx : src, ok);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    const int cb = cv0 + half * kCvT;
    const float* hv0 = buf + half * kCvT * W::plane + h0;
    const float* rv0 = rvs + half * kCvT * win2;
    float acc[kCvT];
#pragma unroll
    for (int c = 0; c < kCvT; ++c) acc[c] = 0.f;
    if (rel_v != nullptr) {                       // block-uniform
      for (int dy = 0; dy < win; ++dy) {
        const float* hrow = hv0 + dy * W::hw;
        const float* prow = col + dy * win * kQp;
        const float* rrow = rv0 + dy * win;
#pragma unroll
        for (int dx = 0; dx < win; ++dx) {
          const float p = prow[dx * kQp];
#pragma unroll
          for (int c = 0; c < kCvT; ++c) {
            acc[c] = fmaf(p, hrow[dx + c * W::plane], acc[c]);
            acc[c] = fmaf(p, rrow[dx + c * win2], acc[c]);
          }
        }
      }
    } else {
      for (int dy = 0; dy < win; ++dy) {
        const float* hrow = hv0 + dy * W::hw;
        const float* prow = col + dy * win * kQp;
#pragma unroll
        for (int dx = 0; dx < win; ++dx) {
          const float p = prow[dx * kQp];
#pragma unroll
          for (int c = 0; c < kCvT; ++c) {
            acc[c] = fmaf(p, hrow[dx + c * W::plane], acc[c]);
          }
        }
      }
    }
    if (q_ok) {
      const int nc = min(kCvT, cv_hi - cb);
#pragma unroll
      for (int c = 0; c < kCvT; ++c) {
        if (c < nc) o_row[cb + c] = acc[c] / total;
      }
    }
  }
}

template <int M>
int launch(const float* q, const float* k, const float* v,
           const float* rel_bias, const float* rel_v, float* out, Dims g,
           int tiles, int batch_heads, int split, float scale,
           cudaStream_t stream) {
  constexpr size_t bytes = Win<M>::smem_bytes;
  static_assert(bytes <= 232448, "shared memory of one block");
  cudaError_t err = cudaFuncSetAttribute(
      local_window_attn_wide_kernel<M>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles, batch_heads, split);
  local_window_attn_wide_kernel<M><<<grid, kThreads, bytes, stream>>>(
      q, k, v, rel_bias, rel_v, out, g, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound from Python with ctypes. `sms` is the card's
// SM count (the dv split fills one wave of blocks). Launches on `stream`
// and returns cudaGetLastError() (0 on success); allocates nothing.
extern "C" int local_window_attn_wide_fwd(
    const void* q, const void* k, const void* v, const void* rel_bias,
    const void* rel_v, void* out, int batch, int heads, int height, int width,
    int d, int dv, int max_dis, float scale, int sms, void* stream) {
  if (batch < 1 || heads < 1 || height < 1 || width < 1 || d < 1 || dv < 1 ||
      max_dis < 0 || max_dis > kMaxDis || sms < 1 || batch * heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Dims g;
  g.heads = heads;
  g.height = height;
  g.width = width;
  g.d = d;
  g.dv = dv;
  g.tiles_x = (width + kTX - 1) / kTX;
  const int tiles = g.tiles_x * ((height + kTY - 1) / kTY);
  const int base_blocks = tiles * batch * heads;
  // split dv over gridDim.z while the grid stays within one wave
  const int chunks = (dv + kCv - 1) / kCv;
  int split = base_blocks < sms ? sms / base_blocks : 1;
  split = split < 1 ? 1 : (split > chunks ? chunks : split);
  g.dv_split = ((chunks + split - 1) / split) * kCv;
  split = (dv + g.dv_split - 1) / g.dv_split;

  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const float* rb = (const float*)rel_bias;
  const float* rv = (const float*)rel_v;
  float* o = (float*)out;
  const int bh = batch * heads;
  cudaStream_t s = (cudaStream_t)stream;
  switch (max_dis) {
    case 0: return launch<0>(qf, kf, vf, rb, rv, o, g, tiles, bh, split, scale, s);
    case 1: return launch<1>(qf, kf, vf, rb, rv, o, g, tiles, bh, split, scale, s);
    case 2: return launch<2>(qf, kf, vf, rb, rv, o, g, tiles, bh, split, scale, s);
    case 3: return launch<3>(qf, kf, vf, rb, rv, o, g, tiles, bh, split, scale, s);
    case 4: return launch<4>(qf, kf, vf, rb, rv, o, g, tiles, bh, split, scale, s);
    case 5: return launch<5>(qf, kf, vf, rb, rv, o, g, tiles, bh, split, scale, s);
    case 6: return launch<6>(qf, kf, vf, rb, rv, o, g, tiles, bh, split, scale, s);
    default: return launch<7>(qf, kf, vf, rb, rv, o, g, tiles, bh, split, scale, s);
  }
}
