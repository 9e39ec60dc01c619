// Local-window attention forward for Hopper (sm_90a), fp32.
//
// Replaces aot_tpu/ops/pallas/local_window_attn.py:414 _kernel_flat, the
// TPU kernel behind local_window_attention_flat (:475), which serves every
// short-term attention of the eval path. Same function, at the port's
// public layout:
//   q, k      (B, HW, h*d)      contiguous fp32
//   v         (B, HW, h*dv)
//   rel_bias  (B, h, HW, win2)  per-query relative key bias
//   rel_v     (h, dv, win2)     relative value bias, or null
//   out       (B, HW, h*dv)
// with win = 2*max_dis+1 and win2 = win*win. For each (b, head, query):
//   s[slot] = (q*scale) . k[key(slot)] + rel_bias[slot]   (key in image)
//   s[slot] = -1e30                                         (key outside)
//   p = softmax(s);  out = sum_slot p * v[key] (+ p * rel_v[:, slot])
// q is scaled before the dot and rel_bias added after it, as in the TPU
// kernel (:420, :433-434).
//
// Design (simple first): one warp per (query, head), kWarps queries per
// block, grid (ceil(HW / kWarps), B*h). Lanes split the channels for q.k
// and reduce with shuffles; the win2 scores sit in shared memory; softmax
// max and sum are warp reductions; in the value walk lanes split dv and
// the rel_v term rides the same loop. Each slot's key position (ky, kx) is
// computed and out-of-image slots are skipped: nothing is read through a
// flat index that wrapped into the next image row (the TPU kernel's
// flat-diagonal trick reads first and masks after). Masked slots carry
// probability exactly 0.
//
// What bounds it: each query reads its window's win2*(d+dv) floats of k and
// v (230 KB at the AOT shape) plus win2 floats of rel_bias, served by
// L1/L2 since neighbouring queries share most of the window. Later work for
// speed: stage the k/v row band of a query tile in shared memory once per
// block, and run the score and value products on tensor cores.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;       // queries per block
constexpr int kMaxWin2 = 225;   // max_dis <= 7
constexpr int kMaxD = 512;      // q channels per head held in shared memory
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__global__ void __launch_bounds__(kWarps * 32)
local_window_attn_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ rel_bias,
                         const float* __restrict__ rel_v,
                         float* __restrict__ out,
                         int heads, int height, int width, int d, int dv,
                         int max_dis, float scale) {
  __shared__ float s_q[kWarps][kMaxD];
  __shared__ float s_p[kWarps][kMaxWin2];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int hw = height * width;
  const int query = blockIdx.x * kWarps + warp;
  // the whole warp leaves together; no block-wide barrier follows
  if (query >= hw) return;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int head = bh % heads;
  const int win = 2 * max_dis + 1;
  const int win2 = win * win;
  const int qy = query / width;
  const int qx = query % width;

  const long long qk_stride = (long long)heads * d;   // one token of q / k
  const long long v_stride = (long long)heads * dv;   // one token of v / out
  const float* q_row = q + ((long long)b * hw + query) * qk_stride +
                       (long long)head * d;
  const float* k_base = k + (long long)b * hw * qk_stride + (long long)head * d;
  const float* v_base = v + (long long)b * hw * v_stride + (long long)head * dv;
  const float* rb_row = rel_bias + ((long long)bh * hw + query) * win2;
  const float* rv_head =
      rel_v != nullptr ? rel_v + (long long)head * dv * win2 : nullptr;
  float* o_row = out + ((long long)b * hw + query) * v_stride +
                 (long long)head * dv;
  float* sq = s_q[warp];
  float* sp = s_p[warp];

  for (int c = lane; c < d; c += 32) sq[c] = q_row[c] * scale;
  __syncwarp();

  // phase 1: scores (branches are warp-uniform)
  for (int dy = 0; dy < win; ++dy) {
    const int ky = qy + dy - max_dis;
    const bool row_ok = ky >= 0 && ky < height;
    for (int dx = 0; dx < win; ++dx) {
      const int kx = qx + dx - max_dis;
      float score = kNegInf;
      if (row_ok && kx >= 0 && kx < width) {
        const float* k_row = k_base + (long long)(ky * width + kx) * qk_stride;
        float part = 0.f;
        for (int c = lane; c < d; c += 32) part = fmaf(sq[c], k_row[c], part);
        score = warp_sum(part) + rb_row[dy * win + dx];
      }
      if (lane == 0) sp[dy * win + dx] = score;
    }
  }
  __syncwarp();

  // softmax over the window; exp(-1e30 - max) is exactly 0
  float m = kNegInf;
  for (int s = lane; s < win2; s += 32) m = fmaxf(m, sp[s]);
  m = warp_max(m);
  float sum = 0.f;
  for (int s = lane; s < win2; s += 32) {
    const float e = expf(sp[s] - m);
    sp[s] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int s = lane; s < win2; s += 32) sp[s] = sp[s] / sum;
  __syncwarp();

  // phase 2: value walk, lanes over dv; masked slots are skipped (p == 0)
  for (int c = lane; c < dv; c += 32) {
    float acc = 0.f;
    for (int dy = 0; dy < win; ++dy) {
      const int ky = qy + dy - max_dis;
      if (ky < 0 || ky >= height) continue;
      for (int dx = 0; dx < win; ++dx) {
        const int kx = qx + dx - max_dis;
        if (kx < 0 || kx >= width) continue;
        const int s = dy * win + dx;
        const float p = sp[s];
        acc = fmaf(p, v_base[(long long)(ky * width + kx) * v_stride + c], acc);
        if (rv_head != nullptr) acc = fmaf(p, rv_head[(long long)c * win2 + s], acc);
      }
    }
    o_row[c] = acc;
  }
}

}  // namespace

// Plain C entry point, bound from Python with ctypes. Launches on `stream`
// and returns cudaGetLastError() (0 on success); allocates nothing.
extern "C" int local_window_attn_fwd(const void* q, const void* k,
                                     const void* v, const void* rel_bias,
                                     const void* rel_v, void* out, int batch,
                                     int heads, int height, int width, int d,
                                     int dv, int max_dis, float scale,
                                     void* stream) {
  if (batch < 1 || heads < 1 || height < 1 || width < 1 || d < 1 ||
      d > kMaxD || dv < 1 || max_dis < 0 ||
      (2 * max_dis + 1) * (2 * max_dis + 1) > kMaxWin2) {
    return (int)cudaErrorInvalidValue;
  }
  const int hw = height * width;
  const dim3 grid((hw + kWarps - 1) / kWarps, batch * heads);
  local_window_attn_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v,
      (const float*)rel_bias, (const float*)rel_v, (float*)out, heads, height,
      width, d, dv, max_dis, scale);
  return (int)cudaGetLastError();
}
