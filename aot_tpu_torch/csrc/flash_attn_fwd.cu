// Flash-attention forward for Hopper (sm_90a), fp32.
//
// Replaces aot_tpu/ops/pallas/flash_attn_vjp.py:51 _fwd_kernel, the TPU
// kernel behind _flash_fwd_raw (:211) and flash_attention (:338), which
// serves the global attention over a long-term memory ring once it holds
// many keys. Same function, at the port's public layout (no head-major
// copy, no padding):
//   q      (B, Lq, h*d)   rows of h*d floats, batch/row strides given
//   k      (B, Lk, h*d)   likewise
//   v      (B, Lk, h*dv)  likewise
//   valid  (B,) int32 live key counts, or null (then `valid_all` for all)
//   out    (B, Lq, h*dv)  contiguous
//   lse    (B*h, Lq)      log-sum-exp of the scaled scores over live keys
// For each (b, head, query) over the live keys j < min(valid[b], Lk):
//   s_j = (q * scale) . k_j;  out = sum_j softmax(s)_j v_j;  lse = logsumexp(s)
// A row with no live key gives out 0 and lse -1e30, as the TPU kernel does
// (:89-96). fp32 in, out and accumulation; plain FMAs, no TF32.
//
// Design (simple first). One block of 256 threads (16 x 16) per
// (b*h, 64-query tile, value-column tile); the key loop runs inside the
// block over 64-key tiles and stops at the live length, so dead keys are
// never read and the ragged last tile is masked. Online softmax with the
// running max and sum in registers (each row's 16 threads reduce with
// half-warp shuffles); each tile's P V products are summed apart and folded
// into the running output once per tile, as the TPU kernel's block
// products are. A value-column tile is 128 wide (dv > 32) or 32 wide
// (dv <= 32): at DeAOT's dv = 1024 a 64 x 1024 fp32 accumulator (256 KB)
// would not fit one block, so dv is split across the grid and each block
// recomputes the scores of its query tile. Shared memory holds the scaled q
// tile, one k tile, one v tile and the 64 x 64 probability tile (116 KB at
// d = 128, dv tile 128), as dynamic shared memory. Each thread owns a 4 x 4
// block of the score tile and a 4 x 8 block of the output tile (rows
// interleaved by 16, so float4 reads of k rows are free of bank conflicts
// when d is a multiple of 32).
//
// What bounds it: arithmetic. At DeAOTL's longest memory (Lq = 900,
// Lk = 19,800, d = 128, dv = 1024) the products are 41 GFLOP a call, and
// the 8 value tiles recompute the 4.6 GFLOP of scores 8 times, so the kernel
// runs ~73 GFLOP of fp32 FMAs, without tensor cores, against the card's
// ~67 TFLOP/s of fp32 outside them. Each k and v tile is read by 8 and 15
// blocks respectively and served mostly by L2. Later work for speed: tensor
// cores (TF32 or bf16 wgmma, as a declared precision mode), TMA/cp.async
// double buffering of the k/v tiles, and splitting the key loop across
// blocks so that a single video fills all 132 SMs.

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // queries per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kMaxD = 256;       // q/k channels per head
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float half_warp_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// TN value columns per thread: a value tile of 16*TN columns, in groups of
// kG contiguous columns, column(g, e) = g*16*kG + tx*kG + e.
template <int TN>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ valid,
                 float* __restrict__ out, float* __restrict__ lse, int heads,
                 int lq, int lk, int d, int dv, int valid_all, long long q_sb,
                 long long q_sl, long long k_sb, long long k_sl,
                 long long v_sb, long long v_sl, float scale) {
  constexpr int kBV = 16 * TN;
  constexpr int kG = TN < 4 ? TN : 4;
  constexpr int kNG = TN / kG;
  constexpr int kPS = kBK + 4;   // row stride of the probability tile
  constexpr int kVS = kBV + 4;   // row stride of the value tile
  extern __shared__ float4 smem4[];
  const int ds = d + 4;          // row stride of the q and k tiles
  float* s_q = reinterpret_cast<float*>(smem4);
  float* s_k = s_q + kBQ * ds;
  float* s_p = s_k + kBK * ds;
  float* s_v = s_p + kBQ * kPS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int head = bh % heads;
  const int q0 = blockIdx.y * kBQ;
  const int c0 = blockIdx.z * kBV;
  int n_live = valid != nullptr ? valid[b] : valid_all;
  n_live = max(0, min(n_live, lk));

  const float* q_base = q + b * q_sb + (long long)head * d;
  const float* k_base = k + b * k_sb + (long long)head * d;
  const float* v_base = v + b * v_sb + (long long)head * dv + c0;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const int d4 = d >> 2;

  for (int i = tid; i < kBQ * d4; i += kThreads) {
    const int r = i / d4;
    const int c = (i - r * d4) * 4;
    float4 x = zero4;
    if (q0 + r < lq)
      x = *reinterpret_cast<const float4*>(q_base + (q0 + r) * q_sl + c);
    x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    *reinterpret_cast<float4*>(s_q + r * ds + c) = x;
  }

  float m[4], l[4], acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[i][n] = 0.f;
  }

  for (int k0 = 0; k0 < n_live; k0 += kBK) {
    __syncthreads();   // the last tile's readers are done; q tile is stored
    for (int i = tid; i < kBK * d4; i += kThreads) {
      const int r = i / d4;
      const int c = (i - r * d4) * 4;
      float4 x = zero4;
      if (k0 + r < n_live)
        x = *reinterpret_cast<const float4*>(k_base + (k0 + r) * k_sl + c);
      *reinterpret_cast<float4*>(s_k + r * ds + c) = x;
    }
    constexpr int kBV4 = kBV / 4;
    for (int i = tid; i < kBK * kBV4; i += kThreads) {
      const int r = i / kBV4;
      const int c = (i - r * kBV4) * 4;
      float4 x = zero4;
      if (k0 + r < n_live && c0 + c < dv)
        x = *reinterpret_cast<const float4*>(v_base + (k0 + r) * v_sl + c);
      *reinterpret_cast<float4*>(s_v + r * kVS + c) = x;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; c += 4) {
      float4 a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(s_q + (ty + 16 * i) * ds + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kk[j] = *reinterpret_cast<const float4*>(s_k + (tx + 16 * j) * ds + c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(a[i].x, kk[j].x, t);
          t = fmaf(a[i].y, kk[j].y, t);
          t = fmaf(a[i].z, kk[j].z, t);
          s[i][j] = fmaf(a[i].w, kk[j].w, t);
        }
    }

    // online softmax; the tile holds at least one live key (k0 < n_live),
    // so m_new is finite and exp(-1e30 - m_new) is exactly 0
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + tx + 16 * j >= n_live) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        s_p[(ty + 16 * i) * kPS + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha[i] + half_warp_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();

    // acc = acc * alpha + P V: the tile's products are summed apart and
    // added once, so a long memory's output is not a running sum of one
    // product per key (fp32 error ~ Lk * eps where the weights are flat)
    float pv[4][TN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < TN; ++n) pv[i][n] = 0.f;
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(s_p + (ty + 16 * i) * kPS + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* v_row = s_v + (kk + e) * kVS + tx * kG;
        float vv[TN];
#pragma unroll
        for (int g = 0; g < kNG; ++g) {
          if constexpr (kG == 4) {
            const float4 t = *reinterpret_cast<const float4*>(v_row + g * 64);
            vv[g * 4 + 0] = t.x; vv[g * 4 + 1] = t.y;
            vv[g * 4 + 2] = t.z; vv[g * 4 + 3] = t.w;
          } else {
#pragma unroll
            for (int u = 0; u < kG; ++u) vv[g * kG + u] = v_row[g * 16 * kG + u];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = e == 0 ? p4[i].x : e == 1 ? p4[i].y
                        : e == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int n = 0; n < TN; ++n) pv[i][n] = fmaf(p, vv[n], pv[i][n]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[i][n] = fmaf(acc[i][n], alpha[i], pv[i][n]);
  }

  const long long o_stride = (long long)heads * dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= lq) continue;
    const bool empty = l[i] == 0.f;
    float* o_row = out + ((long long)b * lq + r) * o_stride +
                   (long long)head * dv + c0;
#pragma unroll
    for (int g = 0; g < kNG; ++g) {
      const int col = g * 16 * kG + tx * kG;
      if (c0 + col >= dv) continue;   // dv % 4 == 0: whole groups in or out
#pragma unroll
      for (int u = 0; u < kG; ++u)
        o_row[col + u] = empty ? 0.f : acc[i][g * kG + u] / l[i];
    }
    if (blockIdx.z == 0 && tx == 0)
      lse[(long long)bh * lq + r] = empty ? kNegInf : m[i] + logf(l[i]);
  }
}

template <int TN>
int launch(const float* q, const float* k, const float* v, const int* valid,
           float* out, float* lse, int batch, int heads, int lq, int lk,
           int d, int dv, int valid_all, long long q_sb, long long q_sl,
           long long k_sb, long long k_sl, long long v_sb, long long v_sl,
           float scale, cudaStream_t stream) {
  constexpr int kBV = 16 * TN;
  const size_t smem = sizeof(float) * (size_t)(2 * kBQ * (d + 4) +
                                               kBQ * (kBK + 4) +
                                               kBK * (kBV + 4));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch * heads, (lq + kBQ - 1) / kBQ, (dv + kBV - 1) / kBV);
  flash_fwd_kernel<TN><<<grid, kThreads, smem, stream>>>(
      q, k, v, valid, out, lse, heads, lq, lk, d, dv, valid_all, q_sb, q_sl,
      k_sb, k_sl, v_sb, v_sl, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound from Python with ctypes. Strides are in floats;
// every stride and pointer must be 16-byte aligned (the wrapper checks).
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape it does not take; allocates nothing.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* valid, void* out, void* lse,
                              int batch, int heads, int lq, int lk, int d,
                              int dv, int valid_all, long long q_sb,
                              long long q_sl, long long k_sb, long long k_sl,
                              long long v_sb, long long v_sl, float scale,
                              void* stream) {
  if (batch < 1 || heads < 1 || lq < 1 || lk < 0 || d < 4 || d > kMaxD ||
      d % 4 != 0 || dv < 4 || dv % 4 != 0 || (q_sb | q_sl | k_sb | k_sl |
                                              v_sb | v_sl) % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  const int* vl = (const int*)valid;
  float* of = (float*)out;
  float* lf = (float*)lse;
  cudaStream_t s = (cudaStream_t)stream;
  if (dv <= 32)
    return launch<2>(qf, kf, vf, vl, of, lf, batch, heads, lq, lk, d, dv,
                     valid_all, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale, s);
  return launch<8>(qf, kf, vf, vl, of, lf, batch, heads, lq, lk, d, dv,
                   valid_all, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, scale, s);
}
