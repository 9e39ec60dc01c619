// Swin Transformer's (shifted-)window attention forward for Hopper
// (sm_90a), fp32, fused from the qkv projection's output to the input of
// the output projection.
//
// Replaces no TPU kernel: the JAX package computes Swin-B's window
// attention (aot_tpu/models/encoders/swin.py) in plain jnp and leaves it
// to XLA. It was added because the port's plain path for it,
// models/encoders/swin.py (pad, roll, window partition, the qkv product
// on the padded map, two batched matmuls around a materialised score
// tensor with the bias and mask added, softmax, window reverse, roll back,
// slice), is some 14 launches a block beyond the block's GEMMs and norms,
// 22 blocks a frame, and writes and reads the fp32 score tensors (21, 11
// and 6 MB a block at DAVIS 480p) about four times each.
//
// Layouts (the port's; the wrapper is ops/kernels/swin_window_attn.py):
//   qkv       (B, H, W, 3C)  the qkv Linear's output over the image's own
//                            tokens, in token order; column
//                            which * C + head * 32 + c, which = q, k, v
//   qkv_bias  (3C)           the qkv Linear's bias
//   table     (169, heads)   the block's relative position bias table
//   out       (B, H, W, C)   column head * 32 + c (the output projection's
//                            input)
// with C = heads * 32, a 7 x 7 window and a shift s (0, or 3 in every
// second block). For each window of the rolled map padded at the bottom
// and right to multiples of 7 (Hp x Wp), cell (i, j) of window (wy, wx)
// holds token ((7 wy + i + s) mod Hp, (7 wx + j + s) mod Wp) of the
// unrolled map: the pad, the roll and the window partition of the
// published code, and their reverses, are this index arithmetic. A cell
// outside the image is padding: the published code pads after norm1 with
// zeros and applies qkv to the padding, so its q, k and v are the qkv
// bias, and it stays a live key. For each head and query cell n:
//   s[m] = (scale q_n) . k_m + table[rel(n, m), head] - 100 [region differs]
//   out_n = softmax(s) v
// where rel(n, m) = (y_n - y_m + 6) * 13 + (x_n - x_m + 6) within the
// window, and the region of a cell is, on each axis of the rolled padded
// map, 0 below Hp - 7, 1 below Hp - s, else 2 (the published slices
// slice(0, -7), slice(-7, -s), slice(-s, None)); the -100 mask only in
// shifted blocks. Outputs are written for in-image queries only.
//
// Design. A block owns one window of one image and G heads (1, 2 or 4, the
// wrapper's launch plan), a thread one (head, query) pair: 64, 128 or 224
// threads for 49, 98 or 196 pairs. The block works out its 49 cells'
// source tokens and regions once, stages the K and V rows of its heads (49
// x 32 floats each; 512 contiguous bytes a cell at G = 4, read with
// 16-byte loads, the bias for padding cells) and the heads' columns of
// the bias table in shared memory; each thread reads its own q row from
// device memory into registers. A thread then walks the 7 key rows of the
// window: 7 scores (every K row read by all the head's threads at once, a
// shared-memory broadcast), the row's max, and an online softmax update of
// its 32 fp32 output sums (one rescale a key row), then writes its 32
// outputs to the query's token. Every product is an fp32 FMA (no tensor
// core, so no 3xTF32 splitting is needed for fp32 accuracy).
//
// What bounds it. Counting in-image queries only, the read does 4 * 49 * 32
// FLOPs a (query, head) and moves q, k, v and out once (16 bytes a channel
// of a token): bytes bound it (a stage-3 block of Swin-B at 30 x 53
// tokens, 16 heads: 13.0 MB, 3.9 us at 3.35 TB/s, against 160 MFLOP, 1.0
// us at 165 TFLOP/s). The FMAs run on the fp32 units (67 TFLOP/s): 2.4 us
// at that block, 23% more for the padding cells of its 40 windows. Each
// token's q, k and v are read from device memory once (windows do not
// overlap), padding cells read the bias, and no score leaves the block.

#include <cuda_runtime.h>

namespace {

constexpr int kWin = 7;
constexpr int kCells = kWin * kWin;                     // 49
constexpr int kSide = 2 * kWin - 1;                     // 13
constexpr int kTable = kSide * kSide;                   // 169
constexpr int kD = 32;                                  // channels a head
// floats of one head's K (or V) in shared memory: 4 more than the 49 rows,
// so that the rows of two heads read by one warp fall in other banks
constexpr int kHeadStride = kCells * kD + 4;

struct Args {
  const float* qkv;
  const float* qkv_bias;
  const float* table;
  float* out;
  int height, width;     // the image's tokens
  int hp, wp;            // padded to multiples of the window
  int windows_x;         // wp / 7
  int heads;
  int shift;
  float scale;
};

template <int G>
struct Tile {
  static constexpr int kThreads = (G * kCells + 31) / 32 * 32;
  static constexpr size_t kSmem =
      (2 * G * kHeadStride + G * kTable) * sizeof(float) +
      2 * kCells * sizeof(int);
};

// The region of a place on one axis of the rolled, padded map
__device__ __forceinline__ int region(int r, int size, int shift) {
  return r < size - kWin ? 0 : (r < size - shift ? 1 : 2);
}

template <int G>
__global__ void __launch_bounds__(Tile<G>::kThreads)
    swin_window_attn_kernel(Args a) {
  constexpr int kThreads = Tile<G>::kThreads;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);     // [G][kHeadStride]
  float* vs = ks + G * kHeadStride;                // [G][kHeadStride]
  float* bias = vs + G * kHeadStride;              // [G][kTable]
  int* src = reinterpret_cast<int*>(bias + G * kTable);   // [kCells]
  int* reg = src + kCells;                                // [kCells]

  const int tid = threadIdx.x;
  const int wy = blockIdx.x / a.windows_x;
  const int wx = blockIdx.x - wy * a.windows_x;
  const int g0 = blockIdx.y * G;
  const int channels = a.heads * kD;
  const long long ld = 3LL * channels;
  const long long tokens = (long long)a.height * a.width;
  const float* base = a.qkv + blockIdx.z * tokens * ld;

  // each cell's source token (-1: padding) and region id
  if (tid < kCells) {
    const int r = kWin * wy + tid / kWin;
    const int c = kWin * wx + tid % kWin;
    int y = r + a.shift;
    if (y >= a.hp) y -= a.hp;
    int x = c + a.shift;
    if (x >= a.wp) x -= a.wp;
    src[tid] = (y < a.height && x < a.width) ? y * a.width + x : -1;
    reg[tid] = a.shift > 0 ? 3 * region(r, a.hp, a.shift) +
                                 region(c, a.wp, a.shift)
                           : 0;
  }
  for (int e = tid; e < G * kTable; e += kThreads) {
    const int g = e / kTable;
    bias[e] = __ldg(a.table + (e - g * kTable) * a.heads + g0 + g);
  }
  __syncthreads();

  // this thread's (head, query) pair and its q row, scaled
  const int pair = tid < G * kCells ? tid : 0;
  const int g = pair / kCells;
  const int n = pair - g * kCells;
  const int sn = src[n];
  const int qcol = (g0 + g) * kD;
  const float4* qp = reinterpret_cast<const float4*>(
      sn >= 0 ? base + sn * ld + qcol : a.qkv_bias + qcol);
  float q[kD];
#pragma unroll
  for (int f = 0; f < kD / 4; ++f) {
    const float4 t = __ldg(qp + f);
    q[4 * f] = t.x * a.scale;
    q[4 * f + 1] = t.y * a.scale;
    q[4 * f + 2] = t.z * a.scale;
    q[4 * f + 3] = t.w * a.scale;
  }

  // K and V of the block's heads: G * 32 contiguous floats a cell each
  constexpr int kVec = G * kD / 4;
  for (int e = tid; e < 2 * kCells * kVec; e += kThreads) {
    const int which = e / (kCells * kVec);           // 0: K, 1: V
    const int rem = e - which * kCells * kVec;
    const int m = rem / kVec;
    const int f = rem - m * kVec;
    const int col = (1 + which) * channels + g0 * kD + 4 * f;
    const int sm = src[m];
    const float4 t = __ldg(reinterpret_cast<const float4*>(
        sm >= 0 ? base + sm * ld + col : a.qkv_bias + col));
    float* dst = (which ? vs : ks) + (f / (kD / 4)) * kHeadStride + m * kD +
                 (f % (kD / 4)) * 4;
    *reinterpret_cast<float4*>(dst) = t;
  }
  __syncthreads();
  if (tid >= G * kCells) return;

  const float* kh = ks + g * kHeadStride;
  const float* vh = vs + g * kHeadStride;
  // table row of the relative offset (y_n - y_m + 6, x_n - x_m + 6) at key
  // (0, 0); key (ky, kx) is ky * 13 + kx before it
  const float* bn = bias + g * kTable + (n / kWin + kWin - 1) * kSide +
                    n % kWin + kWin - 1;
  const int rn = reg[n];
  float o[kD];
#pragma unroll
  for (int c = 0; c < kD; ++c) o[c] = 0.f;
  float mx = __int_as_float(0xff800000);    // -inf
  float sum = 0.f;
#pragma unroll 1
  for (int ky = 0; ky < kWin; ++ky) {
    float s[kWin];
    float row_max = __int_as_float(0xff800000);
#pragma unroll
    for (int kx = 0; kx < kWin; ++kx) {
      const int m = ky * kWin + kx;
      const float4* kr = reinterpret_cast<const float4*>(kh + m * kD);
      float acc = 0.f;
#pragma unroll
      for (int f = 0; f < kD / 4; ++f) {
        const float4 t = kr[f];
        acc = fmaf(q[4 * f], t.x, acc);
        acc = fmaf(q[4 * f + 1], t.y, acc);
        acc = fmaf(q[4 * f + 2], t.z, acc);
        acc = fmaf(q[4 * f + 3], t.w, acc);
      }
      float v = acc + bn[-(ky * kSide + kx)];
      if (reg[m] != rn) v += -100.f;
      s[kx] = v;
      row_max = fmaxf(row_max, v);
    }
    // online softmax: rescale the sums once a key row (0 at the first)
    const float mnew = fmaxf(mx, row_max);
    const float alpha = expf(mx - mnew);
    sum *= alpha;
#pragma unroll
    for (int c = 0; c < kD; ++c) o[c] *= alpha;
#pragma unroll
    for (int kx = 0; kx < kWin; ++kx) {
      const float p = expf(s[kx] - mnew);
      sum += p;
      const float4* vr =
          reinterpret_cast<const float4*>(vh + (ky * kWin + kx) * kD);
#pragma unroll
      for (int f = 0; f < kD / 4; ++f) {
        const float4 t = vr[f];
        o[4 * f] = fmaf(p, t.x, o[4 * f]);
        o[4 * f + 1] = fmaf(p, t.y, o[4 * f + 1]);
        o[4 * f + 2] = fmaf(p, t.z, o[4 * f + 2]);
        o[4 * f + 3] = fmaf(p, t.w, o[4 * f + 3]);
      }
    }
    mx = mnew;
  }
  if (sn < 0) return;
  const float inv = 1.f / sum;
  float4* op = reinterpret_cast<float4*>(
      a.out + (blockIdx.z * tokens + sn) * channels + qcol);
#pragma unroll
  for (int f = 0; f < kD / 4; ++f)
    op[f] = make_float4(o[4 * f] * inv, o[4 * f + 1] * inv,
                        o[4 * f + 2] * inv, o[4 * f + 3] * inv);
}

template <int G>
int launch(const Args& a, int windows, int batch, cudaStream_t stream) {
  auto kernel = swin_window_attn_kernel<G>;
  static bool sized = false;     // the shared-memory attribute, set once
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Tile<G>::kSmem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  kernel<<<dim3(windows, a.heads / G, batch), Tile<G>::kThreads,
           Tile<G>::kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound from Python with ctypes: the window attention
// of one Swin block over `batch` images of height x width tokens (fp32
// tensors in the layouts above). `window` must be 7 and 0 <= shift < 7;
// `heads_per_block` (1, 2 or 4, dividing heads) is the wrapper's launch
// plan. Launches on `stream` and returns cudaGetLastError() (0 on
// success); allocates nothing.
extern "C" int swin_window_attn(const void* qkv, const void* qkv_bias,
                                const void* table, void* out, int batch,
                                int height, int width, int heads, int window,
                                int shift, int heads_per_block, float scale,
                                void* stream) {
  const int g = heads_per_block;
  if (window != kWin || shift < 0 || shift >= kWin || batch < 1 ||
      batch > 65535 || height < 1 || width < 1 || heads < 1 ||
      (g != 1 && g != 2 && g != 4) || heads % g != 0 ||
      heads / g > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.qkv = (const float*)qkv;
  a.qkv_bias = (const float*)qkv_bias;
  a.table = (const float*)table;
  a.out = (float*)out;
  a.height = height;
  a.width = width;
  a.hp = (height + kWin - 1) / kWin * kWin;
  a.wp = (width + kWin - 1) / kWin * kWin;
  a.windows_x = a.wp / kWin;
  a.heads = heads;
  a.shift = shift;
  a.scale = scale;
  const int windows = (a.hp / kWin) * a.windows_x;
  cudaStream_t s = (cudaStream_t)stream;
  if (g == 4) return launch<4>(a, windows, batch, s);
  if (g == 2) return launch<2>(a, windows, batch, s);
  return launch<1>(a, windows, batch, s);
}
