// Flash-attention forward at bf16 for Hopper (sm_90a), every product on
// wgmma.
//
// Replaces, for bf16 q, k and v, aot_tpu/ops/pallas/flash_attn_vjp.py:51
// _fwd_kernel, the TPU kernel behind _flash_fwd_raw (:211) and
// flash_attention (:338): the global attention over a long LT memory in
// bf16 serving and every global attention of bf16 training. Layouts as
// flash_attn_fwd.cu (the fp32 kernel): q (B, Lq, h*d), k (B, Lk, h*d),
// v (B, Lk, h*dv) bf16 with row and batch strides given (the LT ring's live
// prefix); valid (B,) int32 live key counts or null; out (B, Lq, h*dv)
// bf16; lse (B*h, Lq) fp32. For each (b, head, query) over the live keys
// j < min(valid[b], Lk), as the TPU kernel computes at bf16 (:41-96):
// S = q k^T in fp32 (each product of two bf16 values exact), then scaled;
// the online max and sum in fp32; P rounded to bf16 before P V (:85), P V
// summed in fp32; out rounded to bf16 once; a row with no live key gives
// out 0 and lse -1e30 (:89-96); lse in fp32 for the backward.
//
// Design (the launch plan: flash_attn_fwd_bf16_plan.h). One kernel for
// every width, one pass, no score scratch. A block of two warpgroups takes
// one (b*h, 128-query tile, value tile of 32, 128 or 256 columns, key
// split); each warpgroup owns 64 query rows. The key loop runs over
// 64-key tiles and stops at the live length, so dead key tiles are never
// read. Per tile, in each warpgroup:
//   S = Q K^T    wgmma m64n64k16, both operands from shared memory
//                (K-major), d/16 steps;
//   softmax      scale, mask, the online max and sum in fp32 registers (a
//                thread holds parts of two rows; a row's max and sum over
//                the four threads of a quad), O rescaled by alpha;
//   O += P V     wgmma m64nVTk16, P the left operand straight from the
//                score registers rounded to bf16 (wg::bf16_from_acc), V the
//                right operand from shared memory MN-major (rows of keys as
//                they lie in memory: no transpose, no pack pass).
// The tiles land by TMA: q, k and v are 3-D tensor maps (channels, rows,
// batch; the LT ring's live prefix is a strided view) read in boxes of 64
// rows (Box below): 64 channels or columns wide with the 128-byte swizzle
// where d and dv are multiples of 64 (DeAOT's heads: 6 boxes a tile), 32
// wide with the 64-byte swizzle at AOT's d = dv = 32, else 8 wide without
// swizzle. One thread issues a tile's
// boxes under the stage's mbarrier, kS - 1 tiles ahead through a ring of
// three or four stages; a barrier a tile frees the stage the block
// finished. A box holds 64 keys, so the tile that holds the live length
// also brings dead keys: their S is masked and their v rows are zeroed in
// shared memory before P V (a dead key's value may be anything, and 0
// times a NaN is not 0).
// At dv > 256 (DeAOT's dv = 1024) each block takes one value tile and
// recomputes S: every value tile of a row sees the same keys in the same
// order and computes the same m, l and lse. At d = 128 and dv = 1024 that
// is 1.33x the FLOPs of one pass over the scores, where keeping the scores
// for a second pass costs an fp32 scratch of B*h*Lq*Lk (71 MB at DeAOTL's
// longest memory) read once per value tile. Where the grid is under the
// blocks the card holds at once, the key loop is split over blocks that
// write fp32 partials (out_i normalised, lse_i) and merge_kernel combines
// them in split order, lse = logsumexp_i lse_i, out = sum_i exp(lse_i -
// lse) out_i: two runs give the same bits. O is summed in the wgmma
// accumulator across key tiles (rescaled in fp32 registers between them);
// the tensor core's rounding toward zero over ~1,240 16-key steps moves it
// by ~1e-4 of its scale at 19,800 keys, far inside the output's bf16
// rounding (tests/test_torch_port_bf16_fwd.py emulates it).
//
// What bounds it (chip_smoke.py flash_fwd_bound_live at bf16: 2 (d + dv)
// FLOPs a (query, live key, head) over 989 TFLOP/s against q, the live k
// and v, out and lse over 3.35 TB/s): operations at every shape of the
// paths, e.g. 0.0415 ms at DeAOTL's LT read (Lq 900, Lk 19,800, d 128,
// dv 1024), 0.0302 at DeAOT's GPM self-attention in training (B 16,
// Lq = Lk = 900) and 0.0134 at AOTT's (B 16, h 8, d = dv = 32; NVIDIA H100
// 80GB HBM3, 700 W). On the card (PERF.md section 6) the products alone
// run at the tensor cores' rate (960 TFLOP/s in a loop of both from shared
// memory); what holds the kernel is feeding them: each block reads 48 KB
// of k and v a 64-key tile from L2 for 128 query rows. Unswizzled boxes 8
// wide (16-byte rows) and cp.async by every thread both ran 1.4-1.7x
// slower than 64-wide swizzled boxes at d = 128. Next: TMA multicast of a
// tile to the blocks of a cluster (fewer L2 reads), a producer warp that
// lets the two warpgroups' softmax and products overlap, and key splits
// that balance a batch of ragged live lengths.

#include <cuda.h>          // CUtensorMap (the encoder is found at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bf16_mma.cuh"
#include "flash_attn_fwd_bf16_plan.h"
#include "wgmma.cuh"

namespace {

using namespace fwdplan;
using bf16mma::bf16;
using bf16mma::store2;

constexpr float kNegInf = -1e30f;
constexpr float kEmptyLse = -1e29f;   // lse below this: no live key
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kUnit = 16;             // bytes of a copy: 8 bf16

struct Args {
  const int* valid;
  void* out;               // (B, Lq, h*dv) bf16, or the splits' fp32
                           // partials (split stride out_split floats)
  float* lse;              // (B*h, Lq), or the splits' partials
  long long out_split, lse_split;
  int heads, lq, lk, d, dv, valid_all, value_tiles, tiles_per_split;
  float scale;
  int out_bf16;            // `out` holds bf16 (one split)
};

// q, k and v as 3-D tensor maps (channels, rows, batch) of 8 x 64 x 1 boxes
struct Maps {
  CUtensorMap q, k, v;
};

// Tiles in shared memory, each filled by tensor-map copies (TMA) of boxes
// of W channels (q, k) or value columns (v) x 64 rows, in the layouts
// wgmma reads (W the plan's box_cols):
//   W = 64, 32  rows of 2W bytes, their 16-byte chunks XOR-swizzled by TMA
//               in atoms of 8 rows (the 128- and 64-byte swizzles); q, k
//               (K-major): SBO (the next 8 rows) 16W bytes, a 16-channel
//               step 32 bytes into the row, the next W channels the next
//               box; v (MN-major): LBO (the next W columns, a box) 128W,
//               SBO (the next 8 keys) 16W;
//   W = 8       rows of 16 bytes, 8 of wgmma's 128-byte core matrices, no
//               swizzle; q, k: box c (channels 8c..) at 1 KB c, LBO (the
//               next 8 channels) 1 KB, SBO (the next 8 rows) 128; v: LBO
//               (the next 8 keys) 128, SBO (the next 8 columns) 1 KB.
// Wide boxes are few copies of whole rows (2 + 4 a tile at DeAOT's d = 128
// with 256 value columns); they need every box inside one head.
template <int W>
struct Box {
  static_assert(W == 8 || W == 32 || W == 64, "W");
  static constexpr int kCols = W;                 // channels or columns
  static constexpr int kBytes = W * 2 * 64;       // 64 rows
  static constexpr uint64_t kType =               // swizzle mode
      W == 64 ? 1ull << 62 : W == 32 ? 2ull << 62 : 0;

  // the K-major tile at shared address t, k-step ks (16 channels)
  __device__ static uint64_t k_major(uint32_t t, int ks) {
    if constexpr (W > 8)
      return wg::desc_strides(t + (ks * 16 / W) * kBytes + (ks * 16 % W) * 2,
                              16, 16 * W) |
             kType;
    else
      return wg::desc_strides(t + ks * 2 * kBytes, kBytes, 128);
  }
  // the MN-major value tile at shared address t, k-step j (16 keys)
  __device__ static uint64_t mn_major(uint32_t t, int j) {
    if constexpr (W > 8)
      return wg::desc_strides(t + j * 32 * W, kBytes, 16 * W) | kType;
    else
      return wg::desc_strides(t + j * 256, 128, kBytes);
  }
};

// Bounded wait on an mbarrier phase: a lost copy ends the kernel with an
// error instead of hanging it
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = wg::smem_u32(bar);
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1LL << 26)) __trap();
  }
}

// One box of a 3-D tensor map (channels, rows, batch) at coordinates
// (c0, c1, c2) into shared memory, completing on `bar`
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// O += P V over one 64-key tile: P the bf16 register fragments of its four
// 16-key steps, V the MN-major value tile at shared address u_v. Fences,
// issues and commits; the caller waits.
template <int VT, int W>
__device__ __forceinline__ void pv_issue(float* o, uint32_t (*pf)[4],
                                         uint32_t u_v) {
  wg::keep_u<kKeyTile / 4>(&pf[0][0]);
  wg::keep<VT / 2>(o);
  wg::fence();
#pragma unroll
  for (int j = 0; j < kKeyTile / 16; ++j)
    wg::mma_rs_tb<VT>(o, pf[j], Box<W>::mn_major(u_v, j), 1);
  wg::commit();
}

// The plan's tiles of one instantiation, tied to the plan header
template <int DP, int VT, int W>
struct Tiles {
  static constexpr int kS = stages(DP, VT);            // ring stages
  static constexpr int kBlocks = blocks_per_sm(VT);    // a multiprocessor
  static constexpr int kQWg = (int)qk_tile_bytes(kWgRows, DP);
  static constexpr int kKBytes = (int)qk_tile_bytes(kKeyTile, DP);
  static constexpr int kStage = (int)stage_bytes(DP, VT);
  static constexpr int kSmem = (int)smem_bytes(DP, VT);
  static_assert(kS >= 3 && kS <= kMaxStages && VT == value_tile(VT, DP) &&
                DP == d_pad(DP) && kSmem <= kMaxSmem && kKeyTile == 64 &&
                kWgRows == 64 && kThreads == 256 &&
                kSmem == kAlign + kWarpgroups * kQWg + kS * kStage +
                             kBarBytes &&
                kQWg == DP / W * Box<W>::kBytes && kKBytes == kQWg &&
                kQWg % kAlign == 0 &&
                kStage == kKBytes + VT / W * Box<W>::kBytes &&
                DP % W == 0 && VT % W == 0);
};

template <int DP, int VT, int W>
__global__ void __launch_bounds__(kThreads, (Tiles<DP, VT, W>::kBlocks))
    fwd_bf16_kernel(const Args a, const __grid_constant__ Maps maps) {
  using T = Tiles<DP, VT, W>;
  using B = Box<W>;
  constexpr int kS = T::kS;
  constexpr int kNO = VT / 2;                 // O accumulators a thread
  constexpr int kNS = kKeyTile / 2;           // S accumulators a thread
  constexpr int kKSteps = DP / 16;            // S = Q K^T k-steps
  constexpr int kQWg = T::kQWg;               // a warpgroup's q tile
  constexpr int kKBytes = T::kKBytes;
  constexpr int kStage = T::kStage;
  extern __shared__ __align__(128) char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) &
      ~uintptr_t(kAlign - 1));
  char* s_q = smem;                           // two warpgroups' q tiles
  char* s_ring = smem + kWarpgroups * kQWg;   // kS x (k tile, v tile)
  uint64_t* bars = reinterpret_cast<uint64_t*>(s_ring + kS * kStage);
  uint64_t* q_bar = bars + kS;                // bars[s]: stage s is full

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;            // in the warpgroup
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int bh = blockIdx.x;
  const int b = bh / a.heads;
  const int head = bh - b * a.heads;
  const int q0 = blockIdx.y * kBlockRows;
  const int vt = blockIdx.z % a.value_tiles;
  const int split = blockIdx.z / a.value_tiles;
  const int c0 = vt * VT;
  int n_live = a.valid != nullptr ? a.valid[b] : a.valid_all;
  n_live = max(0, min(n_live, a.lk));
  const int k_begin = split * a.tiles_per_split * kKeyTile;
  const int k_end = min(n_live, k_begin + a.tiles_per_split * kKeyTile);
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kKeyTile - 1) / kKeyTile : 0;
  const int k_boxes = a.d / B::kCols;         // boxes of a q or k row
  const int v_boxes = min(VT, a.dv - c0) / B::kCols;

  // channels beyond d and value columns beyond dv are never copied: zero
  // (a partial head only; the paths' widths fill their tiles)
  if (k_boxes * B::kCols < DP || v_boxes * B::kCols < VT) {
    for (int i = tid; i < (kWarpgroups * kQWg + kS * kStage) / 16;
         i += kThreads)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
    wg::fence_async_smem();
  }
  if (tid == 0) {
    for (int i = 0; i <= kS; ++i) wg::bar_init(&bars[i], 1);
    wg::bar_init_fence();
  }
  __syncthreads();
  auto load_tile = [&](int i) {   // key tile i of this split -> its stage
    const int k0 = k_begin + i * kKeyTile;
    char* st = s_ring + (i % kS) * kStage;
    uint64_t* bar = &bars[i % kS];
    wg::bar_expect(bar, (k_boxes + v_boxes) * B::kBytes);
    for (int c = 0; c < k_boxes; ++c)
      tma_box(st + c * B::kBytes, &maps.k, head * a.d + c * B::kCols, k0, b,
              bar);
    for (int j = 0; j < v_boxes; ++j)
      tma_box(st + kKBytes + j * B::kBytes, &maps.v,
              head * a.dv + c0 + j * B::kCols, k0, b, bar);
  };
  if (tid == 0) {
    // the q tile (zero beyond Lq), then the first stages
    wg::bar_expect(q_bar, 2 * k_boxes * B::kBytes);
    for (int w = 0; w < kWarpgroups; ++w)
      for (int c = 0; c < k_boxes; ++c)
        tma_box(s_q + w * kQWg + c * B::kBytes, &maps.q,
                head * a.d + c * B::kCols, q0 + w * kWgRows, b, q_bar);
    for (int i = 0; i < kS - 1 && i < n_tiles; ++i) load_tile(i);
  }

  // rows 16 warp + g and + 8 of the warpgroup's 64: running max and sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[kNO], s[kNS];
#pragma unroll
  for (int j = 0; j < kNO; ++j) o[j] = 0.f;
  // a warpgroup whose rows all lie beyond Lq skips the products
  const bool active = q0 + wg * kWgRows < a.lq;
  const uint32_t u_q = wg::smem_u32(s_q + wg * kQWg);
  const uint32_t u_ring = wg::smem_u32(s_ring);
  bar_wait(q_bar, 0);                 // (no copy may outlive the block)

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = k_begin + i * kKeyTile;
    char* st = s_ring + (i % kS) * kStage;
    bar_wait(&bars[i % kS], (i / kS) & 1);   // tile i landed
    if (k0 + kKeyTile > n_live && n_live < a.lk) {
      // the copies read keys at and beyond the live length too (a box is
      // 64 keys): their values may be anything, so zero those v rows (P
      // is 0 there, but 0 times a NaN is not)
      const int r0 = n_live - k0, r1 = min(kKeyTile, a.lk - k0);
      constexpr int kRow = B::kCols * 2;      // bytes of a box row
      for (int u = tid; u < (r1 - r0) * v_boxes * (kRow / 16);
           u += kThreads) {
        const int j = u / ((r1 - r0) * (kRow / 16));
        const int rest = u - j * (r1 - r0) * (kRow / 16);
        *reinterpret_cast<uint4*>(st + kKBytes + j * B::kBytes +
                                  (r0 + rest / (kRow / 16)) * kRow +
                                  rest % (kRow / 16) * 16) =
            make_uint4(0, 0, 0, 0);
      }
      wg::fence_async_smem();
    }
    __syncthreads();                   // every thread is done with tile i-1
    if (tid == 0 && i + kS - 1 < n_tiles) load_tile(i + kS - 1);
    if (!active) continue;
    const uint32_t u_k = u_ring + (i % kS) * kStage;
#pragma unroll
    for (int j = 0; j < kNS; ++j) s[j] = 0.f;
    wg::keep<kNS>(s);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks)   // 16 channels a step
      wg::ss_bf16_n64(s, B::k_major(u_q, ks), B::k_major(u_k, ks), 1);
    wg::commit();
    wg::wait<0>();
    wg::keep<kNS>(s);
    // scale and mask; this tile holds a live key (k0 < k_end), so the new
    // max is finite and exp2(-1e30 * log2e - ...) is exactly 0
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;               // row e >> 1, column e & 1
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        s[x] = key < k_end ? s[x] * a.scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[x]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < kKeyTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        s[x] = exp2f((s[x] - m[e >> 1]) * kLog2e);
        rs[e >> 1] += s[x];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(rs[r]);
#pragma unroll
    for (int j = 0; j < VT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
    // O += P V: P rounded to bf16, 16 keys a k-step, from the registers
    uint32_t pf[kKeyTile / 16][4];
#pragma unroll
    for (int j = 0; j < kKeyTile / 16; ++j) wg::bf16_from_acc(pf[j], s, j);
    pv_issue<VT, W>(o, pf, u_k + kKBytes);
    wg::wait<0>();
    wg::keep<kNO>(o);
  }

  if (!active) return;
  const long long o_stride = (long long)a.heads * a.dv;
  float* lse = a.lse + split * a.lse_split + (long long)bh * a.lq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wg * kWgRows + warp * 16 + g + 8 * r;
    if (row >= a.lq) continue;
    const bool empty = l[r] == 0.f;
    const float inv = empty ? 0.f : 1.f / l[r];
    const long long o_row = split * a.out_split +
                            ((long long)b * a.lq + row) * o_stride +
                            (long long)head * a.dv + c0;
#pragma unroll
    for (int j = 0; j < VT / 8; ++j) {
      const int col = 8 * j + 2 * t;         // dv % 8 == 0: both or none
      if (c0 + col < a.dv)
        store2(a.out, o_row + col, a.out_bf16, o[4 * j + 2 * r] * inv,
               o[4 * j + 2 * r + 1] * inv);
    }
    if (vt == 0 && t == 0) lse[row] = empty ? kNegInf : m[r] + logf(l[r]);
  }
}

// Merge the key splits' partials in split order: out and lse of each
// (b, query, head) from (out_i, lse_i), i < splits. An empty split has
// lse_i = -1e30 and out_i = 0 and weighs exactly 0; a row with no live key
// in any split gives out 0 and lse -1e30.
__global__ void __launch_bounds__(256)
merge_kernel(const float* __restrict__ part,
             const float* __restrict__ part_lse, bf16* __restrict__ out,
             float* __restrict__ lse, int splits, int heads, int lq, int dv,
             long long n4, long long out_split, long long lse_split) {
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
    for (int s = 0; s < splits; ++s)
      mx = fmaxf(mx, part_lse[s * lse_split + li]);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    float total = kNegInf;
    if (mx > kEmptyLse) {
      float sum = 0.f;
      for (int s = 0; s < splits; ++s)
        sum += expf(part_lse[s * lse_split + li] - mx);
      total = mx + logf(sum);
      for (int s = 0; s < splits; ++s) {
        const float w = expf(part_lse[s * lse_split + li] - total);
        const float4 x =
            *reinterpret_cast<const float4*>(part + s * out_split + e);
        o.x = fmaf(w, x.x, o.x);
        o.y = fmaf(w, x.y, o.y);
        o.z = fmaf(w, x.z, o.z);
        o.w = fmaf(w, x.w, o.w);
      }
    }
    store2(out, e, true, o.x, o.y);
    store2(out, e + 2, true, o.z, o.w);
    if (col % dv == 0) lse[li] = total;
  }
}

template <int DP, int VT, int W>
int launch(const Args& a, const Maps& maps, const long long* p,
           cudaStream_t stream) {
  auto kernel = fwd_bf16_kernel<DP, VT, W>;
  const int smem = Tiles<DP, VT, W>::kSmem;
  if (p[kSmem] != smem || p[kStages] != Tiles<DP, VT, W>::kS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(p[kB] * p[kH]), (unsigned)p[kQTiles],
                  (unsigned)(p[kValueTiles] * p[kSplits]));
  kernel<<<grid, kThreads, smem, stream>>>(a, maps);
  return (int)cudaGetLastError();
}

template <int DP, int VT>
int launch_v(const Args& a, const Maps& maps, const long long* p,
             cudaStream_t s) {
  switch (p[kBoxCols]) {
    case 64:
      if constexpr (DP >= 64 && VT >= 64)
        return launch<DP, VT, 64>(a, maps, p, s);
      break;
    case 32: return launch<DP, VT, 32>(a, maps, p, s);
    case 8: return launch<DP, VT, 8>(a, maps, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int DP>
int launch_d(const Args& a, const Maps& maps, const long long* p,
             cudaStream_t s) {
  switch (p[kValueTile]) {
    case 32: return launch_v<DP, 32>(a, maps, p, s);
    case 128: return launch_v<DP, 128>(a, maps, p, s);
    case 256:   // value_tile: 256 columns only up to d = 128
      if constexpr (DP <= 128) return launch_v<DP, 256>(a, maps, p, s);
  }
  return (int)cudaErrorInvalidValue;
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

// A (channels, rows, batch) bf16 tensor map of W x 64 x 1 boxes in Box<W>'s
// swizzle, zeros outside the tensor; strides in elements
bool make_map(CUtensorMap* map, const void* base, long long channels,
              long long rows, long long batch, long long row_stride,
              long long batch_stride, int w) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)channels,
                              (cuuint64_t)(rows > 0 ? rows : 1),
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)row_stride * 2,
                                 (cuuint64_t)(batch > 1 ? batch_stride
                                                        : rows * row_stride) *
                                     2};
  const cuuint32_t box[3] = {(cuuint32_t)w, kKeyTile, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                w == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                : w == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Plain C entry, bound from Python with ctypes: `plan` as fwd_bf16_plan
// filled it for this shape (flash_attn_fwd_bf16_plan.h), bf16 q, k, v and
// out and fp32 lse in the layouts above (strides in elements, multiples of
// 8, pointers 16-byte aligned: the wrapper checks), `work` the plan's
// workspace (the splits' partials; null when it is 0 bytes). Launches on
// `stream` and returns the first non-zero cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a plan it does not take;
// allocates nothing.
extern "C" int flash_attn_fwd_bf16(const long long* plan, const void* q,
                                   const void* k, const void* v,
                                   const void* valid, void* out, void* lse,
                                   void* work, int valid_all, long long q_sb,
                                   long long q_sl, long long k_sb,
                                   long long k_sl, long long v_sb,
                                   long long v_sl, float scale,
                                   void* stream) {
  const long long* p = plan;
  const long long splits = p[kSplits];
  if (p[kWorkspace] < 0 || (splits > 1) != (work != nullptr) ||
      p[kDPad] != d_pad(p[kD]) ||
      p[kValueTile] != value_tile(p[kDv], (int)p[kDPad]) ||
      p[kBoxCols] != box_cols(p[kD], p[kDv], (int)p[kDPad],
                              (int)p[kValueTile]) ||
      (q_sb | q_sl | k_sb | k_sl | v_sb | v_sl) % 8 != 0 ||
      p[kQTiles] > 65535 || p[kValueTiles] * splits > 65535)
    return (int)cudaErrorInvalidValue;
  Maps maps;
  const int box = (int)p[kBoxCols];
  if (!make_map(&maps.q, q, p[kH] * p[kD], p[kLq], p[kB], q_sl, q_sb, box) ||
      !make_map(&maps.k, k, p[kH] * p[kD], p[kLk], p[kB], k_sl, k_sb, box) ||
      !make_map(&maps.v, v, p[kH] * p[kDv], p[kLk], p[kB], v_sl, v_sb, box))
    return (int)cudaErrorInvalidValue;
  const long long n_out = p[kB] * p[kLq] * p[kH] * p[kDv];
  const long long n_lse = p[kB] * p[kH] * p[kLq];
  char* w = static_cast<char*>(work);
  float* part_out = splits > 1 ? (float*)(w + p[kPartOut]) : nullptr;
  float* part_lse = splits > 1 ? (float*)(w + p[kPartLse]) : nullptr;
  Args a{(const int*)valid, splits > 1 ? (void*)part_out : out,
         splits > 1 ? part_lse : (float*)lse,
         splits > 1 ? n_out : 0, splits > 1 ? n_lse : 0,
         (int)p[kH], (int)p[kLq], (int)p[kLk], (int)p[kD], (int)p[kDv],
         valid_all, (int)p[kValueTiles], (int)p[kTilesPerSplit], scale,
         splits > 1 ? 0 : 1};
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  switch (p[kDPad]) {
    case 32: err = launch_d<32>(a, maps, p, s); break;
    case 128: err = launch_d<128>(a, maps, p, s); break;
    case 256: err = launch_d<256>(a, maps, p, s); break;
    default: err = (int)cudaErrorInvalidValue;
  }
  if (err != 0 || splits == 1) return err;
  const long long n4 = n_out / 4;
  const long long blocks = (n4 + 255) / 256 < 2048 ? (n4 + 255) / 256 : 2048;
  merge_kernel<<<(int)blocks, 256, 0, s>>>(part_out, part_lse, (bf16*)out,
                                           (float*)lse, (int)splits,
                                           (int)p[kH], (int)p[kLq],
                                           (int)p[kDv], n4, n_out, n_lse);
  return (int)cudaGetLastError();
}
