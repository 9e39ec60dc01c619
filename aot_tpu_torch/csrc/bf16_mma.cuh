// Device helpers for the bf16 instantiations of the flash-attention kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu): mma.sync m16n8k16 on bf16
// operands into fp32 accumulators, bf16 pairs packed for its operand
// registers, two-column stores in fp32 or bf16, and cp.async staging of
// fp32 or bf16 tiles into shared memory.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4; each operand
// register holds two bf16, the lower index in the low half):
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1),
//                     a2 (g, 2t+8..2t+9), a3 (g + 8, 2t+8..2t+9)
//   B (16 x 8, col):  b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g)
//   C (16 x 8):       as m16n8k8's (tf32x3.cuh)
// So the accumulators of two adjacent 8-column blocks of a score tile (rows
// g and g + 8, columns 2t and 2t + 1 of each) are exactly the A fragment of
// a 16-column product: P and dS go from the accumulators into the next
// product, rounded to bf16 in registers, with no permutation.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace bf16mma {

using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool kIsBf16 = std::is_same_v<T, bf16>;

// the low half of a 32-bit mma operand register holds the lower index
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a b, m16n8k16 on bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of a 16-column product from the accumulators of two
// adjacent 8-column blocks w0, w1 (columns 0-7 and 8-15), rounded to bf16
__device__ __forceinline__ void a_from_acc_bf16(uint32_t fa[4],
                                                const float w0[4],
                                                const float w1[4]) {
  fa[0] = pack_bf16(w0[0], w0[1]);
  fa[1] = pack_bf16(w0[2], w0[3]);
  fa[2] = pack_bf16(w1[0], w1[1]);
  fa[3] = pack_bf16(w1[2], w1[3]);
}

// Store two adjacent output columns (fp32, or rounded to bf16)
__device__ __forceinline__ void store2(void* out, long long i, bool as_bf16,
                                       float x, float y) {
  if (as_bf16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + i) =
        __floats2bfloat162_rn(x, y);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(out) + i) =
        make_float2(x, y);
}

// tf32x3::stage for fp32 tiles; for bf16, 8 elements a 16-byte copy
// (COLS a multiple of 8, columns at or beyond c_end zero: c_end a
// multiple of 8)
template <typename T, int ROWS, int COLS, int LD, int THREADS>
__device__ __forceinline__ void stage_t(T* dst, const T* src, long long ld,
                                        int r_end, int c_end) {
  if constexpr (!kIsBf16<T>) {
    tf32x3::stage<ROWS, COLS, LD, THREADS>(dst, src, ld, r_end, c_end);
  } else {
    constexpr int kC8 = COLS / 8;
#pragma unroll 4
    for (int i = threadIdx.x; i < ROWS * kC8; i += THREADS) {
      const int r = i / kC8;
      const int c = (i % kC8) * 8;
      const bool ok = r < r_end && c < c_end;
      tf32x3::cp_async16(
          reinterpret_cast<float*>(dst + r * LD + c),
          reinterpret_cast<const float*>(ok ? src + r * ld + c : src), ok);
    }
  }
}

}  // namespace bf16mma
