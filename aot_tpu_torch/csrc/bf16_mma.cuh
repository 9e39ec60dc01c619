// Device helpers of the kernels that take bf16 operands
// (local_window_attn_bf16.cu, flash_attn_bwd.cu; flash_attn_fwd_bf16.cu and
// the fp32 flash forward store with store2): mma.sync m16n8k16 on bf16
// operands into fp32 accumulators, bf16 pairs packed for its operand
// registers, and two-column stores in fp32 or bf16.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4; each operand
// register holds two bf16, the lower index in the low half):
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1),
//                     a2 (g, 2t+8..2t+9), a3 (g + 8, 2t+8..2t+9)
//   B (16 x 8, col):  b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g)
//   C (16 x 8):       as m16n8k8's (tf32x3.cuh)

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

}  // namespace bf16mma
