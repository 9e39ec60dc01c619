// Device helpers shared by the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): fp32-accurate products on the TF32 tensor cores and
// cp.async staging of fp32 tiles into shared memory.
//
// 3xTF32. A TF32 tensor-core product keeps 10 mantissa bits of each operand
// (~3 decimal digits); the JAX kernels these replace compute fp32 at
// Precision.HIGHEST. So every operand x is split into two TF32 numbers,
//   x_hi = cvt.rna.tf32.f32(x),  x_lo = cvt.rna.tf32.f32(x - x_hi)
// (the same rounding in integer instructions, see tf32_hi),
// and a b is computed as a_lo b_hi + a_hi b_lo + a_hi b_hi (the small terms
// first) in fp32 accumulators: ~21 bits of each operand, the dropped
// a_lo b_lo term is ~2^-22 of the product. Instruction: mma.sync m16n8k8
// .row.col.f32.tf32.tf32.f32 (legal on sm_90a; its fragments are loaded
// from shared memory in any layout, which lets P and dS go from the score
// accumulators straight into the next product, see `a_from_acc`).
//
// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace tf32x3 {

// x rounded to TF32 as cvt.rna.tf32.f32 rounds (to nearest, ties away from
// zero: add half of the range of the 13 dropped bits to the magnitude, then
// drop them), with the low 13 bits cleared, so the value is exact in fp32
// too. Two integer instructions: on sm_90a cvt.rna.tf32.f32 compiles to the
// same add behind a test for inf and NaN (three instructions, none of
// which these kernels need), and the splits, not the products, bounded the
// first version of the kernels.
__device__ __forceinline__ uint32_t tf32_hi(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The rest x - hi rounded the same way. Its low 13 bits are left as they
// are: the tensor core reads only the 19 high bits of a TF32 operand.
__device__ __forceinline__ uint32_t tf32_lo(float x, uint32_t hi) {
  return __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

// A fragment from its four elements (a0, a1, a2, a3 of the layout above)
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  const float x[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = tf32_hi(x[i]);
    f.lo[i] = tf32_lo(x[i], f.hi[i]);
  }
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  f.hi[0] = tf32_hi(b0);
  f.lo[0] = tf32_lo(b0, f.hi[0]);
  f.hi[1] = tf32_hi(b1);
  f.lo[1] = tf32_lo(b1, f.hi[1]);
  return f;
}

// The A fragment of a product whose left operand is a score-shaped
// accumulator c[4] (P or dS, 16 rows x 8 columns): the accumulator holds
// columns 2t and 2t + 1, so the summation index is taken in the order
// k = t <-> column 2t, k = t + 4 <-> column 2t + 1. The B fragment of the
// same product must read rows 2t and 2t + 1 of its 8-row block (b0, b1).
__device__ __forceinline__ FragA a_from_acc(const float c[4]) {
  return frag_a(c[0], c[2], c[1], c[3]);
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b to fp32 accuracy: a_lo b_hi + a_hi b_lo + a_hi b_hi, small first
__device__ __forceinline__ void mma3(float c[4], const FragA& a,
                                     const FragB& b) {
  mma(c, a.lo, b.hi[0], b.hi[1]);
  mma(c, a.hi, b.lo[0], b.lo[1]);
  mma(c, a.hi, b.hi[0], b.hi[1]);
}

// The same product with the large term kept apart: big += a_hi b_hi,
// small += a_lo b_hi + a_hi b_lo. The tensor core rounds its fp32
// accumulator toward zero after each product, so a long sum in one
// accumulator drifts by up to an ulp a step; with the small terms apart,
// the large accumulator takes a third of the roundings, and big + small
// is added once in fp32.
__device__ __forceinline__ void mma3_apart(float big[4], float small[4],
                                           const FragA& a, const FragB& b) {
  mma(small, a.lo, b.hi[0], b.hi[1]);
  mma(small, a.hi, b.lo[0], b.lo[1]);
  mma(big, a.hi, b.hi[0], b.hi[1]);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copies of a ROWS x COLS fp32 tile (COLS a multiple of 4) into
// shared memory with row stride LD floats: `src` is its row 0, column 0 in
// global memory, `ld` its row stride in floats (both 16-byte aligned).
// Rows at or beyond `r_end` and columns at or beyond `c_end` are zero
// (cp.async with a source size of 0 reads nothing). THREADS threads share
// the copies.
template <int ROWS, int COLS, int LD, int THREADS>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long ld, int r_end, int c_end) {
  constexpr int kC4 = COLS / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * kC4; i += THREADS) {
    const int r = i / kC4;
    const int c = (i % kC4) * 4;
    const bool ok = r < r_end && c < c_end;
    cp_async16(dst + r * LD + c, ok ? src + r * ld + c : src, ok);
  }
}

// Issue the copies of N consecutive floats (4 bytes a copy, any alignment);
// those at or beyond `n_end` are zero.
template <int N, int THREADS>
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int n_end) {
  for (int i = threadIdx.x; i < N; i += THREADS)
    cp_async4(dst + i, i < n_end ? src + i : src, i < n_end);
}

}  // namespace tf32x3
