// Hopper (sm_90a) building blocks of the flash-attention backward
// (flash_attn_bwd.cu) and of the fp32 forward's P V pass (flash_attn_fwd.cu
// pv_kernel): warpgroup products (wgmma) with the right operand
// in shared memory and the left one in shared memory or registers, 1-D
// bulk copies (cp.async.bulk, run by the TMA unit) of whole operand tiles
// into shared memory under mbarriers, and the packed layout both read.
//
// The packed layout. wgmma reads a K-major operand without swizzle as
// "core matrices" of 8 rows x 16 bytes, each 128 contiguous bytes. An
// operand of R rows and C columns (C the summation index, K) is kept in
// chunks of 128 bytes of K (32 fp32 or 64 bf16 columns, KC): chunk c holds
// every row, in groups of 8 rows, each group the chunk's 8 core matrices
// in K order. In bytes, with E = 16 / sizeof(element) and R padded to Rp:
//   (c / KC) * Rp * 128 + (r / 8) * 1024 + (c % KC / E) * 128
//     + (r % 8) * 16 + (c % E) * sizeof(element)
// so rows [r0, r0 + n) of one chunk are n * 128 contiguous bytes at
// (c / KC) * Rp * 128 + r0 * 128: one bulk copy moves a tile into shared
// memory, where it keeps the layout. A wgmma descriptor of such a tile has
// LBO 128 bytes (K-adjacent core matrices) and SBO 1024 (8-row groups),
// and advances 256 bytes a k-step (32 bytes of K: 16 bf16 or 8 tf32).
// flash_attn_bwd.cu's bwd_pack_kernel writes this layout;
// flash_attn_bwd_plan.h sizes it.
//
// 3xTF32 on wgmma. An fp32 operand is kept as two copies of the layout,
// hi = x rounded to TF32 and lo = the rest rounded to TF32 (tf32x3.cuh),
// split once where the operand is packed; a product is three TF32
// products, lo hi + hi lo + hi hi (the small terms first). `.tf32` wgmma
// reads shared-memory operands K-major only, so every operand is packed
// K-major for the product that reads it.
//
// The accumulator of m64nN (g = lane / 4, t = lane % 4, w = warp of the
// warpgroup): d[4j + 2i + e] = (row 16w + g + 8i, column 8j + 2t + e).
// A left operand in registers (one k-step), per warp's 16 rows:
//   bf16 k16: a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1), a2 (g, 2t+8..2t+9),
//             a3 (g + 8, 2t+8..2t+9): the accumulators of columns 16j to
//             16j + 15 are this fragment, rounded to bf16 (bf16_from_acc);
//   tf32 k8:  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4):
//             the accumulators of columns 8j to 8j + 7 give it with the
//             summation index taken in the order k = t <-> column 2t,
//             k = t + 4 <-> column 2t + 1 (tf32_from_acc), so the right
//             operand's rows of K are packed in that order within each 8
//             (the packed "permuted" form: position p of each group of 8
//             holds row 2p for p < 4, 2(p - 4) + 1 above).

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace wg {

constexpr int kChunkBytes = 128;   // bytes of K a packed row of a chunk
constexpr int kGroupBytes = 1024;  // 8 rows of a chunk (SBO)
constexpr int kStepBytes = 256;    // a k-step: two core matrices of K

template <typename E>
constexpr int kChunk = kChunkBytes / (int)sizeof(E);   // KC, elements

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The descriptor of a tile at shared address addr, with `lbo` bytes between
// two core matrices adjacent in K and `sbo` between two adjacent in M or N
// (the canonical no-swizzle layouts: K-major ((8 rows, m), (8 elements, k))
// : ((16 bytes, sbo), (1, lbo)); MN-major, bf16 only, ((8 elements, m),
// (8 rows of K, k)) : ((1, sbo), (16 bytes, lbo)); a core matrix is 128
// contiguous bytes either way). Its swizzle mode (bits 62-63) is 0, no
// swizzle; a swizzled tile ORs in 1 (128-byte) or 2 (64-byte), and its
// strides are those of flash_attn_fwd_bf16.cu's Box.
__device__ __forceinline__ uint64_t desc_strides(uint32_t addr, uint32_t lbo,
                                                 uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// The descriptor of a tile of the packed layout at shared address addr
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return desc_strides(addr, kChunkBytes, kGroupBytes);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulators across a
// wgmma fence or wait
template <int R>
__device__ __forceinline__ void keep(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void keep_u(uint32_t* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ---- wgmma m64nNk16 (bf16) and m64nNk8 (tf32), fp32 accumulators ----------
// scale_d 0: d = a b; 1: d += a b. ss: both operands from descriptors; rs:
// a from registers.

__device__ __forceinline__ void rs_bf16_n32(
    float* d, const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void ss_bf16_n64(
    float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void ss_bf16_n128(
    float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void ss_tf32_n32(
    float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void rs_tf32_n32(
    float* d, const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void ss_tf32_n64(
    float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void ss_tf32_n128(
    float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// tf32, left operand in registers, 128 columns: the fp32 flash forward's
// P V (flash_attn_fwd.cu pv_kernel)
__device__ __forceinline__ void rs_tf32_n128(
    float* d, const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// bf16, left operand in registers, right operand MN-major (imm-trans-b 1):
// the flash forward's P V with V in its natural layout (rows of keys, the
// value columns contiguous; an MN-major desc_strides tile)
__device__ __forceinline__ void rs_bf16_n32_tb(
    float* d, const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void rs_bf16_n128_tb(
    float* d, const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void rs_bf16_n256_tb(
    float* d, const uint32_t* a, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void mma_rs_tb(float* d, const uint32_t* a,
                                          uint64_t db, int scale_d) {
  static_assert(N == 32 || N == 128 || N == 256, "N");
  if constexpr (N == 32) rs_bf16_n32_tb(d, a, db, scale_d);
  else if constexpr (N == 128) rs_bf16_n128_tb(d, a, db, scale_d);
  else rs_bf16_n256_tb(d, a, db, scale_d);
}

// The shapes the backward uses: N = 32 (tf32), 64 and 128 with shared
// memory operands; N = 32 with the left one in registers.
template <typename E, int N>
__device__ __forceinline__ void mma_ss(float* d, uint64_t da, uint64_t db,
                                       int scale_d) {
  static_assert(N == 64 || N == 128 || (N == 32 && sizeof(E) == 4), "N");
  if constexpr (sizeof(E) == 2) {
    if constexpr (N == 64) ss_bf16_n64(d, da, db, scale_d);
    else ss_bf16_n128(d, da, db, scale_d);
  } else {
    if constexpr (N == 32) ss_tf32_n32(d, da, db, scale_d);
    else if constexpr (N == 64) ss_tf32_n64(d, da, db, scale_d);
    else ss_tf32_n128(d, da, db, scale_d);
  }
}

template <typename E, int N>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a,
                                       uint64_t db, int scale_d) {
  static_assert(N == 32, "N");
  if constexpr (sizeof(E) == 2)
    rs_bf16_n32(d, a, db, scale_d);
  else
    rs_tf32_n32(d, a, db, scale_d);
}

// d (+)= A B^T over the first `steps` (<= 4) k-steps of one chunk: A a
// 64-row tile at shared address a (its lo copy at a_lo), B an N-row tile at
// b (b_lo); the lo copies are read for fp32 only. fp32: lo hi + hi lo +
// hi hi; APART: the hi hi term into d, the small ones into `small`.
// scale_d 0 overwrites d (and small) with the first k-step. Issues the
// products only: the caller fences before and commits and waits after.
template <typename E, int N, bool APART = false>
__device__ __forceinline__ void chunk_ss(float* d, float* small, uint32_t a,
                                         uint32_t a_lo, uint32_t b,
                                         uint32_t b_lo, int steps,
                                         int scale_d) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (s < steps) {
      const int sd = s == 0 ? scale_d : 1;
      const uint64_t ah = desc(a + s * kStepBytes);
      const uint64_t bh = desc(b + s * kStepBytes);
      if constexpr (sizeof(E) == 2) {
        mma_ss<E, N>(d, ah, bh, sd);
      } else {
        const uint64_t al = desc(a_lo + s * kStepBytes);
        const uint64_t bl = desc(b_lo + s * kStepBytes);
        float* lo_acc = APART ? small : d;
        mma_ss<E, N>(lo_acc, al, bh, sd);
        mma_ss<E, N>(lo_acc, ah, bl, 1);
        mma_ss<E, N>(d, ah, bh, APART ? sd : 1);
      }
    }
  }
}

// The left operand of one k-step from accumulators c of a score-shaped
// tile (the layout above): bf16, columns 16j..16j+15, rounded to bf16
__device__ __forceinline__ void bf16_from_acc(uint32_t* a, const float* c,
                                              int j) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v =
        __floats2bfloat162_rn(c[8 * j + 2 * i], c[8 * j + 2 * i + 1]);
    a[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
}

// tf32, columns 8j..8j+7 in the permuted summation order, split into hi
// and lo
__device__ __forceinline__ void tf32_from_acc(uint32_t* hi, uint32_t* lo,
                                              const float* c, int j) {
  const float x[4] = {c[4 * j], c[4 * j + 2], c[4 * j + 1], c[4 * j + 3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32x3::tf32_hi(x[i]);
    lo[i] = tf32x3::tf32_lo(x[i], hi[i]);
  }
}

// The left operand of a product C B^T over one chunk (4 k-steps), from
// the accumulators c of a score-shaped tile: k-step s holds columns 16 s to
// 16 s + 15 at bf16 (bf16_from_acc), 8 s to 8 s + 7 at fp32, split into hi
// and lo (tf32_from_acc; B packed permuted).
template <typename E>
struct Frags {
  uint32_t hi[4][4];
  uint32_t lo[sizeof(E) == 2 ? 1 : 4][4];
};

template <typename E>
__device__ __forceinline__ void frags_from_acc(Frags<E>& f, const float* c) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if constexpr (sizeof(E) == 2)
      bf16_from_acc(f.hi[s], c, s);
    else
      tf32_from_acc(f.hi[s], f.lo[s], c, s);
  }
  keep_u<16>(&f.hi[0][0]);
  if constexpr (sizeof(E) != 2) keep_u<16>(&f.lo[0][0]);
}

// d (+)= C B^T over the first `steps` (<= 4) k-steps: C the fragments f, B
// an N-row tile at b (b_lo). fp32: lo hi + hi lo + hi hi. The fragments
// are built before the caller's fence, so no register the products read
// is written between them; the caller fences before and commits and waits
// after.
template <typename E, int N>
__device__ __forceinline__ void chunk_rs(float* d, const Frags<E>& f,
                                         uint32_t b, uint32_t b_lo,
                                         int steps, int scale_d) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (s < steps) {
      const int sd = s == 0 ? scale_d : 1;
      const uint64_t bh = desc(b + s * kStepBytes);
      if constexpr (sizeof(E) == 2) {
        mma_rs<E, N>(d, f.hi[s], bh, sd);
      } else {
        const uint64_t bl = desc(b_lo + s * kStepBytes);
        mma_rs<E, N>(d, f.lo[s], bh, sd);
        mma_rs<E, N>(d, f.hi[s], bl, 1);
        mma_rs<E, N>(d, f.hi[s], bh, 1);
      }
    }
  }
}

// ---- mbarriers and bulk copies ---------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// After the barriers' init, before any thread or copy uses them
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One arrival that also expects `bytes` of copies to complete on `bar`
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the barrier's phase `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// bar_wait with a bound: a lost copy ends the kernel with an error instead
// of hanging the card
__device__ __forceinline__ void bar_wait_bounded(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
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

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Order this thread's generic-proxy accesses of shared memory before later
// async-proxy ones (a bulk copy overwriting what threads read)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace wg
