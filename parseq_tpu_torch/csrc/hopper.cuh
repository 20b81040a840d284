// Device helpers for Hopper (sm_90a) shared by the port's kernels
// (csrc/ar_decode.cu: B1; csrc/attention.cu: B2 and B3; csrc/flash_bwd.cu:
// B4; csrc/encoder_blocks.cu: B5): cp.async staging, the 128-byte swizzle,
// ldmatrix and mma.sync (m16n8k16, bf16 -> f32), wgmma shared-memory
// descriptors and products, proxy fences, named barriers, bf16 packing and
// quad reductions over the rows of an mma / wgmma accumulator.
//
// Shared-memory operands are kept as wgmma core matrices without swizzle
// (B5's products use the 128-byte swizzle instead: wgmma_desc_sw128):
// 8 rows x 16 bytes (128 contiguous bytes) each. A matrix of R rows and
// 8 * NC bf16 columns puts element (r, c) at
//   (r / 8) * (NC * 64) + (c / 8) * 64 + (r % 8) * 8 + c % 8   (elements),
// so one core matrix is 128 bytes further along the columns and NC * 128
// bytes further along the rows (core_at). A descriptor takes the stride
// along the product's K dimension as LBO and along M or N as SBO, whether
// the operand is K-major or, with the transpose bit, MN-major.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ constexpr int core_at(int r, int c, int nc) {
  return (r >> 3) * (nc * 64) + (c >> 3) * 64 + (r & 7) * 8 + (c & 7);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy through L2 only; fills zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of wgmma, no swizzle: start address, LBO
// (stride between core matrices along K) and SBO (along M or N), in bytes.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// Descriptor of a K-major operand in the 128-byte swizzle: rows of 64 bf16
// (128 bytes) back to back, 16-byte chunk c of row r at chunk c ^ (r % 8),
// 8-row atoms of 1024 bytes (aligned to 1024) sbo bytes apart. The k-step
// of 16 elements at k0 starts 2 * k0 bytes into the row (sw128_at).
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3ffff) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

// Element offset of (r, 8 c) in the 128-byte swizzle above.
__host__ __device__ constexpr int sw128_at(int r, int c) {
  return r * 64 + ((c ^ (r & 7)) << 3);
}

// Four 8x8 b16 matrices from shared memory: lanes 8i .. 8i + 7 give the
// row addresses of matrix i (16-byte aligned), r[i] gets its fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row-major fragment) * b (16x8, column-major fragment).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Named barriers: `id` (1 .. 15) over `n` threads of the block.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Shared-memory writes of this thread (cp.async's or plain stores) made
// visible to the async proxy that wgmma reads through; a block barrier
// follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (m64n64, 32 f32 a thread) += A (64 x 16) * B (16 x 64), both bf16 in
// shared memory; TA / TB: A / B MN-major (transposed) instead of K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (m64n128, 64 f32 a thread) = A (64 x 16) * B (16 x 128) (+ d when
// kAccumulate), both operands K-major in shared memory. Without kAccumulate
// d is write-only, so the registers are free for other work before the
// first product.
#define HOPPER_D64(F) \
  F(d[0]), F(d[1]), F(d[2]), F(d[3]), F(d[4]), F(d[5]), F(d[6]), F(d[7]), F(d[8]), F(d[9]), \
  F(d[10]), F(d[11]), F(d[12]), F(d[13]), F(d[14]), F(d[15]), F(d[16]), F(d[17]), F(d[18]), \
  F(d[19]), F(d[20]), F(d[21]), F(d[22]), F(d[23]), F(d[24]), F(d[25]), F(d[26]), F(d[27]), \
  F(d[28]), F(d[29]), F(d[30]), F(d[31]), F(d[32]), F(d[33]), F(d[34]), F(d[35]), F(d[36]), \
  F(d[37]), F(d[38]), F(d[39]), F(d[40]), F(d[41]), F(d[42]), F(d[43]), F(d[44]), F(d[45]), \
  F(d[46]), F(d[47]), F(d[48]), F(d[49]), F(d[50]), F(d[51]), F(d[52]), F(d[53]), F(d[54]), \
  F(d[55]), F(d[56]), F(d[57]), F(d[58]), F(d[59]), F(d[60]), F(d[61]), F(d[62]), F(d[63])
#define HOPPER_RW(x) "+f"(x)
#define HOPPER_WO(x) "=f"(x)
#define HOPPER_M64N128K16                                                       \
  "{\n"                                                                          \
  ".reg .pred p;\n"                                                              \
  "setp.ne.b32 p, %66, 0;\n"                                                     \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
  "%61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"                                   \
  "}\n"
template <bool kAccumulate>
__device__ __forceinline__ void wgmma_ss128(float* d, uint64_t da, uint64_t db) {
  if constexpr (kAccumulate) {
    asm volatile(HOPPER_M64N128K16
                 : HOPPER_D64(HOPPER_RW)
                 : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(HOPPER_M64N128K16
                 : HOPPER_D64(HOPPER_WO)
                 : "l"(da), "l"(db), "r"(0));
  }
}
#undef HOPPER_M64N128K16
#undef HOPPER_WO
#undef HOPPER_RW
#undef HOPPER_D64

// d (m64n32, 16 f32 a thread) += A (64 x 16) * B (16 x 32), as wgmma_ss64.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss32(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// N = 64 or 32 columns.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db) {
  static_assert(N == 64 || N == 32, "wgmma_ss: N is 64 or 32");
  if constexpr (N == 64) {
    wgmma_ss64<TA, TB>(d, da, db);
  } else {
    wgmma_ss32<TA, TB>(d, da, db);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Max and sum over the 4 lanes of a quad (the 4 threads that hold one row
// of an mma / wgmma accumulator).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace
