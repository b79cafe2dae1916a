// Hopper (sm_90a) building blocks shared by the package's tensor-core
// kernels: shared-memory addresses, mbarriers, proxy fences, cp.async,
// warpgroup matrix multiplies (wgmma) with their shared-memory
// descriptors, the tf32 rounding of the 3xTF32 split, and the 16-byte
// moves and bf16 packing their producers and epilogues use.
//
// Operand layout. Every wgmma operand read from shared memory here is
// K-major (the reduction axis contiguous) in the unswizzled canonical
// layout: the tile is cut into core matrices of 8 rows x 16 bytes, each
// stored as 128 contiguous bytes (row r of the core matrix at 16 r), the
// core matrices along K 128 bytes apart (LBO) and the groups of 8 rows
// `sbo` bytes apart (SBO). So element (r, k) of a tile with 16-byte chunks
// of `E` elements lies at byte
//     (r / 8) * sbo + (k / E) * 128 + (r % 8) * 16 + (k % E) * sizeof(elem)
// (kmajor_offset). One wgmma k-step reads 32 bytes of K, two chunks, so
// the descriptor of k-step kk is the tile's plus kk * 256 bytes
// (desc + 16 * kk: the address field counts 16-byte units).
//
// Register fragments (one warpgroup = 4 warps; warp w owns rows
// 16w..16w+15; g = lane / 4, t = lane % 4):
//   * f32 accumulator of m64nN: d[4j + 2h + e] is (row g + 8h, column
//     8j + 2t + e);
//   * tf32 A of m64nNk8: a[0] (g, t), a[1] (g+8, t), a[2] (g, t+4),
//     a[3] (g+8, t+4);
//   * bf16 A of m64nNk16: a[0] (g, 2t..2t+1), a[1] (g+8, 2t..2t+1),
//     a[2] (g, 2t+8..2t+9), a[3] (g+8, 2t+8..2t+9), the lower column in the
//     lower half.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int kmajor_offset(int row, int chunk, int sbo) {
  return (row >> 3) * sbo + chunk * 128 + (row & 7) * 16;
}

// --- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// make this thread's generic-proxy shared-memory writes visible to the
// async proxy (wgmma's operand reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --- tf32 -------------------------------------------------------------------

// round to nearest, ties away from zero, to tf32 (what cvt.rna.tf32.f32
// does to a finite value) in two integer operations: add half of the 13
// dropped bits to the magnitude, then clear them. The tensor core reads
// only the top 19 bits of a register, so an unrounded operand would be
// truncated.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// the 3xTF32 split: x = hi + lo + O(2^-22 |x|)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// --- cp.async ----------------------------------------------------------------

// 16 bytes from device memory to shared memory, asynchronously; zeros where
// !valid (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but this thread's N most recent commit groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// --- 16-byte moves, the tf32 split of four values, bf16 packing ------------

__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void store16(char* p, uint4 x) {
  *reinterpret_cast<uint4*>(p) = x;
}

// the hi and lo parts of four f32 values
__device__ __forceinline__ void split4(uint4 x, uint4& hi, uint4& lo) {
  split_tf32(__uint_as_float(x.x), hi.x, lo.x);
  split_tf32(__uint_as_float(x.y), hi.y, lo.y);
  split_tf32(__uint_as_float(x.z), hi.z, lo.z);
  split_tf32(__uint_as_float(x.w), hi.w, lo.w);
}

__device__ __forceinline__ uint32_t pick(uint4 x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 x = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// --- wgmma ------------------------------------------------------------------

// descriptor of a K-major unswizzled tile at shared address `addr`
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accesses of a register array across the
// asynchronous wgmma (its issue and its wait)
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define SM90_D8(i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),     \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define SM90_D16 SM90_D8(0), SM90_D8(8)
#define SM90_D24 SM90_D16, SM90_D8(16)
#define SM90_D32 SM90_D24, SM90_D8(24)
#define SM90_D64 SM90_D32, SM90_D8(32), SM90_D8(40), SM90_D8(48), SM90_D8(56)
#define SM90_R16                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define SM90_R24                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "   \
  "%17, %18, %19, %20, %21, %22, %23}"
#define SM90_R32                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "   \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define SM90_R64                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "   \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 64, f32) (+)= A (64 x k, shared) . B (64 x k, shared)^T; scale_d = 0
// ignores d's old value
__device__ __forceinline__ void wgmma_ss_tf32_n64(float* d, uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " SM90_R32
      ", %32, %33, p, 1, 1;\n}\n"
      : SM90_D32
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_bf16_n64(float* d, uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_D32
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 32, f32) (+)= A (64 x k, shared) . B (32 x k, shared)^T
__device__ __forceinline__ void wgmma_ss_tf32_n32(float* d, uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " SM90_R16
      ", %16, %17, p, 1, 1;\n}\n"
      : SM90_D16
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_bf16_n32(float* d, uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " SM90_R16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : SM90_D16
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N, f32) (+)= A (64 x k, registers) . B (N x k, shared)^T
__device__ __forceinline__ void wgmma_rs_tf32_n128(float* d, const uint32_t* a, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " SM90_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : SM90_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_tf32_n64(float* d, const uint32_t* a, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " SM90_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : SM90_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_tf32_n48(float* d, const uint32_t* a, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 " SM90_R24
      ", {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : SM90_D24
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_bf16_n64(float* d, const uint32_t* a, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : SM90_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_bf16_n48(float* d, const uint32_t* a, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 " SM90_R24
      ", {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : SM90_D24
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef SM90_D8
#undef SM90_D16
#undef SM90_D24
#undef SM90_D32
#undef SM90_D64
#undef SM90_R16
#undef SM90_R24
#undef SM90_R32
#undef SM90_R64

}  // namespace sm90
