// Hopper building blocks of the flash-attention kernels: asynchronous global
// -> shared copies (cp.async, and TMA tracked by mbarriers), warpgroup
// products (wgmma), named barriers, and the lane arithmetic on the products'
// register fragments.
//
// A warpgroup (4 consecutive warps, 128 threads) issues one asynchronous
// product of a 64-row tile: B, and A where it is not in registers, are read
// from shared memory through 64-bit matrix descriptors; the fp32 sum stays in
// registers. With lane = 4 * gid + tig, warp w of the group holds rows
// 16w..16w+15 (PTX ISA, "Register Fragments and Shared Memory Matrix
// Layouts" of wgmma):
//
//   accumulator, per 8 columns i: d[i][0..1] = (row gid, columns 8i + 2tig..),
//                                 d[i][2..3] = (row gid + 8, the same columns)
//   A in registers, per k16 block: a0 = (gid, 2tig..), a1 = (gid + 8, 2tig..),
//                                  a2 = (gid, 8 + 2tig..), a3 = (gid + 8, 8 + 2tig..)
//
// So the accumulators of two neighbouring 8-column blocks, rounded to bf16
// in pairs, are the A operand of a product over those 16 columns: the
// softmax weights never leave the registers between the two products of
// attention, and a row's max and sum need only the 4 lanes of a quad.
//
// Shared-memory tiles read by wgmma use the 128-byte swizzle: a [rows][D]
// bf16 tile is stored as D/64 slabs of [rows][64] (128 bytes a row), and the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8). Slabs start on
// 1024-byte boundaries (one swizzle atom of 8 rows), so the hardware's XOR of
// address bits [4:6] with [7:9] finds the chunks where the copies put them.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace metis {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared that completes asynchronously; with
// valid == false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4-byte asynchronous copy (per-row fp32 statistics), zero-filled when invalid.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// threadIdx.x / 128 as lane 0 sees it: the compiler then knows that the value
// is the same across the warp, and a branch on it is a uniform one.
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
}

// Two floats rounded to bf16 in one register, lo in the low half (the lower
// column of a fragment pair).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit; 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Max and sum over the four lanes (one quad) that share a fragment row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

constexpr int SW128_ROW = 128;    // bytes per row of a swizzled slab
constexpr int SW128_ATOM = 1024;  // 8 rows: the stride between 8-row groups

// Byte offset of the 16-byte chunk `chunk` (0 .. D/8 - 1) of row r in a
// swizzled [rows][D] tile.
__device__ __forceinline__ int sw128_offset(int rows, int r, int chunk) {
  return (chunk / 8) * rows * SW128_ROW + r * SW128_ROW + (((chunk % 8) ^ (r % 8)) * 16);
}

// Matrix descriptor: start address, leading and stride byte offsets (16-byte
// units, 14 bits each) and the 128-byte swizzle mode (layout type 1, bits 62-63).
__device__ __forceinline__ uint64_t sw128_desc(const void* start, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return (uint64_t)((smem_u32(start) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo_bytes & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo_bytes & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// K-major operand (k contiguous along a row): 8-row groups SW128_ATOM apart;
// the leading offset is not used. `start` points at the row and the 32-byte
// k16 column block where the product begins.
__device__ __forceinline__ uint64_t desc_k_major(const void* start) {
  return sw128_desc(start, 16, SW128_ATOM);
}

// MN-major operand (n contiguous along a row, one row per k): 8-k-row groups
// SW128_ATOM apart, 64-column slabs `slab_bytes` apart.
__device__ __forceinline__ uint64_t desc_mn_major(const void* start, uint32_t slab_bytes) {
  return sw128_desc(start, slab_bytes, SW128_ATOM);
}

// Order this thread's earlier register writes (accumulators, A fragments)
// before the next wgmma.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Register dependency on every accumulator element: placed after a wait, it
// keeps the compiler from reading the accumulators before the wait (the
// asm of a wgmma tells it the results are ready when the product is issued).
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
  }
}

// Make this thread's cp.async writes to shared memory visible to wgmma's
// (asynchronous proxy) reads; a barrier then extends that to the CTA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[8][4] = A . B (+ d when scale_d != 0), m64n64k16: A and B from shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[8][4], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[16][4] = A . B (+ d when scale_d != 0), m64n128k16: A and B from shared
// memory, both K-major.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[16][4], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[8][4] += A . B, m64n64k16: A from registers (per warp, 16 rows in the
// mma.sync A layout), B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[8][4], const uint32_t a[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[16][4] += A . B, m64n128k16: A from registers (per warp, 16 rows in the
// mma.sync A layout), B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[16][4], const uint32_t a[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The two products above by their width N (64 or 128 columns, N / 8
// fragment tiles), for kernels whose head dim picks the shape.
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 8][4], const uint32_t a[4],
                                            uint64_t desc_b) {
  static_assert(N == 64 || N == 128, "wgmma width 64 or 128");
  if constexpr (N == 64) {
    wgmma_m64n64k16_rs_tb(d, a, desc_b);
  } else {
    wgmma_m64n128k16_rs_tb(d, a, desc_b);
  }
}

// mbarrier in shared memory: `count` arrivals complete a phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make barrier initialisation visible to the asynchronous proxy (TMA).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive and expect `bytes` more of asynchronous (TMA) writes in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed. A bounded spin: a
// protocol fault traps (the launch fails) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spin = 0; spin < (1u << 28); ++spin) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

// TMA: copy one box of a 3-d tensor map, at coordinates (c0 innermost, c1,
// c2), into shared memory; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* tmap, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(tmap), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Named barriers (0 is __syncthreads): sync waits until `count` threads,
// this warp's included, have arrived at barrier `id`; arrive does not wait.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

}  // namespace metis
