// Hopper (sm_90a) building blocks shared by the bf16 attention kernels:
// mbarriers, TMA tile loads, wgmma descriptors and instructions, and
// register rebalancing, all as raw PTX in inline asm (no CuTe or
// CUTLASS templates: this header builds in seconds).
//
// Shared-memory tiles.  A [rows, head_dim] bf16 tile arrives through
// TMA with the 128-byte swizzle, whose box may be at most 128 bytes
// (64 bf16) wide, so a tile is stored as head_dim / 64 column halves,
// each [rows][64] with 128-byte rows: 16-byte chunk c of row r sits at
// chunk c ^ (r % 8).  Each half starts on a 1024-byte boundary (the
// swizzle repeats every 8 rows of 128 bytes), so every descriptor below
// keeps the base-offset field 0: a k16 step moves the start address by
// 32 bytes inside a 128-byte row (address bits 5-6 only) or by whole
// 1024-byte atoms, never across the bits the swizzle reads (7-9).
//
// - K-major operand (the reduction dimension is the tile's columns, as
//   Q and K in Q K^T): SBO = 1024 bytes (8 rows), LBO unused (16).  The
//   k16 step kk of head_dim reads half kk / 4 at byte 32 * (kk % 4).
// - MN-major operand (the reduction dimension is the tile's rows, as V
//   in P V): the wgmma's transpose-B bit, SBO = 1024 bytes (the next 8
//   rows along K), LBO = the byte distance between column halves (the
//   next 64 columns along N).  The k16 step kk reads rows 16 kk..: byte
//   2048 * kk.
//
// Register fragments (per warpgroup of 128 threads, warp w = tid / 32,
// lane l = tid % 32, r0 = 16 w + l / 4, c0 = 2 (l % 4)):
// - the f32 accumulator of m64nNk16: d[4 i + 2 j + e] is element
//   (r0 + 8 j, 8 i + c0 + e), i < N / 8, j, e in {0, 1};
// - the bf16 A operand of m64nNk16 (4 x b32): a[0] = (r0, c0 + {0,1}),
//   a[1] = (r0 + 8, c0 + {0,1}), a[2] = (r0, 8 + c0 + {0,1}), a[3] =
//   (r0 + 8, 8 + c0 + {0,1}).
// So the accumulator's columns 16 kk .. 16 kk + 15, rounded to bf16 in
// pairs (d[8 kk + 2 m], d[8 kk + 2 m + 1]) -> a[m], are exactly the A
// fragment of k16 step kk of the next product: P = softmax(Q K^T)
// feeds P V without a trip through shared memory (pack_a below).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

// ---- shared-memory addresses and mbarriers ------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// one arrival that also tells the barrier to expect `bytes` of TMA data
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the barrier's phase of parity `parity` has completed.  The
// wait is bounded: a phase bit out of step would otherwise hang the
// block, so after 4 s the kernel traps and the launch fails with an
// error the caller sees.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  if (mbar_try_wait(a, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(a, parity)) {
    if (global_ns() - t0 > 4000000000ull) __trap();
  }
}

// ---- TMA ------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// The box of a 3-D tensor map at element coordinates (c0, c1, c2) into
// shared memory at dst; the barrier's transaction count falls by the
// box's bytes when it lands (out-of-bounds elements read as zero).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned; the barrier's transaction count falls by them when they land.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 2^x on the special-function unit, subnormal results flushed to 0 (a
// probability below 2^-126 adds nothing an f32 sum keeps); exp2(-inf) = 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle, base offset 0.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (smem_addr(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tie the accumulator registers to this point of the program, so the
// compiler neither reads them before the wgmma_wait that completes them
// nor moves their updates across an issue.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for A fragments, so they are packed before the wgmma_fence
// that precedes their products.
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// Two f32 values rounded to bf16 and packed as one b32 (lo in bits 0-15).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k16 step kk from accumulator columns 16 kk .. + 15.
template <int R>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&d)[R],
                                       int kk) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
    a[m] = pack_bf16(d[8 * kk + 2 * m], d[8 * kk + 2 * m + 1]);
}

// D[64 x 32] += A[64 x 16] * B[16 x 32], A and B from shared memory,
// both K-major (descriptors a, b).
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], as above.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
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
      : "l"(a), "l"(b), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], as above.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
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
      : "l"(a), "l"(b), "r"(1));
}

// D[64 x 32] = A[64 x 16] * B[16 x 32]: the first k16 step of a
// product.  D's old value is not read, so its registers need not stay
// alive up to here.
__device__ __forceinline__ void wgmma_ss_zero(float (&d)[16], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
      : "l"(a), "l"(b), "r"(0));
}

// D[64 x 64] = A[64 x 16] * B[16 x 64], as above.
__device__ __forceinline__ void wgmma_ss_zero(float (&d)[32], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(a), "l"(b), "r"(0));
}

// D[64 x 128] = A[64 x 16] * B[16 x 128], as above.
__device__ __forceinline__ void wgmma_ss_zero(float (&d)[64], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(a), "l"(b), "r"(0));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (the m64k16
// fragment above), B from shared memory MN-major (descriptor b, the
// transpose-B bit set).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], as above.
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- warp specialisation --------------------------------------------------

// Registers a thread of this warpgroup may hold from here on; every warp
// of the warpgroup executes it.  The producer gives registers up, the
// consumers take them.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- host: tensor maps -----------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime's entry
// point query (no link against libcuda).  Null when the driver has none.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 3-D map {head_dim, seq, bh} over a contiguous [bh, seq, head_dim]
// bf16 tensor, box {64, box_rows, 1}, 128-byte swizzle.  Rows past seq
// read as zero, so a ragged last tile never reaches the next head.
// Returns cudaErrorInvalidValue when the driver refuses the map.
inline cudaError_t make_map(CUtensorMap* map, const void* base, int bh,
                            int seq, int head_dim, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(head_dim),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(head_dim) * 2,
      static_cast<cuuint64_t>(seq) * head_dim * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                      const_cast<void*>(base), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
