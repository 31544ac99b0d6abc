// Inline-PTX wrappers for Hopper (sm_90a): mbarriers, TMA tensor loads,
// and wgmma with bf16 operands and float32 accumulators (the prefill
// kernel); cp.async, ldmatrix and mma.sync m16n8k16 (the decode
// kernels).
//
// Shared-memory tiles read by wgmma here are 64 rows of 128 bytes in the
// 128-byte swizzle that TMA writes under CU_TENSOR_MAP_SWIZZLE_128B: the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8).  Eight rows make
// one 1024-byte swizzle atom, so every tile starts 1024-byte aligned.
#pragma once

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier --------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

// Makes initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void fence_barrier_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to the phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile("{\n"
                 ".reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n"
                 "}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    return done != 0;
}

// Waits until the phase of parity `parity` has completed.  A fresh
// barrier is in phase 0, so waiting on parity 1 returns at once.  A wait
// of seconds means a transaction was lost: trap, so the launch fails
// with an error instead of holding the card forever.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    if (mbar_try_wait(bar, parity)) return;
    const long long t0 = clock64();
    while (!mbar_try_wait(bar, parity))
        if (clock64() - t0 > (1ll << 33)) __trap();
}

// ---- TMA ----------------------------------------------------------------

// One box of a 4-d tensor map into shared memory; completes `bar`'s
// transaction count by the box's bytes (out-of-bounds elements are
// written as zeros and counted too).  Coordinates are innermost first.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// ---- wgmma --------------------------------------------------------------

// Shared-memory matrix descriptor for a tile in the 128-byte swizzle
// (layout type 1): start address, leading and stride byte offsets, each
// in 16-byte units.  K-major tiles: the stride byte offset is the
// 1024 bytes between 8-row groups; the leading one is unused.  MN-major
// tiles: the stride byte offset is the 1024 bytes between groups of 8
// k-rows, the leading one the distance between 64-element column blocks.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16)
         | (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator
// register across a wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define REPRO_WGMMA_D32                                                     \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "   \
    "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "    \
    "%28, %29, %30, %31}"
#define REPRO_WGMMA_OUT32(d)                                                \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),            \
    "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),            \
    "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),       \
    "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),       \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
    "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
    "+f"(d[30]), "+f"(d[31])

// D (64 x 64, f32) = A (64 x 16) * B (16 x 64) [+ D when accumulate]:
// A and B both K-major in shared memory.  Thread t of the warpgroup holds
// D rows 16 * (t / 32) + (t % 32) / 4 (+ 8), columns 8 * j + 2 * (t % 4)
// (+ 1) in d[4 * j + 2 * row_half + col_odd].
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t a, uint64_t b,
                                                   int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        REPRO_WGMMA_D32 ", %32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : REPRO_WGMMA_OUT32(d)
        : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64): B is
// MN-major in shared memory (its 64 columns contiguous), read through the
// instruction's transpose bit.  A's fragment is the D layout of a 64 x 16
// block: a[0] rows r, cols 2q..2q+1; a[1] rows r + 8; a[2] cols + 8;
// a[3] both (r = 16 * warp + lane / 4, q = lane % 4).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t b) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        REPRO_WGMMA_D32 ", {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
        : REPRO_WGMMA_OUT32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

#undef REPRO_WGMMA_OUT32
#undef REPRO_WGMMA_D32

// ---- cp.async -----------------------------------------------------------

// 16 bytes from global to shared memory, past L1.  With `src_bytes` 0
// nothing is read and the 16 bytes are written as zeros.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes from global to shared memory, through L1 (.cg copies only 16);
// with `src_bytes` 0 nothing is read and the 4 bytes are written as zeros.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---- ldmatrix and mma.sync m16n8k16 ---------------------------------------

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and r[i] holds its element (lane / 4, 2 (lane % 4) .. + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// The same, transposed: r[i] holds element (2 (lane % 4) .. + 1, lane / 4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
        "{%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// C (16 x 8, f32) += A (16 x 16, bf16, row-major) * B (16 x 8, bf16,
// column-major).  With g = lane / 4 and q = lane % 4: a[0] holds A row g,
// columns 2q..2q+1; a[1] row g + 8; a[2] columns + 8; a[3] both.  b0
// holds B rows 2q..2q+1 of column g, b1 rows + 8.  c[0..1] hold C row g,
// columns 2q..2q+1, c[2..3] row g + 8.
__device__ __forceinline__ void mma_m16n8k16_bf16(float (&c)[4],
                                                  const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace hopper
