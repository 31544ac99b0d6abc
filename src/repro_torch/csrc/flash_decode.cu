// Split-KV flash decode for Hopper (sm_90a): the split partials and
// their log-sum-exp combine in one launch.
//
// Replaces: src/repro/kernels/flash_decode.py::_decode_kernel, launched
// by flash_decode_partials (pallas_call at flash_decode.py:135), and
// src/repro/kernels/flash_combine.py::_combine_kernel (pallas_call at
// flash_combine.py:61), which the reference runs after it on every
// decode call.
//
// What bounds it: bytes, and at decode's sizes latency.  A decode step
// reads every resident K and V row of the cache once (2 * L * Hkv * D * 2
// bytes in bf16) and does 4 * G * D flops per row, about 4 flops per byte
// at G = 8: far below the ~295 flops per byte where an H100 stops being
// memory-bound.  At the paper's low-head-count shapes B * Hkv CTAs cannot
// keep 132 SMs streaming, which is what the split count S is for, and a
// CTA's time is a few DRAM round trips plus the launch.
//
// Design:
//  - One CTA per (split s, kv head h, batch b), so the grid is exactly
//    B * Hkv * S CTAs: the plan's num_splits is the paper's variable and
//    is launched as given.  Split s covers the 128-row KV blocks
//    [s * NB, min((s + 1) * NB, nblk)), NB = ceil(nblk / S), as FA3 does.
//  - The cache is read through a strided view (batch and row strides are
//    arguments), so the caller passes k[:, :bucket] of the (B, max_len,
//    Hkv, D) cache without a copy.  kv_len is clamped to the view length;
//    rows at or past it are never read from global memory.
//  - bf16 q over a bf16 cache runs on the tensor cores; at G <= 16 and
//    D = 64 or 128 in decode_tc_kernel:
//      * Each of the 4 warps owns 16 keys of every 64-row tile and loads
//        them itself, by 16-byte cp.async copies straight into bf16 shared
//        memory (no widening, no register staging), K and V in separate
//        commit groups, through a ring of two tiles: a whole 128-row
//        block in flight (deeper rings timed no faster on the card).  A
//        warp waits only for its own copies, so the ring needs no
//        block-wide barrier.
//        Rows at or past kv_len are zero-filled (source size 0): a NaN or
//        Inf tail never reaches the math.  Rows are padded to D + 8
//        elements, so ldmatrix reads 8 rows from 8 distinct bank groups.
//      * mma.sync m16n8k16, bf16 operands, f32 accumulators, FA2's
//        register layout.  M is the G query heads padded to 16 (rows G and
//        up are zero); Q's A fragments are loaded once and stay in
//        registers.  S = Q K^T takes K's B fragments from ldmatrix; the
//        probabilities, as two bf16 terms each (hi = bf16(p), lo = bf16(p
//        - hi)), are P V's A fragments, one mma each, and never touch
//        shared memory; V's B fragments come from ldmatrix.trans.
//        l sums the f32 p, as the reference does.
//      * Each warp keeps its own running (m, l, O); the four merge once at
//        the end, through shared memory, in warp order.
//      * Not wgmma: its M is 64 per warpgroup, so at G = 8 seven eighths
//        of each product would be padding, and decode is not bound by the
//        math.  Not TMA: a tensor map is encoded on the host per launch,
//        and a decode step launches this kernel once per layer.
//  - Other G and D (G > 16 query heads per KV head, as the paper's Table 1
//    has at H_KV 1 and 2; D = 160 or 256) run decode_tc_wide_kernel: the
//    G rows in passes of up to 64, each warp one 16-row group over a
//    slice of every tile's keys, the tile shared by the block (below).
//  - Any f32 operand (an f32 model over its cache, the CPU-parity dtypes)
//    keeps the CUDA-core body (decode_cc_kernel): K and V staged as f32 in
//    shared memory, 64 rows per step, register-blocked scores, the G rows
//    in passes of 16.
//  - Epilogue, both bodies (csrc/decode_epilogue.cuh, shared with the
//    quantized cache's kernel): with S = 1 the CTA writes the output;
//    with S > 1 it writes its partial and the CTA of (b, h) that arrives
//    last merges the S partials in split order with flash_combine.cu's
//    arithmetic and resets its arrival counter.  Without a counter the
//    kernel writes the partials only (flash_decode_partials).
#include <type_traits>

#include "common.cuh"
#include "decode_epilogue.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

template <int D>
struct TcShape {
    static constexpr int kPitch = D + 8;            // bf16 per staged row
    static constexpr int kTileElems = kTile * kPitch;
    static constexpr int kStageElems = 2 * kTileElems;       // K, then V
    static constexpr size_t kRing = sizeof(__nv_bfloat16) * kStages *
                                    kStageElems;
    static constexpr size_t kMerge = WarpMerge<D>::kBytes;
    static constexpr size_t kSmem = kRing > kMerge ? kRing : kMerge;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_tc_kernel(const __nv_bfloat16* __restrict__ q,  // (B, Hkv, G, D)
                 const __nv_bfloat16* __restrict__ k,  // strided (B,L,Hkv,D)
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ kv_len,       // (B,)
                 Epilogue ep, int B, int Hkv, int G, int L, int S,
                 long long stride_b, long long stride_l) {
    using Sh = TcShape<D>;
    constexpr int kChunks = D / 8;                  // 16-byte chunks per row
    constexpr int kPerLane = kWarpRows * kChunks / 32;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);

    const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gq = lane / 4, tq = lane % 4;         // fragment row, column
    const int wrow = warp * kWarpRows;              // this warp's first key
    const Rows rows = split_rows(L, S, s, kv_len[b]);
    const int ntiles = rows.hi > rows.lo
                           ? (rows.hi - rows.lo + kTile - 1) / kTile : 0;
    const long long bh = static_cast<long long>(b) * Hkv + h;

    // this warp's 16 rows of tile t into `dst`, zero past rows.hi; one
    // commit group per call, empty past the last tile
    const __nv_bfloat16* kb = k + b * stride_b + h * D;
    const __nv_bfloat16* vb = v + b * stride_b + h * D;
    auto load = [&](const __nv_bfloat16* src, int t, __nv_bfloat16* dst) {
        if (t < ntiles) {
            const int r0 = rows.lo + t * kTile + wrow;
#pragma unroll
            for (int i = 0; i < kPerLane; ++i) {
                const int c = lane + i * 32;
                const int r = c / kChunks, col = (c % kChunks) * 8;
                const bool ok = r0 + r < rows.hi;
                hopper::cp_async_16(
                    hopper::smem_u32(dst + (wrow + r) * Sh::kPitch + col),
                    ok ? src + (r0 + r) * stride_l + col : src, ok ? 16 : 0);
            }
        }
        hopper::cp_async_commit();
    };
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
        __nv_bfloat16* slot = ring + st * Sh::kStageElems;
        load(kb, st, slot);
        load(vb, st, slot + Sh::kTileElems);
    }

    // Q's A fragments: rows gq and gq + 8, zero at or past G
    const __nv_bfloat16* qb = q + bh * G * D;
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int g = gq + (i & 1) * 8;
            const int c = kk * 16 + tq * 2 + (i >> 1) * 8;
            qa[kk][i] = g < G ? *reinterpret_cast<const uint32_t*>(
                                    qb + g * D + c)
                              : 0u;
        }
    }

    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
        o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float m_r[2] = {REPRO_NEG_INF, REPRO_NEG_INF};   // rows gq, gq + 8
    float l_r[2] = {0.f, 0.f};                       // this lane's columns

    // ldmatrix row addresses: K as S's B operand (keys x D), V through
    // the transpose as P V's (keys x D)
    const int k_row = wrow + (lane & 7) + (lane >> 4) * 8;
    const int k_col = ((lane >> 3) & 1) * 8;
    const int v_row = wrow + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int v_col = (lane >> 4) * 8;

    for (int t = 0; t < ntiles; ++t) {
        __nv_bfloat16* ks = ring + (t % kStages) * Sh::kStageElems;
        __nv_bfloat16* vs = ks + Sh::kTileElems;
        hopper::cp_async_wait<2 * kStages - 1>();   // K of tile t
        __syncwarp();

        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t kf[4];
            hopper::ldmatrix_x4(
                kf, hopper::smem_u32(ks + k_row * Sh::kPitch + kk * 16 +
                                     k_col));
            hopper::mma_m16n8k16_bf16(sc[0], qa[kk], kf[0], kf[1]);
            hopper::mma_m16n8k16_bf16(sc[1], qa[kk], kf[2], kf[3]);
        }

        // online softmax over this warp's 16 keys: sc[n][e] is row
        // gq + 8 (e / 2), key 8 n + 2 tq + e % 2
        const int key0 = rows.lo + t * kTile + wrow + tq * 2;
        float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                if (key0 + n * 8 + (e & 1) >= rows.hi)
                    sc[n][e] = REPRO_NEG_INF;
                mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
            }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            alpha[i] = expf(m_r[i] - mx[i]);
            m_r[i] = mx[i];
            l_r[i] *= alpha[i];
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = key0 + n * 8 + (e & 1) < rows.hi
                                    ? expf(sc[n][e] - m_r[e >> 1]) : 0.f;
                sc[n][e] = p;
                l_r[e >> 1] += p;
            }
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
            o[j][0] *= alpha[0];
            o[j][1] *= alpha[0];
            o[j][2] *= alpha[1];
            o[j][3] *= alpha[1];
        }
        uint32_t pa[4], pl[4];        // P's hi and lo terms
        split_bf16(sc[0][0], sc[0][1], pa[0], pl[0]);
        split_bf16(sc[0][2], sc[0][3], pa[1], pl[1]);
        split_bf16(sc[1][0], sc[1][1], pa[2], pl[2]);
        split_bf16(sc[1][2], sc[1][3], pa[3], pl[3]);

        hopper::cp_async_wait<2 * kStages - 2>();   // V of tile t
        __syncwarp();
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t vf[4];
            hopper::ldmatrix_x4_trans(
                vf, hopper::smem_u32(vs + v_row * Sh::kPitch + dp * 16 +
                                     v_col));
            hopper::mma_m16n8k16_bf16(o[2 * dp], pa, vf[0], vf[1]);
            hopper::mma_m16n8k16_bf16(o[2 * dp], pl, vf[0], vf[1]);
            hopper::mma_m16n8k16_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
            hopper::mma_m16n8k16_bf16(o[2 * dp + 1], pl, vf[2], vf[3]);
        }
        __syncwarp();                 // every lane is done with the slot
        load(kb, t + kStages, ks);
        load(vb, t + kStages, vs);
    }
    hopper::cp_async_wait<0>();

    finish_tc<D>(o, m_r, l_r, smem_raw, ep, B, Hkv, G, S, s, bh);
}

// The tensor-core body for the shapes decode_tc_kernel does not take: more
// than 16 query heads per KV head, or D = 160 / 256.  The G rows go in
// passes of up to kPassRows (64): R = 1, 2 or 4 groups of 16 rows
// (padded), and warp w owns row group w % R over key slice w / R of every
// 64-row tile (16 R keys, in steps of 16).  So at G = 64 each warp holds
// its own 16 rows over all keys, and at G <= 16 the four warps split the
// keys, as decode_tc_kernel's do.  All 128 threads load each tile (K and
// V in one commit group) through a ring of two tiles, and a block-wide
// barrier hands it over.  Each 16-key step is decode_tc_kernel's: Q K^T
// on mma.sync, the online softmax, P as two bf16 terms times V.  At
// D = 256 a 16-row O alone is 128 registers a thread, so Q is staged in
// shared memory and read by ldmatrix instead of held in registers.  A G
// above 64 reads the split's K and V once per pass.
template <int D>
struct WideShape {
    static constexpr int kPitch = D + 8;            // bf16 per staged row
    static constexpr int kTileElems = kTile * kPitch;
    static constexpr int kStageElems = 2 * kTileElems;       // K, then V
    static constexpr size_t kRing = sizeof(__nv_bfloat16) * kStages *
                                    kStageElems;
    static constexpr bool kQRegs = D <= 160;        // else Q in smem
    static constexpr size_t kQ =
        kQRegs ? 0 : sizeof(__nv_bfloat16) * kPassRows * kPitch;
    static constexpr size_t kMerge = WarpMerge<D>::kBytes;
    static constexpr size_t kSmem =
        kRing + kQ > kMerge ? kRing + kQ : kMerge;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_tc_wide_kernel(const __nv_bfloat16* __restrict__ q,  // (B,Hkv,G,D)
                      const __nv_bfloat16* __restrict__ k,  // strided
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ kv_len,       // (B,)
                      Epilogue ep, int B, int Hkv, int G, int L, int S,
                      long long stride_b, long long stride_l) {
    using Sh = WideShape<D>;
    constexpr int kChunks = D / 8;                  // 16-byte chunks per row
    constexpr int kPerThread = kTile * kChunks / kThreads;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* q_s =
        reinterpret_cast<__nv_bfloat16*>(smem_raw + Sh::kRing);

    const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int gq = lane / 4, tq = lane % 4;         // fragment row, column
    const Rows rows = split_rows(L, S, s, kv_len[b]);
    const int ntiles = rows.hi > rows.lo
                           ? (rows.hi - rows.lo + kTile - 1) / kTile : 0;
    const long long bh = static_cast<long long>(b) * Hkv + h;

    // tile t's K and V into ring slot `slot`, zero past rows.hi; one
    // commit group per call, empty past the last tile
    const __nv_bfloat16* kb = k + b * stride_b + h * D;
    const __nv_bfloat16* vb = v + b * stride_b + h * D;
    auto load = [&](int t, __nv_bfloat16* slot) {
        if (t < ntiles) {
            const int r0 = rows.lo + t * kTile;
            // rolled: unrolled, the copies' addresses stay live in
            // registers across the tile loop beside the 16-row O
#pragma unroll 1
            for (int i = 0; i < 2 * kPerThread; ++i) {
                const int c = tid + (i % kPerThread) * kThreads;
                const int r = c / kChunks, col = (c % kChunks) * 8;
                const bool ok = r0 + r < rows.hi;
                const __nv_bfloat16* src = i < kPerThread ? kb : vb;
                hopper::cp_async_16(
                    hopper::smem_u32(slot + (i < kPerThread ? 0
                                                 : Sh::kTileElems) +
                                     r * Sh::kPitch + col),
                    ok ? src + (r0 + r) * stride_l + col : src, ok ? 16 : 0);
            }
        }
        hopper::cp_async_commit();
    };

    // ldmatrix row addresses within a 16-key step: K as S's B operand,
    // V through the transpose as P V's, Q as S's A operand
    const int k_row = (lane & 7) + (lane >> 4) * 8;
    const int k_col = ((lane >> 3) & 1) * 8;
    const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int v_col = (lane >> 4) * 8;
    const __nv_bfloat16* qb = q + bh * G * D;

#pragma unroll 1
    for (int g0 = 0; g0 < G; g0 += kPassRows) {
        const int gp = min(kPassRows, G - g0);
        const int R = gp <= 16 ? 1 : gp <= 32 ? 2 : 4;   // row groups
        const int rg = warp % R, slice = warp / R;
        if (g0 > 0) __syncthreads();    // the last pass's merge is read
#pragma unroll
        for (int st = 0; st < kStages; ++st)
            load(st, ring + st * Sh::kStageElems);

        // Q: rows g0 + 16 rg + gq (+ 8) in registers, or the pass's rows
        // in shared memory; zero at or past G
        uint32_t qa[Sh::kQRegs ? D / 16 : 1][4];
        if constexpr (Sh::kQRegs) {
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int g = g0 + rg * 16 + gq + (i & 1) * 8;
                    const int c = kk * 16 + tq * 2 + (i >> 1) * 8;
                    qa[kk][i] = g < G ? *reinterpret_cast<const uint32_t*>(
                                            qb + g * D + c)
                                      : 0u;
                }
        } else {
            for (int c = tid; c < kPassRows * kChunks; c += kThreads) {
                const int r = c / kChunks, col = (c % kChunks) * 8;
                *reinterpret_cast<uint4*>(q_s + r * Sh::kPitch + col) =
                    g0 + r < G ? *reinterpret_cast<const uint4*>(
                                     qb + (g0 + r) * D + col)
                               : make_uint4(0u, 0u, 0u, 0u);
            }
        }

        float o[D / 8][4];
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
            o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
        float m_r[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
        float l_r[2] = {0.f, 0.f};

#pragma unroll 1
        for (int t = 0; t < ntiles; ++t) {
            __nv_bfloat16* ks = ring + (t % kStages) * Sh::kStageElems;
            __nv_bfloat16* vs = ks + Sh::kTileElems;
            hopper::cp_async_wait<kStages - 1>();   // tile t, own copies
            __syncthreads();                        // everyone's copies

#pragma unroll 1
            for (int j = 0; j < R; ++j) {
                const int kb0 = (slice * R + j) * 16;   // step's first key
                float sc[2][4] = {{0.f, 0.f, 0.f, 0.f},
                                  {0.f, 0.f, 0.f, 0.f}};
                const __nv_bfloat16* krow = ks + (kb0 + k_row) * Sh::kPitch +
                                            k_col;
                if constexpr (Sh::kQRegs) {
#pragma unroll
                    for (int kk = 0; kk < D / 16; ++kk) {
                        uint32_t kf[4];
                        hopper::ldmatrix_x4(
                            kf, hopper::smem_u32(krow + kk * 16));
                        hopper::mma_m16n8k16_bf16(sc[0], qa[kk], kf[0],
                                                  kf[1]);
                        hopper::mma_m16n8k16_bf16(sc[1], qa[kk], kf[2],
                                                  kf[3]);
                    }
                } else {
                    // a partial unroll keeps the fragments in flight (and
                    // the registers they take) few beside the 16-row O
                    const __nv_bfloat16* qrow =
                        q_s + (rg * 16 + (lane & 15)) * Sh::kPitch +
                        (lane >> 4) * 8;
#pragma unroll 2
                    for (int kk = 0; kk < D / 16; ++kk) {
                        uint32_t kf[4], qf[4];
                        hopper::ldmatrix_x4(
                            kf, hopper::smem_u32(krow + kk * 16));
                        hopper::ldmatrix_x4(
                            qf, hopper::smem_u32(qrow + kk * 16));
                        hopper::mma_m16n8k16_bf16(sc[0], qf, kf[0], kf[1]);
                        hopper::mma_m16n8k16_bf16(sc[1], qf, kf[2], kf[3]);
                    }
                }

                // online softmax over the step's 16 keys: sc[n][e] is row
                // gq + 8 (e / 2), key 8 n + 2 tq + e % 2
                const int key0 = rows.lo + t * kTile + kb0 + tq * 2;
                float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
                for (int n = 0; n < 2; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        if (key0 + n * 8 + (e & 1) >= rows.hi)
                            sc[n][e] = REPRO_NEG_INF;
                        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
                    }
                float alpha[2];
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    mx[i] = fmaxf(mx[i],
                                  __shfl_xor_sync(0xffffffffu, mx[i], 1));
                    mx[i] = fmaxf(mx[i],
                                  __shfl_xor_sync(0xffffffffu, mx[i], 2));
                    alpha[i] = expf(m_r[i] - mx[i]);
                    m_r[i] = mx[i];
                    l_r[i] *= alpha[i];
                }
#pragma unroll
                for (int n = 0; n < 2; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float p = key0 + n * 8 + (e & 1) < rows.hi
                                            ? expf(sc[n][e] - m_r[e >> 1])
                                            : 0.f;
                        sc[n][e] = p;
                        l_r[e >> 1] += p;
                    }
#pragma unroll
                for (int jj = 0; jj < D / 8; ++jj) {
                    o[jj][0] *= alpha[0];
                    o[jj][1] *= alpha[0];
                    o[jj][2] *= alpha[1];
                    o[jj][3] *= alpha[1];
                }
                uint32_t pa[4], pl[4];        // P's hi and lo terms
                split_bf16(sc[0][0], sc[0][1], pa[0], pl[0]);
                split_bf16(sc[0][2], sc[0][3], pa[1], pl[1]);
                split_bf16(sc[1][0], sc[1][1], pa[2], pl[2]);
                split_bf16(sc[1][2], sc[1][3], pa[3], pl[3]);
#pragma unroll
                for (int dp = 0; dp < D / 16; ++dp) {
                    uint32_t vf[4];
                    hopper::ldmatrix_x4_trans(
                        vf, hopper::smem_u32(vs + (kb0 + v_row) * Sh::kPitch +
                                             dp * 16 + v_col));
                    hopper::mma_m16n8k16_bf16(o[2 * dp], pa, vf[0], vf[1]);
                    hopper::mma_m16n8k16_bf16(o[2 * dp], pl, vf[0], vf[1]);
                    hopper::mma_m16n8k16_bf16(o[2 * dp + 1], pa, vf[2],
                                              vf[3]);
                    hopper::mma_m16n8k16_bf16(o[2 * dp + 1], pl, vf[2],
                                              vf[3]);
                }
            }
            __syncthreads();              // every warp is done with the slot
            load(t + kStages, ks);
        }
        hopper::cp_async_wait<0>();
        __syncthreads();                  // the ring is free for the merge
        finish_wide<D>(o, m_r, l_r, smem_raw, ep, B, Hkv, G, S, s, bh, g0,
                       gp, R);
    }
    combine_if_last<D>(ep, S, static_cast<long long>(B) * Hkv * G, bh * G, G,
                       bh);
}

// ---------------------------------------------------------------------------
// f32 operands on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kGB = 4;         // query rows per thread in the score phase

// K rows are padded to D + 4 floats: 16-byte aligned, and the float4
// reads of 8 consecutive rows fall in distinct banks.
constexpr int kPad = 4;

template <int D>
constexpr size_t cc_smem_bytes() {
    return sizeof(float) * (kTile * (D + kPad) + kTile * D + kRowGroup * D +
                            kRowGroup * kTile);
}

// The largest count of at most 8 that divides `iters`: a tile's loads go
// in batches of that many 16-byte vectors.
__host__ __device__ constexpr int load_batch(int iters, int b = 8) {
    return b > iters ? load_batch(iters, iters)
                     : iters % b == 0 ? b : load_batch(iters, b - 1);
}

// The minimum of one block per SM lifts ptxas's own register cap (96 at
// D=64, with spills) to what the body needs.  The G rows go in passes of
// kRowGroup, each reading the split's K and V once.
template <typename TQ, typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
decode_cc_kernel(const TQ* __restrict__ q,  // (B, Hkv, G, D) scaled
                 const T* __restrict__ k,   // strided (B, L, Hkv, D)
                 const T* __restrict__ v,
                 const int* __restrict__ kv_len,   // (B,)
                 Epilogue ep, int B, int Hkv, int G, int L, int S,
                 long long stride_b, long long stride_l) {
    constexpr int KS = D + kPad;
    extern __shared__ __align__(16) float smem[];
    float* k_s = smem;                       // kTile x KS
    float* v_s = k_s + kTile * KS;           // kTile x D
    float* q_s = v_s + kTile * D;            // kRowGroup x D (rows >= gp 0)
    float* p_s = q_s + kRowGroup * D;        // kRowGroup x kTile
    __shared__ float m_s[kRowGroup], l_s[kRowGroup], alpha_s[kRowGroup];

    const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const Rows rows = split_rows(L, S, s, kv_len[b]);
    const int row_lo = rows.lo, row_hi = rows.hi;
    const long long bh = static_cast<long long>(b) * Hkv + h;
    const long long split_stride = static_cast<long long>(B) * Hkv * G;
    const long long row0 = bh * G;

    // P V phase: thread owns output columns c0 + i * kThreads (< D) of
    // rows gs, gs + kGStep, ...
    constexpr int kColW = D < kThreads ? D : kThreads;
    constexpr int kGStep = kThreads / kColW;
    constexpr int kAccG = kRowGroup / kGStep;
    constexpr int kCols = (D + kThreads - 1) / kThreads;
    const int c0 = tid % kColW, gs = tid / kColW;

    const long long head_off = static_cast<long long>(h) * D;
    const T* kb = k + b * stride_b + head_off;
    const T* vb = v + b * stride_b + head_off;
    constexpr int kVec = Vec16<T>::N;
    constexpr int kChunks = D / kVec;        // 16-byte chunks per row
    constexpr int kIters = kTile * kChunks / kThreads;
    constexpr int kBatch = load_batch(kIters);   // loads in flight

    for (int g0 = 0; g0 < G; g0 += kRowGroup) {
        const int gp = min(kRowGroup, G - g0);
        const TQ* qb = q + (row0 + g0) * D;
        if (g0 > 0) __syncthreads();   // the last pass's m_s, l_s are read
        for (int i = tid; i < kRowGroup * D; i += kThreads)
            q_s[i] = i < gp * D ? to_float(qb[i]) : 0.f;
        if (tid < kRowGroup) {
            m_s[tid] = REPRO_NEG_INF;
            l_s[tid] = 0.f;
        }
        float acc[kCols][kAccG];
#pragma unroll
        for (int ci = 0; ci < kCols; ++ci)
#pragma unroll
            for (int j = 0; j < kAccG; ++j) acc[ci][j] = 0.f;
        __syncthreads();

        for (int r0 = row_lo; r0 < row_hi; r0 += kTile) {
            const int n = min(kTile, row_hi - r0);
            for (int it0 = 0; it0 < kIters; it0 += kBatch) {
                uint4 kr[kBatch], vr[kBatch];
#pragma unroll
                for (int i = 0; i < kBatch; ++i) {
                    const int ci = tid + (it0 + i) * kThreads;
                    const int r = ci / kChunks, col = (ci % kChunks) * kVec;
                    if (r < n) {
                        const long long off = (r0 + r) * stride_l + col;
                        kr[i] = *reinterpret_cast<const uint4*>(kb + off);
                        vr[i] = *reinterpret_cast<const uint4*>(vb + off);
                    } else {
                        kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
                    }
                }
#pragma unroll
                for (int i = 0; i < kBatch; ++i) {
                    const int ci = tid + (it0 + i) * kThreads;
                    const int r = ci / kChunks, col = (ci % kChunks) * kVec;
                    float kf[kVec], vf[kVec];
                    widen16<T>(kr[i], kf);
                    widen16<T>(vr[i], vf);
#pragma unroll
                    for (int e = 0; e < kVec; e += 4) {
                        *reinterpret_cast<float4*>(k_s + r * KS + col + e) =
                            make_float4(kf[e], kf[e + 1], kf[e + 2],
                                        kf[e + 3]);
                        *reinterpret_cast<float4*>(v_s + r * D + col + e) =
                            make_float4(vf[e], vf[e + 1], vf[e + 2],
                                        vf[e + 3]);
                    }
                }
            }
            __syncthreads();

            // scores: thread handles row r for kGB query rows at a time
            {
                const int r = tid % kTile;
                for (int gb = (tid / kTile) * kGB; gb < gp;
                     gb += (kThreads / kTile) * kGB) {
                    float a[kGB];
#pragma unroll
                    for (int i = 0; i < kGB; ++i) a[i] = 0.f;
                    const float* kr = k_s + r * KS;
#pragma unroll 8
                    for (int d = 0; d < D; d += 4) {
                        const float4 kv =
                            *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
                        for (int i = 0; i < kGB; ++i) {
                            const float4 qv = *reinterpret_cast<const float4*>(
                                q_s + (gb + i) * D + d);
                            a[i] = fmaf(qv.x, kv.x, a[i]);
                            a[i] = fmaf(qv.y, kv.y, a[i]);
                            a[i] = fmaf(qv.z, kv.z, a[i]);
                            a[i] = fmaf(qv.w, kv.w, a[i]);
                        }
                    }
#pragma unroll
                    for (int i = 0; i < kGB; ++i)
                        if (gb + i < gp)
                            p_s[(gb + i) * kTile + r] = r < n ? a[i]
                                                              : REPRO_NEG_INF;
                }
            }
            __syncthreads();

            // online softmax, one warp per query row
            for (int g = warp; g < gp; g += kThreads / 32) {
                const float s0 = p_s[g * kTile + lane];
                const float s1 = p_s[g * kTile + lane + 32];
                const float m_old = m_s[g];
                const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
                const float p0 = lane < n ? expf(s0 - m_new) : 0.f;
                const float p1 = lane + 32 < n ? expf(s1 - m_new) : 0.f;
                p_s[g * kTile + lane] = p0;
                p_s[g * kTile + lane + 32] = p1;
                const float sum = warp_sum(p0 + p1);
                if (lane == 0) {
                    const float alpha = expf(m_old - m_new);
                    alpha_s[g] = alpha;
                    l_s[g] = l_s[g] * alpha + sum;
                    m_s[g] = m_new;
                }
            }
            __syncthreads();

            // acc = acc * alpha + P V; rows past n have p = 0 and v = 0
            const int n4 = (n + 3) & ~3;
#pragma unroll
            for (int ci = 0; ci < kCols; ++ci)
#pragma unroll
                for (int j = 0; j < kAccG; ++j) {
                    const int g = gs + j * kGStep;
                    if (g < gp) acc[ci][j] *= alpha_s[g];
                }
            for (int r = 0; r < n4; r += 4) {
#pragma unroll
                for (int ci = 0; ci < kCols; ++ci) {
                    const int c = c0 + ci * kThreads;
                    if (c >= D) continue;
                    const float v0 = v_s[r * D + c], v1 = v_s[(r + 1) * D + c];
                    const float v2 = v_s[(r + 2) * D + c];
                    const float v3 = v_s[(r + 3) * D + c];
#pragma unroll
                    for (int j = 0; j < kAccG; ++j) {
                        const int g = gs + j * kGStep;
                        if (g < gp) {
                            const float4 p = *reinterpret_cast<const float4*>(
                                p_s + g * kTile + r);
                            acc[ci][j] = fmaf(p.x, v0, acc[ci][j]);
                            acc[ci][j] = fmaf(p.y, v1, acc[ci][j]);
                            acc[ci][j] = fmaf(p.z, v2, acc[ci][j]);
                            acc[ci][j] = fmaf(p.w, v3, acc[ci][j]);
                        }
                    }
                }
            }
            __syncthreads();
        }

#pragma unroll
        for (int ci = 0; ci < kCols; ++ci)
#pragma unroll
            for (int j = 0; j < kAccG; ++j) {
                const int g = gs + j * kGStep, c = c0 + ci * kThreads;
                if (g < gp && c < D)
                    store_split(ep, S, s, split_stride, row0 + g0 + g, D, c,
                                acc[ci][j], l_s[g], m_s[g]);
            }
    }
    combine_if_last<D>(ep, S, split_stride, row0, G, bh);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
    const void *q, *k, *v, *kv_len;
    Epilogue ep;
    int B, Hkv, G, L, S;
    long long stride_b, stride_l;
    cudaStream_t stream;
};

template <typename TQ, typename T, typename Kernel>
cudaError_t launch_kernel(Kernel kernel, size_t smem, const Args& a) {
    dim3 grid(a.S, a.Hkv, a.B);
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const TQ*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const int*>(a.kv_len), a.ep,
        a.B, a.Hkv, a.G, a.L, a.S, a.stride_b, a.stride_l);
    return cudaGetLastError();
}

template <typename TQ, typename T, int D>
cudaError_t launch(const Args& a) {
    if constexpr (std::is_same<TQ, __nv_bfloat16>::value &&
                  std::is_same<T, __nv_bfloat16>::value) {
        if constexpr (D == 64 || D == 128) {
            if (a.G <= kRowGroup) {
                auto kernel = decode_tc_kernel<D>;
                constexpr size_t smem = TcShape<D>::kSmem;
                static const cudaError_t attr = smem_attr(kernel, smem);
                if (attr != cudaSuccess) return attr;
                return launch_kernel<TQ, T>(kernel, smem, a);
            }
        }
        auto kernel = decode_tc_wide_kernel<D>;
        constexpr size_t smem = WideShape<D>::kSmem;
        static const cudaError_t attr = smem_attr(kernel, smem);
        if (attr != cudaSuccess) return attr;
        return launch_kernel<TQ, T>(kernel, smem, a);
    } else {
        auto kernel = decode_cc_kernel<TQ, T, D>;
        constexpr size_t smem = cc_smem_bytes<D>();
        static const cudaError_t attr = smem_attr(kernel, smem);
        if (attr != cudaSuccess) return attr;
        return launch_kernel<TQ, T>(kernel, smem, a);
    }
}

template <typename TQ, typename T>
cudaError_t launch_d(const Args& a, int D) {
    if (D == 128) return launch<TQ, T, 128>(a);
    if (D == 64) return launch<TQ, T, 64>(a);
    if (D == 160) return launch<TQ, T, 160>(a);
    if (D == 256) return launch<TQ, T, 256>(a);
    return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t launch_kv(const Args& a, int D, int kv_dtype) {
    if (kv_dtype == REPRO_DTYPE_BF16) return launch_d<TQ, __nv_bfloat16>(a, D);
    if (kv_dtype == REPRO_DTYPE_F32) return launch_d<TQ, float>(a, D);
    return cudaErrorInvalidValue;
}

}  // namespace

// q in q_dtype, k and v in kv_dtype, out in out_dtype (each REPRO_DTYPE_F32
// or _BF16).  acc, l, m: the (S, B, Hkv, G, D) and (S, B, Hkv, G) f32
// partials.  With counters (B * Hkv int32, all 0) and out, the launch
// writes the combined output and leaves the counters at 0; with both null
// it writes the partials only.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* kv_len, void* acc, void* l, void* m,
                            void* counters, void* out, int B, int Hkv, int G,
                            int L, int S, int D, long long stride_b,
                            long long stride_l, int q_dtype, int kv_dtype,
                            int out_dtype, void* stream) {
    if (G < 1 || S < 1 || L < 1 || B < 1 || Hkv < 1 ||
        (counters == nullptr) != (out == nullptr) ||
        (out != nullptr && out_dtype != REPRO_DTYPE_F32 &&
         out_dtype != REPRO_DTYPE_BF16))
        return static_cast<int>(cudaErrorInvalidValue);
    const Epilogue ep{static_cast<float*>(acc), static_cast<float*>(l),
                      static_cast<float*>(m), static_cast<int*>(counters),
                      out, out_dtype};
    const Args a{q, k, v, kv_len, ep, B, Hkv, G, L, S, stride_b, stride_l,
                 static_cast<cudaStream_t>(stream)};
    if (q_dtype == REPRO_DTYPE_BF16)
        return static_cast<int>(launch_kv<__nv_bfloat16>(a, D, kv_dtype));
    if (q_dtype == REPRO_DTYPE_F32)
        return static_cast<int>(launch_kv<float>(a, D, kv_dtype));
    return static_cast<int>(cudaErrorInvalidValue);
}
