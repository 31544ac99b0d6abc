// Split-KV flash decode over a quantized KV cache for Hopper (sm_90a):
// int8 or fp8 (e4m3) K/V with one f32 scale per (row, head); the split
// partials and their log-sum-exp combine in one launch.
//
// Replaces: src/repro/kernels/flash_decode.py::_decode_quant_kernel,
// launched by flash_decode_quant_partials (pallas_call at
// flash_decode.py:296), and src/repro/kernels/flash_combine.py::
// _combine_kernel (pallas_call at flash_combine.py:61), which the
// reference runs after it on every quantized decode call.
//
// What bounds it: bytes, as for the bf16 cache's kernel
// (csrc/flash_decode.cu), at half the bytes: 1 byte per K/V element plus
// a 4-byte scale per (row, head), 2 * L * Hkv * (D + 4) bytes a step.  At
// the paper's low-head-count shapes the grid (B * Hkv * S CTAs) and the
// latency of each CTA's loop bound it before the bytes do.
//
// Design: csrc/flash_decode.cu's, with the dequantization moved to where
// it is exact.  The reference computes q . (code * k_scale) and
// p * (code * v_scale) in f32 (Quantizer.dequantize).
//  - bf16 q runs on the tensor cores; at G <= 16 and D = 64 or 128 in
//    decode_quant_tc_kernel (other G and D: decode_quant_tc_wide_kernel,
//    below, laid out as flash_decode.cu's wide body):
//      * One CTA per (split s, kv head h, batch b); each of the 4 warps
//        owns 16 keys of every 64-row tile and loads them itself by
//        cp.async through a ring of two tiles: its K codes (16-byte
//        copies; a D = 128 row is 8 of them, half a bf16 row) and its 16
//        keys' k and v scales (4-byte copies) in one commit group, its V
//        codes in the next.  Rows at or past kv_len are zero-filled, data
//        and scales (source size 0), so a poisoned tail (data 127, scale
//        1e4) is never read.
//      * The codes, not the dequantized values, become the mma's bf16
//        operands: every int8 value and every e4m3 value, subnormals
//        included, is a bf16 value, so the conversion is exact.  A
//        dequantized value would not be: code * scale rounded to bf16 is
//        off by up to half a bf16 step, 0.25 at V entries near 100.
//        The scales are applied in f32: S = Q . codes^T (mma.sync
//        m16n8k16, G query heads padded to M = 16, Q's A fragments in
//        registers, f32 accumulators), then each score column times its
//        key's k scale; after the online softmax, p' = p * v scale goes to
//        P V as two bf16 terms (hi = bf16(p'), lo = bf16(p' - hi), one mma
//        each), and l sums the unscaled p, as the reference does.
//      * K's B fragments come straight from the codes: each lane reads 4
//        consecutive codes of its key as one 32-bit word, and Q's A
//        fragments are loaded with the same permutation of d, which leaves
//        the product unchanged.  V's B fragments need codes of different
//        rows in one register, so each warp converts its own 16 V rows to
//        a bf16 tile in shared memory (__syncwarp only) and reads it
//        through ldmatrix.trans, as the bf16 kernel does.  (K converted
//        the same way and read through ldmatrix timed 2-12% slower.)
//      * Each warp keeps its own running (m, l, O); the four merge at the
//        end (finish_tc).
//  - f32 q (an f32 model over a quantized cache) keeps the CUDA-core body
//    (decode_quant_cc_kernel): K and V widened as float(code) * scale
//    into f32 tiles, the reference's dequantization bit for bit, the G
//    rows in passes of 16.
//  - Epilogue, both bodies: csrc/decode_epilogue.cuh, the bf16 kernel's.
//    With counters the launch writes the combined output, without them
//    the partials only.
#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"
#include "decode_epilogue.cuh"
#include "hopper.cuh"

namespace {

// The low two codes of `w` (the lower address in the low half) as one
// bf16x2 word, exactly.
template <typename T>
__device__ __forceinline__ uint32_t code_pair(uint32_t w);

template <> __device__ __forceinline__ uint32_t code_pair<int8_t>(uint32_t w) {
    const float a = __int2float_rn(static_cast<int>(w << 24) >> 24);
    const float b = __int2float_rn(static_cast<int>(w << 16) >> 24);
    const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&r);
}

template <>
__device__ __forceinline__ uint32_t code_pair<__nv_fp8_e4m3>(uint32_t w) {
    // e4m3 -> f16 is exact (subnormals too), f16 -> f32 -> bf16 as well
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), __NV_E4M3);
    const float2 f = __half22float2(__half2(h));
    const __nv_bfloat162 r = __floats2bfloat162_rn(f.x, f.y);
    return *reinterpret_cast<const uint32_t*>(&r);
}

// 16 codes as 16 bf16 values, in order.
template <typename T>
__device__ __forceinline__ void codes16_bf16(const uint4& in, uint4* out) {
    out[0] = make_uint4(code_pair<T>(in.x), code_pair<T>(in.x >> 16),
                        code_pair<T>(in.y), code_pair<T>(in.y >> 16));
    out[1] = make_uint4(code_pair<T>(in.z), code_pair<T>(in.z >> 16),
                        code_pair<T>(in.w), code_pair<T>(in.w >> 16));
}

// ---------------------------------------------------------------------------
// bf16 q on the tensor cores
// ---------------------------------------------------------------------------

template <int D>
struct QtcShape {
    static constexpr int kChunks = D / 16;          // 16-byte chunks per row
    static constexpr int kPerLane = kWarpRows * kChunks / 32;
    // a stage: K codes, V codes (rows of D + 16 bytes: 16-byte aligned, and
    // the 32-bit reads of 8 rows fall in distinct banks), k scales, v scales
    static constexpr int kCPitch = D + 16;
    static constexpr int kCodeBytes = kTile * kCPitch;
    static constexpr int kScaleOff = 2 * kCodeBytes;
    static constexpr int kStageBytes = kScaleOff + 2 * kTile * 4;
    static constexpr size_t kRing = kStages * kStageBytes;
    // each warp's 16 converted rows, bf16, padded as the bf16 kernel's
    static constexpr int kPitch = D + 8;
    static constexpr size_t kConv =
        sizeof(__nv_bfloat16) * kWarps * kWarpRows * kPitch;
    static constexpr size_t kMerge = WarpMerge<D>::kBytes;
    static constexpr size_t kSmem =
        kRing + kConv > kMerge ? kRing + kConv : kMerge;
};
static_assert(2 * kWarpRows == 32, "a lane loads one k or v scale");

// Converts this lane's own copies of one stage's code tile (the chunks its
// cp.async wrote, so no barrier is needed first) to the warp's bf16 rows.
template <typename T, int D>
__device__ __forceinline__ void convert_own(const unsigned char* codes,
                                            __nv_bfloat16* conv, int wrow,
                                            int lane) {
    using Sh = QtcShape<D>;
#pragma unroll
    for (int i = 0; i < Sh::kPerLane; ++i) {
        const int c = lane + i * 32;
        const int r = c / Sh::kChunks, col = (c % Sh::kChunks) * 16;
        codes16_bf16<T>(*reinterpret_cast<const uint4*>(
                            codes + (wrow + r) * Sh::kCPitch + col),
                        reinterpret_cast<uint4*>(conv + r * Sh::kPitch + col));
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_quant_tc_kernel(const __nv_bfloat16* __restrict__ q,  // (B,Hkv,G,D)
                       const T* __restrict__ k,      // strided (B, L, Hkv, D)
                       const T* __restrict__ v,
                       const float* __restrict__ k_scale,  // strided (B,L,Hkv)
                       const float* __restrict__ v_scale,
                       const int* __restrict__ kv_len,     // (B,)
                       Epilogue ep, int B, int Hkv, int G, int L, int S,
                       long long stride_b, long long stride_l,
                       long long sstride_b, long long sstride_l) {
    using Sh = QtcShape<D>;
    extern __shared__ __align__(16) unsigned char smem_raw[];

    const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gq = lane / 4, tq = lane % 4;         // fragment row, column
    const int wrow = warp * kWarpRows;              // this warp's first key
    const Rows rows = split_rows(L, S, s, kv_len[b]);
    const int ntiles = rows.hi > rows.lo
                           ? (rows.hi - rows.lo + kTile - 1) / kTile : 0;
    const long long bh = static_cast<long long>(b) * Hkv + h;
    __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(
        smem_raw + Sh::kRing) + warp * kWarpRows * Sh::kPitch;

    // this warp's 16 rows of tile t into ring stage `st`, zero past
    // rows.hi: K's codes and the rows' two scales in one commit group, V's
    // codes in the next; both groups empty past the last tile
    const unsigned char* kb =
        reinterpret_cast<const unsigned char*>(k + b * stride_b + h * D);
    const unsigned char* vb =
        reinterpret_cast<const unsigned char*>(v + b * stride_b + h * D);
    const float* sb = (lane < kWarpRows ? k_scale : v_scale) +
                      b * sstride_b + h;
    auto load_codes = [&](const unsigned char* src, int r0,
                          unsigned char* dst) {
#pragma unroll
        for (int i = 0; i < Sh::kPerLane; ++i) {
            const int c = lane + i * 32;
            const int r = c / Sh::kChunks, col = (c % Sh::kChunks) * 16;
            const bool ok = r0 + r < rows.hi;
            hopper::cp_async_16(
                hopper::smem_u32(dst + (wrow + r) * Sh::kCPitch + col),
                ok ? src + (r0 + r) * stride_l + col : src, ok ? 16 : 0);
        }
    };
    auto load = [&](int t, unsigned char* st) {
        const int r0 = rows.lo + t * kTile + wrow;
        if (t < ntiles) {
            load_codes(kb, r0, st);
            const int r = lane % kWarpRows;     // lanes 16-31: v scales
            const bool ok = r0 + r < rows.hi;
            hopper::cp_async_4(
                hopper::smem_u32(st + Sh::kScaleOff +
                                 ((lane / kWarpRows) * kTile + wrow + r) * 4),
                ok ? sb + (r0 + r) * sstride_l : sb, ok ? 4 : 0);
        }
        hopper::cp_async_commit();
        if (t < ntiles) load_codes(vb, r0, st + Sh::kCodeBytes);
        hopper::cp_async_commit();
    };
#pragma unroll
    for (int st = 0; st < kStages; ++st)
        load(st, smem_raw + st * Sh::kStageBytes);

    // Q's A fragments: rows gq and gq + 8, zero at or past G.  Reading K
    // from the codes permutes d within each 16-column step: lane tq's
    // columns 2 tq, 2 tq + 1, 2 tq + 8, 2 tq + 9 are d = 4 tq .. 4 tq + 3.
    const __nv_bfloat16* qb = q + bh * G * D;
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int g = gq + (i & 1) * 8;
            const int c = kk * 16 + tq * 4 + (i >> 1) * 2;
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

    // ldmatrix.trans row addresses in the warp's converted V rows, P V's
    // B operand (keys x D)
    const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int v_col = (lane >> 4) * 8;

    for (int t = 0; t < ntiles; ++t) {
        unsigned char* st = smem_raw + (t % kStages) * Sh::kStageBytes;
        const float* ksc = reinterpret_cast<const float*>(st + Sh::kScaleOff);
        const float* vsc = ksc + kTile;
        hopper::cp_async_wait<2 * kStages - 1>();   // K and scales of tile t

        __syncwarp();                 // the warp's copies, seen by all
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
            for (int n = 0; n < 2; ++n) {
                // key 8 n + gq's codes at d = kk * 16 + 4 tq .. + 3
                const uint32_t w = *reinterpret_cast<const uint32_t*>(
                    st + (wrow + n * 8 + gq) * Sh::kCPitch + kk * 16 +
                    tq * 4);
                hopper::mma_m16n8k16_bf16(sc[n], qa[kk], code_pair<T>(w),
                                          code_pair<T>(w >> 16));
            }

        // sc[n][e] is row gq + 8 (e / 2), key 8 n + 2 tq + e % 2 of the
        // warp's 16: each score column times its key's k scale, in f32
        float2 ks[2], vs[2];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
            ks[n] = *reinterpret_cast<const float2*>(ksc + wrow + n * 8 +
                                                     tq * 2);
            vs[n] = *reinterpret_cast<const float2*>(vsc + wrow + n * 8 +
                                                     tq * 2);
        }
        const int key0 = rows.lo + t * kTile + wrow + tq * 2;
        float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                sc[n][e] *= e & 1 ? ks[n].y : ks[n].x;
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
        // P V's A fragments: p times its key's v scale, as two bf16 terms
        uint32_t pa[4], pl[4];
        split_bf16(sc[0][0] * vs[0].x, sc[0][1] * vs[0].y, pa[0], pl[0]);
        split_bf16(sc[0][2] * vs[0].x, sc[0][3] * vs[0].y, pa[1], pl[1]);
        split_bf16(sc[1][0] * vs[1].x, sc[1][1] * vs[1].y, pa[2], pl[2]);
        split_bf16(sc[1][2] * vs[1].x, sc[1][3] * vs[1].y, pa[3], pl[3]);

        hopper::cp_async_wait<2 * kStages - 2>();   // V of tile t
        convert_own<T, D>(st + Sh::kCodeBytes, conv, wrow, lane);
        __syncwarp();
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t vf[4];
            hopper::ldmatrix_x4_trans(
                vf, hopper::smem_u32(conv + v_row * Sh::kPitch + dp * 16 +
                                     v_col));
            hopper::mma_m16n8k16_bf16(o[2 * dp], pa, vf[0], vf[1]);
            hopper::mma_m16n8k16_bf16(o[2 * dp], pl, vf[0], vf[1]);
            hopper::mma_m16n8k16_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
            hopper::mma_m16n8k16_bf16(o[2 * dp + 1], pl, vf[2], vf[3]);
        }
        __syncwarp();                 // every lane is done with the slot
        load(t + kStages, st);
    }
    hopper::cp_async_wait<0>();

    finish_tc<D>(o, m_r, l_r, smem_raw, ep, B, Hkv, G, S, s, bh);
}

// The tensor-core body for the shapes decode_quant_tc_kernel does not take
// (more than 16 query heads per KV head, or D = 160 / 256), laid out as
// flash_decode.cu's decode_tc_wide_kernel: passes of up to 64 rows, warp w
// owning row group w % R over key slice w / R of every tile, all 128
// threads loading each tile (K and V codes and the two scale rows in one
// commit group) and a block-wide barrier handing it over.  After the wait
// each thread converts the V codes it copied to a shared bf16 tile, and a
// barrier publishes it; each 16-key step is decode_quant_tc_kernel's (K's
// B fragments from the codes, Q's fragments permuted alike, the scales
// applied in f32, p times the v scale as two bf16 terms).  At D = 256 Q
// is staged in shared memory, already permuted, and read by ldmatrix.
template <int D>
struct QWideShape {
    static constexpr int kChunks = D / 16;          // 16-byte chunks per row
    static constexpr int kPerThread = kTile * kChunks / kThreads;
    static constexpr int kCPitch = D + 16;          // code rows, bytes
    static constexpr int kCodeBytes = kTile * kCPitch;
    static constexpr int kScaleOff = 2 * kCodeBytes;
    static constexpr int kStageBytes = kScaleOff + 2 * kTile * 4;
    static constexpr size_t kRing = kStages * kStageBytes;
    static constexpr int kPitch = D + 8;            // bf16 rows: V and Q
    static constexpr size_t kConv = sizeof(__nv_bfloat16) * kTile * kPitch;
    static constexpr bool kQRegs = D <= 160;        // else Q in smem
    static constexpr size_t kQ =
        kQRegs ? 0 : sizeof(__nv_bfloat16) * kPassRows * kPitch;
    static constexpr size_t kMerge = WarpMerge<D>::kBytes;
    static constexpr size_t kSmem =
        kRing + kConv + kQ > kMerge ? kRing + kConv + kQ : kMerge;
};
static_assert(kThreads == 2 * kTile, "a thread loads one k or v scale");

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_quant_tc_wide_kernel(
        const __nv_bfloat16* __restrict__ q,   // (B, Hkv, G, D)
        const T* __restrict__ k,               // strided (B, L, Hkv, D)
        const T* __restrict__ v,
        const float* __restrict__ k_scale,     // strided (B, L, Hkv)
        const float* __restrict__ v_scale,
        const int* __restrict__ kv_len,        // (B,)
        Epilogue ep, int B, int Hkv, int G, int L, int S,
        long long stride_b, long long stride_l, long long sstride_b,
        long long sstride_l) {
    using Sh = QWideShape<D>;
    constexpr int kChunks = Sh::kChunks, kPerThread = Sh::kPerThread;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* conv =
        reinterpret_cast<__nv_bfloat16*>(smem_raw + Sh::kRing);
    __nv_bfloat16* q_s = conv + kTile * Sh::kPitch;

    const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int gq = lane / 4, tq = lane % 4;         // fragment row, column
    const Rows rows = split_rows(L, S, s, kv_len[b]);
    const int ntiles = rows.hi > rows.lo
                           ? (rows.hi - rows.lo + kTile - 1) / kTile : 0;
    const long long bh = static_cast<long long>(b) * Hkv + h;

    // tile t's K and V codes and its rows' scales into ring stage `st`,
    // zero past rows.hi; one commit group, empty past the last tile
    const unsigned char* kb =
        reinterpret_cast<const unsigned char*>(k + b * stride_b + h * D);
    const unsigned char* vb =
        reinterpret_cast<const unsigned char*>(v + b * stride_b + h * D);
    const float* sb = (tid < kTile ? k_scale : v_scale) + b * sstride_b + h;
    auto load = [&](int t, unsigned char* st) {
        if (t < ntiles) {
            const int r0 = rows.lo + t * kTile;
            // rolled: unrolled, the copies' addresses stay live in
            // registers across the tile loop beside the 16-row O
#pragma unroll 1
            for (int i = 0; i < 2 * kPerThread; ++i) {
                const int c = tid + (i % kPerThread) * kThreads;
                const int r = c / kChunks, col = (c % kChunks) * 16;
                const bool ok = r0 + r < rows.hi;
                const unsigned char* src = i < kPerThread ? kb : vb;
                hopper::cp_async_16(
                    hopper::smem_u32(st + (i < kPerThread ? 0
                                               : Sh::kCodeBytes) +
                                     r * Sh::kCPitch + col),
                    ok ? src + (r0 + r) * stride_l + col : src, ok ? 16 : 0);
            }
            const int r = tid % kTile;      // threads 64-127: v scales
            const bool ok = r0 + r < rows.hi;
            hopper::cp_async_4(hopper::smem_u32(st + Sh::kScaleOff + tid * 4),
                               ok ? sb + (r0 + r) * sstride_l : sb,
                               ok ? 4 : 0);
        }
        hopper::cp_async_commit();
    };

    // ldmatrix row addresses within a 16-key step: V through the
    // transpose as P V's B operand, Q as S's A operand
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
            load(st, smem_raw + st * Sh::kStageBytes);

        // Q, with d permuted as K's fragments read the codes (lane tq's
        // columns 2 tq, 2 tq + 1, 2 tq + 8, 2 tq + 9 of a 16-column step
        // are d = 4 tq .. 4 tq + 3): rows g0 + 16 rg + gq (+ 8) in
        // registers, or the pass's rows in shared memory; zero past G
        uint32_t qa[Sh::kQRegs ? D / 16 : 1][4];
        if constexpr (Sh::kQRegs) {
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int g = g0 + rg * 16 + gq + (i & 1) * 8;
                    const int c = kk * 16 + tq * 4 + (i >> 1) * 2;
                    qa[kk][i] = g < G ? *reinterpret_cast<const uint32_t*>(
                                            qb + g * D + c)
                                      : 0u;
                }
        } else {
            // 32-bit word 2 t + p of each 16-column step goes to word
            // t + 4 p, so ldmatrix hands lane tq the permuted pairs
            for (int c = tid; c < kPassRows * (D / 16); c += kThreads) {
                const int r = c / (D / 16), col = (c % (D / 16)) * 16;
                uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
                if (g0 + r < G) {
                    const uint4* src = reinterpret_cast<const uint4*>(
                        qb + (g0 + r) * D + col);
                    lo = src[0];
                    hi = src[1];
                }
                uint4* dst = reinterpret_cast<uint4*>(q_s + r * Sh::kPitch +
                                                      col);
                dst[0] = make_uint4(lo.x, lo.z, hi.x, hi.z);
                dst[1] = make_uint4(lo.y, lo.w, hi.y, hi.w);
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
            unsigned char* st = smem_raw + (t % kStages) * Sh::kStageBytes;
            const float* ksc =
                reinterpret_cast<const float*>(st + Sh::kScaleOff);
            const float* vsc = ksc + kTile;
            hopper::cp_async_wait<kStages - 1>();   // tile t, own copies
#pragma unroll 1
            for (int i = 0; i < kPerThread; ++i) {  // own V codes -> bf16
                const int c = tid + i * kThreads;
                const int r = c / kChunks, col = (c % kChunks) * 16;
                codes16_bf16<T>(*reinterpret_cast<const uint4*>(
                                    st + Sh::kCodeBytes + r * Sh::kCPitch +
                                    col),
                                reinterpret_cast<uint4*>(
                                    conv + r * Sh::kPitch + col));
            }
            __syncthreads();                        // everyone's tiles

#pragma unroll 1
            for (int j = 0; j < R; ++j) {
                const int kb0 = (slice * R + j) * 16;   // step's first key
                float sc[2][4] = {{0.f, 0.f, 0.f, 0.f},
                                  {0.f, 0.f, 0.f, 0.f}};
                // key 8 n + gq's codes at d = kk * 16 + 4 tq .. + 3
                auto codes = [&](int n, int kk) {
                    return *reinterpret_cast<const uint32_t*>(
                        st + (kb0 + n * 8 + gq) * Sh::kCPitch + kk * 16 +
                        tq * 4);
                };
                if constexpr (Sh::kQRegs) {
#pragma unroll
                    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
                        for (int n = 0; n < 2; ++n) {
                            const uint32_t w = codes(n, kk);
                            hopper::mma_m16n8k16_bf16(
                                sc[n], qa[kk], code_pair<T>(w),
                                code_pair<T>(w >> 16));
                        }
                } else {
                    // a partial unroll keeps the fragments in flight (and
                    // the registers they take) few beside the 16-row O
                    const __nv_bfloat16* qrow =
                        q_s + (rg * 16 + (lane & 15)) * Sh::kPitch +
                        (lane >> 4) * 8;
#pragma unroll 2
                    for (int kk = 0; kk < D / 16; ++kk) {
                        uint32_t qf[4];
                        hopper::ldmatrix_x4(
                            qf, hopper::smem_u32(qrow + kk * 16));
#pragma unroll
                        for (int n = 0; n < 2; ++n) {
                            const uint32_t w = codes(n, kk);
                            hopper::mma_m16n8k16_bf16(
                                sc[n], qf, code_pair<T>(w),
                                code_pair<T>(w >> 16));
                        }
                    }
                }

                // sc[n][e] is row gq + 8 (e / 2), key 8 n + 2 tq + e % 2
                // of the step's 16: each score column times its key's k
                // scale, in f32
                float2 ks[2], vs[2];
#pragma unroll
                for (int n = 0; n < 2; ++n) {
                    ks[n] = *reinterpret_cast<const float2*>(
                        ksc + kb0 + n * 8 + tq * 2);
                    vs[n] = *reinterpret_cast<const float2*>(
                        vsc + kb0 + n * 8 + tq * 2);
                }
                const int key0 = rows.lo + t * kTile + kb0 + tq * 2;
                float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
                for (int n = 0; n < 2; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        sc[n][e] *= e & 1 ? ks[n].y : ks[n].x;
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
                // P V's A fragments: p times its key's v scale, two terms
                uint32_t pa[4], pl[4];
                split_bf16(sc[0][0] * vs[0].x, sc[0][1] * vs[0].y, pa[0],
                           pl[0]);
                split_bf16(sc[0][2] * vs[0].x, sc[0][3] * vs[0].y, pa[1],
                           pl[1]);
                split_bf16(sc[1][0] * vs[1].x, sc[1][1] * vs[1].y, pa[2],
                           pl[2]);
                split_bf16(sc[1][2] * vs[1].x, sc[1][3] * vs[1].y, pa[3],
                           pl[3]);
#pragma unroll
                for (int dp = 0; dp < D / 16; ++dp) {
                    uint32_t vf[4];
                    hopper::ldmatrix_x4_trans(
                        vf, hopper::smem_u32(conv +
                                             (kb0 + v_row) * Sh::kPitch +
                                             dp * 16 + v_col));
                    hopper::mma_m16n8k16_bf16(o[2 * dp], pa, vf[0], vf[1]);
                    hopper::mma_m16n8k16_bf16(o[2 * dp], pl, vf[0], vf[1]);
                    hopper::mma_m16n8k16_bf16(o[2 * dp + 1], pa, vf[2],
                                              vf[3]);
                    hopper::mma_m16n8k16_bf16(o[2 * dp + 1], pl, vf[2],
                                              vf[3]);
                }
            }
            __syncthreads();     // every warp is done with the stage, conv
            load(t + kStages, st);
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
// f32 q on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kGB = 4;         // query rows per thread in the score phase
constexpr int kPad = 4;        // K rows padded to D + 4 floats (banks)

static_assert(kTile <= kThreads, "one thread stages each row's scales");

template <int D>
constexpr size_t cc_smem_bytes() {
    return sizeof(float) * (kTile * (D + kPad) + kTile * D + kRowGroup * D +
                            kRowGroup * kTile);
}

// Each staged 64-row tile issues its K and V loads (16 codes per 16-byte
// load) and its rows' two scales together; the scales go to shared memory
// once per row, and every element is widened as float(x) * scale into the
// f32 tile.  The score, online-softmax and P V phases, and the passes of
// kRowGroup query rows, are the bf16 kernel's CUDA-core body's.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_quant_cc_kernel(
        const float* __restrict__ q,     // (B, Hkv, G, D) scaled
        const T* __restrict__ k,         // strided (B, L, Hkv, D)
        const T* __restrict__ v,
        const float* __restrict__ k_scale,   // strided (B, L, Hkv)
        const float* __restrict__ v_scale,
        const int* __restrict__ kv_len,      // (B,)
        Epilogue ep, int B, int Hkv, int G, int L, int S,
        long long stride_b, long long stride_l,
        long long sstride_b, long long sstride_l) {
    constexpr int KS = D + kPad;
    extern __shared__ __align__(16) float smem[];
    float* k_s = smem;                       // kTile x KS
    float* v_s = k_s + kTile * KS;           // kTile x D
    float* q_s = v_s + kTile * D;            // kRowGroup x D (rows >= gp 0)
    float* p_s = q_s + kRowGroup * D;        // kRowGroup x kTile
    __shared__ float m_s[kRowGroup], l_s[kRowGroup], alpha_s[kRowGroup];
    __shared__ float ksc_s[kTile], vsc_s[kTile];   // the tile's scales

    const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const Rows rows = split_rows(L, S, s, kv_len[b]);
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
    const float* ksb = k_scale + b * sstride_b + h;
    const float* vsb = v_scale + b * sstride_b + h;
    constexpr int kVec = Vec16<T>::N;        // 16 one-byte elements
    constexpr int kChunks = D / kVec;        // 16-byte chunks per row
    constexpr int kIters = kTile * kChunks / kThreads;
    static_assert(kIters >= 1 && kIters <= 8,
                  "a tile's loads are issued in one batch");

    for (int g0 = 0; g0 < G; g0 += kRowGroup) {
        const int gp = min(kRowGroup, G - g0);
        const float* qb = q + (row0 + g0) * D;
        if (g0 > 0) __syncthreads();   // the last pass's m_s, l_s are read
        for (int i = tid; i < kRowGroup * D; i += kThreads)
            q_s[i] = i < gp * D ? qb[i] : 0.f;
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

        for (int r0 = rows.lo; r0 < rows.hi; r0 += kTile) {
            const int n = min(kTile, rows.hi - r0);
            // every load of the tile in flight at once: K, V, the scales
            uint4 kr[kIters], vr[kIters];
#pragma unroll
            for (int i = 0; i < kIters; ++i) {
                const int ci = tid + i * kThreads;
                const int r = ci / kChunks, col = (ci % kChunks) * kVec;
                if (r < n) {
                    const long long off = (r0 + r) * stride_l + col;
                    kr[i] = *reinterpret_cast<const uint4*>(kb + off);
                    vr[i] = *reinterpret_cast<const uint4*>(vb + off);
                } else {
                    kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
                }
            }
            float ksc = 0.f, vsc = 0.f;
            if (tid < n) {
                ksc = ksb[(r0 + tid) * sstride_l];
                vsc = vsb[(r0 + tid) * sstride_l];
            }
            if (tid < kTile) {
                ksc_s[tid] = ksc;
                vsc_s[tid] = vsc;
            }
            __syncthreads();
#pragma unroll
            for (int i = 0; i < kIters; ++i) {
                const int ci = tid + i * kThreads;
                const int r = ci / kChunks, col = (ci % kChunks) * kVec;
                const float ks = ksc_s[r], vs = vsc_s[r];
                float kf[kVec], vf[kVec];
                widen16<T>(kr[i], kf);
                widen16<T>(vr[i], vf);
#pragma unroll
                for (int e = 0; e < kVec; e += 4) {
                    *reinterpret_cast<float4*>(k_s + r * KS + col + e) =
                        make_float4(kf[e] * ks, kf[e + 1] * ks,
                                    kf[e + 2] * ks, kf[e + 3] * ks);
                    *reinterpret_cast<float4*>(v_s + r * D + col + e) =
                        make_float4(vf[e] * vs, vf[e + 1] * vs,
                                    vf[e + 2] * vs, vf[e + 3] * vs);
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
                    const float* krow = k_s + r * KS;
#pragma unroll 8
                    for (int d = 0; d < D; d += 4) {
                        const float4 kv =
                            *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
                        for (int i = 0; i < kGB; ++i) {
                            const float4 qv =
                                *reinterpret_cast<const float4*>(
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
                            p_s[(gb + i) * kTile + r] =
                                r < n ? a[i] : REPRO_NEG_INF;
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
                    const float v0 = v_s[r * D + c];
                    const float v1 = v_s[(r + 1) * D + c];
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
    const void *q, *k, *v, *k_scale, *v_scale, *kv_len;
    Epilogue ep;
    int B, Hkv, G, L, S;
    long long stride_b, stride_l, sstride_b, sstride_l;
    cudaStream_t stream;
};

template <typename TQ, typename T, int D>
cudaError_t launch(const Args& a) {
    const dim3 grid(a.S, a.Hkv, a.B);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    const float* ks = static_cast<const float*>(a.k_scale);
    const float* vs = static_cast<const float*>(a.v_scale);
    const int* lens = static_cast<const int*>(a.kv_len);
    if constexpr (std::is_same<TQ, __nv_bfloat16>::value) {
        if constexpr (D == 64 || D == 128) {
            if (a.G <= kRowGroup) {
                auto kernel = decode_quant_tc_kernel<T, D>;
                constexpr size_t smem = QtcShape<D>::kSmem;
                static const cudaError_t attr = smem_attr(kernel, smem);
                if (attr != cudaSuccess) return attr;
                kernel<<<grid, kThreads, smem, a.stream>>>(
                    static_cast<const TQ*>(a.q), k, v, ks, vs, lens, a.ep,
                    a.B, a.Hkv, a.G, a.L, a.S, a.stride_b, a.stride_l,
                    a.sstride_b, a.sstride_l);
                return cudaGetLastError();
            }
        }
        auto kernel = decode_quant_tc_wide_kernel<T, D>;
        constexpr size_t smem = QWideShape<D>::kSmem;
        static const cudaError_t attr = smem_attr(kernel, smem);
        if (attr != cudaSuccess) return attr;
        kernel<<<grid, kThreads, smem, a.stream>>>(
            static_cast<const TQ*>(a.q), k, v, ks, vs, lens, a.ep, a.B,
            a.Hkv, a.G, a.L, a.S, a.stride_b, a.stride_l, a.sstride_b,
            a.sstride_l);
    } else {
        auto kernel = decode_quant_cc_kernel<T, D>;
        constexpr size_t smem = cc_smem_bytes<D>();
        static const cudaError_t attr = smem_attr(kernel, smem);
        if (attr != cudaSuccess) return attr;
        kernel<<<grid, kThreads, smem, a.stream>>>(
            static_cast<const TQ*>(a.q), k, v, ks, vs, lens, a.ep, a.B,
            a.Hkv, a.G, a.L, a.S, a.stride_b, a.stride_l, a.sstride_b,
            a.sstride_l);
    }
    return cudaGetLastError();
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
    if (kv_dtype == REPRO_DTYPE_INT8) return launch_d<TQ, int8_t>(a, D);
    if (kv_dtype == REPRO_DTYPE_FP8) return launch_d<TQ, __nv_fp8_e4m3>(a, D);
    return cudaErrorInvalidValue;
}

}  // namespace

// q in q_dtype (REPRO_DTYPE_BF16: tensor cores, or _F32: CUDA cores); k
// and v in kv_dtype (REPRO_DTYPE_INT8 or _FP8); f32 scales; out in
// out_dtype (REPRO_DTYPE_F32 or _BF16).  Strides are in elements.  acc,
// l, m: the (S, B, Hkv, G, D) and (S, B, Hkv, G) f32 partials.  With
// counters (B * Hkv int32, all 0) and out, the launch writes the combined
// output and leaves the counters at 0; with both null it writes the
// partials only.
extern "C" int flash_decode_quant(
        const void* q, const void* k, const void* v, const void* k_scale,
        const void* v_scale, const void* kv_len, void* acc, void* l,
        void* m, void* counters, void* out, int B, int Hkv, int G, int L,
        int S, int D, long long stride_b, long long stride_l,
        long long sstride_b, long long sstride_l, int q_dtype, int kv_dtype,
        int out_dtype, void* stream) {
    if (G < 1 || S < 1 || L < 1 || B < 1 || Hkv < 1 ||
        (counters == nullptr) != (out == nullptr) ||
        (out != nullptr && out_dtype != REPRO_DTYPE_F32 &&
         out_dtype != REPRO_DTYPE_BF16))
        return static_cast<int>(cudaErrorInvalidValue);
    const Epilogue ep{static_cast<float*>(acc), static_cast<float*>(l),
                      static_cast<float*>(m), static_cast<int*>(counters),
                      out, out_dtype};
    const Args a{q, k, v, k_scale, v_scale, kv_len, ep, B, Hkv, G, L, S,
                 stride_b, stride_l, sstride_b, sstride_l,
                 static_cast<cudaStream_t>(stream)};
    if (q_dtype == REPRO_DTYPE_BF16)
        return static_cast<int>(launch_kv<__nv_bfloat16>(a, D, kv_dtype));
    if (q_dtype == REPRO_DTYPE_F32)
        return static_cast<int>(launch_kv<float>(a, D, kv_dtype));
    return static_cast<int>(cudaErrorInvalidValue);
}
