// Causal flash-attention forward (prefill) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_prefill.py::_prefill_kernel, launched
// by flash_prefill (pallas_call at flash_prefill.py:133).
//
// What bounds it: operations, from about 660 keys up at 16/2 heads and
// D = 128.  A causal prompt of L tokens costs 4 * Hq * D * L * L / 2
// flops against 2 * L * (2 * Hq + 2 * Hkv) * D bytes of Q, K, V and
// output, hundreds of flops per byte at that length: only the tensor
// cores can approach the bound.  Shorter prompts are bound by bytes on
// paper and by launch and pipeline fill on the card.
//
// Common to both kernels below:
//  - The GQA KV head is h / (Hq / Hkv): K and V are never replicated.
//  - The KV loop is bounded by the causal limit, and by the window when
//    one is given: tiles above the diagonal or before the window are
//    neither loaded nor computed.  (The Pallas kernel loads them and
//    skips only their flops.)
//  - Masks: kpos < Lk, kpos <= qpos, kpos > qpos - window, with
//    qpos = q_offset + q row.  q_offset is a runtime int; ragged Lq and
//    Lk are masked here, so the caller pads nothing.
//  - Online softmax in f32; the output is acc / max(l, 1e-30), as in the
//    reference, so a row with no valid key is 0.
//
// bf16 (prefill_kernel_tc): FA3's forward on the tensor cores.
//  - CTA = 1 consumer warpgroup (64 query rows) + 1 producer warp.  The
//    producer's one thread loads Q once and K, V tiles of 64 keys
//    through a kStages-deep ring in shared memory with TMA
//    (cp.async.bulk.tensor, 128-byte swizzle, one 64-column box per 64
//    columns of a row, the last one zero-filled past D = 160), each
//    completing on an mbarrier; consumers free a
//    K or V slot with an arrival on its "empty" barrier as soon as the
//    wgmma that reads it has completed.  Loads of the next tiles are in
//    flight while the consumers compute.
//  - S = Q K^T: wgmma m64n64k16, Q and K both K-major in shared memory.
//  - Softmax in registers on the accumulator fragment, in base 2 (log2(e)
//    folded into the scores); masks only on tiles that cross the
//    diagonal, the window's edge or Lk.
//  - O += P V: P in registers, as two bf16 terms (hi = bf16(p), lo =
//    bf16(p - hi); see split_bf16), is the A operand of two wgmmas (the
//    S fragment is already A's layout); V is B, MN-major, through the
//    transpose bit.  FA3 rounds P to one bf16 term; on the full-width
//    model's prompts (V entries ~150, a few dominant keys) that one term
//    missed the 3e-2 tolerance, and two terms keep P V close to the
//    reference's f32 product.  l sums the f32 P.
//  - Heaviest q blocks first: the q block is the slowest grid index,
//    counted down, so the CTAs with the longest KV loops start first.
//  - Tiling: BQ = 64, BK = 64, 2 stages: 83,016 bytes of shared memory,
//    so two CTAs share an SM.  Timed on the H100 against a third stage
//    and against BQ = 128 (two consumer warpgroups) at the four
//    main-path buckets (PERF.md has the times): a third stage buys
//    about 2% at 1024 keys and nothing below, and BQ = 128 is about a
//    fifth slower, so this tiling stays.  FA3's intra-warpgroup
//    schedule (the softmax of tile j beside the P V of tile j - 1)
//    gained about 1% at 1024 keys and lost at 128, so it was left out.
//  - What is left at 1024 keys, about 6x the bound: an m64n64k16 with
//    both operands in shared memory reads 4 KB per 32 tensor-core
//    cycles, the SM's whole shared-memory bandwidth, and each tile's S,
//    softmax and P V run one after another.  A wider score tile or Q in
//    registers are the next levers.
//
//  - K and V of different widths (DK, DV), bf16 only: MLA's prefill
//    (minicpm3-4b) attends q and k of width 96 (64 nope + 32 rope) with v
//    of width 64, at 40 heads over 40.  The same body, templated on both
//    widths, at the D = 128 tiling: Q and K tiles are two 64-column boxes
//    whose tensor maps have an inner extent of 96, so TMA zero-fills
//    columns 96-127 in shared memory (no DRAM bytes), and Q K^T skips the
//    k16 steps that lie wholly in them: it computes the 96 columns and no
//    more.  V is one 64-column box and O one 64-column accumulator, stored
//    as is.  The f32 body takes DK = DV only.
//
// float32 (prefill_kernel_simt): the CUDA cores, picked by dtype alone.
// The tensor cores have no f32 path that keeps f32 numerics (TF32 keeps
// 10 mantissa bits), so f32 stays exact here.  Q, K, V tiles are staged
// as float; each thread computes a 4 x 8 tile of scores and a 4 x (D / 8)
// tile of the output with register blocking.
#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kSimtThreads = 128;   // 16 row groups x 8 column groups
constexpr int kSimtBQ = 64;
constexpr int kSimtBK = 64;

template <int D>
constexpr size_t simt_smem_bytes() {
    return sizeof(float) *
           (D * kSimtBQ + D * kSimtBK + kSimtBK * D + kSimtBK * kSimtBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kSimtThreads)
prefill_kernel_simt(const T* __restrict__ q,   // (B, Lq, Hq, D), pre-scaled
                    const T* __restrict__ k,   // (B, Lk, Hkv, D)
                    const T* __restrict__ v,
                    T* __restrict__ out,       // (B, Lq, Hq, D)
                    int Lq, int Lk, int Hq, int Hkv, int causal, int window,
                    int q_offset) {
    constexpr int kBQ = kSimtBQ, kBK = kSimtBK, kThreads = kSimtThreads;
    extern __shared__ __align__(16) float smem[];
    float* q_s = smem;               // D x kBQ (transposed)
    float* k_s = q_s + D * kBQ;      // D x kBK (transposed)
    float* v_s = k_s + D * kBK;      // kBK x D
    float* p_s = v_s + kBK * D;      // kBK x kBQ (transposed)

    const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (Hq / Hkv);
    const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
    const int q0 = qb * kBQ;
    constexpr int kVec = Vec16<T>::N;
    constexpr int kChunks = D / kVec;
    constexpr int kDV = D / 8;       // output columns per thread

    const long long q_row = static_cast<long long>(Hq) * D;
    const long long kv_row = static_cast<long long>(Hkv) * D;
    const T* qbase = q + static_cast<long long>(b) * Lq * q_row +
                     static_cast<long long>(h) * D;
    const T* kbase = k + static_cast<long long>(b) * Lk * kv_row +
                     static_cast<long long>(hk) * D;
    const T* vbase = v + static_cast<long long>(b) * Lk * kv_row +
                     static_cast<long long>(hk) * D;

    for (int c = tid; c < kBQ * kChunks; c += kThreads) {
        const int r = c % kBQ, col = (c / kBQ) * kVec;
        float f[kVec];
        if (q0 + r < Lq) {
            load16(qbase + (q0 + r) * q_row + col, f);
        } else {
#pragma unroll
            for (int i = 0; i < kVec; ++i) f[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < kVec; ++i) q_s[(col + i) * kBQ + r] = f[i];
    }

    float m_r[4], l_r[4], o[4][kDV];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m_r[i] = REPRO_NEG_INF;
        l_r[i] = 0.f;
#pragma unroll
        for (int c = 0; c < kDV; ++c) o[i][c] = 0.f;
    }

    // the KV rows any query row of this block may attend
    const int q_last = min(q0 + kBQ, Lq) - 1;
    int kv_end = Lk;
    if (causal) kv_end = min(kv_end, q_offset + q_last + 1);
    int kv_start = 0;
    if (window > 0) kv_start = max(0, q_offset + q0 - window + 1);

    for (int k0 = kv_start; k0 < kv_end; k0 += kBK) {
        __syncthreads();   // q_s staged; the previous tile's readers done
        for (int c = tid; c < kBK * kChunks; c += kThreads) {
            const int r = c % kBK, col = (c / kBK) * kVec;
            float f[kVec];
            if (k0 + r < Lk) {
                load16(kbase + (k0 + r) * kv_row + col, f);
            } else {
#pragma unroll
                for (int i = 0; i < kVec; ++i) f[i] = 0.f;
            }
#pragma unroll
            for (int i = 0; i < kVec; ++i) k_s[(col + i) * kBK + r] = f[i];
        }
        for (int c = tid; c < kBK * kChunks; c += kThreads) {
            const int r = c / kChunks, col = (c % kChunks) * kVec;
            float f[kVec];
            if (k0 + r < Lk) {
                load16(vbase + (k0 + r) * kv_row + col, f);
            } else {
#pragma unroll
                for (int i = 0; i < kVec; ++i) f[i] = 0.f;
            }
#pragma unroll
            for (int i = 0; i < kVec; ++i) v_s[r * D + col + i] = f[i];
        }
        __syncthreads();

        // scores: rows ty * 4 + i, kv columns tx * 8 + j
        float sc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
            const float4 qa =
                *reinterpret_cast<const float4*>(q_s + d * kBQ + ty * 4);
            const float4 k_lo =
                *reinterpret_cast<const float4*>(k_s + d * kBK + tx * 8);
            const float4 k_hi =
                *reinterpret_cast<const float4*>(k_s + d * kBK + tx * 8 + 4);
            const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
            const float kv[8] = {k_lo.x, k_lo.y, k_lo.z, k_lo.w,
                                 k_hi.x, k_hi.y, k_hi.z, k_hi.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        }

        // mask + online softmax; a row's 64 columns live in 8 lanes
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qpos = q_offset + q0 + ty * 4 + i;
            bool ok[8];
            float mx = REPRO_NEG_INF;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int kpos = k0 + tx * 8 + j;
                ok[j] = kpos < Lk && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
                if (!ok[j]) sc[i][j] = REPRO_NEG_INF;
                mx = fmaxf(mx, sc[i][j]);
            }
#pragma unroll
            for (int o_ = 1; o_ < 8; o_ <<= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
            const float m_new = fmaxf(m_r[i], mx);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                sc[i][j] = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
                sum += sc[i][j];
            }
#pragma unroll
            for (int o_ = 1; o_ < 8; o_ <<= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, o_);
            const float alpha = expf(m_r[i] - m_new);
            l_r[i] = l_r[i] * alpha + sum;
            m_r[i] = m_new;
#pragma unroll
            for (int c = 0; c < kDV; ++c) o[i][c] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            *reinterpret_cast<float4*>(p_s + (tx * 8 + j) * kBQ + ty * 4) =
                make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
        }
        __syncthreads();

        // O += P V: rows ty * 4 + i, output columns tx * kDV + c
#pragma unroll 4
        for (int j = 0; j < kBK; ++j) {
            const float4 pa =
                *reinterpret_cast<const float4*>(p_s + j * kBQ + ty * 4);
            const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
            const float* vr = v_s + j * D + tx * kDV;
#pragma unroll
            for (int c4 = 0; c4 < kDV; c4 += 4) {
                const float4 vv = *reinterpret_cast<const float4*>(vr + c4);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    o[i][c4 + 0] = fmaf(pv[i], vv.x, o[i][c4 + 0]);
                    o[i][c4 + 1] = fmaf(pv[i], vv.y, o[i][c4 + 1]);
                    o[i][c4 + 2] = fmaf(pv[i], vv.z, o[i][c4 + 2]);
                    o[i][c4 + 3] = fmaf(pv[i], vv.w, o[i][c4 + 3]);
                }
            }
        }
    }

    T* obase = out + static_cast<long long>(b) * Lq * q_row +
               static_cast<long long>(h) * D;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        if (row >= Lq) continue;
        const float den = fmaxf(l_r[i], 1e-30f);
#pragma unroll
        for (int c = 0; c < kDV; ++c)
            obase[row * q_row + tx * kDV + c] = from_float<T>(o[i][c] / den);
    }
}

template <int D>
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        void* out, int B, int Lq, int Lk, int Hq, int Hkv,
                        int causal, int window, int q_offset,
                        cudaStream_t stream) {
    auto kernel = prefill_kernel_simt<float, D>;
    constexpr size_t smem = simt_smem_bytes<D>();
    // opt in to more than 48 KB of dynamic shared memory, once per kernel
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return attr;
    dim3 grid((Lq + kSimtBQ - 1) / kSimtBQ, Hq, B);
    kernel<<<grid, kSimtThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), Lq, Lk, Hq,
        Hkv, causal, window, q_offset);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), fed by TMA
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;                    // query rows per CTA: one wgmma M
constexpr int kBK = 64;                    // keys per tile
constexpr int kStages = 2;                 // K/V slots in the ring
constexpr int kThreads = 128 + 32;         // consumer warpgroup + producer
constexpr int kBox = 64 * 128;             // one 64-row x 64-column bf16 box
constexpr float kLog2e = 1.4426950408889634f;

// A row of D columns is ceil(D / 64) boxes of 64; at D = 160 (and at
// MLA's DK = 96) the last box's last 32 columns lie past the tensor, so
// TMA fills them with zeros: they add 0 to Q K^T and give output columns
// that are never written.  Two CTAs share an SM up to D = 128; at 160 and
// 256 the tiles take more than half of its shared memory, and the minimum
// of one block lets a thread keep the wider O (128 f32 registers at D =
// 256).  Q and K have DK columns, V and O DV.
template <int DK, int DV>
struct TcShape {
    static constexpr int kHalves = (DK + 63) / 64;  // Q / K boxes a row
    static constexpr int kHalvesV = (DV + 63) / 64; // V boxes, O blocks
    static constexpr int kQBytes = kHalves * kBox;   // the Q tile
    static constexpr int kKBytes = kHalves * kBox;   // one K tile
    static constexpr int kVBytes = kHalvesV * kBox;  // one V tile
    static constexpr int kTileBytes =
        kQBytes + kStages * (kKBytes + kVBytes);
    // barriers: q_full; k_full, v_full, k_empty, v_empty per stage
    static constexpr int kBarBytes = 8 * (1 + 4 * kStages);
    // + 1024 so the tiles can start on a 1024-byte boundary
    static constexpr size_t kSmem = kTileBytes + kBarBytes + 1024;
    static constexpr int kMinBlocks = kHalves <= 2 ? 2 : 1;
    // S as one chain a box, added in f32 (see the S loop)
    static constexpr bool kSplitS = kHalves >= 4;
};

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, TcShape<DK, DV>::kMinBlocks)
prefill_kernel_tc(const __grid_constant__ CUtensorMap tq,   // (B,Lq,Hq,DK)
                  const __grid_constant__ CUtensorMap tk,   // (B,Lk,Hkv,DK)
                  const __grid_constant__ CUtensorMap tv,   // (B,Lk,Hkv,DV)
                  __nv_bfloat16* __restrict__ out,          // (B,Lq,Hq,DV)
                  int Lq, int Lk, int Hq, int Hkv, int causal, int window,
                  int q_offset) {
    using S = TcShape<DK, DV>;
    constexpr int kHalves = S::kHalves;
    constexpr int kHalvesV = S::kHalvesV;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = hopper::smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    const uint32_t q_s = base;                              // [half]
    const uint32_t k_s = base + S::kQBytes;                 // [stage][half]
    const uint32_t v_s = k_s + kStages * S::kKBytes;        // [stage][half]
    const uint32_t bars = base + S::kTileBytes;
    const uint32_t q_full = bars;
    auto k_full = [&](int s) { return bars + 8u * (1 + s); };
    auto v_full = [&](int s) { return bars + 8u * (1 + kStages + s); };
    auto k_empty = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };
    auto v_empty = [&](int s) { return bars + 8u * (1 + 3 * kStages + s); };

    const int h = blockIdx.x, b = blockIdx.y;
    const int qb = gridDim.z - 1 - blockIdx.z;     // heaviest blocks first
    const int hk = h / (Hq / Hkv);
    const int q0 = qb * kBQ;
    const int tid = threadIdx.x;

    // the KV rows any query row of this block may attend
    const int q_last = min(q0 + kBQ, Lq) - 1;
    int kv_end = Lk;
    if (causal) kv_end = min(kv_end, q_offset + q_last + 1);
    int kv_start = 0;
    if (window > 0) kv_start = max(0, q_offset + q0 - window + 1);
    const int n_tiles =
        kv_end > kv_start ? (kv_end - kv_start + kBK - 1) / kBK : 0;

    if (tid == 0) {
        hopper::mbar_init(q_full, 1);
        for (int s = 0; s < kStages; ++s) {
            hopper::mbar_init(k_full(s), 1);
            hopper::mbar_init(v_full(s), 1);
            hopper::mbar_init(k_empty(s), 128);
            hopper::mbar_init(v_empty(s), 128);
        }
        hopper::fence_barrier_init();
    }
    __syncthreads();

    if (tid >= 128) {
        // ---- producer: one thread issues every TMA load ----
        if (tid != 128) return;
        hopper::mbar_arrive_expect_tx(q_full, S::kQBytes);
        for (int hf = 0; hf < kHalves; ++hf)
            hopper::tma_load_4d(q_s + hf * kBox, &tq, q_full, hf * 64, h, q0,
                                b);
        for (int j = 0; j < n_tiles; ++j) {
            const int s = j % kStages;
            const uint32_t ph = (j / kStages) & 1;
            const int k0 = kv_start + j * kBK;
            hopper::mbar_wait(k_empty(s), ph ^ 1);  // slot s's K was read
            hopper::mbar_arrive_expect_tx(k_full(s), S::kKBytes);
            for (int hf = 0; hf < kHalves; ++hf)
                hopper::tma_load_4d(k_s + (s * kHalves + hf) * kBox, &tk,
                                    k_full(s), hf * 64, hk, k0, b);
            hopper::mbar_wait(v_empty(s), ph ^ 1);
            hopper::mbar_arrive_expect_tx(v_full(s), S::kVBytes);
            for (int hf = 0; hf < kHalvesV; ++hf)
                hopper::tma_load_4d(v_s + (s * kHalvesV + hf) * kBox, &tv,
                                    v_full(s), hf * 64, hk, k0, b);
        }
        return;
    }

    // ---- consumers: one warpgroup, query rows q0 .. q0 + 63 ----
    const int warp = tid / 32, lane = tid % 32;
    const int r0 = warp * 16 + lane / 4;          // and r0 + 8
    const int c0 = 2 * (lane % 4);                // and c0 + 1, in each n8
    const int qpos0 = q_offset + q0;              // absolute position of q0

    float o[kHalvesV][32];
#pragma unroll
    for (int hf = 0; hf < kHalvesV; ++hf)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[hf][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};          // base-2 running max
    float l[2] = {0.f, 0.f};                      // this thread's share

    hopper::mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t ph = (j / kStages) & 1;
        const int k0 = kv_start + j * kBK;

        // S = Q K^T over DK in steps of 16 (32 bytes within a 128-byte
        // row); steps wholly in a box's zero-filled columns are skipped.
        // At DK = 256 each 64-column box is a chain of its own (boxes 0
        // and 1 in flight together, then 2 and 3 in turn), added in f32
        // as each completes: the tensor core adds a step's products to
        // the running sum aligned to the larger and drops the bits
        // shifted out, and one chain of 16 steps over a large score (a K
        // of std 64: scores in the thousands) drifts past the tolerance
        // of the exact result (recurrentgemma-9b's windowed layers)
        float sc[32], sc2[S::kSplitS ? 32 : 1];
        hopper::mbar_wait(k_full(s), ph);
        hopper::fence_regs(sc);
        hopper::wgmma_fence();
        if constexpr (S::kSplitS) {
            auto box = [&](float (&acc)[32], int hf) {
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    hopper::wgmma_m64n64k16_ss(
                        acc, hopper::desc_sw128(q_s + hf * kBox + kk * 32,
                                                16, 1024),
                        hopper::desc_sw128(k_s + (s * kHalves + hf) * kBox +
                                           kk * 32, 16, 1024),
                        kk > 0);
            };
            hopper::fence_regs(sc2);
            box(sc, 0);
            box(sc2, 1);
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
#pragma unroll
            for (int hf = 2; hf <= kHalves; ++hf) {
                hopper::fence_regs(sc);
                hopper::fence_regs(sc2);
#pragma unroll
                for (int i = 0; i < 32; ++i) sc[i] += sc2[i];
                if (hf == kHalves) break;
                hopper::fence_regs(sc2);
                hopper::wgmma_fence();
                box(sc2, hf);
                hopper::wgmma_commit();
                hopper::wgmma_wait<0>();
            }
        } else {
#pragma unroll
            for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    if (hf * 64 + kk * 16 < DK)
                        hopper::wgmma_m64n64k16_ss(
                            sc, hopper::desc_sw128(q_s + hf * kBox + kk * 32,
                                                   16, 1024),
                            hopper::desc_sw128(k_s + (s * kHalves + hf) *
                                               kBox + kk * 32, 16, 1024),
                            hf + kk > 0);
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_regs(sc);
        }
        hopper::mbar_arrive(k_empty(s));          // K slot s read

#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] *= kLog2e;
        const bool need_mask =
            k0 + kBK > Lk || (causal && k0 + kBK - 1 > qpos0) ||
            (window > 0 && k0 <= qpos0 + 63 - window);
        if (need_mask) {
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                const int kpos = k0 + (i / 4) * 8 + c0 + (i % 2);
                const int qpos = qpos0 + r0 + 8 * ((i / 2) % 2);
                const bool ok = kpos < Lk && (!causal || kpos <= qpos) &&
                                (window <= 0 || kpos > qpos - window);
                if (!ok) sc[i] = -INFINITY;
            }
        }

        // online softmax on rows r0 (register half 0) and r0 + 8 (half 1),
        // whose 64 scores live in the 4 lanes of a quad
        float mx[2] = {m[0], m[1]}, m_use[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 32; ++i)
            mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            // a row with no valid key yet keeps p = 0, never NaN
            m_use[r] = mx[r] == -INFINITY ? 0.f : mx[r];
            alpha[r] = exp2f(m[r] - m_use[r]);
            m[r] = mx[r];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            sc[i] = exp2f(sc[i] - m_use[(i / 2) % 2]);
            sum[(i / 2) % 2] += sc[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
        for (int hf = 0; hf < kHalvesV; ++hf)
#pragma unroll
            for (int i = 0; i < 32; ++i) o[hf][i] *= alpha[(i / 2) % 2];

        // P as bf16 A fragments, one per 16 keys, in two terms: hi in
        // pa, lo in pl
        uint32_t pa[4][4], pl[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int x = 0; x < 4; ++x)
                split_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1],
                           pa[kk][x], pl[kk][x]);

        // O += P V over the tile's keys in steps of 16 (2048 bytes)
        hopper::mbar_wait(v_full(s), ph);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            hopper::fence_regs(pa[kk]);
            hopper::fence_regs(pl[kk]);
        }
#pragma unroll
        for (int hf = 0; hf < kHalvesV; ++hf) hopper::fence_regs(o[hf]);
        hopper::wgmma_fence();
#pragma unroll
        for (int hf = 0; hf < kHalvesV; ++hf)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const uint64_t vd = hopper::desc_sw128(
                    v_s + (s * kHalvesV + hf) * kBox + kk * 2048, kBox,
                    1024);
                hopper::wgmma_m64n64k16_rs_tb(o[hf], pa[kk], vd);
                hopper::wgmma_m64n64k16_rs_tb(o[hf], pl[kk], vd);
            }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int hf = 0; hf < kHalvesV; ++hf) hopper::fence_regs(o[hf]);
        hopper::mbar_arrive(v_empty(s));          // V slot s read
    }

    // epilogue: rows r0 and r0 + 8, divided by max(l, 1e-30)
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    const long long o_row = static_cast<long long>(Hq) * DV;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = q0 + r0 + 8 * r;
        if (row >= Lq) continue;
        __nv_bfloat16* orow = out + (static_cast<long long>(b) * Lq + row) *
                                        o_row + static_cast<long long>(h) * DV;
#pragma unroll
        for (int hf = 0; hf < kHalvesV; ++hf)
#pragma unroll
            for (int n8 = 0; n8 < 8; ++n8) {
                if (hf * 64 + n8 * 8 >= DV) continue;   // padding columns
                const int i = 4 * n8 + 2 * r;
                *reinterpret_cast<__nv_bfloat162*>(
                    orow + hf * 64 + n8 * 8 + c0) =
                    __floats2bfloat162_rn(o[hf][i] * inv[r],
                                          o[hf][i + 1] * inv[r]);
            }
    }
}

// cuTensorMapEncodeTiled, looked up in libcuda through the CUDA runtime
// (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(p)
                   : nullptr;
    }();
    return fn;
}

// A (B, L, H, D) bf16 tensor as 64-column x 64-row boxes of one head,
// in the 128-byte swizzle; rows past L read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int B, int L, int H, int D) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                                static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(L),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {   // bytes, of dims 1..3
        static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(H) * D * 2,
        static_cast<cuuint64_t>(L) * H * D * 2};
    const cuuint32_t box[4] = {64, 1, 64, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DK, int DV = DK>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      int B, int Lq, int Lk, int Hq, int Hkv, int causal,
                      int window, int q_offset, cudaStream_t stream) {
    using S = TcShape<DK, DV>;
    auto kernel = prefill_kernel_tc<DK, DV>;
    // opt in to more than 48 KB of dynamic shared memory, once per kernel
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::kSmem));
    if (attr != cudaSuccess) return attr;
    CUtensorMap tq, tk, tv;
    if (!make_map(&tq, q, B, Lq, Hq, DK) ||
        !make_map(&tk, k, B, Lk, Hkv, DK) || !make_map(&tv, v, B, Lk, Hkv, DV))
        return cudaErrorInvalidValue;
    dim3 grid(Hq, B, (Lq + kBQ - 1) / kBQ);
    kernel<<<grid, kThreads, S::kSmem, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(out), Lq, Lk, Hq, Hkv, causal,
        window, q_offset);
    return cudaGetLastError();
}

// bf16 (tensor cores) or f32 (CUDA cores) at one of the head dims
template <bool kBf16, typename... Args>
cudaError_t launch_d(int D, Args... args) {
    switch (D) {
        case 64: return kBf16 ? launch_tc<64>(args...)
                              : launch_simt<64>(args...);
        case 128: return kBf16 ? launch_tc<128>(args...)
                               : launch_simt<128>(args...);
        case 160: return kBf16 ? launch_tc<160>(args...)
                               : launch_simt<160>(args...);
        case 256: return kBf16 ? launch_tc<256>(args...)
                               : launch_simt<256>(args...);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// q (B, Lq, Hq, D), k (B, Lk, Hkv, D), v (B, Lk, Hkv, Dv) and out (B, Lq,
// Hq, Dv), contiguous.  Dv = D, or (D, Dv) = (96, 64) in bf16.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, int B, int Lq, int Lk, int Hq,
                             int Hkv, int D, int Dv, int causal, int window,
                             int q_offset, int dtype, void* stream) {
    if (B < 1 || Lq < 1 || Lk < 1 || Hkv < 1 || Hq % Hkv != 0 ||
        B > 65535 || (Lq + 63) / 64 > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (Dv != D) {
        if (dtype == REPRO_DTYPE_BF16 && D == 96 && Dv == 64)
            return static_cast<int>(launch_tc<96, 64>(
                q, k, v, out, B, Lq, Lk, Hq, Hkv, causal, window, q_offset,
                st));
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (dtype == REPRO_DTYPE_BF16)
        return static_cast<int>(launch_d<true>(
            D, q, k, v, out, B, Lq, Lk, Hq, Hkv, causal, window, q_offset,
            st));
    if (dtype == REPRO_DTYPE_F32)
        return static_cast<int>(launch_d<false>(
            D, q, k, v, out, B, Lq, Lk, Hq, Hkv, causal, window, q_offset,
            st));
    return static_cast<int>(cudaErrorInvalidValue);
}
