// Split-KV flash-decode partials for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_decode.py::_decode_kernel, launched
// by flash_decode_partials (pallas_call at flash_decode.py:135).
//
// What bounds it: bytes.  A decode step reads every resident K and V
// row of the cache once (2 * L * Hkv * D * 2 bytes in bf16) and does
// 4 * G * D flops per row, about 4 flops per byte at G = 8: far below
// the ~295 flops per byte where an H100 stops being memory-bound.  At
// the paper's low-head-count shapes the real limit is worse than the
// bytes: B * Hkv CTAs cannot keep 132 SMs streaming, which is what the
// split count S is for.
//
// Design:
//  - One CTA per (split s, kv head h, batch b), so the grid is exactly
//    B * Hkv * S CTAs: the plan's num_splits is the paper's variable and
//    is launched as given.
//  - The kernel computes its own split bounds in 128-row KV blocks, as
//    FA3 does: NB = ceil(nblk / S), split s covers blocks
//    [s * NB, min((s + 1) * NB, nblk)).  No padded copy of the cache.
//  - The cache is read through a strided view (batch and row strides are
//    arguments), so the caller passes k[:, :bucket] of the
//    (B, max_len, Hkv, D) cache without a copy.
//  - kv_len is clamped to the view length; rows at or past it are never
//    loaded, so the loop ends where the resident rows end.
//  - The G query heads of one KV head are packed: K and V rows are
//    staged once in shared memory (64 rows per step, 16-byte coalesced
//    loads, up to 8 per thread in flight) and reused by all G rows.
//    Scores are register-blocked (one K row against 4 query rows per
//    thread, float4 shared-memory reads); f32 running (m, l, acc) per row.
//  - A split with no valid row writes m = -1e30, l = 0, acc = 0, never
//    -inf, so the combine never computes -inf - -inf.
// Tensor cores, TMA and a multi-stage pipeline are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlockN = 128;   // KV_BLOCK: split bounds are counted in these
constexpr int kTile = 64;      // rows staged in shared memory per step
constexpr int kMaxG = 16;      // query heads per KV head
constexpr int kGB = 4;         // query rows per thread in the score phase

// K rows are padded to D + 4 floats: 16-byte aligned, and the float4
// reads of 8 consecutive rows fall in distinct banks.
constexpr int kPad = 4;

template <int D>
constexpr size_t smem_bytes() {
    return sizeof(float) *
           (kTile * (D + kPad) + kTile * D + kMaxG * D + kMaxG * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_partials_kernel(const T* __restrict__ q,   // (B, Hkv, G, D) scaled
                       const T* __restrict__ k,   // strided (B, L, Hkv, D)
                       const T* __restrict__ v,
                       const int* __restrict__ kv_len,   // (B,)
                       float* __restrict__ acc_out,      // (S, B, Hkv, G, D)
                       float* __restrict__ l_out,        // (S, B, Hkv, G)
                       float* __restrict__ m_out,        // (S, B, Hkv, G)
                       int B, int Hkv, int G, int L, int S,
                       long long stride_b, long long stride_l) {
    constexpr int KS = D + kPad;
    extern __shared__ __align__(16) float smem[];
    float* k_s = smem;                       // kTile x KS
    float* v_s = k_s + kTile * KS;           // kTile x D
    float* q_s = v_s + kTile * D;            // kMaxG x D (rows >= G zero)
    float* p_s = q_s + kMaxG * D;            // kMaxG x kTile
    __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];

    const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;

    const int nblk = (L + kBlockN - 1) / kBlockN;
    const int nb = (nblk + S - 1) / S;
    const int len = min(max(kv_len[b], 0), L);
    const int row_lo = min(s * nb * kBlockN, L);
    const int row_hi = min(min((s + 1) * nb * kBlockN, L), len);

    const T* qb = q + (static_cast<long long>(b) * Hkv + h) * G * D;
    for (int i = tid; i < kMaxG * D; i += kThreads)
        q_s[i] = i < G * D ? to_float(qb[i]) : 0.f;
    if (tid < kMaxG) {
        m_s[tid] = REPRO_NEG_INF;
        l_s[tid] = 0.f;
    }
    // P V phase: thread owns output column c of rows gs, gs + kGStep, ...
    constexpr int kGStep = kThreads / D;
    constexpr int kAccG = kMaxG / kGStep;
    const int c = tid % D, gs = tid / D;
    float acc[kAccG];
#pragma unroll
    for (int j = 0; j < kAccG; ++j) acc[j] = 0.f;
    __syncthreads();

    const long long head_off = static_cast<long long>(h) * D;
    const T* kb = k + b * stride_b + head_off;
    const T* vb = v + b * stride_b + head_off;
    constexpr int kVec = Vec16<T>::N;
    constexpr int kChunks = D / kVec;        // 16-byte chunks per row
    constexpr int kIters = kTile * kChunks / kThreads;
    constexpr int kBatch = kIters < 8 ? kIters : 8;   // loads in flight
    static_assert(kIters % kBatch == 0, "tile loads must split evenly");

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
                        make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
                    *reinterpret_cast<float4*>(v_s + r * D + col + e) =
                        make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
                }
            }
        }
        __syncthreads();

        // scores: thread handles row r for kGB query rows at a time
        {
            const int r = tid % kTile;
            for (int g0 = (tid / kTile) * kGB; g0 < G;
                 g0 += (kThreads / kTile) * kGB) {
                float a[kGB];
#pragma unroll
                for (int i = 0; i < kGB; ++i) a[i] = 0.f;
                const float* kr = k_s + r * KS;
#pragma unroll 8
                for (int d = 0; d < D; d += 4) {
                    const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
                    for (int i = 0; i < kGB; ++i) {
                        const float4 qv = *reinterpret_cast<const float4*>(
                            q_s + (g0 + i) * D + d);
                        a[i] = fmaf(qv.x, kv.x, a[i]);
                        a[i] = fmaf(qv.y, kv.y, a[i]);
                        a[i] = fmaf(qv.z, kv.z, a[i]);
                        a[i] = fmaf(qv.w, kv.w, a[i]);
                    }
                }
#pragma unroll
                for (int i = 0; i < kGB; ++i)
                    if (g0 + i < G)
                        p_s[(g0 + i) * kTile + r] = r < n ? a[i]
                                                          : REPRO_NEG_INF;
            }
        }
        __syncthreads();

        // online softmax, one warp per query row
        for (int g = warp; g < G; g += kThreads / 32) {
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
        for (int j = 0; j < kAccG; ++j) {
            const int g = gs + j * kGStep;
            if (g < G) acc[j] *= alpha_s[g];
        }
        for (int r = 0; r < n4; r += 4) {
            const float v0 = v_s[r * D + c], v1 = v_s[(r + 1) * D + c];
            const float v2 = v_s[(r + 2) * D + c], v3 = v_s[(r + 3) * D + c];
#pragma unroll
            for (int j = 0; j < kAccG; ++j) {
                const int g = gs + j * kGStep;
                if (g < G) {
                    const float4 p =
                        *reinterpret_cast<const float4*>(p_s + g * kTile + r);
                    acc[j] = fmaf(p.x, v0, acc[j]);
                    acc[j] = fmaf(p.y, v1, acc[j]);
                    acc[j] = fmaf(p.z, v2, acc[j]);
                    acc[j] = fmaf(p.w, v3, acc[j]);
                }
            }
        }
        __syncthreads();
    }

    const long long base = ((static_cast<long long>(s) * B + b) * Hkv + h) * G;
#pragma unroll
    for (int j = 0; j < kAccG; ++j) {
        const int g = gs + j * kGStep;
        if (g < G) acc_out[(base + g) * D + c] = acc[j];
    }
    if (tid < G) {
        l_out[base + tid] = l_s[tid];
        m_out[base + tid] = m_s[tid];
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_len, void* acc, void* l, void* m, int B,
                   int Hkv, int G, int L, int S, long long stride_b,
                   long long stride_l, cudaStream_t stream) {
    auto kernel = decode_partials_kernel<T, D>;
    constexpr size_t smem = smem_bytes<D>();
    // opt in to more than 48 KB of dynamic shared memory, once per kernel
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return attr;
    dim3 grid(S, Hkv, B);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(kv_len),
        static_cast<float*>(acc), static_cast<float*>(l),
        static_cast<float*>(m), B, Hkv, G, L, S, stride_b, stride_l);
    return cudaGetLastError();
}

}  // namespace

extern "C" int flash_decode_partials(const void* q, const void* k,
                                     const void* v, const void* kv_len,
                                     void* acc, void* l, void* m, int B,
                                     int Hkv, int G, int L, int S, int D,
                                     long long stride_b, long long stride_l,
                                     int dtype, void* stream) {
    if (G < 1 || G > kMaxG || S < 1 || L < 1 || B < 1 || Hkv < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == REPRO_DTYPE_BF16 && D == 128)
        return launch<__nv_bfloat16, 128>(q, k, v, kv_len, acc, l, m, B, Hkv,
                                          G, L, S, stride_b, stride_l, st);
    if (dtype == REPRO_DTYPE_BF16 && D == 64)
        return launch<__nv_bfloat16, 64>(q, k, v, kv_len, acc, l, m, B, Hkv,
                                         G, L, S, stride_b, stride_l, st);
    if (dtype == REPRO_DTYPE_F32 && D == 128)
        return launch<float, 128>(q, k, v, kv_len, acc, l, m, B, Hkv, G, L,
                                  S, stride_b, stride_l, st);
    if (dtype == REPRO_DTYPE_F32 && D == 64)
        return launch<float, 64>(q, k, v, kv_len, acc, l, m, B, Hkv, G, L, S,
                                 stride_b, stride_l, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
