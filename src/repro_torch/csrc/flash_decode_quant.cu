// Split-KV flash-decode partials over a quantized KV cache, for Hopper
// (sm_90a): int8 or fp8 (e4m3) K/V with one f32 scale per (row, head),
// dequantized in registers.
//
// Replaces: src/repro/kernels/flash_decode.py::_decode_quant_kernel,
// launched by flash_decode_quant_partials (pallas_call at
// flash_decode.py:296).
//
// What bounds it: bytes, as for the bf16 kernel (csrc/flash_decode.cu),
// at half the bytes: 1 byte per K/V element plus a 4-byte scale per
// (row, head), 2 * L * Hkv * (D + 4) bytes a step.  At the paper's
// low-head-count shapes the grid (B * Hkv * S CTAs) and the latency of
// each CTA's loop bound it before the bytes do.
//
// Design: the bf16 kernel's, with two type parameters, TQ for the query
// (f32 or bf16) and T for the K/V storage (int8_t or __nv_fp8_e4m3):
//  - One CTA per (split s, kv head h, batch b); FA3's split bounds in
//    128-row blocks, computed in the kernel over a strided bucket view.
//  - A 16-byte load carries 16 elements.  Each staged 64-row tile issues
//    its K and V loads and its rows' two scales together; the scales go
//    to shared memory once per row, and every element is widened as
//    float(x) * scale into the f32 tile, the reference's dequantization
//    (Quantizer.dequantize) bit for bit.
//  - The scales have their own batch and row strides, so the caller
//    passes k_s[:, :bucket] of the (B, max_len, Hkv) scale cache in place.
//  - Rows at or past kv_len are never loaded, data or scale, so a
//    poisoned tail (data 127, scale 1e4) never reaches the output.
//  - A split with no valid row writes m = -1e30, l = 0, acc = 0.
// The score, online-softmax and P V phases are the bf16 kernel's.  It
// has its own file so that kernel's code and times stay as they were.
// Tensor cores, TMA and a multi-stage pipeline are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlockN = 128;   // KV_BLOCK: split bounds are counted in these
constexpr int kTile = 64;      // rows staged in shared memory per step
constexpr int kMaxG = 16;      // query heads per KV head
constexpr int kGB = 4;         // query rows per thread in the score phase
constexpr int kPad = 4;        // K rows padded to D + 4 floats (banks)

static_assert(kTile <= kThreads, "one thread stages each row's scales");

template <int D>
constexpr size_t smem_bytes() {
    return sizeof(float) *
           (kTile * (D + kPad) + kTile * D + kMaxG * D + kMaxG * kTile);
}

template <typename TQ, typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_quant_partials_kernel(
        const TQ* __restrict__ q,        // (B, Hkv, G, D) scaled
        const T* __restrict__ k,         // strided (B, L, Hkv, D)
        const T* __restrict__ v,
        const float* __restrict__ k_scale,   // strided (B, L, Hkv)
        const float* __restrict__ v_scale,
        const int* __restrict__ kv_len,      // (B,)
        float* __restrict__ acc_out,         // (S, B, Hkv, G, D)
        float* __restrict__ l_out,           // (S, B, Hkv, G)
        float* __restrict__ m_out,           // (S, B, Hkv, G)
        int B, int Hkv, int G, int L, int S,
        long long stride_b, long long stride_l,
        long long sstride_b, long long sstride_l) {
    constexpr int KS = D + kPad;
    extern __shared__ __align__(16) float smem[];
    float* k_s = smem;                       // kTile x KS
    float* v_s = k_s + kTile * KS;           // kTile x D
    float* q_s = v_s + kTile * D;            // kMaxG x D (rows >= G zero)
    float* p_s = q_s + kMaxG * D;            // kMaxG x kTile
    __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];
    __shared__ float ksc_s[kTile], vsc_s[kTile];   // the tile's scales

    const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;

    const int nblk = (L + kBlockN - 1) / kBlockN;
    const int nb = (nblk + S - 1) / S;
    const int len = min(max(kv_len[b], 0), L);
    const int row_lo = min(s * nb * kBlockN, L);
    const int row_hi = min(min((s + 1) * nb * kBlockN, L), len);

    const TQ* qb = q + (static_cast<long long>(b) * Hkv + h) * G * D;
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
    const float* ksb = k_scale + b * sstride_b + h;
    const float* vsb = v_scale + b * sstride_b + h;
    constexpr int kVec = Vec16<T>::N;        // 16 one-byte elements
    constexpr int kChunks = D / kVec;        // 16-byte chunks per row
    constexpr int kIters = kTile * kChunks / kThreads;
    static_assert(kIters >= 1 && kIters <= 8,
                  "a tile's loads are issued in one batch");

    for (int r0 = row_lo; r0 < row_hi; r0 += kTile) {
        const int n = min(kTile, row_hi - r0);
        // every load of the tile in flight at once: K, V and the scales
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
                    make_float4(kf[e] * ks, kf[e + 1] * ks, kf[e + 2] * ks,
                                kf[e + 3] * ks);
                *reinterpret_cast<float4*>(v_s + r * D + col + e) =
                    make_float4(vf[e] * vs, vf[e + 1] * vs, vf[e + 2] * vs,
                                vf[e + 3] * vs);
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
                const float* krow = k_s + r * KS;
#pragma unroll 8
                for (int d = 0; d < D; d += 4) {
                    const float4 kv =
                        *reinterpret_cast<const float4*>(krow + d);
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

struct Args {
    const void *q, *k, *v, *k_scale, *v_scale, *kv_len;
    void *acc, *l, *m;
    int B, Hkv, G, L, S;
    long long stride_b, stride_l, sstride_b, sstride_l;
    cudaStream_t stream;
};

template <typename TQ, typename T, int D>
cudaError_t launch(const Args& a) {
    auto kernel = decode_quant_partials_kernel<TQ, T, D>;
    constexpr size_t smem = smem_bytes<D>();
    // opt in to more than 48 KB of dynamic shared memory, once per kernel
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return attr;
    dim3 grid(a.S, a.Hkv, a.B);
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const TQ*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const float*>(a.k_scale),
        static_cast<const float*>(a.v_scale),
        static_cast<const int*>(a.kv_len), static_cast<float*>(a.acc),
        static_cast<float*>(a.l), static_cast<float*>(a.m), a.B, a.Hkv, a.G,
        a.L, a.S, a.stride_b, a.stride_l, a.sstride_b, a.sstride_l);
    return cudaGetLastError();
}

template <typename TQ, typename T>
cudaError_t launch_d(const Args& a, int D) {
    if (D == 128) return launch<TQ, T, 128>(a);
    if (D == 64) return launch<TQ, T, 64>(a);
    return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t launch_kv(const Args& a, int D, int kv_dtype) {
    if (kv_dtype == REPRO_DTYPE_INT8) return launch_d<TQ, int8_t>(a, D);
    if (kv_dtype == REPRO_DTYPE_FP8) return launch_d<TQ, __nv_fp8_e4m3>(a, D);
    return cudaErrorInvalidValue;
}

}  // namespace

// q in q_dtype (REPRO_DTYPE_F32 or _BF16); k and v in kv_dtype
// (REPRO_DTYPE_INT8 or _FP8); f32 scales.  Strides are in elements.
extern "C" int flash_decode_quant_partials(
        const void* q, const void* k, const void* v, const void* k_scale,
        const void* v_scale, const void* kv_len, void* acc, void* l,
        void* m, int B, int Hkv, int G, int L, int S, int D,
        long long stride_b, long long stride_l, long long sstride_b,
        long long sstride_l, int q_dtype, int kv_dtype, void* stream) {
    if (G < 1 || G > kMaxG || S < 1 || L < 1 || B < 1 || Hkv < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{q, k, v, k_scale, v_scale, kv_len, acc, l, m, B, Hkv, G,
                 L, S, stride_b, stride_l, sstride_b, sstride_l,
                 static_cast<cudaStream_t>(stream)};
    if (q_dtype == REPRO_DTYPE_BF16)
        return static_cast<int>(launch_kv<__nv_bfloat16>(a, D, kv_dtype));
    if (q_dtype == REPRO_DTYPE_F32)
        return static_cast<int>(launch_kv<float>(a, D, kv_dtype));
    return static_cast<int>(cudaErrorInvalidValue);
}
