// Causal flash-attention forward (prefill) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_prefill.py::_prefill_kernel, launched
// by flash_prefill (pallas_call at flash_prefill.py:133).
//
// What bounds it: operations.  A causal prompt of L tokens costs
// 4 * Hq * D * L * L / 2 flops against 2 * L * (Hq + 2 * Hkv) * D * 2
// bytes of Q, K, V and output, hundreds of flops per byte once L reaches
// a few hundred tokens.
//
// Design:
//  - One CTA per (64-row q block, q head h, batch b); the GQA KV head is
//    h / (Hq / Hkv), so K and V are never replicated in memory.
//  - The KV loop is bounded by the causal limit, and by the window when
//    one is given: tiles above the diagonal or before the window are
//    neither loaded nor computed.  (The Pallas kernel loads them and
//    skips only their flops.)
//  - Masks: kpos < Lk, kpos <= qpos, kpos > qpos - window, with
//    qpos = q_offset + q row.  q_offset is a runtime int; ragged Lq and
//    Lk are masked here, so the caller pads nothing.
//  - Q, K, V tiles are staged in shared memory as float; each thread
//    computes a 4 x 8 tile of scores and a 4 x (D / 8) tile of the output
//    with register blocking on the CUDA cores.  Online softmax in f32;
//    the output is divided by max(l, 1e-30) as in the reference.
// This runs on the CUDA cores.  wgmma tensor-core tiles fed by TMA are
// the next step for this kernel.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;   // 16 row groups x 8 column groups
constexpr int kBQ = 64;
constexpr int kBK = 64;

template <int D>
constexpr size_t smem_bytes() {
    return sizeof(float) * (D * kBQ + D * kBK + kBK * D + kBK * kBQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const T* __restrict__ q,   // (B, Lq, Hq, D), pre-scaled
               const T* __restrict__ k,   // (B, Lk, Hkv, D)
               const T* __restrict__ v,
               T* __restrict__ out,       // (B, Lq, Hq, D)
               int Lq, int Lk, int Hq, int Hkv, int causal, int window,
               int q_offset) {
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Lq, int Lk, int Hq, int Hkv, int causal,
                   int window, int q_offset, cudaStream_t stream) {
    auto kernel = prefill_kernel<T, D>;
    constexpr size_t smem = smem_bytes<D>();
    // opt in to more than 48 KB of dynamic shared memory, once per kernel
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return attr;
    dim3 grid((Lq + kBQ - 1) / kBQ, Hq, B);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), Lq, Lk, Hq, Hkv,
        causal, window, q_offset);
    return cudaGetLastError();
}

}  // namespace

extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, int B, int Lq, int Lk, int Hq,
                             int Hkv, int D, int causal, int window,
                             int q_offset, int dtype, void* stream) {
    if (B < 1 || Lq < 1 || Lk < 1 || Hkv < 1 || Hq % Hkv != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == REPRO_DTYPE_BF16 && D == 128)
        return launch<__nv_bfloat16, 128>(q, k, v, out, B, Lq, Lk, Hq, Hkv,
                                          causal, window, q_offset, st);
    if (dtype == REPRO_DTYPE_BF16 && D == 64)
        return launch<__nv_bfloat16, 64>(q, k, v, out, B, Lq, Lk, Hq, Hkv,
                                         causal, window, q_offset, st);
    if (dtype == REPRO_DTYPE_F32 && D == 128)
        return launch<float, 128>(q, k, v, out, B, Lq, Lk, Hq, Hkv, causal,
                                  window, q_offset, st);
    if (dtype == REPRO_DTYPE_F32 && D == 64)
        return launch<float, 64>(q, k, v, out, B, Lq, Lk, Hq, Hkv, causal,
                                 window, q_offset, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
