// Backward of the prefill attention (K3b): dq, dk and dv of
// out = softmax(q k^T, masked) v, for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The reference trains through
// ref.flash_attention_xla (src/repro/kernels/ref.py:97), a blocked flash
// attention in plain JAX whose gradient XLA derives; none of its Pallas
// kernels has a backward.  The port runs attention's forward on the
// prefill kernel (csrc/flash_prefill.cu, which also writes the per-row
// log-sum-exp), and this is the gradient of that function.
//
// Inputs: q (B, Lq, Hq, DK) already scaled by DK ** -0.5, k (B, Lk, Hkv,
// DK), v (B, Lk, Hkv, DV), the forward's output o (B, Lq, Hq, DV), dout of
// o's shape, and the forward's lse (B, Hq, Lq) f32 in the natural-log base
// (+inf on a row with no valid key, so its P is 0).  Outputs: dq (for the
// scaled q), dk and dv in q's dtype, and delta = rowsum(dout * o) (B, Hq,
// Lq) f32, which the second launch reads.  Masks are the forward's: kpos <
// Lk, kpos <= qpos when causal, kpos > qpos - window when windowed, with
// qpos = q_offset + q row.
//
// Arithmetic, all f32: S = q k^T recomputed, P = exp(S - lse), dP = dout
// v^T, dS = P (dP - delta); dq = dS k, dk = dS^T q, dv = P^T dout.
//
// Two launches, no atomics, so the bits repeat from run to run:
//  1. dq: one CTA per (b, query head, block of T query rows).  It writes
//     delta for its rows first, then walks the key tiles inside the
//     causal / window bound and keeps dq in registers.
//  2. dk, dv: one CTA per (b, KV head, 32 keys).  It walks the G query
//     heads of its group and, for each, the query tiles that can see its
//     keys, summing their contributions in registers.  The heaviest CTAs
//     (the first keys under a causal mask) start first.
//
// What bounds it: operations.  The gradient costs about 2.5 times the
// forward's products (five of the forward's size against two), 2.5 * 4 *
// Hq * DK * Lq * Lk / 2 flops under a causal mask: at the training cell
// (B 2, L 1024, 16 / 2 heads, D 128) 21.5 GFLOP, 0.022 ms at 989 TFLOP/s
// bf16.  This first version runs on the CUDA cores in f32 (bf16 inputs
// are widened as they are staged in shared memory), so it is bound by the
// CUDA cores' FMA rate and by shared-memory reads, far from the tensor
// cores' bound: every tile is staged row-major with an odd row stride
// (width + 1 floats), so the strided column reads of a thread block are
// free of bank conflicts, and each thread keeps a small register tile of
// every product.  Tensor cores (wgmma) and TMA are the next step.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // 16 row groups x 16 column groups
constexpr int kBK2 = 32;        // keys per CTA of the dk / dv launch

// Query rows per tile (and keys per tile of the dq launch): 64, or 32 at
// widths above 160, where four 64-row tiles overflow shared memory.
template <int DK, int DV>
struct BwdShape {
    static constexpr int kT = (DK > 160 || DV > 160) ? 32 : 64;
    static constexpr int LQ = DK + 1;      // row strides in floats
    static constexpr int LV = DV + 1;
    static constexpr int LS = kT + 1;
    static constexpr size_t kSmemDq = sizeof(float) *
        (2 * kT * LQ + 2 * kT * LV + kT * LS + 2 * kT);
    static constexpr size_t kSmemDkv = sizeof(float) *
        (kBK2 * LQ + kBK2 * LV + kT * LQ + kT * LV + 2 * kBK2 * LS + 2 * kT);
};

// Rows [r0, r0 + rows) of a (L, ...) tensor whose row stride is `stride`
// elements, W columns from `src`, widened to float into `dst` (row stride
// ld); rows at or past L read as 0.
template <typename T, int W>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long stride, int r0, int L,
                                          int rows) {
    constexpr int N = Vec16<T>::N, C = W / N;
    for (int c = threadIdx.x; c < rows * C; c += kThreads) {
        const int r = c / C, col = (c % C) * N;
        float f[N];
        if (r0 + r < L) {
            load16(src + static_cast<long long>(r0 + r) * stride + col, f);
        } else {
#pragma unroll
            for (int i = 0; i < N; ++i) f[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < N; ++i) dst[r * ld + col + i] = f[i];
    }
}

// acc[i][j] += sum_{r < R} A[(row0 + i) * lda + r] * B(r, tx + 16 j), with
// B(r, c) = B[c * ldb + r] when kBT, else B[r * ldb + c].
template <int RM, int RN, int R, bool kBT>
__device__ __forceinline__ void mm(float (&acc)[RM][RN], const float* A,
                                   int lda, const float* B, int ldb,
                                   int row0, int tx) {
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
        float a[RM], b[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = A[(row0 + i) * lda + r];
#pragma unroll
        for (int j = 0; j < RN; ++j)
            b[j] = kBT ? B[(tx + 16 * j) * ldb + r] : B[r * ldb + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
}

template <int RM, int RN>
__device__ __forceinline__ void zero(float (&acc)[RM][RN]) {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int Lk,
                                        int causal, int window) {
    return kpos < Lk && (!causal || kpos <= qpos) &&
           (window <= 0 || kpos > qpos - window);
}

// ---- launch 1: dq and delta ------------------------------------------------

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dout, const float* __restrict__ lse,
              T* __restrict__ dq, float* __restrict__ delta, int Lq, int Lk,
              int Hq, int Hkv, int causal, int window, int q_offset) {
    using S = BwdShape<DK, DV>;
    constexpr int kT = S::kT, LQ = S::LQ, LV = S::LV, LS = S::LS;
    constexpr int RM = kT / 16, RN = kT / 16;
    extern __shared__ __align__(16) float smem[];
    float* q_s = smem;                  // kT x LQ
    float* do_s = q_s + kT * LQ;        // kT x LV
    float* k_s = do_s + kT * LV;        // kT x LQ
    float* v_s = k_s + kT * LQ;         // kT x LV
    float* ds_s = v_s + kT * LV;        // kT x LS
    float* lse_s = ds_s + kT * LS;      // kT
    float* dl_s = lse_s + kT;           // kT

    const int qb = gridDim.x - 1 - blockIdx.x;   // heaviest blocks first
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (Hq / Hkv);
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    const int warp = tid / 32, lane = tid % 32;
    const int q0 = qb * kT;

    const long long q_row = static_cast<long long>(Hq) * DK;
    const long long o_row = static_cast<long long>(Hq) * DV;
    const long long k_row = static_cast<long long>(Hkv) * DK;
    const long long v_row = static_cast<long long>(Hkv) * DV;
    const long long q_at = static_cast<long long>(b) * Lq * q_row + h * DK;
    const long long o_at = static_cast<long long>(b) * Lq * o_row + h * DV;
    const T* kbase = k + static_cast<long long>(b) * Lk * k_row + hk * DK;
    const T* vbase = v + static_cast<long long>(b) * Lk * v_row + hk * DV;
    const long long stat = (static_cast<long long>(b) * Hq + h) * Lq;

    load_rows<T, DK>(q_s, LQ, q + q_at, q_row, q0, Lq, kT);
    load_rows<T, DV>(do_s, LV, dout + o_at, o_row, q0, Lq, kT);
    __syncthreads();
    // delta = rowsum(dout * o), a warp a row
    for (int r = warp; r < kT; r += kThreads / 32) {
        const bool in = q0 + r < Lq;
        float s = 0.f;
        if (in) {
            const T* orow = o + o_at + (q0 + r) * o_row;
            for (int c = lane; c < DV; c += 32)
                s = fmaf(do_s[r * LV + c], to_float(orow[c]), s);
        }
        s = warp_sum(s);
        if (lane == 0) {
            dl_s[r] = s;
            lse_s[r] = in ? lse[stat + q0 + r] : INFINITY;
            if (in) delta[stat + q0 + r] = s;
        }
    }

    float acc[RM][DK / 16];
    zero(acc);
    const int q_last = min(q0 + kT, Lq) - 1;
    int kv_end = Lk;
    if (causal) kv_end = min(kv_end, q_offset + q_last + 1);
    int kv_start = 0;
    if (window > 0) kv_start = max(0, q_offset + q0 - window + 1);

    for (int k0 = kv_start; k0 < kv_end; k0 += kT) {
        __syncthreads();   // q, dout, stats staged; last tile's readers done
        load_rows<T, DK>(k_s, LQ, kbase, k_row, k0, Lk, kT);
        load_rows<T, DV>(v_s, LV, vbase, v_row, k0, Lk, kT);
        __syncthreads();
        float s[RM][RN], dp[RM][RN];
        zero(s);
        zero(dp);
        mm<RM, RN, DK, true>(s, q_s, LQ, k_s, LQ, ty * RM, tx);
        mm<RM, RN, DV, true>(dp, do_s, LV, v_s, LV, ty * RM, tx);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            const int r = ty * RM + i;
            const int qpos = q_offset + q0 + r;
#pragma unroll
            for (int j = 0; j < RN; ++j) {
                const int c = tx + 16 * j;
                const float p = visible(k0 + c, qpos, Lk, causal, window)
                                    ? expf(s[i][j] - lse_s[r])
                                    : 0.f;
                ds_s[r * LS + c] = p * (dp[i][j] - dl_s[r]);
            }
        }
        __syncthreads();
        mm<RM, DK / 16, kT, false>(acc, ds_s, LS, k_s, LQ, ty * RM, tx);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int row = q0 + ty * RM + i;
        if (row >= Lq) continue;
        T* dst = dq + q_at + row * q_row;
#pragma unroll
        for (int j = 0; j < DK / 16; ++j)
            dst[tx + 16 * j] = from_float<T>(acc[i][j]);
    }
}

// ---- launch 2: dk and dv ---------------------------------------------------

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int Lq, int Lk, int Hq, int Hkv,
                int causal, int window, int q_offset) {
    using S = BwdShape<DK, DV>;
    constexpr int kT = S::kT, LQ = S::LQ, LV = S::LV, LS = S::LS;
    constexpr int RM = kBK2 / 16, RN = kT / 16;
    extern __shared__ __align__(16) float smem[];
    float* k_s = smem;                  // kBK2 x LQ
    float* v_s = k_s + kBK2 * LQ;       // kBK2 x LV
    float* q_s = v_s + kBK2 * LV;       // kT x LQ
    float* do_s = q_s + kT * LQ;        // kT x LV
    float* pt_s = do_s + kT * LV;       // kBK2 x LS: P^T
    float* dst_s = pt_s + kBK2 * LS;    // kBK2 x LS: dS^T
    float* lse_s = dst_s + kBK2 * LS;   // kT
    float* dl_s = lse_s + kT;           // kT

    const int hk = blockIdx.y, b = blockIdx.z;
    const int G = Hq / Hkv;
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    const int k0 = blockIdx.x * kBK2;

    const long long q_row = static_cast<long long>(Hq) * DK;
    const long long o_row = static_cast<long long>(Hq) * DV;
    const long long k_row = static_cast<long long>(Hkv) * DK;
    const long long v_row = static_cast<long long>(Hkv) * DV;
    const long long k_at = static_cast<long long>(b) * Lk * k_row + hk * DK;
    const long long v_at = static_cast<long long>(b) * Lk * v_row + hk * DV;
    load_rows<T, DK>(k_s, LQ, k + k_at, k_row, k0, Lk, kBK2);
    load_rows<T, DV>(v_s, LV, v + v_at, v_row, k0, Lk, kBK2);

    float dk_acc[RM][DK / 16], dv_acc[RM][DV / 16];
    zero(dk_acc);
    zero(dv_acc);

    // the query rows that can see a key of this block
    const int k_last = min(k0 + kBK2, Lk) - 1;
    const int q_lo = causal ? max(0, k0 - q_offset) : 0;
    const int q_hi = window > 0 ? min(Lq, k_last + window - q_offset) : Lq;
    const int q_first = (q_lo / kT) * kT;

    for (int g = 0; g < G; ++g) {
        const int h = hk * G + g;
        const T* qbase = q + static_cast<long long>(b) * Lq * q_row + h * DK;
        const T* dobase =
            dout + static_cast<long long>(b) * Lq * o_row + h * DV;
        const long long stat = (static_cast<long long>(b) * Hq + h) * Lq;
        for (int q0 = q_first; q0 < q_hi; q0 += kT) {
            __syncthreads();   // k, v staged; last tile's readers done
            load_rows<T, DK>(q_s, LQ, qbase, q_row, q0, Lq, kT);
            load_rows<T, DV>(do_s, LV, dobase, o_row, q0, Lq, kT);
            for (int r = tid; r < kT; r += kThreads) {
                const bool in = q0 + r < Lq;
                lse_s[r] = in ? lse[stat + q0 + r] : INFINITY;
                dl_s[r] = in ? delta[stat + q0 + r] : 0.f;
            }
            __syncthreads();
            float s[RM][RN], dp[RM][RN];
            zero(s);
            zero(dp);
            mm<RM, RN, DK, true>(s, k_s, LQ, q_s, LQ, ty * RM, tx);
            mm<RM, RN, DV, true>(dp, v_s, LV, do_s, LV, ty * RM, tx);
#pragma unroll
            for (int i = 0; i < RM; ++i) {
                const int r = ty * RM + i;
#pragma unroll
                for (int j = 0; j < RN; ++j) {
                    const int c = tx + 16 * j;
                    const float p =
                        visible(k0 + r, q_offset + q0 + c, Lk, causal, window)
                            ? expf(s[i][j] - lse_s[c])
                            : 0.f;
                    pt_s[r * LS + c] = p;
                    dst_s[r * LS + c] = p * (dp[i][j] - dl_s[c]);
                }
            }
            __syncthreads();
            mm<RM, DV / 16, kT, false>(dv_acc, pt_s, LS, do_s, LV, ty * RM, tx);
            mm<RM, DK / 16, kT, false>(dk_acc, dst_s, LS, q_s, LQ, ty * RM,
                                       tx);
        }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int row = k0 + ty * RM + i;
        if (row >= Lk) continue;
        T* dkr = dk + k_at + row * k_row;
        T* dvr = dv + v_at + row * v_row;
#pragma unroll
        for (int j = 0; j < DK / 16; ++j)
            dkr[tx + 16 * j] = from_float<T>(dk_acc[i][j]);
#pragma unroll
        for (int j = 0; j < DV / 16; ++j)
            dvr[tx + 16 * j] = from_float<T>(dv_acc[i][j]);
    }
}

template <typename T, int DK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* dq, void* dk,
                   void* dv, void* delta, int B, int Lq, int Lk, int Hq,
                   int Hkv, int causal, int window, int q_offset,
                   cudaStream_t stream) {
    using S = BwdShape<DK, DV>;
    auto k1 = bwd_dq_kernel<T, DK, DV>;
    auto k2 = bwd_dkdv_kernel<T, DK, DV>;
    // opt in to more than 48 KB of dynamic shared memory, once per kernel
    static const cudaError_t a1 = cudaFuncSetAttribute(
        k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::kSmemDq));
    static const cudaError_t a2 = cudaFuncSetAttribute(
        k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::kSmemDkv));
    if (a1 != cudaSuccess) return a1;
    if (a2 != cudaSuccess) return a2;
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    const T* dot = static_cast<const T*>(dout);
    const float* ls = static_cast<const float*>(lse);
    float* dl = static_cast<float*>(delta);
    dim3 g1((Lq + S::kT - 1) / S::kT, Hq, B);
    k1<<<g1, kThreads, S::kSmemDq, stream>>>(
        qt, kt, vt, static_cast<const T*>(o), dot, ls, static_cast<T*>(dq),
        dl, Lq, Lk, Hq, Hkv, causal, window, q_offset);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dim3 g2((Lk + kBK2 - 1) / kBK2, Hkv, B);
    k2<<<g2, kThreads, S::kSmemDkv, stream>>>(
        qt, kt, vt, dot, ls, dl, static_cast<T*>(dk), static_cast<T*>(dv),
        Lq, Lk, Hq, Hkv, causal, window, q_offset);
    return cudaGetLastError();
}

template <typename T, typename... Args>
cudaError_t launch_widths(int D, int Dv, Args... args) {
    if (D == 96 && Dv == 64) return launch<T, 96, 64>(args...);
    if (D != Dv) return cudaErrorInvalidValue;
    switch (D) {
        case 64: return launch<T, 64, 64>(args...);
        case 128: return launch<T, 128, 128>(args...);
        case 160: return launch<T, 160, 160>(args...);
        case 256: return launch<T, 256, 256>(args...);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv contiguous, shaped as in the header; lse
// and delta (B, Hq, Lq) f32.  (D, Dv) in (64, 64), (128, 128), (160, 160),
// (256, 256), (96, 64); dtype f32 or bf16.  Two kernel launches.
extern "C" int flash_prefill_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* dq, void* dk,
                                 void* dv, void* delta, int B, int Lq,
                                 int Lk, int Hq, int Hkv, int D, int Dv,
                                 int causal, int window, int q_offset,
                                 int dtype, void* stream) {
    if (B < 1 || Lq < 1 || Lk < 1 || Hkv < 1 || Hq % Hkv != 0 ||
        B > 65535 || Hq > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == REPRO_DTYPE_BF16)
        return static_cast<int>(launch_widths<__nv_bfloat16>(
            D, Dv, q, k, v, o, dout, lse, dq, dk, dv, delta, B, Lq, Lk, Hq,
            Hkv, causal, window, q_offset, st));
    if (dtype == REPRO_DTYPE_F32)
        return static_cast<int>(launch_widths<float>(
            D, Dv, q, k, v, o, dout, lse, dq, dk, dv, delta, B, Lq, Lk, Hq,
            Hkv, causal, window, q_offset, st));
    return static_cast<int>(cudaErrorInvalidValue);
}
