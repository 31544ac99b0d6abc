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
// scaled q), dk and dv in q's dtype.  Masks are the forward's: kpos < Lk,
// kpos <= qpos when causal, kpos > qpos - window when windowed, with qpos
// = q_offset + q row.  S = q k^T recomputed, P = exp(S - lse), dP = dout
// v^T, dS = P (dP - delta) with delta = rowsum(dout * o); dq = dS k, dk =
// dS^T q, dv = P^T dout.  Two launches, dq first (it also writes delta),
// then dk / dv; no float atomics, so the bits repeat from run to run.
//
// What bounds it: operations.  The gradient costs about 2.5 times the
// forward's products (five of the forward's size against two), 2.5 * 4 *
// Hq * DK * Lq * Lk / 2 flops under a causal mask: at the training cell
// (B 2, L 1024, 16 / 2 heads, D 128) 21.5 GFLOP, 0.022 ms at 989 TFLOP/s
// bf16, against 0.011 ms for its bytes.
//
// bf16 (bwd_dq_tc, bwd_dkdv_tc): every width on the tensor cores.
//  - Tiles of 64 query rows and 64 keys (one wgmma M), 128-byte swizzled
//    TMA boxes of 64 columns (zero-filled past DK = 96 or 160), as the
//    forward's: each of the five products is hopper::wgmma_m64n64k16_ss
//    (both operands K-major in shared memory) or _rs_tb (A in registers,
//    B MN-major through the transpose bit), f32 sums.  Masks only on
//    tiles that cross the diagonal, the window's edge, Lk or Lq.
//  - One warpgroup a CTA, whose thread 0 also issues the TMA loads into
//    a 2-stage ring of mbarrier-completed slots, refilling a slot once
//    the CTA's barrier shows every warp done with it.  A producer warp
//    beside it would make five warps, and two CTAs of five cap a thread
//    at 168 registers (dq spilled there at D 128, dk / dv needs 255);
//    with four warps two CTAs share an SM up to D 128, each computing
//    while the other runs its softmax.
//  - dq: one CTA per (b, query head, 64 query rows), heaviest first.
//    It first writes delta for its rows, and lse * log2(e), to (2, B,
//    Hq, Lq_pad) f32 stats padded to whole tiles (+inf and 0 past Lq, so
//    P is 0 there), while Q and dO arrive once and K and V tiles stream
//    through the ring.  S = Q K^T and dP = dO V^T (ss), P and dS on the
//    accumulator fragment, which is already the A layout, then dQ += dS K
//    (rs_tb: K's tile [key][d] is MN-major here).  The key tiles are the
//    forward's range.
//  - dk / dv: K and V of 64 keys stay in shared memory; the ring streams
//    the (query head of the group, query tile) steps that can see them,
//    each with its Q and dO tiles (TMA) and its 64 lse and delta (bulk
//    copies from the stats).  S^T = K Q^T and dP^T = V dO^T (ss),
//    P^T and dS^T in registers, dV += P^T dO and dK += dS^T Q (rs_tb).
//    One warpgroup holds two 64-column boxes of dK and of dV beside S^T
//    and dP^T (255 registers at D 128).  Wider rows are cut
//    into column groups of two boxes, one CTA each (gridDim.y: 2 at D 160
//    and 256), which all recompute S^T and dP^T over the whole row: about
//    a fifth more tensor work at D 256, and no spill.  (Two consumer
//    warpgroups in one CTA, dK in one and dV in the other, spilled: nine
//    warps cap a thread at 168 registers.)
//  - The sequence-aware split (the paper's policy, applied to this
//    launch).  A CTA a key block leaves the card nearly empty at few KV
//    heads (B 2 x Hkv 2 x 16 blocks = 64 CTAs at the training cell) and
//    makes the causal triangle's first blocks, which every query tile
//    sees, the critical path (16x the last block's steps).  So each key
//    block's walk is cut into chunks of at most T steps, T the largest
//    length whose chunks still give every SM a CTA (132 CTAs of at most
//    43 steps at the training cell, against one of 128).  The table of
//    chunks, one row a CTA (kWorkInts), is computed on the host
//    (kernels/flash_prefill.py, dkdv_split) from the shape, the mask and
//    the device's SM count.  A key block of one chunk writes bf16; else
//    each chunk writes its f32 dK / dV partial to a workspace, takes a
//    ticket from the key block's counter (an integer atomic), and the
//    CTA that arrives last sums the partials in chunk order, past L1,
//    writes bf16 and resets the counter: the same bits whichever chunk
//    finishes last.
//  - Precision: P and dS enter the products as one bf16 term each (the
//    forward carries P V's P as two; split_bf16's two terms would double
//    those products).  The outputs round to bf16 anyway, and one term
//    kept every check on the card: dq, dk, dv about a quarter of the 1e-2
//    normwise tolerance on random data, every layer of the full-width
//    model's step under a third, and the whole-gradient check's worst
//    leaf where the CUDA-core body left it.  At D 256 the score chains are one chain over
//    the row (the forward's per-box chains guard scores in the thousands,
//    which training does not meet at that width).
//  - What bounds it now: each 64 x 64 step runs its products one after
//    another (S, dP; then dQ or dK and dV) with no overlap of a step's
//    softmax and its own products: only a second CTA on the SM fills
//    that gap, and past D 128 there is none; the dk / dv split's last
//    chunks merge partials while other SMs idle.
//
// float32 (bwd_dq_kernel, bwd_dkdv_kernel): the CUDA cores, picked by
// dtype alone.  The tensor cores have no f32 path that keeps f32 numerics.
// 256 threads a CTA keep a small register tile of every product; every
// tile is staged row-major with an odd row stride (width + 1 floats), so
// the strided column reads are free of bank conflicts.
//  1. dq: one CTA per (b, query head, block of T query rows).  It writes
//     delta for its rows first, then walks the key tiles inside the
//     causal / window bound and keeps dq in registers.
//  2. dk, dv: one CTA per (b, KV head, 32 keys).  It walks the G query
//     heads of its group and, for each, the query tiles that can see its
//     keys, summing their contributions in registers.
#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

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
cudaError_t launch_simt(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* dq, void* dk, void* dv, void* delta, int B,
                        int Lq, int Lk, int Hq, int Hkv, int causal,
                        int window, int q_offset, cudaStream_t stream) {
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
    if (D == 96 && Dv == 64) return launch_simt<T, 96, 64>(args...);
    if (D != Dv) return cudaErrorInvalidValue;
    switch (D) {
        case 64: return launch_simt<T, 64, 64>(args...);
        case 128: return launch_simt<T, 128, 128>(args...);
        case 160: return launch_simt<T, 160, 160>(args...);
        case 256: return launch_simt<T, 256, 256>(args...);
        default: return cudaErrorInvalidValue;
    }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), fed by TMA
// ---------------------------------------------------------------------------

constexpr int kTile = 64;                  // query rows / keys a tile: one M
constexpr int kTcStages = 2;               // ring depth
constexpr int kBox = 64 * 128;             // one 64-row x 64-column bf16 box
constexpr int kStatBytes = kTile * 4;      // one tile's lse or delta (f32)
constexpr int kThreadsTc = 128;            // one warpgroup, no producer warp
constexpr float kLog2e = 1.4426950408889634f;
// One row of the dk / dv launch's work table (kernels/flash_prefill.py
// ``dkdv_split``), one CTA a row: b * Hkv + KV head, key block, its first
// query tile and query-tile count, the chunk's steps [i0, i1) of the key
// block's walk (step i: query head g = i / n_qt of the group, query tile
// first + i % n_qt), the key block's first partial slot (-1 with one
// chunk), this chunk's index and the key block's chunk count.
constexpr int kWorkInts = 9;

// A row of DK (DV) columns is ceil(DK / 64) boxes of 64; at DK = 96 and
// 160 the last box's columns past the tensor are zero-filled by TMA.
template <int DK, int DV>
struct TcBwd {
    static constexpr int kHalves = (DK + 63) / 64;   // Q / K boxes a row
    static constexpr int kHalvesV = (DV + 63) / 64;  // dO / V boxes a row
    static constexpr int kQBytes = kHalves * kBox;    // a Q or K tile
    static constexpr int kVBytes = kHalvesV * kBox;   // a dO or V tile
    // dq launch: Q and dO resident, K and V through the ring
    static constexpr int kDqTiles = (1 + kTcStages) * (kQBytes + kVBytes);
    // barriers: qd_full; k_full, v_full per stage
    static constexpr size_t kDqSmem = kDqTiles + 8 * (1 + 2 * kTcStages)
                                      + 1024;   // tiles 1024-byte aligned
    // dk / dv launch: K and V resident; Q, dO and the tile's lse and
    // delta through the ring.  dK and dV take 32 f32 registers a thread
    // for each 64-column box; beside S^T and dP^T one warpgroup holds two
    // boxes of each, so wider rows are cut into column groups of two
    // boxes, one CTA each (gridDim.y), which all recompute S^T and dP^T
    // over the whole row.
    static constexpr int kKvTiles = (1 + kTcStages) * (kQBytes + kVBytes);
    static constexpr int kGroupK = kHalves < 2 ? kHalves : 2;
    static constexpr int kGroupV = kHalvesV < 2 ? kHalvesV : 2;
    static constexpr int kColumnGroups =
        (kHalves + 1) / 2 > (kHalvesV + 1) / 2 ? (kHalves + 1) / 2
                                               : (kHalvesV + 1) / 2;
    // + stats (lse, delta) a stage; barriers kv_full and full a stage;
    // the merge's ticket
    static constexpr size_t kKvSmem = kKvTiles + kTcStages * 2 * kStatBytes
                                      + 8 * (1 + kTcStages) + 16 + 1024;
    // CTAs an SM: two where two fit in its 228 KB of shared memory (each
    // also holds 1 KB for the system), up to D 128
    static constexpr int kDqBlocks = 2 * (kDqSmem + 1024) <= 233472 ? 2 : 1;
    static constexpr int kKvBlocks = 2 * (kKvSmem + 1024) <= 233472 ? 2 : 1;
    // f32 partial floats a consumer thread, a column group
    static constexpr int kPartFloats = 32 * (kGroupK + kGroupV);
};

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// ---- launch 1: dq, and each row's lse * log2(e) and delta ----------------

template <int DK, int DV>
__global__ void __launch_bounds__(kThreadsTc, TcBwd<DK, DV>::kDqBlocks)
bwd_dq_tc(const __grid_constant__ CUtensorMap tq,    // (B, Lq, Hq, DK)
          const __grid_constant__ CUtensorMap tk,    // (B, Lk, Hkv, DK)
          const __grid_constant__ CUtensorMap tv,    // (B, Lk, Hkv, DV)
          const __grid_constant__ CUtensorMap tdo,   // (B, Lq, Hq, DV)
          const __nv_bfloat16* __restrict__ o,
          const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse,             // (B, Hq, Lq)
          __nv_bfloat16* __restrict__ dq,            // (B, Lq, Hq, DK)
          float* __restrict__ stats,                 // (2, B, Hq, Lq_pad)
          int B, int Lq, int Lk, int Hq, int Hkv, int causal, int window,
          int q_offset) {
    using S = TcBwd<DK, DV>;
    constexpr int kHalves = S::kHalves, kHalvesV = S::kHalvesV;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = hopper::smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    const uint32_t q_s = base;                           // [half]
    const uint32_t do_s = q_s + S::kQBytes;              // [half]
    const uint32_t k_s = do_s + S::kVBytes;              // [stage][half]
    const uint32_t v_s = k_s + kTcStages * S::kQBytes;   // [stage][half]
    const uint32_t bars = base + S::kDqTiles;
    const uint32_t qd_full = bars;
    auto k_full = [&](int s) { return bars + 8u * (1 + s); };
    auto v_full = [&](int s) { return bars + 8u * (1 + kTcStages + s); };

    const int h = blockIdx.x, b = blockIdx.y;
    const int qb = gridDim.z - 1 - blockIdx.z;     // heaviest blocks first
    const int hk = h / (Hq / Hkv);
    const int q0 = qb * kTile;
    const int tid = threadIdx.x;

    // the keys any query row of this block may attend, as in the forward
    const int q_last = min(q0 + kTile, Lq) - 1;
    int kv_end = Lk;
    if (causal) kv_end = min(kv_end, q_offset + q_last + 1);
    int kv_start = 0;
    if (window > 0) kv_start = max(0, q_offset + q0 - window + 1);
    const int n_tiles =
        kv_end > kv_start ? (kv_end - kv_start + kTile - 1) / kTile : 0;

    // K and V tile j into slot j % kTcStages, issued by thread 0
    auto load_kv = [&](int j) {
        const int s = j % kTcStages, k0 = kv_start + j * kTile;
        hopper::mbar_arrive_expect_tx(k_full(s), S::kQBytes);
        for (int hf = 0; hf < kHalves; ++hf)
            hopper::tma_load_4d(k_s + (s * kHalves + hf) * kBox, &tk,
                                k_full(s), hf * 64, hk, k0, b);
        hopper::mbar_arrive_expect_tx(v_full(s), S::kVBytes);
        for (int hf = 0; hf < kHalvesV; ++hf)
            hopper::tma_load_4d(v_s + (s * kHalvesV + hf) * kBox, &tv,
                                v_full(s), hf * 64, hk, k0, b);
    };
    if (tid == 0) {
        hopper::mbar_init(qd_full, 1);
        for (int s = 0; s < kTcStages; ++s) {
            hopper::mbar_init(k_full(s), 1);
            hopper::mbar_init(v_full(s), 1);
        }
        hopper::fence_barrier_init();
        hopper::mbar_arrive_expect_tx(qd_full, S::kQBytes + S::kVBytes);
        for (int hf = 0; hf < kHalves; ++hf)
            hopper::tma_load_4d(q_s + hf * kBox, &tq, qd_full, hf * 64, h,
                                q0, b);
        for (int hf = 0; hf < kHalvesV; ++hf)
            hopper::tma_load_4d(do_s + hf * kBox, &tdo, qd_full, hf * 64, h,
                                q0, b);
        for (int j = 0; j < kTcStages && j < n_tiles; ++j) load_kv(j);
    }
    __syncthreads();

    // ---- the warpgroup: query rows q0 .. q0 + 63 ----
    const int warp = tid / 32, lane = tid % 32;
    const int r0 = warp * 16 + lane / 4;          // and r0 + 8
    const int c0 = 2 * (lane % 4);                // and c0 + 1, in each n8
    const int qpos0 = q_offset + q0;

    // delta = rowsum(dout * o) for rows r0 and r0 + 8, the 4 lanes of a
    // quad a quarter of the columns each; with lse * log2(e) written to
    // the padded stats the dk / dv launch reads (+inf and 0 past Lq,
    // where P is then 0)
    const int Lq_pad = gridDim.z * kTile;
    const long long plane = static_cast<long long>(B) * Hq * Lq_pad;
    const long long stat = (static_cast<long long>(b) * Hq + h) * Lq_pad;
    const long long o_row = static_cast<long long>(Hq) * DV;
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = q0 + r0 + 8 * r;
        float s = 0.f;
        if (row < Lq) {
            const long long at = (static_cast<long long>(b) * Lq + row) *
                                 o_row + static_cast<long long>(h) * DV;
            for (int c = (lane % 4) * 8; c < DV; c += 32) {
                float a[8], d[8];
                load16(o + at + c, a);
                load16(dout + at + c, d);
#pragma unroll
                for (int i = 0; i < 8; ++i) s = fmaf(a[i], d[i], s);
            }
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        dl[r] = s;
        lse2[r] = row < Lq
            ? lse[(static_cast<long long>(b) * Hq + h) * Lq + row] * kLog2e
            : INFINITY;
        if (lane % 4 == 0) {
            stats[stat + q0 + r0 + 8 * r] = lse2[r];
            stats[plane + stat + q0 + r0 + 8 * r] = s;
        }
    }

    float acc[kHalves][32];
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[hf][i] = 0.f;

    hopper::mbar_wait(qd_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kTcStages;
        const uint32_t ph = (j / kTcStages) & 1;
        const int k0 = kv_start + j * kTile;

        // S = Q K^T and dP = dO V^T, both operands K-major; the k16 steps
        // wholly in a box's zero-filled columns are skipped
        float sc[32], dp[32];
        hopper::mbar_wait(k_full(s), ph);
        hopper::fence_regs(sc);
        hopper::wgmma_fence();
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                if (hf * 64 + kk * 16 < DK)
                    hopper::wgmma_m64n64k16_ss(
                        sc, hopper::desc_sw128(q_s + hf * kBox + kk * 32, 16,
                                               1024),
                        hopper::desc_sw128(k_s + (s * kHalves + hf) * kBox +
                                           kk * 32, 16, 1024),
                        hf + kk > 0);
        hopper::wgmma_commit();
        hopper::mbar_wait(v_full(s), ph);
        hopper::fence_regs(dp);
        hopper::wgmma_fence();
#pragma unroll
        for (int hf = 0; hf < kHalvesV; ++hf)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                if (hf * 64 + kk * 16 < DV)
                    hopper::wgmma_m64n64k16_ss(
                        dp, hopper::desc_sw128(do_s + hf * kBox + kk * 32, 16,
                                               1024),
                        hopper::desc_sw128(v_s + (s * kHalvesV + hf) * kBox +
                                           kk * 32, 16, 1024),
                        hf + kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        hopper::fence_regs(dp);

        // P = exp(S - lse), dS = P (dP - delta) on the fragment; masks
        // only on tiles that cross the diagonal, the window's edge or Lk
        const bool need_mask =
            k0 + kTile > Lk || (causal && k0 + kTile - 1 > qpos0) ||
            (window > 0 && k0 <= qpos0 + kTile - 1 - window);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
            const int r = (i / 2) % 2;
            float p = exp2f(fmaf(sc[i], kLog2e, -lse2[r]));
            if (need_mask &&
                !visible(k0 + (i / 4) * 8 + c0 + (i % 2), qpos0 + r0 + 8 * r,
                         Lk, causal, window))
                p = 0.f;
            sc[i] = p * (dp[i] - dl[r]);
        }
        // dS as bf16 A fragments, one per 16 keys
        uint32_t ds[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int x = 0; x < 4; ++x)
                ds[kk][x] = pack_bf16(sc[8 * kk + 2 * x],
                                      sc[8 * kk + 2 * x + 1]);

        // dQ += dS K: K's tile is [key][d], MN-major for this product,
        // read through the transpose bit
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(ds[kk]);
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) hopper::fence_regs(acc[hf]);
        hopper::wgmma_fence();
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                hopper::wgmma_m64n64k16_rs_tb(
                    acc[hf], ds[kk],
                    hopper::desc_sw128(k_s + (s * kHalves + hf) * kBox +
                                       kk * 2048, kBox, 1024));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) hopper::fence_regs(acc[hf]);
        __syncthreads();          // every warp is done with slot s
        if (tid == 0 && j + kTcStages < n_tiles) load_kv(j + kTcStages);
    }

    const long long q_row = static_cast<long long>(Hq) * DK;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = q0 + r0 + 8 * r;
        if (row >= Lq) continue;
        __nv_bfloat16* dst = dq + (static_cast<long long>(b) * Lq + row) *
                                      q_row + static_cast<long long>(h) * DK;
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
            for (int n8 = 0; n8 < 8; ++n8) {
                if (hf * 64 + n8 * 8 >= DK) continue;   // padding columns
                const int i = 4 * n8 + 2 * r;
                *reinterpret_cast<__nv_bfloat162*>(dst + hf * 64 + n8 * 8 +
                                                   c0) =
                    __floats2bfloat162_rn(acc[hf][i], acc[hf][i + 1]);
            }
    }
}

// ---- launch 2: dk and dv ---------------------------------------------------

template <int DK, int DV>
__global__ void __launch_bounds__(kThreadsTc, TcBwd<DK, DV>::kKvBlocks)
bwd_dkdv_tc(const __grid_constant__ CUtensorMap tq,    // (B, Lq, Hq, DK)
            const __grid_constant__ CUtensorMap tk,    // (B, Lk, Hkv, DK)
            const __grid_constant__ CUtensorMap tv,    // (B, Lk, Hkv, DV)
            const __grid_constant__ CUtensorMap tdo,   // (B, Lq, Hq, DV)
            const float* __restrict__ stats,           // (2, B, Hq, Lq_pad)
            const int* __restrict__ work,              // kWorkInts a CTA
            float* __restrict__ part, int* __restrict__ counters,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            int B, int Lq, int Lk, int Hq, int Hkv, int causal, int window,
            int q_offset) {
    using S = TcBwd<DK, DV>;
    constexpr int kHalves = S::kHalves, kHalvesV = S::kHalvesV;
    constexpr int NK = S::kGroupK, NV = S::kGroupV;
    constexpr int kStage = S::kQBytes + S::kVBytes;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = hopper::smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    const uint32_t k_s = base;                           // [half]
    const uint32_t v_s = k_s + S::kQBytes;               // [half]
    const uint32_t q_s0 = v_s + S::kVBytes;              // [stage]: Q, dO
    const uint32_t stat_s = base + S::kKvTiles;          // [stage]: lse, dl
    const uint32_t bars = stat_s + kTcStages * 2 * kStatBytes;
    const uint32_t kv_full = bars;
    auto full = [&](int s) { return bars + 8u * (1 + s); };
    const float* stat_g =
        reinterpret_cast<const float*>(smem_raw + (stat_s - raw));
    int* ticket = reinterpret_cast<int*>(
        smem_raw + (bars + 8u * (1 + kTcStages) - raw));

    const int* w = work + static_cast<long long>(kWorkInts) * blockIdx.x;
    const int bh = w[0], b = bh / Hkv, hk = bh % Hkv, k0 = w[1] * kTile;
    const int qt_lo = w[2], n_qt = w[3], i0 = w[4], i1 = w[5];
    const int slot0 = w[6], j = w[7], chunks = w[8];
    const int cg = blockIdx.y;                     // column group
    const int G = Hq / Hkv;
    const int tid = threadIdx.x;

    // step i's Q and dO tiles, lse and delta into its stage, issued by
    // thread 0
    const int Lq_pad = (Lq + kTile - 1) / kTile * kTile;
    const long long plane = static_cast<long long>(B) * Hq * Lq_pad;
    auto load_step = [&](int i) {
        const int st = (i - i0) % kTcStages;
        const int h = hk * G + i / n_qt;
        const int q0 = (qt_lo + i % n_qt) * kTile;
        const uint32_t q_s = q_s0 + st * kStage;
        hopper::mbar_arrive_expect_tx(full(st), kStage + 2 * kStatBytes);
        for (int hf = 0; hf < kHalves; ++hf)
            hopper::tma_load_4d(q_s + hf * kBox, &tq, full(st), hf * 64, h,
                                q0, b);
        for (int hf = 0; hf < kHalvesV; ++hf)
            hopper::tma_load_4d(q_s + S::kQBytes + hf * kBox, &tdo, full(st),
                                hf * 64, h, q0, b);
        const float* src =
            stats + (static_cast<long long>(b) * Hq + h) * Lq_pad + q0;
        const uint32_t dst = stat_s + st * 2 * kStatBytes;
        hopper::bulk_load(dst, src, kStatBytes, full(st));
        hopper::bulk_load(dst + kStatBytes, src + plane, kStatBytes,
                          full(st));
    };
    if (tid == 0) {
        hopper::mbar_init(kv_full, 1);
        for (int s = 0; s < kTcStages; ++s) hopper::mbar_init(full(s), 1);
        hopper::fence_barrier_init();
        hopper::mbar_arrive_expect_tx(kv_full, S::kQBytes + S::kVBytes);
        for (int hf = 0; hf < kHalves; ++hf)
            hopper::tma_load_4d(k_s + hf * kBox, &tk, kv_full, hf * 64, hk,
                                k0, b);
        for (int hf = 0; hf < kHalvesV; ++hf)
            hopper::tma_load_4d(v_s + hf * kBox, &tv, kv_full, hf * 64, hk,
                                k0, b);
        for (int i = i0; i < i1 && i < i0 + kTcStages; ++i) load_step(i);
    }
    __syncthreads();

    // ---- the warpgroup: keys k0 .. k0 + 63, the dK boxes [NK cg, NK cg
    // + NK) and dV boxes [NV cg, NV cg + NV) ----
    const int warp = tid / 32, lane = tid % 32;
    const int r0 = warp * 16 + lane / 4;          // key rows r0, r0 + 8
    const int c0 = 2 * (lane % 4);                // query columns, each n8
    float dka[NK][32], dva[NV][32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
#pragma unroll
        for (int x = 0; x < NK; ++x) dka[x][i] = 0.f;
#pragma unroll
        for (int x = 0; x < NV; ++x) dva[x][i] = 0.f;
    }

    hopper::mbar_wait(kv_full, 0);
    for (int i = i0; i < i1; ++i) {
        const int n = i - i0, st = n % kTcStages;
        const uint32_t ph = (n / kTcStages) & 1;
        const int qpos0 = q_offset + (qt_lo + i % n_qt) * kTile;
        const uint32_t q_s = q_s0 + st * kStage;
        const uint32_t do_s = q_s + S::kQBytes;
        const float* ls = stat_g + st * 2 * kTile;

        // S^T = K Q^T and dP^T = V dO^T over the whole row, both operands
        // K-major; the k16 steps wholly in zero-filled columns are skipped
        float sc[32], dp[32];
        hopper::mbar_wait(full(st), ph);
        hopper::fence_regs(sc);
        hopper::fence_regs(dp);
        hopper::wgmma_fence();
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                if (hf * 64 + kk * 16 < DK)
                    hopper::wgmma_m64n64k16_ss(
                        sc, hopper::desc_sw128(k_s + hf * kBox + kk * 32, 16,
                                               1024),
                        hopper::desc_sw128(q_s + hf * kBox + kk * 32, 16,
                                           1024),
                        hf + kk > 0);
#pragma unroll
        for (int hf = 0; hf < kHalvesV; ++hf)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                if (hf * 64 + kk * 16 < DV)
                    hopper::wgmma_m64n64k16_ss(
                        dp, hopper::desc_sw128(v_s + hf * kBox + kk * 32, 16,
                                               1024),
                        hopper::desc_sw128(do_s + hf * kBox + kk * 32, 16,
                                           1024),
                        hf + kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        hopper::fence_regs(dp);

        // P^T = exp(S^T - lse) and dS^T = P^T (dP^T - delta), a column's
        // lse and delta from the stage's stats (+inf and 0 past Lq);
        // masks only on tiles that cross the diagonal, the window's edge
        // or Lk
        const bool need_mask =
            k0 + kTile > Lk || (causal && k0 + kTile - 1 > qpos0) ||
            (window > 0 && k0 <= qpos0 + kTile - 1 - window);
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
            const float2 l2 =
                *reinterpret_cast<const float2*>(ls + 8 * n8 + c0);
            const float2 d2 =
                *reinterpret_cast<const float2*>(ls + kTile + 8 * n8 + c0);
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int x = 4 * n8 + 2 * r + e;
                    float p = exp2f(fmaf(sc[x], kLog2e, e ? -l2.y : -l2.x));
                    if (need_mask &&
                        !visible(k0 + r0 + 8 * r, qpos0 + 8 * n8 + c0 + e,
                                 Lk, causal, window))
                        p = 0.f;
                    sc[x] = p;
                    dp[x] = p * (dp[x] - (e ? d2.y : d2.x));
                }
        }
        // as bf16 A fragments, one per 16 query rows
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
                pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x],
                                      sc[8 * kk + 2 * x + 1]);
                da[kk][x] = pack_bf16(dp[8 * kk + 2 * x],
                                      dp[8 * kk + 2 * x + 1]);
            }

        // dV += P^T dO and dK += dS^T Q over this CTA's column boxes: the
        // Q and dO tiles are [q][d], MN-major for these products, read
        // through the transpose bit
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            hopper::fence_regs(pa[kk]);
            hopper::fence_regs(da[kk]);
        }
#pragma unroll
        for (int x = 0; x < NV; ++x) hopper::fence_regs(dva[x]);
#pragma unroll
        for (int x = 0; x < NK; ++x) hopper::fence_regs(dka[x]);
        hopper::wgmma_fence();
#pragma unroll
        for (int x = 0; x < NV; ++x)
            if (NV * cg + x < kHalvesV)
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    hopper::wgmma_m64n64k16_rs_tb(
                        dva[x], pa[kk],
                        hopper::desc_sw128(do_s + (NV * cg + x) * kBox +
                                           kk * 2048, kBox, 1024));
#pragma unroll
        for (int x = 0; x < NK; ++x)
            if (NK * cg + x < kHalves)
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    hopper::wgmma_m64n64k16_rs_tb(
                        dka[x], da[kk],
                        hopper::desc_sw128(q_s + (NK * cg + x) * kBox +
                                           kk * 2048, kBox, 1024));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int x = 0; x < NV; ++x) hopper::fence_regs(dva[x]);
#pragma unroll
        for (int x = 0; x < NK; ++x) hopper::fence_regs(dka[x]);
        __syncthreads();          // every warp is done with stage st
        if (tid == 0 && i + kTcStages < i1) load_step(i + kTcStages);
    }

    if (chunks > 1) {
        // this chunk's f32 partial, float4 groups laid out [slot][column
        // group][group][thread] (dK's groups first, then dV's), so a
        // warp's stores and loads are contiguous; then a ticket from the
        // key block's counter
        constexpr int G4 = S::kPartFloats / 4;
        float4* p4 = reinterpret_cast<float4*>(part);
        const int groups = gridDim.y;
        const long long at =
            (static_cast<long long>(slot0 + j) * groups + cg) * G4;
#pragma unroll
        for (int g = 0; g < 8; ++g) {
#pragma unroll
            for (int x = 0; x < NK; ++x)
                p4[(at + x * 8 + g) * 128 + tid] = make_float4(
                    dka[x][4 * g], dka[x][4 * g + 1], dka[x][4 * g + 2],
                    dka[x][4 * g + 3]);
#pragma unroll
            for (int x = 0; x < NV; ++x)
                p4[(at + (NK + x) * 8 + g) * 128 + tid] = make_float4(
                    dva[x][4 * g], dva[x][4 * g + 1], dva[x][4 * g + 2],
                    dva[x][4 * g + 3]);
        }
        int* counter = counters + static_cast<long long>(slot0) * groups + cg;
        __threadfence();          // this thread's partial before the ticket
        __syncthreads();
        if (tid == 0) *ticket = atomicAdd(counter, 1) == chunks - 1;
        __syncthreads();
        if (!*ticket) return;
        __threadfence();          // the other chunks' partials after theirs
        // the key block's partials summed in chunk order, past L1: the
        // same bits whichever chunk arrives last
#pragma unroll
        for (int i = 0; i < 32; ++i) {
#pragma unroll
            for (int x = 0; x < NK; ++x) dka[x][i] = 0.f;
#pragma unroll
            for (int x = 0; x < NV; ++x) dva[x][i] = 0.f;
        }
        for (int ch = 0; ch < chunks; ++ch) {
            const long long src =
                (static_cast<long long>(slot0 + ch) * groups + cg) * G4;
#pragma unroll
            for (int g = 0; g < 8; ++g) {
#pragma unroll
                for (int x = 0; x < NK; ++x) {
                    const float4 y = __ldcg(p4 + (src + x * 8 + g) * 128 +
                                            tid);
                    dka[x][4 * g] += y.x;
                    dka[x][4 * g + 1] += y.y;
                    dka[x][4 * g + 2] += y.z;
                    dka[x][4 * g + 3] += y.w;
                }
#pragma unroll
                for (int x = 0; x < NV; ++x) {
                    const float4 y = __ldcg(p4 + (src + (NK + x) * 8 + g) *
                                            128 + tid);
                    dva[x][4 * g] += y.x;
                    dva[x][4 * g + 1] += y.y;
                    dva[x][4 * g + 2] += y.z;
                    dva[x][4 * g + 3] += y.w;
                }
            }
        }
        if (tid == 0) *counter = 0;               // left at zero
    }

    // rows k0 + r0 and k0 + r0 + 8 of dK and dV, this CTA's columns, bf16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = k0 + r0 + 8 * r;
        if (row >= Lk) continue;
        const long long at = (static_cast<long long>(b) * Lk + row) * Hkv +
                             hk;
        __nv_bfloat16* dkr = dk + at * DK;
        __nv_bfloat16* dvr = dv + at * DV;
#pragma unroll
        for (int x = 0; x < NK; ++x)
#pragma unroll
            for (int n8 = 0; n8 < 8; ++n8) {
                const int col = (NK * cg + x) * 64 + n8 * 8;
                if (col >= DK) continue;           // padding columns
                const int y = 4 * n8 + 2 * r;
                *reinterpret_cast<__nv_bfloat162*>(dkr + col + c0) =
                    __floats2bfloat162_rn(dka[x][y], dka[x][y + 1]);
            }
#pragma unroll
        for (int x = 0; x < NV; ++x)
#pragma unroll
            for (int n8 = 0; n8 < 8; ++n8) {
                const int col = (NV * cg + x) * 64 + n8 * 8;
                if (col >= DV) continue;
                const int y = 4 * n8 + 2 * r;
                *reinterpret_cast<__nv_bfloat162*>(dvr + col + c0) =
                    __floats2bfloat162_rn(dva[x][y], dva[x][y + 1]);
            }
    }
}

template <int DK, int DV>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* lse,
                      void* dq, void* dk, void* dv, void* stats,
                      const void* work, void* part, void* counters, int B,
                      int Lq, int Lk, int Hq, int Hkv, int causal, int window,
                      int q_offset, int n_work, cudaStream_t stream) {
    using S = TcBwd<DK, DV>;
    auto k1 = bwd_dq_tc<DK, DV>;
    auto k2 = bwd_dkdv_tc<DK, DV>;
    // opt in to more than 48 KB of dynamic shared memory, once per kernel
    static const cudaError_t a1 = cudaFuncSetAttribute(
        k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::kDqSmem));
    static const cudaError_t a2 = cudaFuncSetAttribute(
        k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::kKvSmem));
    if (a1 != cudaSuccess) return a1;
    if (a2 != cudaSuccess) return a2;
    if (n_work < 1) return cudaErrorInvalidValue;
    CUtensorMap tq, tk, tv, tdo;
    if (!hopper::make_map(&tq, q, B, Lq, Hq, DK) ||
        !hopper::make_map(&tk, k, B, Lk, Hkv, DK) ||
        !hopper::make_map(&tv, v, B, Lk, Hkv, DV) ||
        !hopper::make_map(&tdo, dout, B, Lq, Hq, DV))
        return cudaErrorInvalidValue;
    using bf16 = __nv_bfloat16;
    dim3 g1(Hq, B, (Lq + kTile - 1) / kTile);
    k1<<<g1, kThreadsTc, S::kDqSmem, stream>>>(
        tq, tk, tv, tdo, static_cast<const bf16*>(o),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<bf16*>(dq), static_cast<float*>(stats), B, Lq, Lk, Hq,
        Hkv, causal, window, q_offset);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dim3 g2(n_work, S::kColumnGroups);
    k2<<<g2, kThreadsTc, S::kKvSmem, stream>>>(
        tq, tk, tv, tdo, static_cast<const float*>(stats),
        static_cast<const int*>(work), static_cast<float*>(part),
        static_cast<int*>(counters), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), B, Lq, Lk, Hq, Hkv, causal, window,
        q_offset);
    return cudaGetLastError();
}

// Registers (as the runtime reports them) and dynamic shared memory of
// both launches at one width: out = {dq registers, dq shared bytes, dk /
// dv registers, dk / dv shared bytes, dk / dv CTAs a chunk, threads a
// CTA, dk / dv CTAs an SM holds at once (the runtime's occupancy)}.
template <typename Dq, typename Dkdv>
cudaError_t attrs(Dq k1, size_t smem1, Dkdv k2, size_t smem2, int ctas,
                  int threads, int* out) {
    cudaFuncAttributes a1, a2;
    int per_sm = 0;
    cudaError_t err = cudaFuncGetAttributes(&a1, k1);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&a2, k2);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem2));
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k2,
                                                            threads, smem2);
    if (err != cudaSuccess) return err;
    const int v[7] = {a1.numRegs, static_cast<int>(smem1), a2.numRegs,
                      static_cast<int>(smem2), ctas, threads, per_sm};
    for (int i = 0; i < 7; ++i) out[i] = v[i];
    return cudaSuccess;
}

template <int DK, int DV>
cudaError_t attrs_tc(int* out) {
    using S = TcBwd<DK, DV>;
    return attrs(bwd_dq_tc<DK, DV>, S::kDqSmem, bwd_dkdv_tc<DK, DV>,
                 S::kKvSmem, S::kColumnGroups, kThreadsTc, out);
}

template <int DK, int DV>
cudaError_t attrs_simt(int* out) {
    using S = BwdShape<DK, DV>;
    return attrs(bwd_dq_kernel<float, DK, DV>, S::kSmemDq,
                 bwd_dkdv_kernel<float, DK, DV>, S::kSmemDkv, 1, kThreads,
                 out);
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv contiguous, shaped as in the header; lse
// (B, Hq, Lq) f32; stats (2, B, Hq, Lq_pad) f32, Lq_pad = Lq rounded up
// to 64 (float32 uses its first B * Hq * Lq as delta).  bf16 only: work,
// the dk / dv launch's n_work rows of kWorkInts ints; part, the f32
// partials of the table's slots (32 * (ceil(D / 64) + ceil(Dv / 64))
// floats a thread of 128, a slot); counters, one int a slot, zero between
// launches.  (D, Dv) in (64, 64), (128, 128), (160, 160), (256, 256),
// (96, 64); dtype f32 or bf16.  Two kernel launches.
extern "C" int flash_prefill_bwd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* dq, void* dk,
                                 void* dv, void* stats, const void* work,
                                 void* part, void* counters, int B, int Lq,
                                 int Lk, int Hq, int Hkv, int D, int Dv,
                                 int causal, int window, int q_offset,
                                 int n_work, int dtype, void* stream) {
    if (B < 1 || Lq < 1 || Lk < 1 || Hkv < 1 || Hq % Hkv != 0 ||
        B > 65535 || Hq > 65535 || (Lq + 63) / 64 > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == REPRO_DTYPE_BF16) {
        auto tc = [&](auto launch) {
            return static_cast<int>(launch(
                q, k, v, o, dout, lse, dq, dk, dv, stats, work, part,
                counters, B, Lq, Lk, Hq, Hkv, causal, window, q_offset,
                n_work, st));
        };
        if (D == 96 && Dv == 64) return tc(launch_tc<96, 64>);
        if (D != Dv) return static_cast<int>(cudaErrorInvalidValue);
        switch (D) {
            case 64: return tc(launch_tc<64, 64>);
            case 128: return tc(launch_tc<128, 128>);
            case 160: return tc(launch_tc<160, 160>);
            case 256: return tc(launch_tc<256, 256>);
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    }
    if (dtype == REPRO_DTYPE_F32)
        return static_cast<int>(launch_widths<float>(
            D, Dv, q, k, v, o, dout, lse, dq, dk, dv, stats, B, Lq, Lk, Hq,
            Hkv, causal, window, q_offset, st));
    return static_cast<int>(cudaErrorInvalidValue);
}

// The registers, shared memory and occupancy of the two launches
// flash_prefill_bwd makes at (D, Dv) in dtype, into out[7] (see attrs).
extern "C" int flash_prefill_bwd_attrs(int D, int Dv, int dtype, int* out) {
    const bool tc = dtype == REPRO_DTYPE_BF16;
    if (!tc && dtype != REPRO_DTYPE_F32)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaErrorInvalidValue;
    if (D == 96 && Dv == 64)
        err = tc ? attrs_tc<96, 64>(out) : attrs_simt<96, 64>(out);
    else if (D == Dv && D == 64)
        err = tc ? attrs_tc<64, 64>(out) : attrs_simt<64, 64>(out);
    else if (D == Dv && D == 128)
        err = tc ? attrs_tc<128, 128>(out) : attrs_simt<128, 128>(out);
    else if (D == Dv && D == 160)
        err = tc ? attrs_tc<160, 160>(out) : attrs_simt<160, 160>(out);
    else if (D == Dv && D == 256)
        err = tc ? attrs_tc<256, 256>(out) : attrs_simt<256, 256>(out);
    return static_cast<int>(err);
}
