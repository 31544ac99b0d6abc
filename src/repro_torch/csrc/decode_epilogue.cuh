// The split-KV decode kernels' shared tiling and epilogue: the bf16 / f32
// cache's kernel (csrc/flash_decode.cu) and the quantized cache's
// (csrc/flash_decode_quant.cu) both include it, so both split the cache
// the same way and end the same way.
//
// Split s of S covers the 128-row KV blocks [s * NB, min((s + 1) * NB,
// nblk)), NB = ceil(nblk / S), as FA3 does; kv_len clamps its rows.
//
// Epilogue.  With S = 1 the CTA writes acc / max(l, 1e-30) in the output
// dtype.  With S > 1 it writes its (acc, l, m) to an f32 workspace (an
// empty split: m = -1e30, l = 0, acc = 0, never -inf), fences, and takes a
// ticket from a per-(b, h) counter; the CTA that arrives last reads the S
// partials past L1, merges them in split order with flash_combine.cu's
// arithmetic, 16 query rows at a time, writes the output and resets the
// counter to 0.  The same split gives the same bits whichever CTA
// finishes last, and the next launch needs no memset.  Without a counter
// the kernel writes the partials only.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockN = 128;   // KV_BLOCK: split bounds are counted in these
constexpr int kTile = 64;      // rows per step (per ring stage)
constexpr int kRowGroup = 16;  // query rows of one mma M, one merge group
constexpr int kWarpRows = kTile / kWarps;   // keys of a tile one warp owns
constexpr int kStages = 2;     // tensor-core ring depth, in tiles
constexpr int kPassRows = kWarps * kRowGroup;   // wide bodies' rows a pass

struct Epilogue {
    float* acc;       // (S, B, Hkv, G, D) partials
    float* l;         // (S, B, Hkv, G)
    float* m;         // (S, B, Hkv, G)
    int* counters;    // (B, Hkv) arrivals; null: write the partials only
    void* out;        // (B, Hkv, G, D) in out_dtype; null without counters
    int out_dtype;
};

struct Rows {
    int lo, hi;       // this split's rows [lo, hi), hi clamped to kv_len
};

__device__ __forceinline__ Rows split_rows(int L, int S, int s, int kv_len) {
    const int nblk = (L + kBlockN - 1) / kBlockN;
    const int nb = (nblk + S - 1) / S;
    const int len = min(max(kv_len, 0), L);
    return {min(s * nb * kBlockN, L),
            min(min((s + 1) * nb * kBlockN, L), len)};
}

__device__ __forceinline__ void store_out(void* out, long long i, float x,
                                          int dtype) {
    if (dtype == REPRO_DTYPE_BF16)
        static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(x);
    else
        static_cast<float*>(out)[i] = x;
}

// Writes one element of the split's result: the output itself when the
// split is the whole row range (S = 1, fused), else the partial.
__device__ __forceinline__ void store_split(const Epilogue& ep, int S, int s,
                                            long long split_stride,
                                            long long row, int D, int d,
                                            float acc, float l, float m) {
    if (S == 1 && ep.out != nullptr) {
        store_out(ep.out, row * D + d, acc / fmaxf(l, 1e-30f), ep.out_dtype);
        return;
    }
    const long long i = s * split_stride + row;
    ep.acc[i * D + d] = acc;
    if (d == 0) {
        ep.l[i] = l;
        ep.m[i] = m;
    }
}

// Stores 4 consecutive output elements.
__device__ __forceinline__ void store_out4(void* out, long long i, float4 x,
                                           int dtype) {
    if (dtype == REPRO_DTYPE_BF16) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
        uint2 v;
        v.x = *reinterpret_cast<const uint32_t*>(&lo);
        v.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + i) = v;
    } else {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + i) = x;
    }
}

// After every thread has stored its part of the split: in fused mode with
// S > 1, the CTA of (b, h) that arrives last merges the S partials in split
// order, m* = max_s m_s, w_s = exp(m_s - m*), out = sum_s w_s acc_s /
// max(sum_s w_s l_s, 1e-30) (flash_combine.cu's arithmetic, so the same
// bits), and resets the counter.  The G rows are merged in groups of
// kRowGroup; in each, m and l of up to kMergeChunk splits are staged in
// shared memory at once, which holds m* too when S fits in one chunk; each
// thread reads 4-column slices of acc, whose loads for different splits do
// not wait on each other.
constexpr int kMergeChunk = 32;
static_assert(kThreads == 8 * kRowGroup, "8 lanes per row find m*");

// Merges the S partials of rows [row0, row0 + G), G <= kRowGroup, into
// the output.
template <int D>
__device__ __forceinline__ void merge_group(const Epilogue& ep, int S,
                                            long long split_stride,
                                            long long row0, int G) {
    constexpr int kC = kRowGroup * D / 4 / kThreads;   // 4-column slices
    static_assert(kRowGroup * D % (4 * kThreads) == 0, "slices split evenly");
    __shared__ float mx_s[kRowGroup], w_s[kMergeChunk][kRowGroup],
        l_s[kMergeChunk][kRowGroup];
    const int tid = threadIdx.x;
    if (S > kMergeChunk) {    // m* first, 8 lanes per row
        const int g = tid / 8;
        float mx = REPRO_NEG_INF;
        if (g < G)
            for (int s = tid % 8; s < S; s += 8)
                mx = fmaxf(mx, __ldcg(ep.m + s * split_stride + row0 + g));
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if (g < G && tid % 8 == 0) mx_s[g] = mx;
    }
    float4 num[kC];
    float den[kC];
#pragma unroll
    for (int i = 0; i < kC; ++i) {
        num[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        den[i] = 0.f;
    }
    for (int s0 = 0; s0 < S; s0 += kMergeChunk) {
        const int n = min(kMergeChunk, S - s0);
        __syncthreads();      // m* is known; the last chunk's weights read
        for (int i = tid; i < n * G; i += kThreads) {
            const long long at = (s0 + i / G) * split_stride + row0 + i % G;
            w_s[i / G][i % G] = __ldcg(ep.m + at);
            l_s[i / G][i % G] = __ldcg(ep.l + at);
        }
        __syncthreads();
        if (S <= kMergeChunk) {
            if (tid < G) {
                float mx = REPRO_NEG_INF;
                for (int j = 0; j < n; ++j) mx = fmaxf(mx, w_s[j][tid]);
                mx_s[tid] = mx;
            }
            __syncthreads();
        }
        for (int i = tid; i < n * G; i += kThreads)
            w_s[i / G][i % G] = expf(w_s[i / G][i % G] - mx_s[i % G]);
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < n; ++j) {
            const float4* acc = reinterpret_cast<const float4*>(
                ep.acc + ((s0 + j) * split_stride + row0) * D);
#pragma unroll
            for (int i = 0; i < kC; ++i) {
                const int c = tid + i * kThreads, g = c * 4 / D;
                if (g >= G) continue;
                const float4 a = __ldcg(acc + c);
                const float w = w_s[j][g];
                num[i] = make_float4(fmaf(w, a.x, num[i].x),
                                     fmaf(w, a.y, num[i].y),
                                     fmaf(w, a.z, num[i].z),
                                     fmaf(w, a.w, num[i].w));
                den[i] = fmaf(w, l_s[j][g], den[i]);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < kC; ++i) {
        const int c = tid + i * kThreads;
        if (c * 4 / D >= G) continue;
        const float d = fmaxf(den[i], 1e-30f);
        store_out4(ep.out, row0 * D + c * 4,
                   make_float4(num[i].x / d, num[i].y / d, num[i].z / d,
                               num[i].w / d), ep.out_dtype);
    }
}

template <int D>
__device__ __forceinline__ void combine_if_last(const Epilogue& ep, int S,
                                                long long split_stride,
                                                long long row0, int G,
                                                long long bh) {
    if (ep.counters == nullptr || S == 1) return;
    __shared__ int last;
    const int tid = threadIdx.x;
    __threadfence();          // this thread's partials before the ticket
    __syncthreads();
    if (tid == 0) last = atomicAdd(ep.counters + bh, 1) == S - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();          // the other CTAs' partials after their tickets
    for (int g0 = 0; g0 < G; g0 += kRowGroup) {
        if (g0 > 0) __syncthreads();      // the last group's weights read
        merge_group<D>(ep, S, split_stride, row0 + g0,
                       min(kRowGroup, G - g0));
    }
    if (tid == 0) ep.counters[bh] = 0;
}

// The tensor-core bodies' shared memory for the warp merge: each warp's
// 16 x D output block in f32, rows padded to D + 4 floats.
template <int D>
struct WarpMerge {
    static constexpr int kOPitch = D + 4;
    static constexpr size_t kBytes = sizeof(float) * kWarps * 16 * kOPitch;
};

// The tensor-core bodies' end.  Each warp holds its own running (m, l, O)
// in mma.sync's accumulator layout (m_r, l_r: rows gq and gq + 8; l_r
// this lane's columns only; o[j]: columns 8 j + 2 tq, + 1).  Each warp
// scales its O to the CTA's running max and parks it in `smem` (the ring
// is free by now: every copy has been waited for), the CTA sums the four
// in warp order, and the split's result goes to the epilogue.
template <int D>
__device__ __forceinline__ void finish_tc(float (&o)[D / 8][4],
                                          const float (&m_r)[2],
                                          float (&l_r)[2], void* smem,
                                          const Epilogue& ep, int B, int Hkv,
                                          int G, int S, int s, long long bh) {
    __shared__ float m_w[kWarps][16], l_w[kWarps][16];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gq = lane / 4, tq = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
        l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    }
    __syncthreads();
    if (tq == 0) {
        m_w[warp][gq] = m_r[0];
        m_w[warp][gq + 8] = m_r[1];
        l_w[warp][gq] = l_r[0];
        l_w[warp][gq + 8] = l_r[1];
    }
    __syncthreads();
    float scale[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float mw = REPRO_NEG_INF;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) mw = fmaxf(mw, m_w[w][gq + 8 * i]);
        scale[i] = expf(m_r[i] - mw);
    }
    constexpr int kOPitch = WarpMerge<D>::kOPitch;
    float* obuf = static_cast<float*>(smem);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
        float* row = obuf + (warp * 16 + gq) * kOPitch + j * 8 + tq * 2;
        *reinterpret_cast<float2*>(row) =
            make_float2(o[j][0] * scale[0], o[j][1] * scale[0]);
        *reinterpret_cast<float2*>(row + 8 * kOPitch) =
            make_float2(o[j][2] * scale[1], o[j][3] * scale[1]);
    }
    __syncthreads();

    const long long split_stride = static_cast<long long>(B) * Hkv * G;
    const long long row0 = bh * G;
    for (int e = threadIdx.x; e < G * D; e += kThreads) {
        const int g = e / D, d = e % D;
        float mw = REPRO_NEG_INF;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) mw = fmaxf(mw, m_w[w][g]);
        float acc = 0.f, l = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            acc += obuf[(w * 16 + g) * kOPitch + d];
            l = fmaf(expf(m_w[w][g] - mw), l_w[w][g], l);
        }
        store_split(ep, S, s, split_stride, row0 + g, D, d, acc, l, mw);
    }
    combine_if_last<D>(ep, S, split_stride, row0, G, bh);
}

// The wide tensor-core bodies' end of one pass of up to kPassRows query
// rows [g0, g0 + gp): warp w holds row group w % R of the pass over key
// slice w / R of every tile, in finish_tc's register layout.  The warps of
// one row group merge through `smem` in slice order (the caller has
// waited for every copy and synchronised), and the pass's rows go to the
// epilogue.
template <int D>
__device__ __forceinline__ void finish_wide(float (&o)[D / 8][4],
                                            const float (&m_r)[2],
                                            float (&l_r)[2], void* smem,
                                            const Epilogue& ep, int B,
                                            int Hkv, int G, int S, int s,
                                            long long bh, int g0, int gp,
                                            int R) {
    __shared__ float m_w[kWarps][16], l_w[kWarps][16];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gq = lane / 4, tq = lane % 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
        l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    }
    if (tq == 0) {
        m_w[warp][gq] = m_r[0];
        m_w[warp][gq + 8] = m_r[1];
        l_w[warp][gq] = l_r[0];
        l_w[warp][gq + 8] = l_r[1];
    }
    __syncthreads();
    float scale[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float mw = REPRO_NEG_INF;
        for (int w = warp % R; w < kWarps; w += R)
            mw = fmaxf(mw, m_w[w][gq + 8 * i]);
        scale[i] = expf(m_r[i] - mw);
    }
    constexpr int kOPitch = WarpMerge<D>::kOPitch;
    float* obuf = static_cast<float*>(smem);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
        float* row = obuf + (warp * 16 + gq) * kOPitch + j * 8 + tq * 2;
        *reinterpret_cast<float2*>(row) =
            make_float2(o[j][0] * scale[0], o[j][1] * scale[0]);
        *reinterpret_cast<float2*>(row + 8 * kOPitch) =
            make_float2(o[j][2] * scale[1], o[j][3] * scale[1]);
    }
    __syncthreads();

    const long long split_stride = static_cast<long long>(B) * Hkv * G;
    const long long row0 = bh * G + g0;
    for (int e = threadIdx.x; e < gp * D; e += kThreads) {
        const int g = e / D, d = e % D;
        const int r = g / 16, gr = g % 16;       // row group, row in it
        float mw = REPRO_NEG_INF;
        for (int w = r; w < kWarps; w += R) mw = fmaxf(mw, m_w[w][gr]);
        float acc = 0.f, l = 0.f;
        for (int w = r; w < kWarps; w += R) {
            acc += obuf[(w * 16 + gr) * kOPitch + d];
            l = fmaf(expf(m_w[w][gr] - mw), l_w[w][gr], l);
        }
        store_split(ep, S, s, split_stride, row0 + g, D, d, acc, l, mw);
    }
}

// opt in to more than 48 KB of dynamic shared memory, once per kernel
template <typename Kernel>
cudaError_t smem_attr(Kernel kernel, size_t smem) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
}

}  // namespace
