// Split-KV combine for Hopper (sm_90a): merge S unnormalised partials.
//
// Replaces: src/repro/kernels/flash_combine.py::_combine_kernel, launched
// by flash_combine (pallas_call at flash_combine.py:61).
//
// What bounds it: bytes.  It reads the S partials (S * B * Hkv * G *
// (D + 2) floats) once, writes B * Hkv * G * D outputs, and does a few
// flops per element.
//
// Design: one CTA per (query row g, kv head, batch) and one thread per
// output column, so the grid has B * Hkv * G CTAs and no thread loops
// over columns; each thread walks the S splits in a fixed order, with no
// atomics, so the same split gives the same bits on every run (FA3's
// combine uses atomics and semaphores instead).  m* = max_s m_s,
// w_s = exp(m_s - m*), out = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30),
// written in the output dtype.  A bf16 or f32 cache no longer runs it:
// flash_decode.cu merges its own splits in its epilogue with the same
// formula.  It merges the quantized decode kernel's partials.
#include "common.cuh"

namespace {

template <typename T>
__global__ void combine_kernel(const float* __restrict__ acc,  // (S,B,Hkv,G,D)
                               const float* __restrict__ l,    // (S,B,Hkv,G)
                               const float* __restrict__ m,    // (S,B,Hkv,G)
                               T* __restrict__ out,            // (B,Hkv,G,D)
                               int S, int B, int Hkv, int G, int D) {
    const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int d = threadIdx.x;
    const long long split_stride = static_cast<long long>(B) * Hkv * G;
    const long long row = (static_cast<long long>(b) * Hkv + h) * G + g;
    float mx = REPRO_NEG_INF;
#pragma unroll 8
    for (int s = 0; s < S; ++s) mx = fmaxf(mx, m[s * split_stride + row]);
    float num = 0.f, den = 0.f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) {
        const long long i = s * split_stride + row;
        const float w = expf(m[i] - mx);
        num = fmaf(w, acc[i * D + d], num);
        den = fmaf(w, l[i], den);
    }
    out[row * D + d] = from_float<T>(num / fmaxf(den, 1e-30f));
}

template <typename T>
cudaError_t launch(const void* acc, const void* l, const void* m, void* out,
                   int S, int B, int Hkv, int G, int D, cudaStream_t stream) {
    dim3 grid(G, Hkv, B);
    combine_kernel<T><<<grid, D, 0, stream>>>(
        static_cast<const float*>(acc), static_cast<const float*>(l),
        static_cast<const float*>(m), static_cast<T*>(out), S, B, Hkv, G, D);
    return cudaGetLastError();
}

}  // namespace

extern "C" int flash_combine(const void* acc, const void* l, const void* m,
                             void* out, int S, int B, int Hkv, int G, int D,
                             int dtype, void* stream) {
    if (S < 1 || B < 1 || Hkv < 1 || G < 1 || D < 1 || D > 1024)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == REPRO_DTYPE_BF16)
        return launch<__nv_bfloat16>(acc, l, m, out, S, B, Hkv, G, D, st);
    if (dtype == REPRO_DTYPE_F32)
        return launch<float>(acc, l, m, out, S, B, Hkv, G, D, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
