// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel reads its inputs as 16-byte vectors and does its
// arithmetic in float32; T is the storage type (float or bfloat16, and
// int8 or fp8 e4m3 for a quantized KV cache).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Finite -inf stand-in, as in the reference: a masked score never makes
// (-inf) - (-inf) = NaN in an online softmax or in the split combine.
#define REPRO_NEG_INF (-1e30f)

// dtype codes passed from Python (repro_torch/kernels/build.py)
#define REPRO_DTYPE_F32 0
#define REPRO_DTYPE_BF16 1
#define REPRO_DTYPE_INT8 2   // quantized KV storage, f32 scales beside it
#define REPRO_DTYPE_FP8 3    // float8_e4m3fn, f32 scales beside it

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
    return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) {
    return static_cast<float>(x);     // exact: every e4m3 value is an f32
}

// Two probabilities as two bf16 terms each, packed in pairs for a
// tensor-core product's bf16 operand: hi = bf16(p), lo = bf16(p - hi).
// hi + lo carries p to about 16 significant bits; hi alone is off by up
// to 2^-9 p.  Where a model's top scores lie a few units apart over V
// entries in the hundreds (qwen2.5-3b at full width with seeded weights),
// that one term moves small attention outputs by several bf16 steps,
// past the 2e-2 / 3e-2 tolerances, so both attention kernels multiply V
// by hi and by lo.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 f = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(a - f.x, b - f.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// elements of T in one 16-byte vector
template <typename T> struct Vec16 {
    static constexpr int N = 16 / sizeof(T);
};

// Widen one 16-byte vector (Vec16<T>::N elements of T) to float.
template <typename T>
__device__ __forceinline__ void widen16(const uint4& raw, float* out) {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < Vec16<T>::N; ++i) out[i] = to_float(e[i]);
}

// Load 16 bytes (Vec16<T>::N elements) and widen them to float.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
    widen16<T>(*reinterpret_cast<const uint4*>(p), out);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}
