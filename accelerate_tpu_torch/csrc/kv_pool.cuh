// Element access shared by the paged-pool kernels (paged_decode.cu,
// paged_verify.cu): conversions to and from f32, and the read of one K or V
// element of the pool as f32. A bf16/f32 pool converts; an int8 pool
// dequantizes with its per-(block, position) f32 scale, q * s, exactly as
// accelerate_tpu_torch/kvcache.py::kv_dequantize (and the JAX package's
// kv_dequantize) does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace kvpool {

constexpr float kNegInf = -1.0e6f;  // the finite NEG_INF of ops/attention.py

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename PT>
constexpr bool kIsInt8 = std::is_same<PT, int8_t>::value;

// The scale of pool row `prow` (= block * block_size + offset); 1 for a
// float pool, whose `scale` pointer is null.
template <typename PT>
__device__ __forceinline__ float row_scale(const float* __restrict__ scale, long prow) {
  if constexpr (kIsInt8<PT>) return scale[prow];
  return 1.f;
}

// Element `idx` of a pool whose row has scale `s` (from row_scale), as f32.
template <typename PT>
__device__ __forceinline__ float dequant(const PT* __restrict__ pool, long idx, float s) {
  if constexpr (kIsInt8<PT>) return (float)pool[idx] * s;
  return to_f(pool[idx]);
}

}  // namespace kvpool
