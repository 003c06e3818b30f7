// Helpers shared by the hand-written kernels of kgdet_tpu_torch.
//
// Every kernel is templated on its storage type T (float or __nv_bfloat16),
// computes in f32, and rounds to T exactly where the JAX reference stores an
// intermediate in the working dtype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace kgdet {

// dtype codes passed from Python (ops/_build.py::DTYPE_CODES)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// v rounded to T and widened back: the value a T-typed scratch would hold
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

}  // namespace kgdet
