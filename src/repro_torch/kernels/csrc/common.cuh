// Shared helpers for the repro_torch CUDA kernels: element loads and
// stores in f32 registers for the two floating types the wrappers
// accept (f32, bf16), and the dtype codes the Python side passes
// through ctypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// dtype codes, kept in lockstep with kernels/_build.py DTYPE_CODES
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr unsigned kFullMask = 0xffffffffu;

}  // namespace repro
