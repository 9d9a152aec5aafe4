// Shared helpers for the repro_torch CUDA kernels: element loads and
// stores in f32 registers for the two floating types the wrappers
// accept (f32, bf16), the dtype codes the Python side passes through
// ctypes, and the tensor-core and cp.async primitives of the attention
// kernels (mma.sync fragments, the 3xTF32 operand split, zero-filling
// 16-byte copies into shared memory), and the launch of a merge kernel
// that overlaps the kernel before it.
#pragma once

#include <cstdint>

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

// Row pads (elements) of the attention kernels' shared-memory tiles: a Q
// or K tile row read as A/B fragment pairs (pitch kQK) and a V tile read
// by columns of rows 2c, 2c + 1 (pitch kV), so that every fragment load
// of a warp hits 32 distinct banks.
template <typename T> struct TilePads;
template <> struct TilePads<float> {
  static constexpr int kQK = 8;  // float2 loads: pitch = 8 mod 32 words
  static constexpr int kV = 4;   // column loads of rows 2c: 4 mod 16
};
template <> struct TilePads<__nv_bfloat16> {
  static constexpr int kQK = 8;  // pitch = 4 mod 32 words
  static constexpr int kV = 8;
};

// hi = tf32(x), round to nearest with ties away (as cvt.rna.tf32.f32),
// lo = x - hi; the tensor core reads only the top 19 bits of each.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) |
         (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return pack_bf16(__float2bfloat16(lo), __float2bfloat16(hi));
}

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *static_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool in) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // src-size 0 zero-fills the 16 bytes (rows past the sequence)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's cp.async groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(pending) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// Programmatic dependent launch: a kernel that calls
// allow_dependent_launch() lets the next kernel on its stream, launched by
// launch_dependent(), be scheduled before it ends; that kernel calls
// grid_dependency_wait() before it reads anything the first one wrote,
// which returns once the first has finished and its writes are visible.
// The second launch's latency then overlaps the first kernel's run.
__device__ __forceinline__ void allow_dependent_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

}  // namespace repro
