// BvSB confidence + top-1 over the last-position logits (paper Eq. 2).
//
// Replaces the TPU kernel src/repro/kernels/bvsb.py::bvsb (body
// _bvsb_kernel): per row, one streaming pass over the vocabulary keeping
// (max1, max2, sum exp(l - max1), argmax) with online rescale, then
//     BvSB = (1 - exp(max2 - max1)) / sum,   top-1 = first index of max1.
//
// What bounds it on an H100: bytes. At the serving shape (64, 2048) f32
// the kernel reads 512 KiB and writes 512 B, a few hundred nanoseconds at
// HBM rate, and does ~2 exp per element, far below the FP32 rate. At
// B = 1 it is bound by the launch itself.
//
// What the design does about it: one block per row, its threads striding
// over the row so that neighbouring threads read neighbouring addresses
// (coalesced loads, each logit read exactly once, nothing staged in shared
// memory). Every thread keeps a private 4-tuple in registers; the tuples
// meet in a warp-shuffle butterfly and then once across warps through
// shared memory. The TPU kernel's (BB, BV) tiling and its -1e38 column
// padding do not carry over: the ragged edge is a loop bound here.
//
// Merge of two tuples a, b (also used to fold in one element, as the
// tuple (x, -inf, 1, col)):
//   m1  = max(a.m1, b.m1)
//   m2  = max(a.m2, b.m2, min(a.m1, b.m1))
//   z   = a.z exp(a.m1 - m1) + b.z exp(b.m1 - m1), where a side whose m1
//         is -inf contributes 0 (exp(-inf - -inf) would be NaN)
//   idx = idx of the larger m1, the smaller index on equality
// so a duplicated maximum gives m2 = m1 (BvSB 0) and the first index even
// across threads, -inf / -1e38 / finfo(f32).min logits contribute exactly
// 0, and a +inf logit gives z = exp(inf - inf) = NaN, so BvSB is NaN as in
// the reference.
#include <climits>
#include <cmath>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kBvsbThreads = 256;
constexpr int kBvsbWarps = kBvsbThreads / 32;

struct Top2 {
  float m1, m2, z;
  int idx;
};

__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  Top2 r;
  r.m1 = fmaxf(a.m1, b.m1);
  r.m2 = fmaxf(fmaxf(a.m2, b.m2), fminf(a.m1, b.m1));
  const float za = a.m1 == -INFINITY ? 0.f : a.z * expf(a.m1 - r.m1);
  const float zb = b.m1 == -INFINITY ? 0.f : b.z * expf(b.m1 - r.m1);
  r.z = za + zb;
  r.idx = a.m1 > b.m1 ? a.idx : (b.m1 > a.m1 ? b.idx : min(a.idx, b.idx));
  return r;
}

__device__ __forceinline__ Top2 shfl_xor(const Top2& a, int offset) {
  Top2 r;
  r.m1 = __shfl_xor_sync(kFullMask, a.m1, offset);
  r.m2 = __shfl_xor_sync(kFullMask, a.m2, offset);
  r.z = __shfl_xor_sync(kFullMask, a.z, offset);
  r.idx = __shfl_xor_sync(kFullMask, a.idx, offset);
  return r;
}

__device__ __forceinline__ Top2 warp_merge(Top2 s) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) s = merge(s, shfl_xor(s, offset));
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kBvsbThreads)
bvsb_kernel(const T* __restrict__ logits, long long row_stride, int cols,
            float* __restrict__ conf, int* __restrict__ top1) {
  const T* x = logits + static_cast<long long>(blockIdx.x) * row_stride;
  const Top2 empty = {-INFINITY, -INFINITY, 0.f, INT_MAX};
  Top2 s = empty;
  for (int c = threadIdx.x; c < cols; c += kBvsbThreads) {
    const Top2 e = {to_f32(x[c]), -INFINITY, 1.f, c};
    s = merge(s, e);
  }
  s = warp_merge(s);

  __shared__ Top2 partial[kBvsbWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kBvsbWarps ? partial[lane] : empty;
    s = warp_merge(s);
    if (lane == 0) {
      conf[blockIdx.x] = (1.f - expf(s.m2 - s.m1)) / s.z;
      top1[blockIdx.x] = s.idx;
    }
  }
}

template <typename T>
cudaError_t launch(const void* logits, long long rows, long long row_stride,
                   int cols, float* conf, int* top1, cudaStream_t stream) {
  bvsb_kernel<T><<<static_cast<unsigned>(rows), kBvsbThreads, 0, stream>>>(
      static_cast<const T*>(logits), row_stride, cols, conf, top1);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// logits: (rows, cols) with unit column stride and `row_stride` elements
// between rows; conf (rows,) f32 and top1 (rows,) int32 are written.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int repro_bvsb(const void* logits, int dtype, long long rows,
                          long long row_stride, int cols, float* conf,
                          int* top1, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(logits, rows, row_stride, cols, conf, top1, s);
    case kBF16: return launch<__nv_bfloat16>(logits, rows, row_stride, cols, conf, top1, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
