// RG-LRU diagonal linear recurrence h_t = a_t * h_{t-1} + u_t, f32 state.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py::rglru_scan
// (body _rglru_kernel): a, u (B, S, D) in f32 or bf16, optional h0 (B, D)
// f32 -> h (B, S, D) f32. The initial state enters as h_0 = a_0 h0 + u_0,
// which is the JAX reference's u_0 += a_0 h0. Each step rounds the product
// and the sum apart (no FMA), as the plain PyTorch version does, so the
// two agree bit for bit.
//
// What bounds it on an H100: bytes. Each element costs one multiply and
// one add over 12 bytes moved (a and u read, h written): at (4, 3000,
// 4096) that is 590 MB, 176 us at 3.35 TB/s.
//
// What the design does about it: the TPU kernel's own shape, sequential
// in time and parallel in channels. One thread owns one (b, d) channel and
// carries h in a register; neighbouring threads own neighbouring channels,
// so every load and store of a time step is coalesced across the warp.
// The time loop is unrolled by kUnroll and issues all of a chunk's loads
// before its arithmetic, so each thread keeps 2 * kUnroll loads in flight:
// at B * D = 16,384 threads that is enough bytes in flight to stream. A
// ragged S needs no padding: the tail runs one step at a time.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ u,
                  const float* __restrict__ h0, float* __restrict__ h, int S,
                  int D, long long asb, long long ass, long long usb,
                  long long uss) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const T* ab = a + b * asb + d;
  const T* ub = u + b * usb + d;
  float* hb = h + static_cast<long long>(b) * S * D + d;
  float hv = h0 != nullptr ? h0[static_cast<long long>(b) * D + d] : 0.f;

  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], uv[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      av[i] = to_f32(ab[(t + i) * ass]);
      uv[i] = to_f32(ub[(t + i) * uss]);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      hv = __fadd_rn(__fmul_rn(av[i], hv), uv[i]);
      hb[static_cast<long long>(t + i) * D] = hv;
    }
  }
  for (; t < S; ++t) {
    hv = __fadd_rn(__fmul_rn(to_f32(ab[t * ass]), hv), to_f32(ub[t * uss]));
    hb[static_cast<long long>(t) * D] = hv;
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* u, const float* h0, float* h,
                   int B, int S, int D, long long asb, long long ass,
                   long long usb, long long uss, cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(u), h0, h, S, D, asb,
      ass, usb, uss);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// a/u: (B, S, D) with a contiguous channel dim and the given (batch, time)
// element strides; h0: (B, D) contiguous f32 or null; h: (B, S, D)
// contiguous f32. Returns the launch's cudaError_t.
extern "C" int repro_rglru_scan(const void* a, const void* u, const void* h0,
                                void* h, int dtype, int B, int S, int D,
                                long long asb, long long ass, long long usb,
                                long long uss, void* stream) {
  using namespace repro;
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(a, u, h0f, hf, B, S, D, asb, ass, usb, uss, s);
    case kBF16:
      return launch<__nv_bfloat16>(a, u, h0f, hf, B, S, D, asb, ass, usb, uss, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
