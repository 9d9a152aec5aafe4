// BvSB confidence + top-1 over the last-position logits (paper Eq. 2).
//
// Replaces the TPU kernel src/repro/kernels/bvsb.py::bvsb (body
// _bvsb_kernel): per row, one streaming pass over the vocabulary keeping
// (max1, max2, sum exp(l - max1), argmax) with online rescale, then
//     BvSB = (1 - exp(max2 - max1)) / sum,   top-1 = first index of max1.
//
// What bounds it on an H100: bytes, and at small shapes the launch. At
// RecurrentGemma's head (4, 256000) f32 the kernel reads 4.1 MB (1.2 us at
// 3.35 TB/s); at (64, 256000) 65.5 MB (19.6 us); at the cascade's (8,
// 2048) view 64 KB, far below one launch.
//
// What the design does about it:
//
// * Several blocks per row. The wrapper's plan (kernels/bvsb.py::chunks)
//   cuts a row of 16,384 columns or more into contiguous chunks of at
//   least 4,096 columns, whole 16-byte vectors, as many as give about four
//   blocks an SM (62 chunks a row at B = 4, 9 at B = 64). A block folds its
//   chunk into one (m1, m2, z, idx) tuple; a second kernel, launched so
//   that it is scheduled while the first runs, merges each row's tuples, a
//   warp a row, lane j taking chunks j, j + 32, ... in order and then a
//   fixed butterfly, so the result does not depend on the order in which
//   blocks finish. A shorter row stays one block, which writes the result
//   itself: one launch, as at the cascade's (8, 2048), where the merge
//   launch would cost more than the cut saves (chip_smoke.py's chunk sweep
//   on an H100: 4.1 us as one block, 6.0 us cut).
// * Loads in flight. Each thread reads 16 bytes at a time (4 f32 or 8
//   bf16), neighbouring threads neighbouring vectors, kUnroll vectors
//   issued before any is folded. A row start off 16 bytes (the cascade's
//   strided (B, S, V)[:, -1] view, odd V) takes scalar loads up to the
//   first aligned column and after the last whole vector.
// * One exp per element. A thread folds element x into its tuple with
//       x > m1:  z = z exp(m1 - x) + 1, m2 = m1, m1 = x, idx = col
//       else:    z = z + exp(x - m1),   m2 = max(m2, x)
//   visiting its columns in increasing order, so idx is the first maximum
//   it saw. Only tuples meet through the full merge below (threads, warps,
//   chunks):
//   m1  = max(a.m1, b.m1)
//   m2  = max(a.m2, b.m2, min(a.m1, b.m1))
//   z   = a.z exp(a.m1 - m1) + b.z exp(b.m1 - m1), where a side whose m1
//         is -inf contributes 0 (exp(-inf - -inf) would be NaN)
//   idx = idx of the larger m1, the smaller index on equality
// So a duplicated maximum gives m2 = m1 (BvSB 0) and the first index, also
// across threads and chunks; -inf, -1e38 and finfo(f32).min logits
// contribute exactly 0, and a chunk that is all -inf is (-inf, -inf, 0,
// its first column), which weighs 0 in every merge. A +inf logit makes m1
// = +inf, and the first merge that meets it forms exp(inf - inf) = NaN, so
// BvSB is NaN as in the reference.
//
// Over a vocabulary cut across ranks (the JAX package's vocab_parallel_bvsb
// in src/repro/launch/distributed.py, its head sharded over the model
// axis), the same two kernels serve in two more entries:
//
// * repro_bvsb_partials: a rank's (rows, V / m) logits folded into one
//   (m1, m2, z, idx) tuple a row, idx offset to the global column and
//   stored as a float (exact below 2^24), written as 16 bytes a row
//   instead of conf / top-1: the chunk kernel alone for a one-chunk row,
//   else the chunk kernel and the merge kernel.
// * repro_bvsb_merge: the ranks' tuples (rows, n, 4), gathered in rank
//   order, merged a warp a row as the chunks are, into conf / top-1. The
//   merge above is the one-device kernel's, so a maximum tied across two
//   ranks gives margin 0 and the first index, as on one device.
#include <climits>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kBvsbThreads = 256;
constexpr int kBvsbWarps = kBvsbThreads / 32;
constexpr int kUnroll = 4;  // 16-byte loads a thread issues before folding

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

// One element into a thread's tuple: one exp. x = -inf adds nothing (while
// m1 is -inf, exp(x - m1) would be NaN).
__device__ __forceinline__ void fold(Top2& s, float x, int col) {
  const bool up = x > s.m1;
  const float e = expf(up ? s.m1 - x : x - s.m1);
  s.z = up ? fmaf(s.z, e, 1.f) : s.z + (x == -INFINITY ? 0.f : e);
  s.m2 = up ? s.m1 : fmaxf(s.m2, x);
  s.idx = up ? col : s.idx;
  s.m1 = up ? x : s.m1;
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

__device__ __forceinline__ void finish(const Top2& s, long long row,
                                       float* conf, int* top1) {
  conf[row] = (1.f - expf(s.m2 - s.m1)) / s.z;
  top1[row] = s.idx;
}

// A row's result: conf / top-1, or (tuples non-null) its tuple with the
// index offset to the global column, as 16 bytes of floats.
__device__ __forceinline__ void emit(const Top2& s, long long row,
                                     float4* tuples, int col_offset,
                                     float* conf, int* top1) {
  if (tuples)
    tuples[row] = make_float4(s.m1, s.m2, s.z,
                              static_cast<float>(s.idx + col_offset));
  else
    finish(s, row, conf, top1);
}

__device__ __forceinline__ Top2 load(const Top2& t) { return t; }
__device__ __forceinline__ Top2 load(const float4& t) {
  return Top2{t.x, t.y, t.z, static_cast<int>(t.w)};
}

// 16 bytes of logits, unpacked to f32 in column order
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  using Raw = float4;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&x)[kN]) {
    x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& r, float (&x)[kN]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the lower half is the lower column
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Block (row, chunk) folds columns [chunk * cols_per, .. + cols_per) of its
// row. One chunk a row: the block writes the row's result (emit); several:
// its tuple goes to part[row * chunks + chunk] for bvsb_merge_kernel.
template <typename T>
__global__ void __launch_bounds__(kBvsbThreads)
bvsb_chunk_kernel(const T* __restrict__ logits, long long row_stride,
                  int cols, int cols_per, Top2* __restrict__ part,
                  float4* __restrict__ tuples, int col_offset,
                  float* __restrict__ conf, int* __restrict__ top1) {
  allow_dependent_launch();  // the merge (several chunks) may be scheduled
  using V = Vec<T>;
  constexpr int kN = V::kN;
  const long long row = blockIdx.x;
  const int chunk = blockIdx.y, chunks = gridDim.y, tid = threadIdx.x;
  const T* x = logits + row * row_stride;
  const int c0 = chunk * cols_per, c1 = min(c0 + cols_per, cols);
  // [a0, a1): the chunk's whole 16-byte vectors
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(x + c0) & 15) / sizeof(T));
  const int a0 = min(c1, c0 + (mis ? kN - mis : 0));
  const int a1 = a0 + (c1 - a0) / kN * kN;

  Top2 s = {-INFINITY, -INFINITY, 0.f, INT_MAX};
  if (c0 + tid < a0) fold(s, to_f32(x[c0 + tid]), c0 + tid);
  const typename V::Raw* xv = reinterpret_cast<const typename V::Raw*>(x + a0);
  const int nv = (a1 - a0) / kN;
  for (int i0 = tid; i0 < nv; i0 += kUnroll * kBvsbThreads) {
    typename V::Raw r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kBvsbThreads;
      if (i < nv) r[u] = __ldg(xv + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kBvsbThreads;
      if (i < nv) {
        float f[kN];
        V::unpack(r[u], f);
#pragma unroll
        for (int j = 0; j < kN; ++j) fold(s, f[j], a0 + i * kN + j);
      }
    }
  }
  if (a1 + tid < c1) fold(s, to_f32(x[a1 + tid]), a1 + tid);
  s = warp_merge(s);

  __shared__ Top2 partial[kBvsbWarps];
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) partial[warp] = s;
  __syncthreads();
  if (warp != 0) return;
  s = lane < kBvsbWarps ? partial[lane]
                        : Top2{-INFINITY, -INFINITY, 0.f, INT_MAX};
  s = warp_merge(s);
  if (lane != 0) return;
  if (s.idx == INT_MAX) s.idx = c0;  // every logit -inf: the first column
  if (chunks == 1)
    emit(s, row, tuples, col_offset, conf, top1);
  else
    part[row * chunks + chunk] = s;
}

// One warp per row: the row's n tuples (a row's chunks, Top2, or the
// ranks' shard tuples, float4) merged in a fixed order, lane j taking
// tuples j, j + 32, ... in order, then the butterfly.
template <typename In>
__global__ void __launch_bounds__(32)
bvsb_merge_kernel(const In* __restrict__ part, int n,
                  float4* __restrict__ tuples, int col_offset,
                  float* __restrict__ conf, int* __restrict__ top1) {
  grid_dependency_wait();  // the chunk kernel has finished
  const long long row = blockIdx.x;
  Top2 s = {-INFINITY, -INFINITY, 0.f, INT_MAX};
  for (int j = threadIdx.x; j < n; j += 32)
    s = merge(s, load(part[row * n + j]));
  s = warp_merge(s);
  if (threadIdx.x == 0) emit(s, row, tuples, col_offset, conf, top1);
}

template <typename T>
cudaError_t launch(const void* logits, long long rows, long long row_stride,
                   int cols, int chunks, int cols_per, Top2* part,
                   float4* tuples, int col_offset, float* conf, int* top1,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(chunks));
  bvsb_chunk_kernel<T><<<grid, kBvsbThreads, 0, stream>>>(
      static_cast<const T*>(logits), row_stride, cols, cols_per, part,
      tuples, col_offset, conf, top1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  return launch_dependent(bvsb_merge_kernel<Top2>,
                          dim3(static_cast<unsigned>(rows)), dim3(32), stream,
                          static_cast<const Top2*>(part), chunks, tuples,
                          col_offset, conf, top1);
}

bool bad_plan(long long rows, int cols, int chunks, int cols_per,
              const void* scratch) {
  return rows <= 0 || rows >= (1LL << 31) || cols <= 0 || chunks <= 0 ||
         chunks > 65535 || cols_per <= 0 ||
         static_cast<long long>(chunks) * cols_per < cols ||
         (chunks > 1 && scratch == nullptr);
}

cudaError_t launch_any(const void* logits, int dtype, long long rows,
                       long long row_stride, int cols, int chunks,
                       int cols_per, void* scratch, float4* tuples,
                       int col_offset, float* conf, int* top1,
                       cudaStream_t s) {
  Top2* part = static_cast<Top2*>(scratch);
  switch (dtype) {
    case kF32:
      return launch<float>(logits, rows, row_stride, cols, chunks, cols_per,
                           part, tuples, col_offset, conf, top1, s);
    case kBF16:
      return launch<__nv_bfloat16>(logits, rows, row_stride, cols, chunks,
                                   cols_per, part, tuples, col_offset, conf,
                                   top1, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// logits: (rows, cols) with unit column stride and `row_stride` elements
// between rows, cut into `chunks` chunks of `cols_per` columns (chunks *
// cols_per >= cols, chunks <= 65535); scratch: rows * chunks * 16 bytes
// when chunks > 1, else unused. conf (rows,) f32 and top1 (rows,) int32
// are written. Returns the launches' cudaError_t (0 = launched).
extern "C" int repro_bvsb(const void* logits, int dtype, long long rows,
                          long long row_stride, int cols, int chunks,
                          int cols_per, void* scratch, float* conf,
                          int* top1, void* stream) {
  using namespace repro;
  if (bad_plan(rows, cols, chunks, cols_per, scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_any(
      logits, dtype, rows, row_stride, cols, chunks, cols_per, scratch,
      nullptr, 0, conf, top1, static_cast<cudaStream_t>(stream)));
}

// The same plan over a rank's shard of the vocabulary, whose first column
// is global column `col_offset` (col_offset + cols <= 2^24): tuples (rows,
// 4) f32 (m1, m2, z, global top-1 index) are written.
extern "C" int repro_bvsb_partials(const void* logits, int dtype,
                                   long long rows, long long row_stride,
                                   int cols, int chunks, int cols_per,
                                   void* scratch, float* tuples,
                                   int col_offset, void* stream) {
  using namespace repro;
  if (bad_plan(rows, cols, chunks, cols_per, scratch) || tuples == nullptr ||
      col_offset < 0 || col_offset + static_cast<long long>(cols) > (1 << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_any(
      logits, dtype, rows, row_stride, cols, chunks, cols_per, scratch,
      reinterpret_cast<float4*>(tuples), col_offset, nullptr, nullptr,
      static_cast<cudaStream_t>(stream)));
}

// tuples: (rows, n, 4) f32 as repro_bvsb_partials writes them, contiguous,
// n in index order; conf (rows,) f32 and top1 (rows,) int32 are written.
extern "C" int repro_bvsb_merge(const float* tuples, long long rows, int n,
                                float* conf, int* top1, void* stream) {
  using namespace repro;
  if (rows <= 0 || rows >= (1LL << 31) || n <= 0 || tuples == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  bvsb_merge_kernel<float4><<<static_cast<unsigned>(rows), 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(tuples), n, nullptr, 0, conf, top1);
  return static_cast<int>(cudaGetLastError());
}
