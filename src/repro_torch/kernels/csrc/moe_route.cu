// The MoE sublayer's way into and out of its experts' capacity buffer
// (models/moe.py local_expert_compute on a card, outside autograd).
//
// Replaces no TPU kernel: the JAX package writes this part of
// src/repro/models/moe.py::_local_expert_compute as XLA ops (a one-hot
// cumsum, a scatter into the (E + 1, C, d) buffer, a gather back and a
// scatter-add), which XLA fuses. Run eagerly they were some 36 PyTorch
// launches a layer, each writing a full-size intermediate: about 2.2 GB
// at granite's mean batch (N = 4,200 tokens, k = 8, C = 1,312).
//
// What bounds it on an H100: bytes. Dispatch reads x (N, d) and writes
// the (E, C, d) buffer; combine reads each kept assignment's output row
// and writes y (N, d): at granite's bucket 32 (N = 6,304, C = 1,970)
// 285 and 233 MB, 85 and 70 us at 3.35 TB/s.
//
// What the design does about it:
//
// * repro_moe_dispatch is two kernels, the second launched to be
//   scheduled while the first runs. moe_rank_kernel cuts the N k
//   assignments (token-major, then top-k slot) into at most kMaxChunks
//   chunks of whole rounds of 256; a block walks its chunk a round at a
//   time, a thread an assignment: __match_any_sync gives the lanes of a
//   warp with the same local expert, __popc of those below a lane its rank
//   in the warp, and a scan over the block's 8 warps (a thread an expert)
//   plus the chunk's running count its rank in the chunk. It writes that
//   rank (-1 for another rank's expert) and the chunk's count of each
//   expert. moe_place_kernel gives a block 128 assignments of one chunk:
//   it sums the counts of the chunks before its own (its experts' first
//   row) and of all (the rows filled), writes each assignment's (expert,
//   row, keep) as moe.dispatch does (row = earlier assignments to the
//   expert; dropped at row >= C or to another rank's expert, to (E, 0)),
//   and copies each kept token row into its buffer row, a warp a row,
//   16 bytes a lane (the wrapper takes only rows of whole 16-byte units). Its share of the E C
//   buffer rows it zeroes where a row lies past its expert's count, so
//   the buffer is the plain version's, bit for bit, without a memset and
//   without a dummy expert. The ranks are integers: any order of blocks
//   gives the same rows.
// * repro_moe_combine runs a warp a token: lane j < k reads slot j's
//   (expert, row, keep, gate) and hands them round by shuffles; each lane
//   takes 16-byte columns of the row, loads four slots' output rows
//   before it folds them, and folds them in slot order as the plain
//   version does: contribution j = out[e, r] * (gate_j * keep_j) rounded
//   in the output's dtype (the gate rounded to it first), y = c_0, then
//   y + c_j; a dropped slot adds +0.0 * that gate. __fmul_rn and
//   __fadd_rn keep nvcc from fusing a multiply and an add, and bfloat16
//   rounds after each operation as PyTorch's eager ops do, so the sum is
//   the plain version's bit for bit. No atomics: two calls give the same
//   bits.
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;       // every kernel here
constexpr int kWarps = kThreads / 32;
constexpr int kMaxExperts = 256;    // a scan thread an expert
constexpr int kMaxChunks = 64;      // the place kernel sums this many counts
constexpr int kSlice = 128;         // assignments a place block owns
constexpr int kMaxTopK = 32;        // a lane a slot in the combine
constexpr int kUnroll = 4;          // loads a lane has in flight before it stores

__global__ void __launch_bounds__(kThreads)
moe_rank_kernel(const int64_t* __restrict__ ids, long long nk, int e_local,
                long long e0, long long chunk, int* __restrict__ rank,
                int* __restrict__ counts) {
  allow_dependent_launch();  // the place kernel may be scheduled
  __shared__ int warp_count[kWarps][kMaxExperts];
  __shared__ int warp_first[kWarps][kMaxExperts];
  __shared__ int running[kMaxExperts];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  for (int i = t; i < kWarps * kMaxExperts; i += kThreads)
    warp_count[i / kMaxExperts][i % kMaxExperts] = 0;
  if (t < e_local) running[t] = 0;
  __syncthreads();
  const long long start = blockIdx.x * chunk;
  const long long stop = min(start + chunk, nk);
  // the bound is the block's, so every lane reaches the __match_any_sync
  for (long long round = start; round < stop; round += kThreads) {
    const long long a = round + t;
    int e = -2;  // past the assignments: its own class
    if (a < stop) {
      const long long f = ids[a] - e0;
      e = (f >= 0 && f < e_local) ? static_cast<int>(f) : -1;
    }
    const unsigned same = __match_any_sync(kFullMask, e);
    const int below = __popc(same & ((1u << lane) - 1u));
    if (e >= 0 && below == 0) warp_count[w][e] = __popc(same);
    __syncthreads();
    if (t < e_local) {
      int run = running[t];
      for (int v = 0; v < kWarps; ++v) {
        warp_first[v][t] = run;
        run += warp_count[v][t];
        warp_count[v][t] = 0;
      }
      running[t] = run;
    }
    __syncthreads();
    if (a < stop) rank[a] = e >= 0 ? warp_first[w][e] + below : -1;
  }
  if (t < e_local) counts[blockIdx.x * e_local + t] = running[t];
}

__device__ __forceinline__ void copy_row(const uint4* __restrict__ src,
                                         uint4* __restrict__ dst,
                                         long long units, int lane) {
  for (long long v0 = lane; v0 < units; v0 += 32 * kUnroll) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (v0 + 32 * u < units) r[u] = src[v0 + 32 * u];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (v0 + 32 * u < units) dst[v0 + 32 * u] = r[u];
  }
}

__global__ void __launch_bounds__(kThreads)
moe_place_kernel(const int64_t* __restrict__ ids, const uint4* __restrict__ x,
                 long long x_row, long long row_units, int k, long long nk,
                 int e_local, long long e0, long long cap, long long chunk,
                 int n_chunks, const int* __restrict__ rank,
                 const int* __restrict__ counts, long long zero_rows,
                 int64_t* __restrict__ expert_out,
                 int64_t* __restrict__ row_out, bool* __restrict__ keep_out,
                 uint4* __restrict__ buf) {
  __shared__ int part_before[kThreads], part_all[kThreads];
  __shared__ long long first[kMaxExperts], filled[kMaxExperts];
  __shared__ long long src[kSlice], dst[kSlice];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const long long a0 = static_cast<long long>(blockIdx.x) * kSlice;
  const int own = static_cast<int>(min(a0, max(nk - 1, 0LL)) / chunk);
  grid_dependency_wait();  // the rank kernel has finished
  // each expert's counts summed over the chunks, `groups` threads an
  // expert: before this block's chunk, and over all of them
  const int groups = kThreads / e_local, e_t = t % e_local, g_t = t / e_local;
  int before = 0, all = 0;
  if (g_t < groups)
    for (int q = g_t; q < n_chunks; q += groups) {
      const int v = counts[q * e_local + e_t];
      all += v;
      before += q < own ? v : 0;
    }
  part_before[t] = before;
  part_all[t] = all;
  __syncthreads();
  if (t < e_local) {
    long long b = 0, n = 0;
    for (int g = 0; g < groups; ++g) {
      b += part_before[g * e_local + t];
      n += part_all[g * e_local + t];
    }
    first[t] = b;
    filled[t] = min(n, cap);
  }
  __syncthreads();
  if (t < kSlice) {
    const long long a = a0 + t;
    long long to = -1;
    if (a < nk) {
      const int r = rank[a];
      long long e = e_local, row = 0;
      bool keep = false;
      if (r >= 0) {
        const long long le = ids[a] - e0, at = first[le] + r;
        if (at < cap) {
          e = le;
          row = at;
          keep = true;
          to = le * cap + at;
        }
      }
      expert_out[a] = e;
      row_out[a] = row;
      keep_out[a] = keep;
      src[t] = a / k;
    }
    dst[t] = to;
  }
  __syncthreads();
  for (int i = w; i < kSlice; i += kWarps)
    if (dst[i] >= 0)
      copy_row(x + src[i] * x_row, buf + dst[i] * row_units, row_units, lane);
  // this block's share of the buffer rows: zero those past the count
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const long long z0 = static_cast<long long>(blockIdx.x) * zero_rows;
  const long long z1 = min(z0 + zero_rows, e_local * cap);
  for (long long z = z0 + w; z < z1; z += kWarps) {
    const long long e = z / cap;
    if (z - e * cap >= filled[e]) {
      uint4* row = buf + z * row_units;
      for (long long v = lane; v < row_units; v += 32) row[v] = zero;
    }
  }
}

// kVec elements of T as f32, from one 16-byte load
template <typename T, int kVec> struct Pack;

template <> struct Pack<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&f)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = q.x; f[1] = q.y; f[2] = q.z; f[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <> struct Pack<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&f)[8]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t word[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(word[i] << 16);
      f[2 * i + 1] = __uint_as_float(word[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&f)[8]) {
    uint32_t word[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) word[i] = pack_bf16(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = make_uint4(word[0], word[1], word[2],
                                              word[3]);
  }
};

// x rounded to T and back, as an eager op's result in T
template <typename T> __device__ __forceinline__ float rounded(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
moe_combine_kernel(const T* __restrict__ out,
                   const int64_t* __restrict__ expert,
                   const int64_t* __restrict__ row,
                   const bool* __restrict__ keep,
                   const float* __restrict__ gates, T* __restrict__ y,
                   long long n, int k, long long d, long long cap) {
  const int lane = threadIdx.x & 31;
  const long long token =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (token >= n) return;  // a whole warp
  long long from = -1;     // slot `lane`'s output row, -1 where dropped
  float gate = 0.f;
  if (lane < k) {
    const long long a = token * k + lane;
    const bool kept = keep[a];
    gate = rounded<T>(__fmul_rn(gates[a], kept ? 1.f : 0.f));
    if (kept) from = (expert[a] * cap + row[a]) * d;
  }
  for (long long col = lane * kVec; col < d; col += 32 * kVec) {
    float acc[kVec];
    for (int j0 = 0; j0 < k; j0 += kUnroll) {
      float o[kUnroll][kVec];
      float g[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = min(j0 + u, k - 1);
        const long long at = __shfl_sync(kFullMask, from, j);
        g[u] = __shfl_sync(kFullMask, gate, j);
        if (at >= 0 && j0 + u < k) {
          Pack<T, kVec>::load(out + at + col, o[u]);
        } else {
#pragma unroll
          for (int i = 0; i < kVec; ++i) o[u][i] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + u >= k) break;
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float c = rounded<T>(__fmul_rn(o[u][i], g[u]));
          acc[i] = j0 + u == 0 ? c : rounded<T>(__fadd_rn(acc[i], c));
        }
      }
    }
    Pack<T, kVec>::store(y + token * d + col, acc);
  }
}

template <typename T, int kVec>
cudaError_t launch_combine(const void* out, const int64_t* expert,
                           const int64_t* row, const bool* keep,
                           const float* gates, void* y, long long n, int k,
                           long long d, long long cap, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
  moe_combine_kernel<T, kVec><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(out), expert, row, keep, gates,
      static_cast<T*>(y), n, k, d, cap);
  return cudaGetLastError();
}

bool aligned(const void* p, long long bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace
}  // namespace repro

// ids (n, k) int64; x rows of d elements of elt bytes, x_row apart, rows
// and strides whole 16-byte units from a 16-byte aligned base; the
// plan (chunk a multiple of 256 assignments, n_chunks <= 64 of them,
// n_slices = ceil(n k / 128)) from kernels/moe_route.py::plan; scratch
// n k + n_chunks e_local int32; expert, row (n k) int64, keep (n k) bool,
// buf (e_local, cap, d) written whole.
extern "C" int repro_moe_dispatch(const void* ids, const void* x, int elt,
                                  long long n, int k, long long d,
                                  long long x_row, int e_local, long long e0,
                                  long long cap, long long chunk,
                                  int n_chunks, int n_slices, void* scratch,
                                  void* expert, void* row, void* keep,
                                  void* buf, void* stream) {
  using namespace repro;
  const long long nk = n * k;
  if (n < 0 || k <= 0 || d <= 0 || (elt != 2 && elt != 4) || e_local <= 0 ||
      e_local > kMaxExperts || cap <= 0 || chunk <= 0 ||
      chunk % (2 * kSlice) != 0 || n_chunks <= 0 || n_chunks > kMaxChunks ||
      static_cast<long long>(n_chunks) * chunk < nk || n_slices <= 0 ||
      static_cast<long long>(n_slices) * kSlice < nk || nk >= (1LL << 31) ||
      buf == nullptr || scratch == nullptr || (d * elt) % 16 != 0 ||
      (x_row * elt) % 16 != 0 || !aligned(x, 16) || !aligned(buf, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* id = static_cast<const int64_t*>(ids);
  int* rank = static_cast<int*>(scratch);
  int* counts = rank + nk;
  moe_rank_kernel<<<n_chunks, kThreads, 0, s>>>(id, nk, e_local, e0, chunk,
                                                rank, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long zero_rows = (e_local * cap + n_slices - 1) / n_slices;
  const long long row_bytes = d * elt, stride_bytes = x_row * elt;
  err = launch_dependent(
      moe_place_kernel, dim3(n_slices), dim3(kThreads), s, id,
      static_cast<const uint4*>(x), stride_bytes / 16, row_bytes / 16, k, nk,
      e_local, e0, cap, chunk, n_chunks, static_cast<const int*>(rank),
      static_cast<const int*>(counts), zero_rows,
      static_cast<int64_t*>(expert), static_cast<int64_t*>(row),
      static_cast<bool*>(keep), static_cast<uint4*>(buf));
  return static_cast<int>(err);
}

// out (e_local, cap, d) and y (n, d) contiguous and 16-byte aligned, of
// `dtype`, d a multiple of 4 (float32) or 8 (bfloat16); expert, row
// (n k) int64, keep (n k) bool, gates (n k) float32.
extern "C" int repro_moe_combine(const void* out, int dtype,
                                 const void* expert, const void* row,
                                 const void* keep, const void* gates, void* y,
                                 long long n, int k, long long d,
                                 long long cap, void* stream) {
  using namespace repro;
  if (n <= 0 || k <= 0 || k > kMaxTopK || d <= 0 || cap <= 0 ||
      (n + kWarps - 1) / kWarps >= (1LL << 31) || y == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* e = static_cast<const int64_t*>(expert);
  const auto* r = static_cast<const int64_t*>(row);
  const auto* kp = static_cast<const bool*>(keep);
  const auto* g = static_cast<const float*>(gates);
  if (!aligned(out, 16) || !aligned(y, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == kF32 && d % 4 == 0)
    err = launch_combine<float, 4>(out, e, r, kp, g, y, n, k, d, cap, s);
  else if (dtype == kBF16 && d % 8 == 0)
    err = launch_combine<__nv_bfloat16, 8>(out, e, r, kp, g, y, n, k, d, cap,
                                           s);
  return static_cast<int>(err);
}
