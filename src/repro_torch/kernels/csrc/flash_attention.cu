// Causal / sliding-window prefill attention with GQA, f32 online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel): q (B, S, H, hd), k/v (B, S, KV, hd)
// -> out (B, S, H, hd) in q's type, the KV head of query head h being
// h / (H / KV). Scores are scaled after the dot, masked to -1e30, and the
// output is acc / max(l, 1e-30), as in the TPU kernel.
//
// What bounds it on an H100: bytes. At the tiers' shapes (S = 16, hd <= 64)
// each (b, h) pair does 2 S^2 hd causal FLOPs over 4 S hd elements it must
// move, about S / 2 FLOP per 4-byte element: far below the card's ratio
// of FP32 rate to HBM rate. At B = 1 it is bound by the launch itself.
//
// What the design does about it: one block per (query tile, head, batch)
// reads its query tile and each needed K/V tile once from device memory
// into shared memory (converted to f32 there) and keeps the softmax state
// (m, l, acc) in registers, so nothing but q, k, v and the output crosses
// HBM. Warp w owns query rows w, w + 4, ...; lane j owns key j of the
// current tile for the scores (a dot over hd read from shared memory,
// rows padded by one float so lanes hit distinct banks) and head-dim
// elements lane, lane + 32, ... of the accumulator. Row max and row sum
// are warp shuffles. Key tiles wholly above the diagonal, or wholly left
// of the window, are never loaded (the TPU kernel's tile skip); the
// ragged sequence edge is masked in the kernel, so S need not be a
// multiple of a tile. Products are plain FMAs: at S = 16 a tensor-core
// tile would be mostly padding.
//
// Head dims up to 256 (RecurrentGemma's local attention): the tiles' row
// length HD is a template parameter, 128 for hd <= 128 and 256 above, so
// every shared-memory stride is a constant. At HD 128 the three tiles
// (kBQ HD + kBK (HD + 1) + kBK HD floats, 40.5 KB) are static shared
// memory, as before hd 256 was added; at HD 256 they take 81 KB, above
// the 48 KB a block gets statically, so they are dynamic shared memory
// and the launch raises the kernel's limit once per type. At
// RecurrentGemma's prefill (S = 3000, window 2048) the tile skip drops the
// key tiles left of each query tile's window as well as those above the
// diagonal. There the kernel is bound by operations, not bytes: 4.05 M
// (query, key) pairs per head times 4 hd FLOPs is 265 GFLOP at B = 4,
// H = 16, about 4 ms at the FP32 rate; these FMAs read both operands from
// shared memory, and 81 KB of tiles leave room for two blocks (eight
// warps) an SM, too few to hide the latency, so they reach a fraction of
// that rate (a tensor-core version is a later change).
#include "common.cuh"

namespace repro {
namespace {

constexpr int kBQ = 16;      // query rows per block
constexpr int kBK = 32;      // keys per tile = lanes per warp
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kBQ / kWarps;
constexpr int kMaxHD = 256;
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, s, h;  // elements; the head dim is contiguous
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// floats of the three tiles at row length HD
template <int HD>
__host__ __device__ constexpr int tile_floats() {
  return kBQ * HD + kBK * (HD + 1) + kBK * HD;
}

template <int HD>
__host__ __device__ constexpr bool tiles_static() {
  return tile_floats<HD>() * 4 <= 48 * 1024;
}

// HD: the tiles' row length, hd <= HD
template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int group, int hd, Strides qs, Strides ks, Strides vs,
                       Strides os, int causal, int window, float scale) {
  constexpr int kDPerLane = HD / 32;
  constexpr int kld = HD + 1;  // padded: lanes read distinct banks
  // q_s[kBQ][HD], k_s[kBK][HD + 1], v_s[kBK][HD], all f32
  float* q_s;
  if constexpr (tiles_static<HD>()) {
    __shared__ float tiles[tile_floats<HD>()];
    q_s = tiles;
  } else {
    extern __shared__ float tiles_dyn[];
    q_s = tiles_dyn;
  }
  float* k_s = q_s + kBQ * HD;
  float* v_s = k_s + kBK * kld;

  const int q_start = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int e = tid; e < kBQ * hd; e += kWarps * 32) {
    const int r = e / hd, d = e % hd, s = q_start + r;
    q_s[r * HD + d] = s < S ? to_f32(qb[s * qs.s + d]) : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int t = 0; t < kRowsPerWarp; ++t) {
    m[t] = kNegInf;
    l[t] = 0.f;
#pragma unroll
    for (int u = 0; u < kDPerLane; ++u) acc[t][u] = 0.f;
  }

  // tile-level skip: keys above the block's last query row (causal) and
  // keys left of its first row's window are never loaded
  const int q_last = min(q_start + kBQ, S) - 1;
  const int k_hi = causal ? q_last : S - 1;
  const int k_lo = (causal && window > 0) ? max(0, q_start - window + 1) : 0;

  for (int kt = (k_lo / kBK) * kBK; kt <= k_hi; kt += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * hd; e += kWarps * 32) {
      const int j = e / hd, d = e % hd, s = kt + j;
      const bool in = s < S;
      k_s[j * kld + d] = in ? to_f32(kb[s * ks.s + d]) : 0.f;
      v_s[j * HD + d] = in ? to_f32(vb[s * vs.s + d]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int t = 0; t < kRowsPerWarp; ++t) {
      const int r = warp + t * kWarps, qi = q_start + r;
      if (qi >= S) continue;  // warp-uniform
      const int kj = kt + lane;
      float sc = 0.f;
      const float* qr = q_s + r * HD;
      const float* kr = k_s + lane * kld;
      for (int d = 0; d < hd; ++d) sc = fmaf(qr[d], kr[d], sc);
      sc *= scale;
      const bool ok = kj < S && (!causal || kj <= qi) &&
                      (window <= 0 || qi - kj < window);
      sc = ok ? sc : kNegInf;

      const float m_new = fmaxf(m[t], warp_max(sc));
      const float corr = expf(m[t] - m_new);
      const float p = expf(sc - m_new);
      l[t] = l[t] * corr + warp_sum(p);
#pragma unroll
      for (int u = 0; u < kDPerLane; ++u) acc[t][u] *= corr;
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(kFullMask, p, j);
#pragma unroll
        for (int u = 0; u < kDPerLane; ++u) {
          const int d = lane + 32 * u;
          if (d < hd) acc[t][u] = fmaf(pj, v_s[j * HD + d], acc[t][u]);
        }
      }
      m[t] = m_new;
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int t = 0; t < kRowsPerWarp; ++t) {
    const int r = warp + t * kWarps, qi = q_start + r;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l[t], 1e-30f);
#pragma unroll
    for (int u = 0; u < kDPerLane; ++u) {
      const int d = lane + 32 * u;
      if (d < hd) ob[qi * os.s + d] = from_f32<T>(acc[t][u] * inv);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int H, int KV, int hd, Strides qs,
                      Strides ks, Strides vs, Strides os, int causal,
                      int window, float scale, cudaStream_t stream) {
  size_t smem = 0;
  if constexpr (!tiles_static<HD>()) {
    smem = sizeof(float) * tile_floats<HD>();
    static bool raised = false;  // the dynamic limit, once per type
    if (!raised) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_attention_kernel<T, HD>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      raised = true;
    }
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, HD><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H / KV, hd, qs, ks,
      vs, os, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KV, int hd, Strides qs,
                   Strides ks, Strides vs, Strides os, int causal,
                   int window, float scale, cudaStream_t stream) {
  if (hd <= 128)
    return launch_hd<T, 128>(q, k, v, o, B, S, H, KV, hd, qs, ks, vs, os,
                             causal, window, scale, stream);
  return launch_hd<T, 256>(q, k, v, o, B, S, H, KV, hd, qs, ks, vs, os,
                           causal, window, scale, stream);
}

}  // namespace
}  // namespace repro

// q/o: (B, S, H, hd), k/v: (B, S, KV, hd), each with a contiguous head dim
// and the given (batch, seq, head) element strides; hd <= 256, H % KV == 0.
// window <= 0 means no window. Returns the launch's cudaError_t.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int H, int KV, int hd, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, int causal, int window, float scale,
    void* stream) {
  using namespace repro;
  if (hd > kMaxHD || hd <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(q, k, v, o, B, S, H, KV, hd, qs, ks, vs, os, causal, window, scale, s);
    case kBF16:
      return launch<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, qs, ks, vs, os, causal, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
