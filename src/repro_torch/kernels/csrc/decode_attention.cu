// Single-token decode attention with GQA over a (ring) KV cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (body _decode_kernel): q (B, H, hd), k/v caches
// (B, W, KV, hd), lengths (B,) -> out (B, H, hd) in q's type, slots
// [0, length) valid, the KV head of query head h being h / (H / KV).
// Scores are scaled after the dot; the output is acc / max(l, 1e-30), as
// in the TPU kernel. Lengths above W mean W; a length must be >= 1.
//
// What bounds it on an H100: bytes. Each cache element is read once and
// used for G = H / KV multiply-adds per product: at RecurrentGemma's
// shapes (B 4, W 2048, KV 1, hd 256, G 16) the caches are 16.8 MB, 5.0 us
// at 3.35 TB/s, against 0.27 GFLOP of products.
//
// What the design does about it: split-K flash decoding. The TPU kernel
// walks the window sequentially per (request, KV head) with its running
// (m, l, acc) in VMEM; that would give Hopper only B * KV blocks, 4 here
// for 132 SMs. So the window is cut into splits, one block per (split,
// KV head, request), and a second small kernel merges the splits' partial
// (m, l, acc) by their maxima. Each block keeps the query group resident
// in shared memory (as the TPU kernel keeps it in VMEM), streams its keys
// through in tiles of kTile, and reads every K and V element of its valid
// slots once from device memory; slots at or past the length are never
// read. Scores: a warp per key, lanes over the head dim, one warp sum per
// query head. Softmax: a warp per query head over the tile. P.V: threads
// over the head dim, each holding its columns of all G rows in registers.
// A block has few keys, so its time is load latency, not bandwidth: each
// warp loads kKU keys and each thread kVU value rows before using any,
// and the merge reads the splits' maxima in parallel, so that many loads
// are in flight at once rather than one after another.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                     // keys per tile
constexpr int kMaxG = 16;                     // query heads per KV head
constexpr int kMaxHD = 256;
constexpr int kKSlots = kMaxHD / 32;          // head-dim elements per lane (Q.K)
constexpr int kDSlots = kMaxHD / kThreads;    // head-dim columns per thread (P.V)
constexpr int kMaxSplits = 64;
constexpr int kKU = 4;    // keys a warp loads before its dots
constexpr int kVU = 16;   // value rows a thread loads before its FMAs
constexpr float kNegInf = -1e30f;

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

struct CacheStrides {
  long long b, w, h;  // elements; the head dim is contiguous
};

// One block per (split, KV head, request): the partial softmax state of
// the group's G query heads over keys [split * chunk, min(.. + chunk,
// length)), written to m_part / l_part (rows of G) and acc_part (G x hd).
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ lengths,
                      float* __restrict__ m_part, float* __restrict__ l_part,
                      float* __restrict__ acc_part, int W, int G, int hd,
                      int chunk, long long qsb, long long qsh, CacheStrides ks,
                      CacheStrides vs, float scale) {
  __shared__ float q_s[kMaxG][kMaxHD];
  __shared__ float s_s[kMaxG][kTile];
  __shared__ float m_s[kMaxG], l_s[kMaxG], c_s[kMaxG];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(lengths[b], W);
  const int k0 = split * chunk, k1 = min(k0 + chunk, len);
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  const T* qb = q + b * qsb + static_cast<long long>(kvh) * G * qsh;

#pragma unroll 8
  for (int e = tid; e < G * hd; e += kThreads) {
    const int g = e / hd, d = e % hd;
    q_s[g][d] = to_f32(qb[g * qsh + d]);
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxG][kDSlots];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int u = 0; u < kDSlots; ++u) acc[g][u] = 0.f;
  __syncthreads();

  for (int kt = k0; kt < k1; kt += kTile) {
    // scores of the tile: warp w takes keys w, w + kWarps, ..., kKU at a
    // time; a masked slot (at or past k1) is never read and scores -1e30
    for (int jj0 = warp; jj0 < kTile; jj0 += kWarps * kKU) {
      float kv[kKU][kKSlots];
#pragma unroll
      for (int x = 0; x < kKU; ++x) {
        const int j = kt + jj0 + x * kWarps;
#pragma unroll
        for (int u = 0; u < kKSlots; ++u) {
          const int d = lane + 32 * u;
          kv[x][u] = (j < k1 && d < hd) ? to_f32(kb[j * ks.w + d]) : 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;  // block-uniform
        float part[kKU];
#pragma unroll
        for (int x = 0; x < kKU; ++x) {
          part[x] = 0.f;
#pragma unroll
          for (int u = 0; u < kKSlots; ++u) {
            const int d = lane + 32 * u;
            if (d < hd) part[x] = fmaf(q_s[g][d], kv[x][u], part[x]);
          }
        }
#pragma unroll
        for (int x = 0; x < kKU; ++x) part[x] = warp_sum(part[x]);
        if (lane == 0) {
#pragma unroll
          for (int x = 0; x < kKU; ++x) {
            const int jj = jj0 + x * kWarps;
            s_s[g][jj] = kt + jj < k1 ? part[x] * scale : kNegInf;
          }
        }
      }
    }
    __syncthreads();

    // online softmax over the tile: warp w takes query heads w, w + kWarps
    for (int g = warp; g < G; g += kWarps) {
      const float s0 = s_s[g][lane], s1 = s_s[g][lane + 32];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      s_s[g][lane] = p0;
      s_s[g][lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        c_s[g] = c;
        l_s[g] = l_s[g] * c + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // P.V: thread t owns head-dim columns t, t + kThreads, ...
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      const float c = c_s[g];
#pragma unroll
      for (int u = 0; u < kDSlots; ++u) acc[g][u] *= c;
    }
    // rows past k1 load 0 and carry p = 0 (their score is -1e30)
    const int nk = min(kTile, k1 - kt);
    for (int jj0 = 0; jj0 < nk; jj0 += kVU) {
      float vv[kVU][kDSlots];
#pragma unroll
      for (int x = 0; x < kVU; ++x) {
        const int j = kt + jj0 + x;
#pragma unroll
        for (int u = 0; u < kDSlots; ++u) {
          const int d = tid + kThreads * u;
          vv[x][u] = (jj0 + x < nk && d < hd) ? to_f32(vb[j * vs.w + d]) : 0.f;
        }
      }
#pragma unroll
      for (int x = 0; x < kVU; ++x) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g >= G) break;
          const float p = s_s[g][jj0 + x];
#pragma unroll
          for (int u = 0; u < kDSlots; ++u)
            acc[g][u] = fmaf(p, vv[x][u], acc[g][u]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites s_s
  }

  const long long row0 =
      ((static_cast<long long>(b) * gridDim.y + kvh) * gridDim.x + split) * G;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int u = 0; u < kDSlots; ++u) {
      const int d = tid + kThreads * u;
      if (d < hd) acc_part[(row0 + g) * hd + d] = acc[g][u];
    }
  }
  if (tid < G) {
    m_part[row0 + tid] = m_s[tid];
    l_part[row0 + tid] = l_s[tid];
  }
}

// One block per (query head of the group, KV head, request): merge the
// splits' partial states by their maxima and normalise.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ m_part,
                    const float* __restrict__ l_part,
                    const float* __restrict__ acc_part, T* __restrict__ o,
                    int NS, int G, int hd, long long osb, long long osh) {
  __shared__ float m_s[kMaxSplits], l_s[kMaxSplits], w_s[kMaxSplits];
  __shared__ float inv_s;
  const int g = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const long long row0 = (static_cast<long long>(b) * gridDim.y + kvh) * NS;
  if (tid < NS) {  // NS <= kMaxSplits <= kThreads: one load each, together
    m_s[tid] = m_part[(row0 + tid) * G + g];
    l_s[tid] = l_part[(row0 + tid) * G + g];
  }
  __syncthreads();
  if (tid == 0) {
    float m = kNegInf;
    for (int s = 0; s < NS; ++s) m = fmaxf(m, m_s[s]);
    float l = 0.f;
    for (int s = 0; s < NS; ++s) {
      w_s[s] = expf(m_s[s] - m);  // 0 for a split with no valid slot
      l += l_s[s] * w_s[s];
    }
    inv_s = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  T* ob = o + b * osb + (static_cast<long long>(kvh) * G + g) * osh;
  for (int d = tid; d < hd; d += kThreads) {
    float acc = 0.f;
#pragma unroll 16
    for (int s = 0; s < NS; ++s)
      acc = fmaf(acc_part[((row0 + s) * G + g) * hd + d], w_s[s], acc);
    ob[d] = from_f32<T>(acc * inv_s);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, float* scratch, void* o, int B, int W,
                   int H, int KV, int hd, int NS, int chunk, long long qsb,
                   long long qsh, CacheStrides ks, CacheStrides vs,
                   long long osb, long long osh, float scale,
                   cudaStream_t stream) {
  const int G = H / KV;
  const long long rows = static_cast<long long>(B) * KV * NS * G;
  float* m_part = scratch;
  float* l_part = scratch + rows;
  float* acc_part = scratch + 2 * rows;
  decode_partial_kernel<T><<<dim3(NS, KV, B), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, m_part, l_part, acc_part, W, G, hd,
      chunk, qsb, qsh, ks, vs, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T><<<dim3(G, KV, B), kThreads, 0, stream>>>(
      m_part, l_part, acc_part, static_cast<T*>(o), NS, G, hd, osb, osh);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// q: (B, H, hd) with (batch, head) element strides; k/v: (B, W, KV, hd)
// with (batch, slot, head) element strides; every head dim contiguous.
// lengths: (B,) int32. scratch: B * KV * NS * G * (2 + hd) floats. out:
// (B, H, hd) with (batch, head) strides. hd <= 256, H / KV <= 16,
// NS <= 64, NS * chunk >= W. Returns the launches' cudaError_t.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* scratch, void* o, int dtype, int B, int W, int H, int KV, int hd,
    int NS, int chunk, long long qsb, long long qsh, long long ksb,
    long long ksw, long long ksh, long long vsb, long long vsw,
    long long vsh, long long osb, long long osh, float scale, void* stream) {
  using namespace repro;
  if (hd > kMaxHD || hd <= 0 || KV <= 0 || H % KV != 0 || H / KV > kMaxG ||
      NS <= 0 || NS > kMaxSplits || static_cast<long long>(NS) * chunk < W ||
      B <= 0 || B > 65535 || KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const CacheStrides ks{ksb, ksw, ksh}, vs{vsb, vsw, vsh};
  const int* len = static_cast<const int*>(lengths);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(q, k, v, len, sc, o, B, W, H, KV, hd, NS, chunk,
                           qsb, qsh, ks, vs, osb, osh, scale, s);
    case kBF16:
      return launch<__nv_bfloat16>(q, k, v, len, sc, o, B, W, H, KV, hd, NS,
                                   chunk, qsb, qsh, ks, vs, osb, osh, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
