// Backward of flash attention: dQ, dK, dV of the causal / windowed GQA
// attention and of the non-causal form over T != S keys that
// flash_attention.cu computes forward, in the FA2 scheme.
//
// Replaces the gradient of the TPU kernel src/repro/kernels/
// flash_attention.py::flash_attention. That Pallas kernel has no custom_vjp:
// the JAX package trains through XLA's differentiable attention_core
// (src/repro/models/attention.py) instead. The port routes every attention
// through its flash kernel and never falls back to a plain path on the
// card, so training there needs this kernel. With s = q.k * scale, masked as
// the forward masks it (causal, window, keys past T), and the forward's
// row log-sum-exp lse:
//
//   P = exp(s - lse)        dP = dO . V^T        D = rowsum(dO o O)
//   dS = P o (dP - D)       dV = P^T dO          dK = dS^T Q * scale
//   dQ = dS K * scale
//
// Three kernels on PyTorch's stream, in order:
//
// 1. flash_bwd_prep_kernel: D, one warp a (b, h, position) row, f32 at
//    (B, H, S).
// 2. flash_bwd_dkdv_kernel: one block a (b, kv head, tile of kTile keys).
//    It keeps its dK and dV tiles in registers and walks every query tile
//    that can see its keys, for each of the G query heads of its KV head
//    (the GQA group summed inside the block), recomputing P and dS.
// 3. flash_bwd_dq_kernel: one block a (b, head, tile of kTile queries),
//    walking the key tiles its queries can see, as the forward does.
//
// No atomics: every output element is summed by one thread in a fixed
// order, so two calls give the same bits (and a recomputed forward under
// remat the same gradients as no remat). The price is that P and dS are
// computed twice, once in each of kernels 2 and 3.
//
// What bounds it on an H100: operations. The backward does about 2.5 times
// the forward's products (four of the 2 S T hd-FLOP products against the
// forward's two, and the recomputed Q.K^T): at granite-moe-1b-a400m's
// training shape (4, 2048, 16 heads over 8, hd 64, causal) 21.5 GFLOP, 0.32
// ms at the FP32 CUDA-core rate of 67 TFLOP/s, against 0.1 ms for its
// bytes. This first kernel runs on CUDA-core FMAs in f32 (bf16 inputs are
// widened as the tiles load): tensor-core products (mma.sync, as the
// forward's long-sequence kernel) are later work. A block holds its K, V,
// Q and dO tiles of kTile rows in shared memory as f32, rows padded to HD +
// 4 floats (HD: hd rounded up to 64, 128 or 256, the padding zero) so that
// the score loop's float4 row loads are free of bank conflicts; each warp
// computes 4 query rows x 32 keys of s and dP, and then, with those in
// shared memory, 4 rows x HD / 32 columns of its accumulators: 4 + HD / 32
// shared loads feed 4 HD / 32 FMAs of each product.
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kTile = 32;                // keys (dK/dV) or queries (dQ) a block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kTile / kWarps;    // rows of a tile a warp owns: 4
constexpr int kMaxHD = 256;

struct Strides {
  long long b, s, h;  // elements; the head dim is contiguous
};

struct Shape {
  int S, Tk, H, group, hd, causal, window;
  float scale;
};

__device__ __forceinline__ bool key_ok(int kj, int qi, int T, int causal,
                                       int window) {
  return kj < T && (!causal || kj <= qi) && (window <= 0 || qi - kj < window);
}

template <int HD>
__host__ __device__ constexpr int pitch() { return HD + 4; }

// floats of the four row tiles, the two (kTile x kTile) score tiles and
// the two row vectors (lse, D)
template <int HD>
__host__ __device__ constexpr int smem_floats() {
  return 4 * kTile * pitch<HD>() + 2 * kTile * kTile + 2 * kTile;
}

// rows [r0, r0 + kTile) of x (row stride `rs` elements from `base`) into a
// tile of pitch HD as f32; rows at or past `n` and columns at or past hd
// are zero
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* tile, const T* base,
                                          long long rs, int r0, int n,
                                          int hd) {
  for (int e = threadIdx.x; e < kTile * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    tile[r * pitch<HD>() + d] =
        (r0 + r < n && d < hd) ? to_f32(base[(r0 + r) * rs + d]) : 0.f;
  }
}

// The scores of a warp's 4 query rows (rows w * 4 + t of q_s / do_s)
// against key `lane` of k_s / v_s: s = q.k and dp = dO.v, over HD.
template <int HD>
__device__ __forceinline__ void dots(float (&s)[kRows], float (&dp)[kRows],
                                     const float* q_s, const float* do_s,
                                     const float* k_s, const float* v_s,
                                     int warp, int lane) {
  constexpr int P = pitch<HD>();
#pragma unroll
  for (int t = 0; t < kRows; ++t) s[t] = dp[t] = 0.f;
  const float* kr = k_s + lane * P;
  const float* vr = v_s + lane * P;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
    const float4 v4 = *reinterpret_cast<const float4*>(vr + d);
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const int i = warp * kRows + t;
      const float4 q4 = *reinterpret_cast<const float4*>(q_s + i * P + d);
      const float4 o4 = *reinterpret_cast<const float4*>(do_s + i * P + d);
      s[t] = fmaf(q4.x, k4.x, s[t]);
      s[t] = fmaf(q4.y, k4.y, s[t]);
      s[t] = fmaf(q4.z, k4.z, s[t]);
      s[t] = fmaf(q4.w, k4.w, s[t]);
      dp[t] = fmaf(o4.x, v4.x, dp[t]);
      dp[t] = fmaf(o4.y, v4.y, dp[t]);
      dp[t] = fmaf(o4.z, v4.z, dp[t]);
      dp[t] = fmaf(o4.w, v4.w, dp[t]);
    }
  }
}

// P and dS of a warp's 4 query rows against key `lane`, at absolute query
// positions q0 + i and key position k0 + lane; 0 where masked or past S.
template <int HD>
__device__ __forceinline__ void probs(float (&p)[kRows], float (&ds)[kRows],
                                      const float* q_s, const float* do_s,
                                      const float* k_s, const float* v_s,
                                      const float* lse_s, const float* d_s,
                                      int q0, int k0, const Shape& sh,
                                      int warp, int lane) {
  float s[kRows], dp[kRows];
  dots<HD>(s, dp, q_s, do_s, k_s, v_s, warp, lane);
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    const int i = warp * kRows + t, qi = q0 + i;
    const bool ok = qi < sh.S && key_ok(k0 + lane, qi, sh.Tk, sh.causal,
                                        sh.window);
    p[t] = ok ? expf(s[t] * sh.scale - lse_s[i]) : 0.f;
    ds[t] = p[t] * (dp[t] - d_s[i]);
  }
}

// ---------------------------------------------------------------------------
// 1. D = rowsum(dO o O)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, long long rows, int S, int H,
                      int hd, Strides os, Strides ds) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps +
                        threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int s = static_cast<int>(row % S);
  const long long bh = row / S;
  const int h = static_cast<int>(bh % H);
  const long long b = bh / H;
  const T* orow = o + b * os.b + s * os.s + h * os.h;
  const T* drow = dout + b * ds.b + s * ds.s + h * ds.h;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFullMask, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// 2. dK, dV: one block a (key tile, kv head, batch)
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, Strides qs, Strides ks, Strides vs,
                      Strides ds, Shape sh) {
  constexpr int P = pitch<HD>(), kCols = HD / 32;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                       // [kTile][P]
  float* v_s = k_s + kTile * P;
  float* q_s = v_s + kTile * P;
  float* do_s = q_s + kTile * P;
  float* p_s = do_s + kTile * P;           // [query][key]
  float* ds_s = p_s + kTile * kTile;
  float* lse_s = ds_s + kTile * kTile;     // [query]
  float* d_s = lse_s + kTile;

  const int k0 = blockIdx.x * kTile, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_rows<T, HD>(k_s, k + b * ks.b + kvh * ks.h, ks.s, k0, sh.Tk, sh.hd);
  load_rows<T, HD>(v_s, v + b * vs.b + kvh * vs.h, vs.s, k0, sh.Tk, sh.hd);

  float acc_k[kRows][kCols], acc_v[kRows][kCols];
#pragma unroll
  for (int t = 0; t < kRows; ++t)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[t][c] = acc_v[t][c] = 0.f;

  // query positions that can see a key of [k0, k0 + kTile): from k0 when
  // causal, up to the last key's window
  const int q_lo = sh.causal ? k0 : 0;
  const int q_hi = sh.window > 0
                       ? min(sh.S - 1, k0 + kTile - 1 + sh.window - 1)
                       : sh.S - 1;
  for (int hg = 0; hg < sh.group; ++hg) {
    const int h = kvh * sh.group + hg;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* db = dout + b * ds.b + h * ds.h;
    const long long row0 = (static_cast<long long>(b) * sh.H + h) * sh.S;
    for (int q0 = (q_lo / kTile) * kTile; q0 <= q_hi; q0 += kTile) {
      __syncthreads();  // the previous tile's readers are done
      load_rows<T, HD>(q_s, qb, qs.s, q0, sh.S, sh.hd);
      load_rows<T, HD>(do_s, db, ds.s, q0, sh.S, sh.hd);
      if (threadIdx.x < kTile) {
        const int qi = q0 + threadIdx.x;
        lse_s[threadIdx.x] = qi < sh.S ? lse[row0 + qi] : 0.f;
        d_s[threadIdx.x] = qi < sh.S ? delta[row0 + qi] : 0.f;
      }
      __syncthreads();
      float p[kRows], dsv[kRows];
      probs<HD>(p, dsv, q_s, do_s, k_s, v_s, lse_s, d_s, q0, k0, sh, warp,
                lane);
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        const int i = warp * kRows + t;
        p_s[i * kTile + lane] = p[t];
        ds_s[i * kTile + lane] = dsv[t];
      }
      __syncthreads();
      // dV[j] += sum_i P[i][j] dO[i], dK[j] += sum_i dS[i][j] Q[i] for this
      // warp's keys j = warp * 4 + t and columns lane + 32 c
#pragma unroll 4
      for (int i = 0; i < kTile; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(p_s + i * kTile + warp * kRows);
        const float4 s4 =
            *reinterpret_cast<const float4*>(ds_s + i * kTile + warp * kRows);
        const float pv[kRows] = {p4.x, p4.y, p4.z, p4.w};
        const float sv[kRows] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float dov = do_s[i * P + lane + 32 * c];
          const float qv = q_s[i * P + lane + 32 * c];
#pragma unroll
          for (int t = 0; t < kRows; ++t) {
            acc_v[t][c] = fmaf(pv[t], dov, acc_v[t][c]);
            acc_k[t][c] = fmaf(sv[t], qv, acc_k[t][c]);
          }
        }
      }
    }
  }

  // dk / dv: (B, T, KV, hd) contiguous
  const int kv_heads = gridDim.y;
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    const int kj = k0 + warp * kRows + t;
    if (kj >= sh.Tk) continue;
    const long long base =
        ((static_cast<long long>(b) * sh.Tk + kj) * kv_heads + kvh) * sh.hd;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < sh.hd) {
        dk[base + d] = from_f32<T>(acc_k[t][c] * sh.scale);
        dv[base + d] = from_f32<T>(acc_v[t][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: one block a (query tile, head, batch)
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Strides qs, Strides ks, Strides vs, Strides ds, Shape sh) {
  constexpr int P = pitch<HD>(), kCols = HD / 32;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * P;
  float* q_s = v_s + kTile * P;
  float* do_s = q_s + kTile * P;
  float* ds_s = do_s + kTile * P;          // [query][key]
  float* lse_s = ds_s + 2 * kTile * kTile;
  float* d_s = lse_s + kTile;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / sh.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_rows<T, HD>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, sh.S, sh.hd);
  load_rows<T, HD>(do_s, dout + b * ds.b + h * ds.h, ds.s, q0, sh.S, sh.hd);
  const long long row0 = (static_cast<long long>(b) * sh.H + h) * sh.S;
  if (threadIdx.x < kTile) {
    const int qi = q0 + threadIdx.x;
    lse_s[threadIdx.x] = qi < sh.S ? lse[row0 + qi] : 0.f;
    d_s[threadIdx.x] = qi < sh.S ? delta[row0 + qi] : 0.f;
  }

  float acc[kRows][kCols];
#pragma unroll
  for (int t = 0; t < kRows; ++t)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[t][c] = 0.f;

  // the forward's key range: up to the last query (causal), from the first
  // query's window (causal with a window)
  const int q_last = min(q0 + kTile, sh.S) - 1;
  const int k_hi = sh.causal ? min(q_last, sh.Tk - 1) : sh.Tk - 1;
  const int k_lo =
      (sh.causal && sh.window > 0) ? max(0, q0 - sh.window + 1) : 0;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  for (int k0 = (k_lo / kTile) * kTile; k0 <= k_hi; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, HD>(k_s, kb, ks.s, k0, sh.Tk, sh.hd);
    load_rows<T, HD>(v_s, vb, vs.s, k0, sh.Tk, sh.hd);
    __syncthreads();
    float p[kRows], dsv[kRows];
    probs<HD>(p, dsv, q_s, do_s, k_s, v_s, lse_s, d_s, q0, k0, sh, warp,
              lane);
#pragma unroll
    for (int t = 0; t < kRows; ++t)
      ds_s[(warp * kRows + t) * kTile + lane] = dsv[t];
    __syncthreads();
    // dQ[i] += sum_j dS[i][j] K[j] for this warp's rows i = warp * 4 + t
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float sv[kRows];
#pragma unroll
      for (int t = 0; t < kRows; ++t)
        sv[t] = ds_s[(warp * kRows + t) * kTile + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float kv = k_s[j * P + lane + 32 * c];
#pragma unroll
        for (int t = 0; t < kRows; ++t) acc[t][c] = fmaf(sv[t], kv, acc[t][c]);
      }
    }
  }

  // dq: (B, S, H, hd) contiguous
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    const int qi = q0 + warp * kRows + t;
    if (qi >= sh.S) continue;
    const long long base =
        ((static_cast<long long>(b) * sh.S + qi) * sh.H + h) * sh.hd;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < sh.hd) dq[base + d] = from_f32<T>(acc[t][c] * sh.scale);
    }
  }
}

template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, size_t bytes, bool& raised) {
  if (raised || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) raised = true;
  return err;
}

template <typename T, int HD>
cudaError_t launch_hd(const T* q, const T* k, const T* v, const T* o,
                      const T* dout, const float* lse, float* delta, T* dq,
                      T* dk, T* dv, int B, int KV, Strides qs, Strides ks,
                      Strides vs, Strides os, Strides ds, const Shape& sh,
                      cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * sh.H * sh.S;
  flash_bwd_prep_kernel<T><<<static_cast<unsigned>((rows + kWarps - 1) /
                                                   kWarps),
                             kThreads, 0, stream>>>(o, dout, delta, rows,
                                                    sh.S, sh.H, sh.hd, os,
                                                    ds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem = sizeof(float) * smem_floats<HD>();
  static bool raised_kv = false, raised_q = false;  // once per instantiation
  err = raise_smem(flash_bwd_dkdv_kernel<T, HD>, smem, raised_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((sh.Tk + kTile - 1) / kTile, KV, B);
  flash_bwd_dkdv_kernel<T, HD><<<grid_kv, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, qs, ks, vs, ds, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = raise_smem(flash_bwd_dq_kernel<T, HD>, smem, raised_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((sh.S + kTile - 1) / kTile, sh.H, B);
  flash_bwd_dq_kernel<T, HD><<<grid_q, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, qs, ks, vs, ds, sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int KV,
                   Strides qs, Strides ks, Strides vs, Strides os, Strides ds,
                   const Shape& sh, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(o);
  const T* dt = static_cast<const T*>(dout);
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  if (sh.hd <= 64)
    return launch_hd<T, 64>(qt, kt, vt, ot, dt, lse, delta, dqt, dkt, dvt, B,
                            KV, qs, ks, vs, os, ds, sh, stream);
  if (sh.hd <= 128)
    return launch_hd<T, 128>(qt, kt, vt, ot, dt, lse, delta, dqt, dkt, dvt,
                             B, KV, qs, ks, vs, os, ds, sh, stream);
  return launch_hd<T, 256>(qt, kt, vt, ot, dt, lse, delta, dqt, dkt, dvt, B,
                           KV, qs, ks, vs, os, ds, sh, stream);
}

}  // namespace
}  // namespace repro

// q, o, dout: (B, S, H, hd); k, v: (B, T, KV, hd); each with a contiguous
// head dim and the given (batch, seq, head) element strides. lse: the
// forward's (B, H, S) f32; delta: (B, H, S) f32 scratch for D; dq (B, S, H,
// hd), dk and dv (B, T, KV, hd): contiguous, in the inputs' type. Masks and
// scale as repro_flash_attention's. Returns the first failing launch's
// cudaError_t.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int S, int T, int H, int KV, int hd,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, long long dsb, long long dss, long long dsh,
    int causal, int window, float scale, void* stream) {
  using namespace repro;
  if (hd > kMaxHD || hd <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || T <= 0 ||
      B <= 0 || B > 65535 || H > 65535 || (causal && T != S))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh}, ds{dsb, dss, dsh};
  const Shape sh{S, T, H, H / KV, hd, causal, window, scale};
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(q, k, v, o, dout, lf, df, dq, dk, dv, B, KV, qs,
                           ks, vs, os, ds, sh, s);
    case kBF16:
      return launch<__nv_bfloat16>(q, k, v, o, dout, lf, df, dq, dk, dv, B,
                                   KV, qs, ks, vs, os, ds, sh, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
