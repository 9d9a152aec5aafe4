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
// With a soft cap c (flash_attention.cu: s' = c tanh(s / c) before the
// mask, and the forward's lse over s'), P = exp(s' - lse) and dS takes the
// cap's derivative, dS = P o (dP - D) o (1 - t^2) with t = tanh(s / c),
// before the scale of dK and dQ. As in the forward, a template flag (kCap)
// keeps the uncapped instantiations the code they were, and the cap is
// tanhf, not tanh.approx.f32.
//
// Kernels on PyTorch's stream, in order: flash_bwd_prep_kernel (D, one warp
// a (b, h, position) row, f32 at (B, H, S)); a dK/dV kernel; for a split
// dK/dV grid, flash_bwd_sum_kernel; a dQ kernel. No atomics: every output
// element is summed by one thread in a fixed order (the split partials too),
// so two calls give the same bits, and a recomputed forward under remat the
// same gradients as no remat. The price is that P and dS are computed
// twice, once in the dK/dV kernel and once in the dQ kernel: seven products
// of 2 hd FLOPs per (query, key) pair, against FA2's five with an atomic dQ.
//
// The C entry point picks one of two forms from the shape, as the forward
// does: the shorter of S and T against a threshold that chip_smoke.py's
// backward sweep set on an H100 (the tensor-core form first won at S = 40
// at the tiers' widths, hd <= 64, B = 64, and lost again by 1-5% at S = 80
// and 96, where a 64-row tile is a fifth padding; at RG's 16 heads of 256
// it won from S = 16, the smallest S swept).
//
// * Long sequences: tensor cores (namespace tensor). What bounds it on an
//   H100 is operations at the tensor-core rate. In f32 every product runs as
//   3xTF32 (three TF32 mma.sync products per FMA pair, hi.hi + hi.lo +
//   lo.hi; one TF32 product misses the 1e-4 gate,
//   tests/test_torch_flash_precision.py): at RecurrentGemma's training shape
//   (2, 3000, 16 heads over 1, hd 256, window 2048) five products take 2.0 ms
//   at 495 TFLOP/s (one product per pair: 0.67 ms), and the seven this kernel
//   forms 2.8 ms, against 0.1 ms for its bytes. mma.sync reaches a part of
//   that rate only; the operand loads from shared memory and the splits
//   into hi and lo compete with it for issue slots. The design:
//
//   - One block body serves both kernels. A block holds M = 64 resident rows
//     (keys for dK/dV, packed query rows for dQ: the GQA group's heads are
//     the rows of one tile, as in the forward, so each streamed K/V tile
//     serves the whole group) and streams tiles of N rows of the other side
//     (64 at hd <= 128, 32 above). Per tile: S' = R1 . X1^T and dP' = R2 .
//     X2^T (M x N; for dK/dV R = K, V and X = Q, dO, so S' = S^T; for dQ R =
//     Q, dO and X = K, V), P' and dS' in registers, stored to shared memory,
//     then acc1 += dS' X1 (dK or dQ) and, for dK/dV, acc2 += P' X2 (dV).
//     Eight warps: 4 x 2 over (M, N) for the scores; 2 x 4 over (M, head
//     dim) for the accumulating products, two m-tiles a warp, so that each
//     streamed operand a warp loads and splits serves two mma, not one. At
//     hd 256 dK + dV take 128 registers a thread; at hd <= 64 both kernels
//     fit in 128 registers, two blocks an SM.
//   - A two-slot cp.async ring, X1 and X2 in turn: each slot is refilled as
//     soon as its last product is done, so it loads during the next
//     product. dK/dV: S' (Q), dP' (dO), dK (Q) then Q(next) loads during dV
//     (dO), dO(next) during the next S'. dQ: dP' (V) then V(next) loads
//     during S' and dQ (K), K(next) during the next dP'. The rows' lse and
//     D come with Q by 4-byte cp.async. At hd 256 in f32 the tiles take 215
//     KB, one block an SM; a deeper ring does not fit.
//   - Streamed tiles that no resident row can see (above the diagonal, left
//     of the window) are never loaded; only tiles that cross an edge
//     (diagonal, window, end of S or T) are masked element by element.
//   - Fill: a dK/dV block per 64 keys gives 2 x 47 blocks at RG's one KV
//     head; the wrapper splits each key tile's query rows over `splits`
//     blocks (kernels/flash_attention.py bwd_splits), which write f32
//     partials to a scratch buffer that flash_bwd_sum_kernel adds in split
//     order.
//   - Shared memory: tiles padded to pitch HD + 4 floats (HD + 8 bf16), 4
//     words mod 32, the P'/dS' tile to N + 8 floats. The score products read
//     their operands in the natural k order (f32 with ldmatrix, as pairs of
//     b16: 8 x 4 blocks, 32 banks); the accumulating products read rows 2c
//     and 2c + 1 of the streamed tile by columns (32 banks) with P'/dS' as
//     float2 pairs: the k order of the forward's P.V, so no operand is read
//     transposed.
//   - The split: hi is x as it stands (the tensor core reads its top 19
//     bits) and lo = x - tf32(x), two operations where the forward's
//     round-to-nearest split takes three. The product's error stays near
//     2^-20 of its size.
//   - bf16: m16n8k16 products with f32 accumulation; P' and dS' enter theirs
//     as hi = bf16(x) and lo = bf16(x - hi), as the forward's P does.
//
// * Short sequences (the live cascade pair's S = 16 at hd <= 128):
//   CUDA-core FMAs (namespace simt), where a 64-row tile would be mostly
//   padding and the launch and the bytes bound the call. One block a (key
//   tile of 32, KV head, batch) for dK/dV summing the GQA group itself, one
//   a (query tile of 32, head, batch) for dQ; K, V, Q and dO tiles in shared
//   memory as f32, each warp 4 rows x 32 keys of s and dP, then 4 rows x HD
//   / 32 columns of its accumulators.
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kMaxHD = 256;
// S from which the tensor-core form runs, at hd <= 128 and above
constexpr int kTensorCoreMinSeq = 40, kTensorCoreMinSeqWide = 16;

struct Strides {
  long long b, s, h;  // elements; the head dim is contiguous
};

struct Shape {
  int S, Tk, H, group, hd, causal, window;
  float scale, cap, inv_cap;  // cap 0: no soft cap (inv_cap = 1 / cap)
};

bool use_tensor_cores(int S, int T, int hd) {
  const int n = S < T ? S : T;
  return n >= (hd <= 128 ? kTensorCoreMinSeq : kTensorCoreMinSeqWide);
}

__device__ __forceinline__ bool key_ok(int kj, int qi, int T, int causal,
                                       int window) {
  return kj < T && (!causal || kj <= qi) && (window <= 0 || qi - kj < window);
}

// P and dS of one (row, key) from the raw dot s, dP, the row's lse and D:
// P = exp(s' - lse), dS = P (dP - D), s' the scaled score, soft-capped
// under kCap, where dS also takes the cap's derivative 1 - tanh^2
template <bool kCap>
__device__ __forceinline__ void prob(float s, float dp, float lse, float d,
                                     bool ok, const Shape& sh, float& p,
                                     float& ds) {
  if constexpr (kCap) {
    const float t = tanhf(s * sh.scale * sh.inv_cap);
    p = ok ? expf(sh.cap * t - lse) : 0.f;
    ds = p * (dp - d) * (1.f - t * t);
  } else {
    p = ok ? expf(s * sh.scale - lse) : 0.f;
    ds = p * (dp - d);
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

// ---------------------------------------------------------------------------
// D = rowsum(dO o O)
// ---------------------------------------------------------------------------
constexpr int kPrepWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kPrepWarps * 32)
flash_bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, long long rows, int S, int H,
                      int hd, Strides os, Strides ds) {
  const long long row = static_cast<long long>(blockIdx.x) * kPrepWarps +
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

template <typename T>
cudaError_t launch_prep(const T* o, const T* dout, float* delta, int B,
                        Strides os, Strides ds, const Shape& sh,
                        cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * sh.H * sh.S;
  flash_bwd_prep_kernel<T><<<static_cast<unsigned>((rows + kPrepWarps - 1) /
                                                   kPrepWarps),
                             kPrepWarps * 32, 0, stream>>>(
      o, dout, delta, rows, sh.S, sh.H, sh.hd, os, ds);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// short sequences: CUDA-core FMAs
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kTile = 32;                // keys (dK/dV) or queries (dQ) a block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kTile / kWarps;    // rows of a tile a warp owns: 4

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
template <int HD, bool kCap>
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
    prob<kCap>(s[t], dp[t], lse_s[i], d_s[i], ok, sh, p[t], ds[t]);
  }
}

// dK, dV: one block a (key tile, kv head, batch)
template <typename T, int HD, bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_bwd_fma_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, Strides qs, Strides ks,
                          Strides vs, Strides ds, Shape sh) {
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
      probs<HD, kCap>(p, dsv, q_s, do_s, k_s, v_s, lse_s, d_s, q0, k0, sh,
                      warp, lane);
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

// dQ: one block a (query tile, head, batch)
template <typename T, int HD, bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_bwd_fma_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        Strides qs, Strides ks, Strides vs, Strides ds,
                        Shape sh) {
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
    probs<HD, kCap>(p, dsv, q_s, do_s, k_s, v_s, lse_s, d_s, q0, k0, sh,
                    warp, lane);
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

template <typename T, int HD, bool kCap>
cudaError_t launch_hd(const T* q, const T* k, const T* v, const T* dout,
                      const float* lse, const float* delta, T* dq, T* dk,
                      T* dv, int B, int KV, Strides qs, Strides ks,
                      Strides vs, Strides ds, const Shape& sh,
                      cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * smem_floats<HD>();
  static bool raised_kv = false, raised_q = false;  // once per instantiation
  cudaError_t err = raise_smem(flash_bwd_fma_dkdv_kernel<T, HD, kCap>, smem,
                               raised_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((sh.Tk + kTile - 1) / kTile, KV, B);
  flash_bwd_fma_dkdv_kernel<T, HD, kCap><<<grid_kv, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, qs, ks, vs, ds, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = raise_smem(flash_bwd_fma_dq_kernel<T, HD, kCap>, smem, raised_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((sh.S + kTile - 1) / kTile, sh.H, B);
  flash_bwd_fma_dq_kernel<T, HD, kCap><<<grid_q, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dq, qs, ks, vs, ds, sh);
  return cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// long sequences: tensor cores
// ---------------------------------------------------------------------------
namespace tensor {

// hi = x as it stands (the tensor core reads its top 19 bits: x truncated
// to TF32), lo = x - tf32(x), also truncated where read: one AND and one
// subtraction. |lo| < 2^-10 |x| (tests/test_torch_flash_precision.py
// emulates the scheme).
__device__ __forceinline__ void split_trunc(float x, uint32_t& hi,
                                            uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// a 4-byte cp.async; src-size 0 zero-fills (a row past the end)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool in) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(in ? 4 : 0) : "memory");
}

constexpr int kM = 64;        // resident rows a block: keys or query rows
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// the accumulating products: each warp takes kMB m-tiles of 16 rows and
// HD / (2 kMB) head-dim columns, nt_b n-tiles of 8
constexpr int kMB = 2;
template <int HD>
__host__ __device__ constexpr int nt_b() { return HD / (16 * kMB); }
template <int HD>
using Acc = float[kMB][nt_b<HD>()][4];

// blocks an SM the register allocation aims at: two at hd <= 64, where
// the tiles leave room for them (128 registers a thread); one for the
// capped f32 dQ kernel, whose tanhf spilled under 128 registers
template <int HD>
__host__ __device__ constexpr int min_blocks() { return HD <= 64 ? 2 : 1; }
template <typename T, int HD, bool kCap>
__host__ __device__ constexpr int min_blocks_dq() {
  return kCap && sizeof(T) == 4 ? 1 : min_blocks<HD>();
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&d)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]) : "r"(a));
}

// streamed rows a tile (query rows or keys): 64 at hd <= 128, 32 above,
// where two 64-row f32 tiles do not fit beside the resident ones
template <int HD>
__host__ __device__ constexpr int n_tile() { return HD <= 128 ? 64 : 32; }
// pitch (floats) of the P' / dS' tiles: float2 accesses at 8 mod 32
template <int HD>
__host__ __device__ constexpr int ld_p() { return n_tile<HD>() + 8; }

// padded row pitch (elements) of the K, V, Q and dO tiles
template <typename T, int HD>
__host__ __device__ constexpr int ld() { return HD + TilePads<T>::kV; }

// the two resident and two streamed tiles, then n_probs f32 tiles of kM x
// n_tile (P' and dS' for dK/dV, dS' for dQ)
template <typename T, int HD, int n_probs>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) * size_t(2 * kM + 2 * n_tile<HD>()) * ld<T, HD>() +
         sizeof(float) * n_probs * kM * ld_p<HD>();
}

// Copy `rows` rows of hd elements into a tile of pitch L, as the forward's
// tensor::load_tile: row_ptr(r) gives row r's source or nullptr for a row
// past the end, which is zero-filled (cp.async then reads nothing at
// `base`, a valid address). cp.async in 16-byte chunks when every row start
// is 16-byte aligned and hd fills whole chunks; plain loads otherwise. Ends
// one cp.async group.
template <typename T, typename RowPtr>
__device__ __forceinline__ void load_tile(T* tile, int L, int rows, int hd,
                                          bool aligned, const T* base,
                                          RowPtr row_ptr) {
  const int tid = threadIdx.x;
  if (aligned) {
    constexpr int kE = 16 / sizeof(T);
    const int cpr = hd / kE;
    for (int e = tid; e < rows * cpr; e += kThreads) {
      const int r = e / cpr, c = e - r * cpr;
      const T* src = row_ptr(r);
      cp_async16(tile + r * L + c * kE, src ? src + c * kE : base,
                 src != nullptr);
    }
  } else {
    for (int e = tid; e < rows * hd; e += kThreads) {
      const int r = e / hd, d = e - r * hd;
      const T* src = row_ptr(r);
      tile[r * L + d] = src ? src[d] : from_f32<T>(0.f);
    }
  }
  cp_async_commit();
}

// s[nt] = R(16 rows from r) . X(8 rows from x + 8 nt)^T over the head dim
// (HD: the zero padding past hd adds nothing), for the warp's n_tile / 16
// n-tiles. k runs in its natural order, so each fragment is four 8 x 4
// blocks of f32 that one ldmatrix.x4 reads (16-byte rows at a pitch of 4
// words mod 32: 32 banks). The small terms run in their own accumulators,
// a second mma chain, and at hd 256 in two.
template <int HD>
__device__ __forceinline__ void scores(float (&s)[n_tile<HD>() / 16][4],
                                       const float* r, const float* x, int g,
                                       int c) {
  constexpr int L = ld<float, HD>(), NT = n_tile<HD>() / 16;
  constexpr bool kTwo = HD > 128;
  float small[NT][4], small2[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = small[nt][i] = small2[nt][i] = 0.f;
  const int lane = threadIdx.x & 31;
  const float* ra = r + ((lane & 7) + 8 * ((lane >> 3) & 1)) * L +
                    4 * (lane >> 4);
  const float* xa = x + ((lane & 7) + 8 * (lane >> 4)) * L +
                    4 * ((lane >> 3) & 1);
#pragma unroll 8
  for (int ks = 0; ks < HD / 8; ++ks) {
    uint32_t av[4], ah[4], al[4];
    ldmatrix_x4(av, ra + ks * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_trunc(__uint_as_float(av[i]), ah[i], al[i]);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bv[4];
      ldmatrix_x4(bv, xa + np * 16 * L + ks * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nt = 2 * np + j;
        uint32_t bh[2], bl[2];
        split_trunc(__uint_as_float(bv[2 * j]), bh[0], bl[0]);
        split_trunc(__uint_as_float(bv[2 * j + 1]), bh[1], bl[1]);
        mma_tf32(small[nt], al, bh);
        mma_tf32(kTwo ? small2[nt] : small[nt], ah, bl);
        mma_tf32(s[nt], ah, bh);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[nt][i] += kTwo ? small[nt][i] + small2[nt][i] : small[nt][i];
}

template <int HD>
__device__ __forceinline__ void scores(float (&s)[n_tile<HD>() / 16][4],
                                       const __nv_bfloat16* r,
                                       const __nv_bfloat16* x, int g, int c) {
  constexpr int L = ld<__nv_bfloat16, HD>(), NT = n_tile<HD>() / 16;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
  const __nv_bfloat16* r0 = r + g * L + 2 * c;
  const __nv_bfloat16* x0 = x + g * L + 2 * c;
#pragma unroll 8
  for (int ks = 0; ks < HD / 16; ++ks) {
    const uint32_t a[4] = {ld_u32(r0 + ks * 16), ld_u32(r0 + 8 * L + ks * 16),
                           ld_u32(r0 + ks * 16 + 8),
                           ld_u32(r0 + 8 * L + ks * 16 + 8)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* xn = x0 + nt * 8 * L + ks * 16;
      const uint32_t bb[2] = {ld_u32(xn), ld_u32(xn + 8)};
      mma_bf16(s[nt], a, bb);
    }
  }
}

// acc[nt] += A(16 rows from a, n_tile wide, f32 at pitch ld_p) . Y(n_tile
// rows, columns 8 nt.. from y) for the columns below `cols`. A's k index c
// holds row 2c of Y and c + 4 holds 2c + 1 (the forward's P.V order): A is
// read as float2 pairs, Y by columns of rows 2c, 2c + 1.
template <int HD>
__device__ __forceinline__ void accumulate(Acc<HD>& acc, const float* a,
                                           const float* y, int cols, int g,
                                           int c) {
  constexpr int L = ld<float, HD>(), kLdP = ld_p<HD>();
  const float* a0 = a + g * kLdP + 2 * c;
  const float* y0 = y + 2 * c * L + g;
#pragma unroll
  for (int kk = 0; kk < n_tile<HD>() / 8; ++kk) {
    uint32_t ah[kMB][4], al[kMB][4];
#pragma unroll
    for (int mt = 0; mt < kMB; ++mt) {
      const float* am = a0 + mt * 16 * kLdP + kk * 8;
      const float2 x0 = *reinterpret_cast<const float2*>(am);
      const float2 x1 = *reinterpret_cast<const float2*>(am + 8 * kLdP);
      split_trunc(x0.x, ah[mt][0], al[mt][0]);
      split_trunc(x1.x, ah[mt][1], al[mt][1]);
      split_trunc(x0.y, ah[mt][2], al[mt][2]);
      split_trunc(x1.y, ah[mt][3], al[mt][3]);
    }
    const float* yk = y0 + kk * 8 * L;
#pragma unroll
    for (int nt = 0; nt < nt_b<HD>(); ++nt) {
      if (nt * 8 >= cols) break;
      uint32_t bh[2], bl[2];
      split_trunc(yk[nt * 8], bh[0], bl[0]);
      split_trunc(yk[L + nt * 8], bh[1], bl[1]);
#pragma unroll
      for (int mt = 0; mt < kMB; ++mt) {
        mma_tf32(acc[mt][nt], al[mt], bh);
        mma_tf32(acc[mt][nt], ah[mt], bl);
        mma_tf32(acc[mt][nt], ah[mt], bh);
      }
    }
  }
}

// bf16: A enters as hi = bf16(x) and lo = bf16(x - hi), Y is bf16 already
template <int HD>
__device__ __forceinline__ void accumulate(Acc<HD>& acc, const float* a,
                                           const __nv_bfloat16* y, int cols,
                                           int g, int c) {
  constexpr int L = ld<__nv_bfloat16, HD>(), kLdP = ld_p<HD>();
  const float* a0 = a + g * kLdP + 2 * c;
  const __nv_bfloat16* y0 = y + 2 * c * L + g;
#pragma unroll
  for (int kk = 0; kk < n_tile<HD>() / 16; ++kk) {
    // rows g, g + 8 and k pairs (2c, 2c + 1), (2c + 8, 2c + 9)
    uint32_t ah[kMB][4], al[kMB][4];
#pragma unroll
    for (int mt = 0; mt < kMB; ++mt) {
      const float* ak = a0 + mt * 16 * kLdP + kk * 16;
      const float2 x[4] = {
          *reinterpret_cast<const float2*>(ak),
          *reinterpret_cast<const float2*>(ak + 8 * kLdP),
          *reinterpret_cast<const float2*>(ak + 8),
          *reinterpret_cast<const float2*>(ak + 8 * kLdP + 8)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat16 h0 = __float2bfloat16(x[i].x);
        const __nv_bfloat16 h1 = __float2bfloat16(x[i].y);
        ah[mt][i] = pack_bf16(h0, h1);
        al[mt][i] = pack_bf16(x[i].x - __bfloat162float(h0),
                              x[i].y - __bfloat162float(h1));
      }
    }
    const __nv_bfloat16* yk = y0 + kk * 16 * L;
#pragma unroll
    for (int nt = 0; nt < nt_b<HD>(); ++nt) {
      if (nt * 8 >= cols) break;
      const __nv_bfloat16* yn = yk + nt * 8;
      const uint32_t bb[2] = {pack_bf16(yn[0], yn[L]),
                              pack_bf16(yn[8 * L], yn[9 * L])};
#pragma unroll
      for (int mt = 0; mt < kMB; ++mt) {
        mma_bf16(acc[mt][nt], al[mt], bb);
        mma_bf16(acc[mt][nt], ah[mt], bb);
      }
    }
  }
}

// P' and dS' of this warp's 16 x n_tile / 2 scores (rows m0 + g (+8) of
// the resident side, columns n0 + 8 nt + 2c (+1) of the streamed side) into
// p_s (null: not stored) and ds_s, masked where !ok(r, nt, e).
template <int HD, bool kCap, typename Ok, typename Lse, typename Del>
__device__ __forceinline__ void probs(const float (&s)[n_tile<HD>() / 16][4],
                                      const float (&dp)[n_tile<HD>() / 16][4],
                                      const Shape& sh, float* p_s, float* ds_s,
                                      int m0, int n0, int g, int c, Ok ok,
                                      Lse lse_of, Del d_of) {
  constexpr int kLdP = ld_p<HD>();
#pragma unroll
  for (int nt = 0; nt < n_tile<HD>() / 16; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float p[2], dsv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * r + e;
        prob<kCap>(s[nt][i], dp[nt][i], lse_of(r, nt, e), d_of(r, nt, e),
                   ok(r, nt, e), sh, p[e], dsv[e]);
      }
      const int off = (m0 + g + 8 * r) * kLdP + n0 + nt * 8 + 2 * c;
      if (p_s) *reinterpret_cast<float2*>(p_s + off) = make_float2(p[0], p[1]);
      *reinterpret_cast<float2*>(ds_s + off) = make_float2(dsv[0], dsv[1]);
    }
}

template <int HD>
__device__ __forceinline__ void zero(Acc<HD>& acc) {
#pragma unroll
  for (int mt = 0; mt < kMB; ++mt)
#pragma unroll
    for (int nt = 0; nt < nt_b<HD>(); ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
}

// acc (rows 16 mt + g (+8) from the warp's first, columns h0 + 8 nt + 2c
// (+1)) * mul into dst(row) + column, for rows where dst(row) is not null
// and columns < hd
template <typename D, int HD, typename Dst>
__device__ __forceinline__ void store(const Acc<HD>& acc, float mul, int h0,
                                      int hd, int g, int c, Dst dst) {
#pragma unroll
  for (int mt = 0; mt < kMB; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      D* row = dst(16 * mt + g + 8 * r);
      if (row == nullptr) continue;
#pragma unroll
      for (int nt = 0; nt < nt_b<HD>(); ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = h0 + nt * 8 + 2 * c + e;
          if (d < hd) row[d] = from_f32<D>(acc[mt][nt][2 * r + e] * mul);
        }
    }
}

struct Args {
  Strides qs, ks, vs, ds;
  Shape sh;
  int splits, aligned;
};

// dK, dV: one block a (tile of kM keys, kv head, batch x split), walking
// its split's share of the packed (position, head-in-group) query rows
// that can see its keys. splits == 1: dk, dv in T; else f32 partials at
// part[(split) * n] (dK) and part[(splits + split) * n] (dV), n = B T KV hd.
template <typename T, int HD, bool kCap>
__global__ void __launch_bounds__(kThreads, min_blocks<HD>())
flash_bwd_tc_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, float* __restrict__ part,
                         Args args) {
  constexpr int L = ld<T, HD>(), kN = n_tile<HD>(), NT = kN / 16,
                kLdP = ld_p<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);   // [kM][L]
  T* v_s = k_s + kM * L;
  T* q_s = v_s + kM * L;                     // [kN][L], streamed
  T* do_s = q_s + kN * L;
  float* p_s = reinterpret_cast<float*>(do_s + kN * L);  // [kM][kLdP]
  float* ds_s = p_s + kM * kLdP;
  float* lse_s = ds_s + kM * kLdP;           // [kN]: lse, D of Q's rows
  float* d_s = lse_s + kN;

  const Shape sh = args.sh;
  const int G = sh.group, n_rows = sh.S * G, hd = sh.hd;
  const int k0 = blockIdx.x * kM, kvh = blockIdx.y;
  const int b = blockIdx.z / args.splits, split = blockIdx.z % args.splits;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int m0 = 16 * (warp & 3), n0 = (kN / 2) * (warp >> 2);
  // the accumulating products' rows and head-dim columns
  const int mb = 16 * kMB * (warp / (2 * kMB));
  const int h0 = (warp % (2 * kMB)) * (HD / (2 * kMB));

  // head-dim padding up to HD stays zero, so every k step may read it
  for (int e = tid; e < (2 * kM + 2 * kN) * (HD - hd); e += kThreads)
    k_s[(e / (HD - hd)) * L + hd + e % (HD - hd)] = from_f32<T>(0.f);

  auto key_rows = [&](const T* base, long long stride) {
    return [=](int r) -> const T* {
      return k0 + r < sh.Tk ? base + (k0 + r) * stride : nullptr;
    };
  };
  auto packed = [&](const T* base, const Strides& st, int r0) {
    return [=](int r) -> const T* {
      const int row = r0 + r;
      if (row >= n_rows) return nullptr;
      return base + b * st.b + (row / G) * st.s + (kvh * G + row % G) * st.h;
    };
  };
  const T* kb = k + b * args.ks.b + kvh * args.ks.h;
  const T* vb = v + b * args.vs.b + kvh * args.vs.h;
  load_tile(k_s, L, kM, hd, args.aligned, kb, key_rows(kb, args.ks.s));
  load_tile(v_s, L, kM, hd, args.aligned, vb, key_rows(vb, args.vs.s));

  // query rows that can see a key of [k0, k0 + kM): positions from k0 when
  // causal, up to the last key's window; this split's share of their tiles
  const int pos_lo = sh.causal ? k0 : 0;
  const int pos_hi = sh.window > 0
                         ? min(sh.S - 1, k0 + kM - 1 + sh.window - 1)
                         : sh.S - 1;
  const int t_lo = pos_lo * G / kN;
  const int tiles = (min(n_rows, (pos_hi + 1) * G) - 1) / kN - t_lo + 1;
  const int t_first = t_lo + split * tiles / args.splits;
  const int t_end = t_lo + (split + 1) * tiles / args.splits;

  // lse and D of the rows [r0, r0 + kN), issued into Q's cp.async group
  auto load_stats = [&](int r0) {
    if (tid < kN) {
      const int row = r0 + tid;
      long long i = 0;
      if (row < n_rows)
        i = (static_cast<long long>(b) * sh.H + kvh * G + row % G) * sh.S +
            row / G;
      cp_async4(lse_s + tid, lse + i, row < n_rows);
      cp_async4(d_s + tid, delta + i, row < n_rows);
    }
  };
  if (t_first < t_end) {
    load_stats(t_first * kN);
    load_tile(q_s, L, kN, hd, args.aligned, q,
              packed(q, args.qs, t_first * kN));
    load_tile(do_s, L, kN, hd, args.aligned, dout,
              packed(dout, args.ds, t_first * kN));
  }

  Acc<HD> acc_k, acc_v;
  zero<HD>(acc_k);
  zero<HD>(acc_v);

  for (int t = t_first; t < t_end; ++t) {
    const int r0 = t * kN;
    cp_async_wait<1>();
    __syncthreads();  // K, V, Q(t) and its rows' lse, D landed
    float s[NT][4], dp[NT][4];
    scores<HD>(s, k_s + m0 * L, q_s + n0 * L, g, c);
    cp_async_wait<0>();
    __syncthreads();  // dO(t) landed
    scores<HD>(dp, v_s + m0 * L, do_s + n0 * L, g, c);

    // every (key, row) of the tile valid?
    const int p_first = r0 / G, p_last = (min(r0 + kN, n_rows) - 1) / G;
    const bool full = k0 + kM <= sh.Tk && r0 + kN <= n_rows &&
                      (!sh.causal || k0 + kM - 1 <= p_first) &&
                      (sh.window <= 0 || p_last - k0 < sh.window);
    probs<HD, kCap>(s, dp, sh, p_s, ds_s, m0, n0, g, c,
          [&](int r, int nt, int e) {
            const int row = r0 + n0 + nt * 8 + 2 * c + e;
            return full || (row < n_rows &&
                            key_ok(k0 + m0 + g + 8 * r, row / G, sh.Tk,
                                   sh.causal, sh.window));
          },
          [&](int, int nt, int e) { return lse_s[n0 + nt * 8 + 2 * c + e]; },
          [&](int, int nt, int e) { return d_s[n0 + nt * 8 + 2 * c + e]; });
    __syncthreads();  // P', dS' stored; lse_s, d_s read
    accumulate<HD>(acc_k, ds_s + mb * kLdP, q_s + h0, hd - h0, g, c);
    __syncthreads();  // Q(t)'s readers are done
    if (t + 1 < t_end) {
      load_stats(r0 + kN);
      load_tile(q_s, L, kN, hd, args.aligned, q,
                packed(q, args.qs, r0 + kN));
    } else {
      cp_async_commit();
    }
    accumulate<HD>(acc_v, p_s + mb * kLdP, do_s + h0, hd - h0, g, c);
    __syncthreads();  // dO(t)'s and P' / dS''s readers are done
    if (t + 1 < t_end)
      load_tile(do_s, L, kN, hd, args.aligned, dout,
                packed(dout, args.ds, r0 + kN));
    else
      cp_async_commit();
  }
  cp_async_wait_all();

  // (B, T, KV, hd) contiguous, or the split's f32 partials
  const long long n = static_cast<long long>(gridDim.z / args.splits) *
                      sh.Tk * gridDim.y * hd;
  auto at = [&](int r) -> long long {
    const int kj = k0 + mb + r;
    return kj < sh.Tk ? ((static_cast<long long>(b) * sh.Tk + kj) *
                             gridDim.y + kvh) * hd
                      : -1;
  };
  if (args.splits == 1) {
    store<T, HD>(acc_k, sh.scale, h0, hd, g, c, [&](int r) -> T* {
      const long long i = at(r);
      return i < 0 ? nullptr : dk + i;
    });
    store<T, HD>(acc_v, 1.f, h0, hd, g, c, [&](int r) -> T* {
      const long long i = at(r);
      return i < 0 ? nullptr : dv + i;
    });
  } else {
    float* pk = part + split * n;
    float* pv = part + (args.splits + split) * n;
    store<float, HD>(acc_k, 1.f, h0, hd, g, c, [&](int r) -> float* {
      const long long i = at(r);
      return i < 0 ? nullptr : pk + i;
    });
    store<float, HD>(acc_v, 1.f, h0, hd, g, c, [&](int r) -> float* {
      const long long i = at(r);
      return i < 0 ? nullptr : pv + i;
    });
  }
}

// dQ: one block a (tile of kM packed (position, head-in-group) query rows,
// kv head, batch), walking the key tiles its rows can see
template <typename T, int HD, bool kCap>
__global__ void __launch_bounds__(kThreads, min_blocks_dq<T, HD, kCap>())
flash_bwd_tc_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       Args args) {
  constexpr int L = ld<T, HD>(), kN = n_tile<HD>(), NT = kN / 16,
                kLdP = ld_p<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);   // [kM][L]
  T* do_s = q_s + kM * L;
  T* k_s = do_s + kM * L;                    // [kN][L], streamed
  T* v_s = k_s + kN * L;
  float* ds_s = reinterpret_cast<float*>(v_s + kN * L);  // [kM][kLdP]

  const Shape sh = args.sh;
  const int G = sh.group, n_rows = sh.S * G, hd = sh.hd;
  const int m_base = blockIdx.x * kM, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int m0 = 16 * (warp & 3), n0 = (kN / 2) * (warp >> 2);
  // the accumulating products' rows and head-dim columns
  const int mb = 16 * kMB * (warp / (2 * kMB));
  const int h0 = (warp % (2 * kMB)) * (HD / (2 * kMB));

  for (int e = tid; e < (2 * kM + 2 * kN) * (HD - hd); e += kThreads)
    q_s[(e / (HD - hd)) * L + hd + e % (HD - hd)] = from_f32<T>(0.f);

  auto packed = [&](const T* base, const Strides& st) {
    return [=](int r) -> const T* {
      const int row = m_base + r;
      if (row >= n_rows) return nullptr;
      return base + b * st.b + (row / G) * st.s + (kvh * G + row % G) * st.h;
    };
  };
  const T* kb = k + b * args.ks.b + kvh * args.ks.h;
  const T* vb = v + b * args.vs.b + kvh * args.vs.h;
  auto key_rows = [&](const T* base, long long stride, int kt) {
    return [=](int r) -> const T* {
      return kt + r < sh.Tk ? base + (kt + r) * stride : nullptr;
    };
  };
  load_tile(q_s, L, kM, hd, args.aligned, q, packed(q, args.qs));
  load_tile(do_s, L, kM, hd, args.aligned, dout, packed(dout, args.ds));

  // this thread's rows m_base + m0 + g (+8): position, lse, D
  int pos_r[2];
  float lse_r[2], d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m_base + m0 + g + 8 * r;
    pos_r[r] = -1;
    lse_r[r] = d_r[r] = 0.f;
    if (row < n_rows) {
      const int pos = row / G, h = kvh * G + row % G;
      const long long i =
          (static_cast<long long>(b) * sh.H + h) * sh.S + pos;
      pos_r[r] = pos;
      lse_r[r] = lse[i];
      d_r[r] = delta[i];
    }
  }

  // key tiles the block's positions can see: up to its last position
  // (causal), from its first position's window
  const int p_lo = m_base / G;
  const int p_hi = (min(m_base + kM, n_rows) - 1) / G;
  const int k_hi = sh.causal ? min(p_hi, sh.Tk - 1) : sh.Tk - 1;
  const int k_lo = sh.window > 0 ? max(0, p_lo - sh.window + 1) : 0;
  const int kt0 = (k_lo / kN) * kN;
  load_tile(v_s, L, kN, hd, args.aligned, vb, key_rows(vb, args.vs.s, kt0));
  load_tile(k_s, L, kN, hd, args.aligned, kb, key_rows(kb, args.ks.s, kt0));

  Acc<HD> acc;
  zero<HD>(acc);

  for (int kt = kt0; kt <= k_hi; kt += kN) {
    const bool more = kt + kN <= k_hi;
    cp_async_wait<1>();
    __syncthreads();  // Q, dO and V(kt) landed
    float s[NT][4], dp[NT][4];
    scores<HD>(dp, do_s + m0 * L, v_s + n0 * L, g, c);
    __syncthreads();  // V(kt)'s readers are done
    if (more)
      load_tile(v_s, L, kN, hd, args.aligned, vb,
                key_rows(vb, args.vs.s, kt + kN));
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // K(kt) landed
    scores<HD>(s, q_s + m0 * L, k_s + n0 * L, g, c);

    const bool full = kt + kN <= sh.Tk && m_base + kM <= n_rows &&
                      (!sh.causal || kt + kN - 1 <= p_lo) &&
                      (sh.window <= 0 || p_hi - kt < sh.window);
    probs<HD, kCap>(s, dp, sh, nullptr, ds_s, m0, n0, g, c,
          [&](int r, int nt, int e) {
            const int pos = pos_r[r];
            return full || (pos >= 0 && key_ok(kt + n0 + nt * 8 + 2 * c + e,
                                               pos, sh.Tk, sh.causal,
                                               sh.window));
          },
          [&](int r, int, int) { return lse_r[r]; },
          [&](int r, int, int) { return d_r[r]; });
    __syncthreads();  // dS' stored
    accumulate<HD>(acc, ds_s + mb * kLdP, k_s + h0, hd - h0, g, c);
    __syncthreads();  // K(kt)'s and dS''s readers are done
    if (more)
      load_tile(k_s, L, kN, hd, args.aligned, kb,
                key_rows(kb, args.ks.s, kt + kN));
    else
      cp_async_commit();
  }
  cp_async_wait_all();

  // dq: (B, S, H, hd) contiguous
  store<T, HD>(acc, sh.scale, h0, hd, g, c, [&](int r) -> T* {
    const int row = m_base + mb + r;
    if (row >= n_rows) return nullptr;
    const int pos = row / G, h = kvh * G + row % G;
    return dq + ((static_cast<long long>(b) * sh.S + pos) * sh.H + h) * hd;
  });
}

// dk = scale * sum of the dK partials, dv = sum of the dV partials, the
// splits added in order
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_sum_kernel(const float* __restrict__ part, int splits, long long n,
                     float scale, T* __restrict__ dk, T* __restrict__ dv) {
  for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * 256) {
    float sk = 0.f, sv = 0.f;
    for (int s = 0; s < splits; ++s) {
      sk += part[s * n + i];
      sv += part[(splits + s) * n + i];
    }
    dk[i] = from_f32<T>(sk * scale);
    dv[i] = from_f32<T>(sv);
  }
}

template <typename T, int HD, bool kCap>
cudaError_t launch_hd(const T* q, const T* k, const T* v, const T* dout,
                      const float* lse, const float* delta, T* dq, T* dk,
                      T* dv, float* part, int B, int KV, const Args& args,
                      cudaStream_t stream) {
  // dK/dV: P', dS' and the streamed rows' lse, D; dQ: dS'
  constexpr size_t smem_kv = smem_bytes<T, HD, 2>() +
                             2 * sizeof(float) * n_tile<HD>(),
                   smem_q = smem_bytes<T, HD, 1>();
  static bool raised_kv = false, raised_q = false;  // once per instantiation
  cudaError_t err = raise_smem(flash_bwd_tc_dkdv_kernel<T, HD, kCap>,
                               smem_kv, raised_kv);
  if (err != cudaSuccess) return err;
  const Shape& sh = args.sh;
  const dim3 grid_kv((sh.Tk + kM - 1) / kM, KV, B * args.splits);
  flash_bwd_tc_dkdv_kernel<T, HD, kCap>
      <<<grid_kv, kThreads, smem_kv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, part, args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (args.splits > 1) {
    const long long n = static_cast<long long>(B) * sh.Tk * KV * sh.hd;
    const long long blocks = (n + 255) / 256;
    flash_bwd_sum_kernel<T><<<static_cast<unsigned>(blocks < 4096 ? blocks
                                                                   : 4096),
                              256, 0, stream>>>(part, args.splits, n,
                                                sh.scale, dk, dv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  err = raise_smem(flash_bwd_tc_dq_kernel<T, HD, kCap>, smem_q, raised_q);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(sh.S) * sh.group;
  const dim3 grid_q(static_cast<unsigned>((rows + kM - 1) / kM), KV, B);
  flash_bwd_tc_dq_kernel<T, HD, kCap><<<grid_q, kThreads, smem_q, stream>>>(
      q, k, v, dout, lse, delta, dq, args);
  return cudaGetLastError();
}

}  // namespace tensor

// kernel: 0 picks from the shape, 1 the FMA kernels, 2 the tensor-core ones
template <typename T, bool kCap>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, float* part,
                   int B, int KV, Strides qs, Strides ks, Strides vs,
                   Strides os, Strides ds, const Shape& sh, int splits,
                   int kernel, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  T* dqt = static_cast<T*>(dq);
  T* dkt = static_cast<T*>(dk);
  T* dvt = static_cast<T*>(dv);
  if (kernel == 0) kernel = use_tensor_cores(sh.S, sh.Tk, sh.hd) ? 2 : 1;
  if (kernel == 1 && splits != 1) return cudaErrorInvalidValue;
  cudaError_t err = launch_prep(static_cast<const T*>(o), dt, delta, B, os,
                                ds, sh, stream);
  if (err != cudaSuccess) return err;
  if (kernel == 1) {
    if (sh.hd <= 64)
      return simt::launch_hd<T, 64, kCap>(qt, kt, vt, dt, lse, delta, dqt,
                                          dkt, dvt, B, KV, qs, ks, vs, ds, sh,
                                          stream);
    if (sh.hd <= 128)
      return simt::launch_hd<T, 128, kCap>(qt, kt, vt, dt, lse, delta, dqt,
                                           dkt, dvt, B, KV, qs, ks, vs, ds, sh,
                                           stream);
    return simt::launch_hd<T, 256, kCap>(qt, kt, vt, dt, lse, delta, dqt, dkt,
                                         dvt, B, KV, qs, ks, vs, ds, sh,
                                         stream);
  }
  // cp.async needs every row start 16-byte aligned and whole chunks
  const long long e = 16 / sizeof(T);
  auto al = [&](const void* p, const Strides& st) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % e == 0 &&
           st.s % e == 0 && st.h % e == 0;
  };
  const tensor::Args args{
      qs, ks, vs, ds, sh, splits,
      sh.hd % e == 0 && al(q, qs) && al(k, ks) && al(v, vs) && al(dout, ds)};
  if (sh.hd <= 64)
    return tensor::launch_hd<T, 64, kCap>(qt, kt, vt, dt, lse, delta, dqt,
                                          dkt, dvt, part, B, KV, args, stream);
  if (sh.hd <= 128)
    return tensor::launch_hd<T, 128, kCap>(qt, kt, vt, dt, lse, delta, dqt,
                                           dkt, dvt, part, B, KV, args,
                                           stream);
  return tensor::launch_hd<T, 256, kCap>(qt, kt, vt, dt, lse, delta, dqt, dkt,
                                         dvt, part, B, KV, args, stream);
}

template <typename T>
cudaError_t launch_capped(const void* q, const void* k, const void* v,
                          const void* o, const void* dout, const float* lse,
                          float* delta, void* dq, void* dk, void* dv,
                          float* part, int B, int KV, Strides qs, Strides ks,
                          Strides vs, Strides os, Strides ds, const Shape& sh,
                          int splits, int kernel, cudaStream_t stream) {
  if (sh.cap > 0.f)
    return launch<T, true>(q, k, v, o, dout, lse, delta, dq, dk, dv, part, B,
                           KV, qs, ks, vs, os, ds, sh, splits, kernel, stream);
  return launch<T, false>(q, k, v, o, dout, lse, delta, dq, dk, dv, part, B,
                          KV, qs, ks, vs, os, ds, sh, splits, kernel, stream);
}

}  // namespace
}  // namespace repro

// q, o, dout: (B, S, H, hd); k, v: (B, T, KV, hd); each with a contiguous
// head dim and the given (batch, seq, head) element strides. lse: the
// forward's (B, H, S) f32; delta: (B, H, S) f32 scratch for D; dq (B, S, H,
// hd), dk and dv (B, T, KV, hd): contiguous, in the inputs' type. Masks,
// scale and soft cap (cap > 0; 0 means none) as repro_flash_attention's,
// whose lse this takes. kernel: 0 picks from the shape
// (repro_flash_bwd_uses_tensor_cores), 1 forces the FMA kernels, 2 the
// tensor-core ones. splits: blocks sharing a key tile's query rows in the
// tensor-core dK/dV kernel (1 with the FMA kernels); above 1, part holds
// 2 * splits * B * T * KV * hd f32 of scratch for their partial sums.
// Returns the first failing launch's cudaError_t.
extern "C" int repro_flash_attention_bwd_kernel(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int S, int T, int H, int KV, int hd,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, long long dsb, long long dss, long long dsh,
    int causal, int window, float scale, float cap, void* stream, int splits,
    void* part, int kernel) {
  using namespace repro;
  if (hd > kMaxHD || hd <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || T <= 0 ||
      B <= 0 || B > 65535 || H > 65535 || (causal && T != S) || splits < 1 ||
      static_cast<long long>(B) * splits > 65535 ||
      (splits > 1 && part == nullptr) || kernel < 0 || kernel > 2 ||
      !(cap >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh}, ds{dsb, dss, dsh};
  const Shape sh{S, T, H, H / KV, hd, causal, window, scale, cap,
                 cap > 0.f ? 1.f / cap : 0.f};
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(delta);
  float* pf = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_capped<float>(q, k, v, o, dout, lf, df, dq, dk, dv, pf,
                                  B, KV, qs, ks, vs, os, ds, sh, splits,
                                  kernel, s);
    case kBF16:
      return launch_capped<__nv_bfloat16>(q, k, v, o, dout, lf, df, dq, dk,
                                          dv, pf, B, KV, qs, ks, vs, os, ds,
                                          sh, splits, kernel, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// 1 when repro_flash_attention_bwd runs the tensor-core kernels at (S, T,
// hd).
extern "C" int repro_flash_bwd_uses_tensor_cores(int S, int T, int hd) {
  return repro::use_tensor_cores(S, T, hd) ? 1 : 0;
}

// The kernels picked from the shape: what the wrapper calls.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int S, int T, int H, int KV, int hd,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, long long dsb, long long dss, long long dsh,
    int causal, int window, float scale, float cap, void* stream, int splits,
    void* part) {
  return repro_flash_attention_bwd_kernel(
      q, k, v, o, dout, lse, delta, dq, dk, dv, dtype, B, S, T, H, KV, hd, qsb,
      qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh, dsb, dss, dsh,
      causal, window, scale, cap, stream, splits, part, 0);
}
