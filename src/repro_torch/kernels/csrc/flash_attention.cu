// Causal / sliding-window prefill attention with GQA, f32 online softmax,
// and non-causal attention of S queries over T keys (cross-attention).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel): q (B, S, H, hd), k/v (B, T, KV, hd)
// -> out (B, S, H, hd) in q's type, the KV head of query head h being
// h / (H / KV). Scores are scaled after the dot, masked to -1e30, and the
// output is acc / max(l, 1e-30), as in the TPU kernel. Any S and T (the
// ragged edges are masked in the kernel), any (batch, seq, head) strides
// with a contiguous head dim, f32 and bf16, hd <= 256. The TPU kernel takes
// T = S only; T != S is the non-causal form the JAX package computes with
// XLA for an encoder-decoder's cross-attention (models/attention.py
// attention_core, causal=False), so causal attention needs T = S here too.
// Query tiles run over S; the key loop, and the masking of the last
// partial key tile, run over T (Tk in the templates, whose T is the element
// type).
//
// Two kernels; the C entry point picks one from the shape alone. It takes
// the shorter of S and T for "the sequence length" below: the query length
// fills the tensor-core kernel's 128-row tile, the key length amortises its
// per-tile loads, so it needs both long (at T = S this is the rule the
// threshold sweep set):
//
// * Long sequences (S >= 48 at hd <= 128, S >= 80 above): tensor cores, from
//   the S at which they first beat the FMA kernel in chip_smoke.py's
//   threshold sweep on an H100 (the tiers' widths at S = 48, where the FMA
//   kernel won at 40; RG's 16 heads of 256 at S = 80, 63.4 against 65.4 us,
//   where at S = 64 the FMA kernel was 1.4 us ahead of 47.5 us). What bounds
//   it is operations at the tensor-core rate: at RecurrentGemma's prefill (S
//   = 3000, window 2048, hd 256, 16 query heads over 1 KV head) each head
//   keeps 4.05 M (query, key) pairs, 4 hd FLOPs each, 265 GFLOP at B = 4 and
//   three TF32 products per FLOP pair in f32 (1.61 ms at 495 TFLOP/s),
//   against 418 MB of q, k, v and out (0.12 ms). The block takes 128 rows of
//   the flattened (position, head-in-group) axis of one KV head: the GQA
//   group's heads are packed into the rows of one tile, so every K/V tile a
//   block loads from L2 serves 128 rows, and at 16 heads a group the rows
//   span 8 positions, so the causal and window edges cost a block 8 extra
//   keys, not 128 (7.78 against 8.46 ms unpacked on an H100). Eight warps own
//   16 rows each and run both products with mma.sync (m16n8k8 tf32, m16n8k16
//   bf16), keeping the scores, the softmax state and the output accumulator
//   (16 x HD f32 a warp, 128 registers a thread at HD 256) in registers.
//   Shared memory holds the query tile (128 x HD, loaded once) and one K and
//   one V tile of 32 keys: a two-slot ring filled by cp.async, K and V in
//   turn, so that V of tile j loads during Q.K^T of tile j and K of tile j +
//   1 during P.V of tile j. At hd 256 in f32 that is 198 KB, one block (8
//   warps) an SM. Key tiles wholly above the block's last position, or wholly
//   left of its first position's window, are never loaded; only tiles that
//   cross an edge (diagonal, window, S) are masked element by element. Rows
//   of smem tiles are padded (Q/K by 8 elements, V by 4 in f32) so that each
//   fragment load hits 32 distinct banks. Strides or head dims that are not
//   16-byte aligned load the same tiles with plain loads.
//
//   Precision. The RG path runs in f32 and must agree with the CPU to 1e-5 in
//   BvSB confidence, so a single TF32 product (10 mantissa bits, relative
//   error ~2^-11 per operand) is not f32 attention. For f32 inputs both
//   products use 3xTF32: each operand x splits into hi = tf32(x) (round to
//   nearest, ties away, by adding half an ulp and masking the low 13 bits)
//   and lo = x - hi, and the product is hi.hi + hi.lo + lo.hi accumulated in
//   f32; the tensor core drops lo's low 13 bits (rounding toward zero). The
//   dropped lo.lo term and lo's truncation leave a relative error of about
//   2^-21 per product, the order of f32 rounding itself; the card gate is
//   1e-4 against the f32 plain version (tests/test_torch_flash_precision.py
//   emulates the scheme on the CPU and shows that 1xTF32 misses that gate).
//   Scores accumulate their small terms apart from hi.hi, which gives two
//   independent mma chains per score tile. For bf16 inputs both products are
//   bf16 tensor-core products with f32 accumulation. P enters P.V as two bf16
//   terms, hi = bf16(P) and lo = bf16(P - hi), so that P keeps 16 bits: with
//   P rounded once to bf16 (relative error 2^-9) outputs of size 2-4 moved by
//   one bf16 ulp, 0.0156 on an H100, against the bf16 gate of 2e-2, and an
//   output of size 4-8 would have missed it.
//
// * Short sequences (the live cascade's S = 16): CUDA-core FMAs. A
//   128-row tensor-core tile would be mostly padding there, and what
//   bounds the call is the launch and the bytes (2 S^2 hd causal FLOPs
//   over 4 S hd elements per (b, h): about S / 2 FLOP per element). One
//   block per (16-row query tile, head, batch) reads its query tile and
//   each needed K/V tile of 32 keys once into shared memory (converted
//   to f32) and keeps (m, l, acc) in registers. Warp w owns query rows
//   w, w + 4, ...; lane j owns key j of the tile for the scores and
//   head-dim elements lane, lane + 32, ... of the accumulator; row max and
//   sum are warp shuffles. The tiles' row length HD is a template
//   parameter (128 or 256) so that every shared-memory stride is a
//   constant: static tiles at 128, dynamic shared memory at 256.
//
// Both kernels can also write each row's log-sum-exp, lse = m + log(l)
// (natural log, over the scaled and masked scores), in f32 at (B, H, S):
// what the backward kernels (flash_attention_bwd.cu) recompute P from.
// The serving paths pass a null pointer and run an instantiation without
// the store (template flag kLse), so their code is the kernel's as it was.
//
// Soft cap (Gemma 2's attn_logit_softcapping; the JAX package's
// models/attention.py applies it whenever cfg.logit_soft_cap is set): a cap
// c > 0 replaces each scaled score s by c tanh(s / c) before the mask, as
// JAX does, and the lse is then over the capped scores. c arrives as a
// runtime float with its reciprocal, behind a template flag (kCap), so the
// uncapped instantiations compile to the code they had. tanhf, not
// tanh.approx.f32: the approximation's relative error (~2^-11) times a cap
// of 50 would move a score by ~0.02, far over the 1e-4 gate.
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kMaxHD = 256;
constexpr float kNegInf = -1e30f;
// S from which the tensor-core kernel runs, at hd <= 128 and above
constexpr int kTensorCoreMinSeq = 48, kTensorCoreMinSeqWide = 80;

struct Strides {
  long long b, s, h;  // elements; the head dim is contiguous
};

bool use_tensor_cores(int S, int T, int hd) {
  const int n = S < T ? S : T;
  return n >= (hd <= 128 ? kTensorCoreMinSeq : kTensorCoreMinSeqWide);
}

__device__ __forceinline__ bool key_ok(int kj, int qi, int T, int causal,
                                       int window) {
  return kj < T && (!causal || kj <= qi) && (window <= 0 || qi - kj < window);
}

// c tanh(s / c), with inv_cap = 1 / c
__device__ __forceinline__ float soft_cap(float s, float cap, float inv_cap) {
  return cap * tanhf(s * inv_cap);
}

// ---------------------------------------------------------------------------
// short sequences: CUDA-core FMAs
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kBQ = 16;      // query rows per block
constexpr int kBK = 32;      // keys per tile = lanes per warp
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kBQ / kWarps;

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

// HD: the tiles' row length, hd <= HD; kLse: write each row's lse; kCap:
// soft-cap the scaled scores at cap
template <typename T, int HD, bool kLse, bool kCap>
__global__ void __launch_bounds__(kWarps * 32)
flash_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int Tk,
                 int group, int hd, Strides qs, Strides ks, Strides vs,
                 Strides os, int causal, int window, float scale,
                 float cap, float inv_cap, float* __restrict__ lse) {
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
  const int k_hi = causal ? q_last : Tk - 1;
  const int k_lo = (causal && window > 0) ? max(0, q_start - window + 1) : 0;

  for (int kt = (k_lo / kBK) * kBK; kt <= k_hi; kt += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * hd; e += kWarps * 32) {
      const int j = e / hd, d = e % hd, s = kt + j;
      const bool in = s < Tk;
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
      if constexpr (kCap) sc = soft_cap(sc, cap, inv_cap);
      sc = key_ok(kj, qi, Tk, causal, window) ? sc : kNegInf;

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
    if (kLse && lane == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * S + qi] =
          m[t] + logf(l[t]);
#pragma unroll
    for (int u = 0; u < kDPerLane; ++u) {
      const int d = lane + 32 * u;
      if (d < hd) ob[qi * os.s + d] = from_f32<T>(acc[t][u] * inv);
    }
  }
}

template <typename T, int HD, bool kLse, bool kCap>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int Tk, int H, int KV, int hd, Strides qs,
                      Strides ks, Strides vs, Strides os, int causal,
                      int window, float scale, float cap, float* lse,
                      cudaStream_t stream) {
  size_t smem = 0;
  if constexpr (!tiles_static<HD>()) {
    smem = sizeof(float) * tile_floats<HD>();
    static bool raised = false;  // the dynamic limit, once per type
    if (!raised) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_fma_kernel<T, HD, kLse, kCap>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      raised = true;
    }
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fma_kernel<T, HD, kLse, kCap><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H / KV, hd, qs,
      ks, vs, os, causal, window, scale, cap, kCap ? 1.f / cap : 0.f, lse);
  return cudaGetLastError();
}

template <typename T, bool kLse, bool kCap>
cudaError_t launch_lse_cap(const void* q, const void* k, const void* v,
                           void* o, int B, int S, int Tk, int H, int KV,
                           int hd, Strides qs, Strides ks, Strides vs,
                           Strides os, int causal, int window, float scale,
                           float cap, float* lse, cudaStream_t stream) {
  if (hd <= 128)
    return launch_hd<T, 128, kLse, kCap>(q, k, v, o, B, S, Tk, H, KV, hd, qs,
                                         ks, vs, os, causal, window, scale,
                                         cap, lse, stream);
  return launch_hd<T, 256, kLse, kCap>(q, k, v, o, B, S, Tk, H, KV, hd, qs,
                                       ks, vs, os, causal, window, scale, cap,
                                       lse, stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Tk, int H, int KV, int hd, Strides qs,
                   Strides ks, Strides vs, Strides os, int causal,
                   int window, float scale, float cap, float* lse,
                   cudaStream_t stream) {
#define REPRO_FLASH_SIMT(LSE, CAP)                                         \
  launch_lse_cap<T, LSE, CAP>(q, k, v, o, B, S, Tk, H, KV, hd, qs, ks, vs,  \
                              os, causal, window, scale, cap, lse, stream)
  if (lse != nullptr)
    return cap > 0.f ? REPRO_FLASH_SIMT(true, true)
                     : REPRO_FLASH_SIMT(true, false);
  return cap > 0.f ? REPRO_FLASH_SIMT(false, true)
                   : REPRO_FLASH_SIMT(false, false);
#undef REPRO_FLASH_SIMT
}

}  // namespace simt

// ---------------------------------------------------------------------------
// long sequences: tensor cores
// ---------------------------------------------------------------------------
namespace tensor {

constexpr int kRows = 128;   // (position, head-in-group) rows per block
constexpr int kKeys = 32;    // keys per K/V tile
constexpr int kWarps = 8;    // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kNT = kKeys / 8;  // score n-tiles of 8 keys a warp

// padded row pitches (elements) of the Q/K tiles and of the V tile
template <typename T, int HD>
__host__ __device__ constexpr int ld_qk() { return HD + TilePads<T>::kQK; }
template <typename T, int HD>
__host__ __device__ constexpr int ld_v() { return HD + TilePads<T>::kV; }
template <typename T, int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t(kRows + kKeys) * ld_qk<T, HD>() +
                      size_t(kKeys) * ld_v<T, HD>());
}

// Copy `rows` rows of hd elements into a tile of pitch ld. row_ptr(r)
// gives row r's source or nullptr for a row past the end, which is
// zero-filled (cp.async then reads nothing at `base`, a valid address).
// cp.async in 16-byte chunks when every row start is 16-byte aligned and
// hd fills whole chunks; plain loads otherwise.
template <typename T, typename RowPtr>
__device__ __forceinline__ void load_tile(T* tile, int ld, int rows, int hd,
                                          bool aligned, const T* base,
                                          RowPtr row_ptr) {
  const int tid = threadIdx.x;
  if (aligned) {
    constexpr int kE = 16 / sizeof(T);
    const int cpr = hd / kE;
    for (int e = tid; e < rows * cpr; e += kThreads) {
      const int r = e / cpr, c = e - r * cpr;
      const T* src = row_ptr(r);
      cp_async16(tile + r * ld + c * kE, src ? src + c * kE : base,
                 src != nullptr);
    }
  } else {
    for (int e = tid; e < rows * hd; e += kThreads) {
      const int r = e / hd, d = e - r * hd;
      const T* src = row_ptr(r);
      tile[r * ld + d] = src ? src[d] : from_f32<T>(0.f);
    }
  }
  cp_async_commit();
}

// sc[nt][*] += Q(16 rows of this warp) . K(tile)^T over the head dim
template <int HD>
__device__ __forceinline__ void scores(float (&sc)[kNT][4],
                                       const float* q_s, const float* k_s,
                                       int hd, int g, int c) {
  constexpr int ld = ld_qk<float, HD>();
  float small[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[nt][i] = small[nt][i] = 0.f;
  const float* q0 = q_s + g * ld + 2 * c;
  const float* k0 = k_s + g * ld + 2 * c;
  const int steps = (hd + 7) / 8;
#pragma unroll 4
  for (int ks = 0; ks < steps; ++ks) {
    // A's k index c holds head-dim element 2c, k index c + 4 holds 2c + 1
    // (and B's alike): one float2 per pair, the dot unchanged.
    const float2 x0 = *reinterpret_cast<const float2*>(q0 + ks * 8);
    const float2 x1 = *reinterpret_cast<const float2*>(q0 + 8 * ld + ks * 8);
    uint32_t ah[4], al[4];
    split_tf32(x0.x, ah[0], al[0]);
    split_tf32(x1.x, ah[1], al[1]);
    split_tf32(x0.y, ah[2], al[2]);
    split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float2 y = *reinterpret_cast<const float2*>(k0 + nt * 8 * ld +
                                                        ks * 8);
      uint32_t bh[2], bl[2];
      split_tf32(y.x, bh[0], bl[0]);
      split_tf32(y.y, bh[1], bl[1]);
      mma_tf32(small[nt], al, bh);
      mma_tf32(small[nt], ah, bl);
      mma_tf32(sc[nt], ah, bh);
    }
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[nt][i] += small[nt][i];
}

template <int HD>
__device__ __forceinline__ void scores(float (&sc)[kNT][4],
                                       const __nv_bfloat16* q_s,
                                       const __nv_bfloat16* k_s, int hd,
                                       int g, int c) {
  constexpr int ld = ld_qk<__nv_bfloat16, HD>();
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
  const __nv_bfloat16* q0 = q_s + g * ld + 2 * c;
  const __nv_bfloat16* k0 = k_s + g * ld + 2 * c;
  const int steps = (hd + 15) / 16;
#pragma unroll 4
  for (int ks = 0; ks < steps; ++ks) {
    const uint32_t a[4] = {ld_u32(q0 + ks * 16), ld_u32(q0 + 8 * ld + ks * 16),
                           ld_u32(q0 + ks * 16 + 8),
                           ld_u32(q0 + 8 * ld + ks * 16 + 8)};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const __nv_bfloat16* kr = k0 + nt * 8 * ld + ks * 16;
      const uint32_t b[2] = {ld_u32(kr), ld_u32(kr + 8)};
      mma_bf16(sc[nt], a, b);
    }
  }
}

// acc[nt][*] += P(16 x kKeys, in the score registers) . V(tile)
template <int HD>
__device__ __forceinline__ void accumulate(float (&acc)[HD / 8][4],
                                           const float (&p)[kNT][4],
                                           const float* v_s, int hd, int g,
                                           int c) {
  constexpr int ld = ld_v<float, HD>();
#pragma unroll
  for (int kk = 0; kk < kNT; ++kk) {
    // P's accumulator layout holds keys 2c, 2c + 1 of rows g, g + 8; as an
    // A fragment k index c carries key 2c and c + 4 carries key 2c + 1, so
    // B takes V rows 2c and 2c + 1
    uint32_t ah[4], al[4];
    split_tf32(p[kk][0], ah[0], al[0]);
    split_tf32(p[kk][2], ah[1], al[1]);
    split_tf32(p[kk][1], ah[2], al[2]);
    split_tf32(p[kk][3], ah[3], al[3]);
    const float* v0 = v_s + (kk * 8 + 2 * c) * ld + g;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      if (nt * 8 >= hd) break;
      uint32_t bh[2], bl[2];
      split_tf32(v0[nt * 8], bh[0], bl[0]);
      split_tf32(v0[ld + nt * 8], bh[1], bl[1]);
      mma_tf32(acc[nt], al, bh);
      mma_tf32(acc[nt], ah, bl);
      mma_tf32(acc[nt], ah, bh);
    }
  }
}

template <int HD>
__device__ __forceinline__ void accumulate(float (&acc)[HD / 8][4],
                                           const float (&p)[kNT][4],
                                           const __nv_bfloat16* v_s, int hd,
                                           int g, int c) {
  constexpr int ld = ld_v<__nv_bfloat16, HD>();
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk) {
    // score n-tiles 2kk, 2kk + 1 are the A fragment of keys 16kk..16kk+15;
    // P enters as hi = bf16(P) and lo = bf16(P - hi); V is bf16 already
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* pi = p[2 * kk + (i >> 1)] + 2 * (i & 1);
      const __nv_bfloat16 h0 = __float2bfloat16(pi[0]);
      const __nv_bfloat16 h1 = __float2bfloat16(pi[1]);
      ah[i] = pack_bf16(h0, h1);
      al[i] = pack_bf16(pi[0] - __bfloat162float(h0),
                        pi[1] - __bfloat162float(h1));
    }
    const __nv_bfloat16* v0 = v_s + (kk * 16 + 2 * c) * ld + g;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      if (nt * 8 >= hd) break;
      const __nv_bfloat16* vn = v0 + nt * 8;
      const uint32_t b[2] = {pack_bf16(vn[0], vn[ld]),
                             pack_bf16(vn[8 * ld], vn[9 * ld])};
      mma_bf16(acc[nt], al, b);
      mma_bf16(acc[nt], ah, b);
    }
  }
}

template <typename T, int HD, bool kLse, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o, int S, int Tk,
                int group, int hd, Strides qs, Strides ks, Strides vs,
                Strides os, int causal, int window, float scale, float cap,
                float inv_cap, float* __restrict__ lse, int aligned) {
  constexpr int ldqk = ld_qk<T, HD>(), ldv = ld_v<T, HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);   // [kRows][ldqk]
  T* k_s = q_s + kRows * ldqk;               // [kKeys][ldqk]
  T* v_s = k_s + kKeys * ldqk;               // [kKeys][ldv]

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int n_rows = S * group;              // (position, head) rows
  const int r0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  // head-dim padding up to HD stays zero, so every k step may read it
  for (int e = tid; e < (kRows + kKeys) * (HD - hd); e += kThreads) {
    const int r = e / (HD - hd), d = hd + e % (HD - hd);
    q_s[r * ldqk + d] = from_f32<T>(0.f);  // rows of q_s then k_s
  }
  for (int e = tid; e < kKeys * (HD - hd); e += kThreads)
    v_s[(e / (HD - hd)) * ldv + hd + e % (HD - hd)] = from_f32<T>(0.f);

  load_tile(q_s, ldqk, kRows, hd, aligned, q, [&](int r) -> const T* {
    const int row = r0 + r;
    if (row >= n_rows) return nullptr;
    const int pos = row / group, h = kvh * group + row % group;
    return q + b * qs.b + pos * qs.s + h * qs.h;
  });

  // positions of the block's first and last rows, and of this thread's
  const int p_lo = r0 / group;
  const int p_hi = (min(r0 + kRows, n_rows) - 1) / group;
  const int row0 = r0 + warp * 16 + g;
  const int pos[2] = {row0 / group, (row0 + 8) / group};
  const bool live = r0 + warp * 16 < n_rows;  // warp-uniform

  // tile-level skip: keys above the last position (causal) and keys left
  // of the first position's window are never loaded
  const int k_hi = causal ? p_hi : Tk - 1;
  const int k_lo = (causal && window > 0) ? max(0, p_lo - window + 1) : 0;
  const int kt0 = (k_lo / kKeys) * kKeys;

  auto key_rows = [&](const T* base, long long stride, int kt) {
    return [=](int r) -> const T* {
      return kt + r < Tk ? base + (kt + r) * stride : nullptr;
    };
  };
  load_tile(k_s, ldqk, kKeys, hd, aligned, kb, key_rows(kb, ks.s, kt0));

  float acc[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = kt0; kt <= k_hi; kt += kKeys) {
    cp_async_wait_all();
    __syncthreads();  // K(kt) (and Q) landed; V's last readers are done
    load_tile(v_s, ldv, kKeys, hd, aligned, vb, key_rows(vb, vs.s, kt));

    float sc[kNT][4];
    if (live) {
      scores<HD>(sc, q_s + warp * 16 * ldqk, k_s, hd, g, c);
      // every (row, key) of the tile valid for every row of the block?
      const bool full = kt + kKeys <= Tk &&
                        (!causal || kt + kKeys - 1 <= p_lo) &&
                        (window <= 0 || p_hi - kt < window);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float s = sc[nt][i] * scale;
          if constexpr (kCap) s = soft_cap(s, cap, inv_cap);
          if (!full && !key_ok(kt + nt * 8 + 2 * c + (i & 1), pos[i >> 1],
                               Tk, causal, window))
            s = kNegInf;
          sc[nt][i] = s;
          mx[i >> 1] = fmaxf(mx[i >> 1], s);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFullMask, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];  // this thread's share of the row sum
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[nt][i] = expf(sc[nt][i] - m[i >> 1]);
          l[i >> 1] += sc[nt][i];
        }
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] *= corr[i >> 1];
    }

    cp_async_wait_all();
    __syncthreads();  // V(kt) landed; K(kt)'s readers are done
    if (kt + kKeys <= k_hi)
      load_tile(k_s, ldqk, kKeys, hd, aligned, kb,
                key_rows(kb, ks.s, kt + kKeys));
    if (live) accumulate<HD>(acc, sc, v_s, hd, g, c);
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFullMask, l[r], 1);
    l[r] += __shfl_xor_sync(kFullMask, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n_rows) continue;
    const int h = kvh * group + row % group;
    T* out = o + b * os.b + pos[r] * os.s + h * os.h;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    if (kLse && c == 0)
      lse[(static_cast<long long>(b) * gridDim.y * group + h) * S + pos[r]] =
          m[r] + logf(l[r]);
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = nt * 8 + 2 * c + e;
        if (d < hd) out[d] = from_f32<T>(acc[nt][2 * r + e] * inv);
      }
  }
}

template <typename T, int HD, bool kLse, bool kCap>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int Tk, int H, int KV, int hd, Strides qs,
                      Strides ks, Strides vs, Strides os, int causal,
                      int window, float scale, float cap, float* lse,
                      int aligned, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, HD>();
  static bool raised = false;  // the dynamic limit, once per instantiation
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<T, HD, kLse, kCap>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    raised = true;
  }
  const int group = H / KV;
  const long long rows = static_cast<long long>(S) * group;
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows), KV, B);
  flash_tc_kernel<T, HD, kLse, kCap><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, group, hd, qs, ks,
      vs, os, causal, window, scale, cap, kCap ? 1.f / cap : 0.f, lse,
      aligned);
  return cudaGetLastError();
}

template <typename T, bool kLse, bool kCap>
cudaError_t launch_lse_cap(const void* q, const void* k, const void* v,
                           void* o, int B, int S, int Tk, int H, int KV,
                           int hd, Strides qs, Strides ks, Strides vs,
                           Strides os, int causal, int window, float scale,
                           float cap, float* lse, int aligned,
                           cudaStream_t stream) {
  if (hd <= 64)
    return launch_hd<T, 64, kLse, kCap>(q, k, v, o, B, S, Tk, H, KV, hd, qs,
                                        ks, vs, os, causal, window, scale, cap,
                                        lse, aligned, stream);
  if (hd <= 128)
    return launch_hd<T, 128, kLse, kCap>(q, k, v, o, B, S, Tk, H, KV, hd, qs,
                                         ks, vs, os, causal, window, scale,
                                         cap, lse, aligned, stream);
  return launch_hd<T, 256, kLse, kCap>(q, k, v, o, B, S, Tk, H, KV, hd, qs,
                                       ks, vs, os, causal, window, scale, cap,
                                       lse, aligned, stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Tk, int H, int KV, int hd, Strides qs,
                   Strides ks, Strides vs, Strides os, int causal,
                   int window, float scale, float cap, float* lse,
                   cudaStream_t stream) {
  // cp.async needs every row start 16-byte aligned and whole chunks
  const long long e = 16 / sizeof(T);
  auto al = [&](const void* p, const Strides& st) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % e == 0 &&
           st.s % e == 0 && st.h % e == 0;
  };
  const int aligned = hd % e == 0 && al(q, qs) && al(k, ks) && al(v, vs);
#define REPRO_FLASH_TC(LSE, CAP)                                           \
  launch_lse_cap<T, LSE, CAP>(q, k, v, o, B, S, Tk, H, KV, hd, qs, ks, vs,  \
                              os, causal, window, scale, cap, lse, aligned, \
                              stream)
  if (lse != nullptr)
    return cap > 0.f ? REPRO_FLASH_TC(true, true) : REPRO_FLASH_TC(true, false);
  return cap > 0.f ? REPRO_FLASH_TC(false, true) : REPRO_FLASH_TC(false, false);
#undef REPRO_FLASH_TC
}

}  // namespace tensor

// kernel: 0 picks from the shape, 1 the FMA kernel, 2 the tensor-core one
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int Tk, int H, int KV, int hd, Strides qs,
                     Strides ks, Strides vs, Strides os, int causal,
                     int window, float scale, float cap, float* lse,
                     cudaStream_t stream, int kernel) {
  if (kernel == 0) kernel = use_tensor_cores(S, Tk, hd) ? 2 : 1;
  if (kernel == 2)
    return tensor::launch<T>(q, k, v, o, B, S, Tk, H, KV, hd, qs, ks, vs, os,
                             causal, window, scale, cap, lse, stream);
  return simt::launch<T>(q, k, v, o, B, S, Tk, H, KV, hd, qs, ks, vs, os,
                         causal, window, scale, cap, lse, stream);
}

}  // namespace
}  // namespace repro

// q/o: (B, S, H, hd), k/v: (B, T, KV, hd), each with a contiguous head dim
// and the given (batch, seq, head) element strides; hd <= 256, H % KV == 0;
// causal needs T == S. window <= 0 means no window. cap > 0 soft-caps the
// scaled scores at cap (cap tanh(s / cap)); 0 means no cap. lse: (B, H, S) f32
// contiguous for each row's log-sum-exp, or null. kernel: 0 picks the
// kernel from the shape (tensor cores from min(S, T) = kTensorCoreMinSeq
// up, kTensorCoreMinSeqWide at hd > 128), 1 forces the FMA kernel, 2 the
// tensor-core kernel (for measuring both at one shape). Returns the
// launch's cudaError_t.
extern "C" int repro_flash_attention_kernel(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int T, int H, int KV, int hd, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, int causal, int window, float scale,
    float cap, float* lse, void* stream, int kernel) {
  using namespace repro;
  if (hd > kMaxHD || hd <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || T <= 0 ||
      (causal && T != S) || kernel < 0 || kernel > 2 || !(cap >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch<float>(q, k, v, o, B, S, T, H, KV, hd, qs, ks, vs, os,
                             causal, window, scale, cap, lse, s, kernel);
    case kBF16:
      return dispatch<__nv_bfloat16>(q, k, v, o, B, S, T, H, KV, hd, qs, ks,
                                     vs, os, causal, window, scale, cap, lse,
                                     s, kernel);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// 1 when repro_flash_attention runs the tensor-core kernel at (S, T, hd).
extern "C" int repro_flash_uses_tensor_cores(int S, int T, int hd) {
  return repro::use_tensor_cores(S, T, hd) ? 1 : 0;
}

// The kernel picked from the shape: what the wrapper calls.
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int T, int H, int KV, int hd, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, int causal, int window, float scale,
    float cap, float* lse, void* stream) {
  return repro_flash_attention_kernel(q, k, v, o, dtype, B, S, T, H, KV, hd,
                                      qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                                      vsh, osb, oss, osh, causal, window,
                                      scale, cap, lse, stream, 0);
}
