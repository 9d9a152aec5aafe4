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
// at 3.35 TB/s, against 0.27 GFLOP of products. To stream at that rate the
// card needs tens of KB of loads in flight on every SM at once.
//
// What the design does about it: split-K flash decoding sized for bytes
// per SM, a ring of tiles in flight, and both products on the tensor
// cores.
//
// * Splits. The TPU kernel walks the window in order per (request, KV
//   head); Hopper needs the window cut across blocks. The wrapper's plan
//   (kernels/decode_attention.py::splits) gives each (request, KV head) as
//   many splits of whole kTile-key tiles as keep the grid within one block
//   an SM: 32 splits of 64 keys at B = 4, 2 of 1024 at B = 64. One block
//   per (split, KV head, request) streams its contiguous run of keys;
//   slots at or past the length are never read. Two blocks an SM (64 and 4
//   splits) measured slower on an H100 (chip_smoke.py's split sweep): more
//   splits write and merge more partials.
// * Loads in flight. K and V tiles of kTile keys go through a kStages-slot
//   ring in shared memory filled by cp.async (16 bytes a thread, both
//   tiles of a key range in one group): tiles j + 1 and j + 2 are in flight
//   while tile j computes. A row at or past the split's end is a src-size
//   0 copy, which zero-fills the row and reads nothing, so the NaN a
//   stale slot may hold never meets an mma (NaN x 0 is NaN). Unaligned
//   strides, or a head dim under the tile's row of 64, 128 or 256, load
//   the same tiles with plain loads.
// * Tensor cores. The query group (G <= 16 heads sharing a KV head; 16 for
//   RecurrentGemma, zero rows below that) is the M = 16 rows of mma.sync.
//   Four warps each own a quarter of the head dim: a warp keeps its Q
//   fragments in registers for the whole split, forms the partial scores
//   of its columns (m16n8k8 TF32 or m16n8k16 bf16), and the four partials
//   meet through shared memory, summed by every warp in the same order, so
//   each warp holds the same scores and the same softmax state (m, l). Each
//   warp then runs P.V for its own columns. f32 inputs take 3xTF32 for
//   both products, as csrc/flash_attention.cu does (hi = tf32(x), lo = x -
//   hi, hi.hi + hi.lo + lo.hi): one TF32 product misses the f32 gate of
//   1e-4 (tests/test_torch_flash_precision.py emulates both). bf16 inputs
//   take bf16 products with P as two bf16 terms.
// * f32 queries over a bf16 cache (the JAX package's default cache under an
//   f32 model): the ring holds the bf16 tiles as they are in device memory
//   (half the bytes of an f32 cache) and each fragment load widens them.
//   A bf16 value is exact in TF32 (8 of its 10 mantissa bits), so K and V
//   have no low part and each product takes two mma (x_hi.y + x_lo.y)
//   where 3xTF32 takes three; the output is f32, as JAX computes it.
// * Merge. A second kernel combines the splits of each (request, KV head)
//   by their maxima, in split order with a fixed sum per output element,
//   so the result is bitwise repeatable; a split with no valid slot
//   carries m = -1e30 and weighs exp(-1e30 - max) = 0. It reads the
//   partials from L2, where the first kernel has just written them, 32
//   splits' loads in flight a thread, and is launched so that it is
//   scheduled while the first kernel runs (programmatic dependent launch).
// * Soft cap (the JAX package's attn_decode under cfg.logit_soft_cap): a cap
//   c > 0 replaces each scaled score s by c tanh(s / c) before the mask, in
//   the partial kernel, behind a template flag (kCap) so that the uncapped
//   instantiations are the code they were; tanhf, not tanh.approx.f32,
//   whose error times the cap would miss the 1e-4 gate.
// * A ring cut over ranks on its W slots (decode context parallelism, the
//   JAX package's cache_shardings; the TPU kernel has no such form, GSPMD
//   partitions its XLA decode): the partial entry runs the partial kernel
//   over a rank's shard, lengths clipped to it, and writes the rank's
//   splits into its place in one buffer of all ranks' splits, rank by rank;
//   the caller gathers the buffer (a sum of zero-filled buffers) and the
//   merge entry runs the merge kernel over every rank's splits in that
//   order, so a repeat is bitwise. An empty shard (the ring not yet filled
//   past it) writes m = -1e30, l = 0, acc = 0 and weighs nothing.
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kWarps = 4;                     // each owns HD / 4 columns
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16;                     // keys per ring slot
constexpr int kStages = 3;                    // ring slots
constexpr int kNT = kTile / 8;                // score n-tiles of 8 keys
constexpr int kRows = 16;                     // mma rows: the query group
constexpr int kMaxG = kRows;
constexpr int kMaxHD = 256;
constexpr int kMaxSplits = 256;
constexpr int kMergeThreads = 128;
constexpr int kMergeBatch = 32;               // splits a merge thread loads at once
constexpr float kNegInf = -1e30f;

struct CacheStrides {
  long long b, w, h;  // elements; the head dim is contiguous
};

// padded row pitches (elements) of the K (and staged Q) and V tiles
template <typename T, int HD>
__host__ __device__ constexpr int ld_k() { return HD + TilePads<T>::kQK; }
template <typename T, int HD>
__host__ __device__ constexpr int ld_v() { return HD + TilePads<T>::kV; }
// one ring slot: a K tile, then a V tile
template <typename T, int HD>
__host__ __device__ constexpr int slot_elems() {
  return kTile * (ld_k<T, HD>() + ld_v<T, HD>());
}
// the warps' partial scores: [warp][n-tile][4][lane] floats
constexpr int kRedFloats = kWarps * kNT * 4 * 32;
template <typename T, int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) * kStages * slot_elems<T, HD>() + sizeof(float) * kRedFloats;
}

// Per (query type, cache type): a warp's Q fragments over its HD / 4
// columns, its partial scores against a K tile, and P.V over a V tile into
// its columns. A's k index c holds column 2c of a k step and c + 4 holds
// 2c + 1 (and B's alike), which leaves every dot unchanged and makes the
// loads pairs.
template <typename TQ, typename TC, int HD> struct Mma;

template <int HD> struct Mma<float, float, HD> {
  static constexpr bool kStageQ = true;  // Q staged in shared memory
  static constexpr int kCols = HD / kWarps;
  static constexpr int kSteps = kCols / 8;
  static constexpr int ldk = ld_k<float, HD>(), ldv = ld_v<float, HD>();
  uint32_t hi[kSteps][4], lo[kSteps][4];

  __device__ __forceinline__ void load_q(const float* q_s, int warp, int g,
                                         int c) {
    const float* q0 = q_s + g * ldk + warp * kCols + 2 * c;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const float2 x0 = *reinterpret_cast<const float2*>(q0 + ks * 8);
      const float2 x1 = *reinterpret_cast<const float2*>(q0 + 8 * ldk + ks * 8);
      split_tf32(x0.x, hi[ks][0], lo[ks][0]);
      split_tf32(x1.x, hi[ks][1], lo[ks][1]);
      split_tf32(x0.y, hi[ks][2], lo[ks][2]);
      split_tf32(x1.y, hi[ks][3], lo[ks][3]);
    }
  }

  __device__ __forceinline__ void scores(float (&sc)[kNT][4], const float* k_s,
                                         int warp, int g, int c) const {
    float small[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = small[nt][i] = 0.f;
    const float* k0 = k_s + g * ldk + warp * kCols + 2 * c;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float2 y =
            *reinterpret_cast<const float2*>(k0 + nt * 8 * ldk + ks * 8);
        uint32_t bh[2], bl[2];
        split_tf32(y.x, bh[0], bl[0]);
        split_tf32(y.y, bh[1], bl[1]);
        mma_tf32(small[nt], lo[ks], bh);
        mma_tf32(small[nt], hi[ks], bl);
        mma_tf32(sc[nt], hi[ks], bh);
      }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] += small[nt][i];
  }

  // P's score layout holds keys 2c, 2c + 1 of rows g, g + 8; as an A
  // fragment k index c carries key 2c and c + 4 key 2c + 1, so B takes V
  // rows 2c and 2c + 1
  static __device__ __forceinline__ void accumulate(
      float (&acc)[kCols / 8][4], const float (&p)[kNT][4], const float* v_s,
      int warp, int g, int c) {
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(p[kk][0], ah[0], al[0]);
      split_tf32(p[kk][2], ah[1], al[1]);
      split_tf32(p[kk][1], ah[2], al[2]);
      split_tf32(p[kk][3], ah[3], al[3]);
      const float* v0 = v_s + (kk * 8 + 2 * c) * ldv + warp * kCols + g;
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt) {
        uint32_t bh[2], bl[2];
        split_tf32(v0[nt * 8], bh[0], bl[0]);
        split_tf32(v0[ldv + nt * 8], bh[1], bl[1]);
        mma_tf32(acc[nt], al, bh);
        mma_tf32(acc[nt], ah, bl);
        mma_tf32(acc[nt], ah, bh);
      }
    }
  }
};

template <int HD> struct Mma<__nv_bfloat16, __nv_bfloat16, HD> {
  using T = __nv_bfloat16;
  static constexpr bool kStageQ = true;
  static constexpr int kCols = HD / kWarps;
  static constexpr int kSteps = kCols / 16;
  static constexpr int ldk = ld_k<T, HD>(), ldv = ld_v<T, HD>();
  uint32_t a[kSteps][4];

  __device__ __forceinline__ void load_q(const T* q_s, int warp, int g,
                                         int c) {
    const T* q0 = q_s + g * ldk + warp * kCols + 2 * c;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      a[ks][0] = ld_u32(q0 + ks * 16);
      a[ks][1] = ld_u32(q0 + 8 * ldk + ks * 16);
      a[ks][2] = ld_u32(q0 + ks * 16 + 8);
      a[ks][3] = ld_u32(q0 + 8 * ldk + ks * 16 + 8);
    }
  }

  __device__ __forceinline__ void scores(float (&sc)[kNT][4], const T* k_s,
                                         int warp, int g, int c) const {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
    const T* k0 = k_s + g * ldk + warp * kCols + 2 * c;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const T* kr = k0 + nt * 8 * ldk + ks * 16;
        const uint32_t b[2] = {ld_u32(kr), ld_u32(kr + 8)};
        mma_bf16(sc[nt], a[ks], b);
      }
  }

  // the tile's two score n-tiles are the A fragment of its 16 keys; P
  // enters as hi = bf16(P) and lo = bf16(P - hi), V is bf16 already
  static __device__ __forceinline__ void accumulate(
      float (&acc)[kCols / 8][4], const float (&p)[kNT][4], const T* v_s,
      int warp, int g, int c) {
    static_assert(kNT == 2, "one k16 step per tile");
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* pi = p[i >> 1] + 2 * (i & 1);
      const T h0 = __float2bfloat16(pi[0]), h1 = __float2bfloat16(pi[1]);
      ah[i] = pack_bf16(h0, h1);
      al[i] = pack_bf16(pi[0] - __bfloat162float(h0),
                        pi[1] - __bfloat162float(h1));
    }
    const T* v0 = v_s + 2 * c * ldv + warp * kCols + g;
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) {
      const T* vn = v0 + nt * 8;
      const uint32_t b[2] = {pack_bf16(vn[0], vn[ldv]),
                             pack_bf16(vn[8 * ldv], vn[9 * ldv])};
      mma_bf16(acc[nt], al, b);
      mma_bf16(acc[nt], ah, b);
    }
  }
};

// the bits of a bf16 value as a TF32 operand: exact, no rounding
__device__ __forceinline__ uint32_t bf16_tf32(__nv_bfloat16 x) {
  return uint32_t(__bfloat16_as_ushort(x)) << 16;
}

// f32 queries over a bf16 cache: Q splits into hi + lo as in 3xTF32, K and
// V are exact TF32 operands, so each product is x_hi.y + x_lo.y. Q's
// fragments come straight from device memory (the ring's slots are bf16).
template <int HD> struct Mma<float, __nv_bfloat16, HD> {
  using T = __nv_bfloat16;
  static constexpr bool kStageQ = false;
  static constexpr int kCols = HD / kWarps;
  static constexpr int kSteps = kCols / 8;
  static constexpr int ldk = ld_k<T, HD>(), ldv = ld_v<T, HD>();
  uint32_t hi[kSteps][4], lo[kSteps][4];

  // rows >= G and columns >= hd are zero
  __device__ __forceinline__ void load_q_global(const float* qb, long long qsh,
                                                int G, int hd, int warp,
                                                int g, int c) {
    auto x = [&](int r, int d) {
      return r < G && d < hd ? qb[r * qsh + d] : 0.f;
    };
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int d = warp * kCols + ks * 8 + 2 * c;
      split_tf32(x(g, d), hi[ks][0], lo[ks][0]);
      split_tf32(x(g + 8, d), hi[ks][1], lo[ks][1]);
      split_tf32(x(g, d + 1), hi[ks][2], lo[ks][2]);
      split_tf32(x(g + 8, d + 1), hi[ks][3], lo[ks][3]);
    }
  }

  __device__ __forceinline__ void scores(float (&sc)[kNT][4], const T* k_s,
                                         int warp, int g, int c) const {
    float small[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = small[nt][i] = 0.f;
    const T* k0 = k_s + g * ldk + warp * kCols + 2 * c;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const uint32_t y = ld_u32(k0 + nt * 8 * ldk + ks * 8);
        const uint32_t b[2] = {y << 16, y & 0xffff0000u};
        mma_tf32(small[nt], lo[ks], b);
        mma_tf32(sc[nt], hi[ks], b);
      }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] += small[nt][i];
  }

  static __device__ __forceinline__ void accumulate(
      float (&acc)[kCols / 8][4], const float (&p)[kNT][4], const T* v_s,
      int warp, int g, int c) {
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(p[kk][0], ah[0], al[0]);
      split_tf32(p[kk][2], ah[1], al[1]);
      split_tf32(p[kk][1], ah[2], al[2]);
      split_tf32(p[kk][3], ah[3], al[3]);
      const T* v0 = v_s + (kk * 8 + 2 * c) * ldv + warp * kCols + g;
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt) {
        const uint32_t b[2] = {bf16_tf32(v0[nt * 8]),
                               bf16_tf32(v0[ldv + nt * 8])};
        mma_tf32(acc[nt], al, b);
        mma_tf32(acc[nt], ah, b);
      }
    }
  }
};

// K and V rows [kt, kt + kTile) into one ring slot, as one cp.async group;
// rows at or past k1 are zero-filled and not read. cp.async in 16-byte
// chunks when `aligned` (the host's test: hd == HD and every row start
// 16-byte aligned), plain loads otherwise.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* slot, const T* kb, const T* vb,
                                          CacheStrides ks, CacheStrides vs,
                                          int kt, int k1, int hd,
                                          bool aligned) {
  constexpr int ldk = ld_k<T, HD>(), ldv = ld_v<T, HD>();
  T* k_s = slot;
  T* v_s = slot + kTile * ldk;
  const int tid = threadIdx.x;
  if (aligned) {
    constexpr int kE = 16 / sizeof(T);
    constexpr int kChunks = HD / kE;          // 16-byte chunks of a row
#pragma unroll
    for (int e = tid; e < kTile * kChunks; e += kThreads) {
      const int r = e / kChunks, col = (e % kChunks) * kE;
      const bool in = kt + r < k1;
      const long long j = kt + r;
      cp_async16(k_s + r * ldk + col, in ? kb + j * ks.w + col : kb, in);
      cp_async16(v_s + r * ldv + col, in ? vb + j * vs.w + col : vb, in);
    }
  } else {
    for (int e = tid; e < kTile * hd; e += kThreads) {
      const int r = e / hd, d = e - r * hd;
      const bool in = kt + r < k1;
      const long long j = kt + r;
      k_s[r * ldk + d] = in ? kb[j * ks.w + d] : from_f32<T>(0.f);
      v_s[r * ldv + d] = in ? vb[j * vs.w + d] : from_f32<T>(0.f);
    }
  }
  cp_async_commit();
}

// One block per (split, KV head, request): the partial softmax state of
// the group's G query heads over keys [split * chunk, min(.. + chunk,
// length)), written to m_part / l_part (rows of G) and acc_part (G x hd).
// Over a shard of a ring (slots [w0, w0 + W) of a wider one) the length is
// clipped to the shard, and the block writes split split0 + split of
// ns_total per (request, KV head), so that the shards' partials of all
// ranks sit in one buffer in rank order; the whole ring is w0 = 0,
// split0 = 0, ns_total = NS.
template <typename TQ, typename T, int HD, bool kCap>
__global__ void __launch_bounds__(kThreads, 2)
decode_partial_kernel(const TQ* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ lengths,
                      float* __restrict__ m_part, float* __restrict__ l_part,
                      float* __restrict__ acc_part, int W, int G, int hd,
                      int chunk, long long qsb, long long qsh, CacheStrides ks,
                      CacheStrides vs, float scale, float cap, float inv_cap,
                      int aligned, int w0, int ns_total, int split0) {
  using M = Mma<TQ, T, HD>;
  constexpr int ldk = ld_k<T, HD>(), ldv = ld_v<T, HD>();
  constexpr int kSlot = slot_elems<T, HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* red = reinterpret_cast<float*>(ring + kStages * kSlot);

  allow_dependent_launch();  // the merge may be scheduled now
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  // slots of this ring (a shard starting at global slot w0) the length
  // covers: clip(length - w0, 0, W)
  const int len = min(max(lengths[b] - w0, 0), W);
  const int k0 = split * chunk, k1 = min(k0 + chunk, len);
  const long long row0 =
      ((static_cast<long long>(b) * gridDim.y + kvh) * ns_total + split0 +
       split) * G;

  if (k1 <= k0) {  // no valid slot: weight 0 in the merge
    for (int e = tid; e < G * hd; e += kThreads) acc_part[row0 * hd + e] = 0.f;
    if (tid < G) {
      m_part[row0 + tid] = kNegInf;
      l_part[row0 + tid] = 0.f;
    }
    return;
  }
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  // the first tiles' copies go out before anything else is done
  const int n_tiles = (k1 - k0 + kTile - 1) / kTile;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles)
      load_tile<T, HD>(ring + s * kSlot, kb, vb, ks, vs, k0 + s * kTile, k1,
                       hd, aligned);
    else
      cp_async_commit();  // an empty group keeps the wait counts uniform
  }
  // head-dim padding up to HD stays zero: the copies write the first hd
  // columns only
  if (hd < HD)
    for (int e = tid; e < kStages * kTile * (HD - hd); e += kThreads) {
      const int r = e / (HD - hd), d = hd + e % (HD - hd);
      T* slot = ring + (r / kTile) * kSlot;
      slot[(r % kTile) * ldk + d] = from_f32<T>(0.f);
      slot[kTile * ldk + (r % kTile) * ldv + d] = from_f32<T>(0.f);
    }
  const TQ* qb = q + b * qsb + static_cast<long long>(kvh) * G * qsh;
  M mma;
  if constexpr (M::kStageQ) {
    // the query group, staged in the last slot's K tile (free until the
    // first iteration refills it): rows >= G and columns >= hd are zero
    T* q_s = ring + (kStages - 1) * kSlot;
    for (int e = tid; e < kRows * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      q_s[r * ldk + d] = r < G && d < hd ? qb[r * qsh + d] : from_f32<T>(0.f);
    }
    __syncthreads();  // q_s written
    mma.load_q(q_s, warp, g, c);
  } else {
    mma.load_q_global(qb, qsh, G, hd, warp, g, c);
  }

  float acc[M::kCols / 8][4];
#pragma unroll
  for (int nt = 0; nt < M::kCols / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed; tile t - 1's slot (and q_s) is free
    const int next = t + kStages - 1;
    if (next < n_tiles)
      load_tile<T, HD>(ring + (next % kStages) * kSlot, kb, vb, ks, vs,
                       k0 + next * kTile, k1, hd, aligned);
    else
      cp_async_commit();
    const T* k_s = ring + (t % kStages) * kSlot;

    float sc[kNT][4];
    mma.scores(sc, k_s, warp, g, c);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[((warp * kNT + nt) * 4 + i) * 32 + lane] = sc[nt][i];
    __syncthreads();

    // every warp sums the four partials in the same order, so all hold
    // the same scores and the same (m, l)
    const int kt = k0 + t * kTile;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = red[(nt * 4 + i) * 32 + lane];
#pragma unroll
        for (int w = 1; w < kWarps; ++w)
          s += red[((w * kNT + nt) * 4 + i) * 32 + lane];
        s *= scale;
        if constexpr (kCap) s = cap * tanhf(s * inv_cap);
        if (kt + nt * 8 + 2 * c + (i & 1) >= k1) s = kNegInf;
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
    for (int nt = 0; nt < M::kCols / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] *= corr[i >> 1];
    M::accumulate(acc, sc, k_s + kTile * ldk, warp, g, c);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFullMask, l[r], 1);
    l[r] += __shfl_xor_sync(kFullMask, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (row >= G) continue;
    float* out = acc_part + (row0 + row) * hd;
#pragma unroll
    for (int nt = 0; nt < M::kCols / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = warp * M::kCols + nt * 8 + 2 * c + e;
        if (d < hd) out[d] = acc[nt][2 * r + e];
      }
    if (warp == 0 && c == 0) {
      m_part[row0 + row] = m[r];
      l_part[row0 + row] = l[r];
    }
  }
}

// One block per (kMergeThreads output elements of the group, KV head,
// request): each thread merges the splits of its (query head, column) in
// split order, weighting split s by exp(m_s - max_s m_s), and normalises.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
decode_merge_kernel(const float* __restrict__ m_part,
                    const float* __restrict__ l_part,
                    const float* __restrict__ acc_part, T* __restrict__ o,
                    int NS, int G, int hd, long long osb, long long osh) {
  __shared__ float m_s[kMaxSplits * kMaxG], l_s[kMaxSplits * kMaxG];
  grid_dependency_wait();  // the partial kernel has finished
  const int kvh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int n_el = G * hd, e0 = blockIdx.x * kMergeThreads;
  // the query heads this block's elements belong to: at most G
  const int g_lo = e0 / hd;
  const int ng = (min(e0 + kMergeThreads, n_el) - 1) / hd - g_lo + 1;
  const long long row0 = (static_cast<long long>(b) * gridDim.y + kvh) * NS;
  for (int i = tid; i < NS * ng; i += kMergeThreads) {
    const int s = i / ng, gg = i - s * ng;
    m_s[i] = m_part[(row0 + s) * G + g_lo + gg];
    l_s[i] = l_part[(row0 + s) * G + g_lo + gg];
  }
  __syncthreads();
  const int e = e0 + tid;
  if (e >= n_el) return;
  const int g = e / hd, d = e - g * hd, gg = g - g_lo;
  float mx = kNegInf;
  for (int s = 0; s < NS; ++s) mx = fmaxf(mx, m_s[s * ng + gg]);
  const float* ap = acc_part + (row0 * G + g) * hd + d;
  const long long step = static_cast<long long>(G) * hd;
  float l = 0.f, acc = 0.f;
  for (int s0 = 0; s0 < NS; s0 += kMergeBatch) {
    float a[kMergeBatch];  // the batch's loads all in flight at once
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j)
      a[j] = s0 + j < NS ? ap[(s0 + j) * step] : 0.f;
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      if (s0 + j >= NS) break;
      const int i = (s0 + j) * ng + gg;
      const float w = expf(m_s[i] - mx);  // 0 for an empty split
      l = fmaf(l_s[i], w, l);
      acc = fmaf(a[j], w, acc);
    }
  }
  o[b * osb + (static_cast<long long>(kvh) * G + g) * osh + d] =
      from_f32<T>(acc * (1.f / fmaxf(l, 1e-30f)));
}

// The partial kernel over NS splits (written at split0 of ns_total), then,
// where o is not null, the merge of all ns_total splits into o.
template <typename TQ, typename T, int HD, bool kCap>
cudaError_t launch_hd(const void* q, const void* k, const void* v,
                      const int* lengths, float* scratch, void* o, int B,
                      int W, int H, int KV, int hd, int NS, int chunk,
                      long long qsb, long long qsh, CacheStrides ks,
                      CacheStrides vs, long long osb, long long osh,
                      float scale, float cap, int aligned, int w0,
                      int ns_total, int split0, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, HD>();
  static bool raised = false;  // the dynamic limit, once per instantiation
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_partial_kernel<TQ, T, HD, kCap>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    raised = true;
  }
  const int G = H / KV;
  const long long rows = static_cast<long long>(B) * KV * ns_total * G;
  float* m_part = scratch;
  float* l_part = scratch + rows;
  float* acc_part = scratch + 2 * rows;
  decode_partial_kernel<TQ, T, HD, kCap>
      <<<dim3(NS, KV, B), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, m_part, l_part, acc_part, W, G, hd,
      chunk, qsb, qsh, ks, vs, scale, cap, kCap ? 1.f / cap : 0.f, aligned,
      w0, ns_total, split0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || o == nullptr) return err;
  const dim3 merge_grid((G * hd + kMergeThreads - 1) / kMergeThreads, KV, B);
  return launch_dependent(decode_merge_kernel<TQ>, merge_grid,
                          dim3(kMergeThreads), stream,
                          static_cast<const float*>(m_part),
                          static_cast<const float*>(l_part),
                          static_cast<const float*>(acc_part),
                          static_cast<TQ*>(o), ns_total, G, hd, osb,
                          osh);
}

template <typename TQ, typename T, bool kCap>
cudaError_t launch_cap(const void* q, const void* k, const void* v,
                       const int* lengths, float* scratch, void* o, int B,
                       int W, int H, int KV, int hd, int NS, int chunk,
                       long long qsb, long long qsh, CacheStrides ks,
                       CacheStrides vs, long long osb, long long osh,
                       float scale, float cap, int aligned, int w0,
                       int ns_total, int split0, cudaStream_t stream) {
  if (hd <= 64)
    return launch_hd<TQ, T, 64, kCap>(
        q, k, v, lengths, scratch, o, B, W, H, KV, hd, NS, chunk, qsb, qsh, ks,
        vs, osb, osh, scale, cap, aligned, w0, ns_total, split0, stream);
  if (hd <= 128)
    return launch_hd<TQ, T, 128, kCap>(
        q, k, v, lengths, scratch, o, B, W, H, KV, hd, NS, chunk, qsb, qsh, ks,
        vs, osb, osh, scale, cap, aligned, w0, ns_total, split0, stream);
  return launch_hd<TQ, T, 256, kCap>(
      q, k, v, lengths, scratch, o, B, W, H, KV, hd, NS, chunk, qsb, qsh, ks,
      vs, osb, osh, scale, cap, aligned, w0, ns_total, split0, stream);
}

template <typename TQ, typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, float* scratch, void* o, int B, int W,
                   int H, int KV, int hd, int NS, int chunk, long long qsb,
                   long long qsh, CacheStrides ks, CacheStrides vs,
                   long long osb, long long osh, float scale, float cap,
                   int w0, int ns_total, int split0, cudaStream_t stream) {
  // cp.async needs every row start 16-byte aligned and whole tile rows
  const long long e = 16 / sizeof(T);
  auto al = [&](const void* p, const CacheStrides& st) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % e == 0 &&
           st.w % e == 0 && st.h % e == 0;
  };
  const int HDs = hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
  const int aligned = hd == HDs && al(k, ks) && al(v, vs);
  if (cap > 0.f)
    return launch_cap<TQ, T, true>(q, k, v, lengths, scratch, o, B, W, H, KV,
                                   hd, NS, chunk, qsb, qsh, ks, vs, osb, osh,
                                   scale, cap, aligned, w0, ns_total, split0,
                                   stream);
  return launch_cap<TQ, T, false>(q, k, v, lengths, scratch, o, B, W, H, KV,
                                  hd, NS, chunk, qsb, qsh, ks, vs, osb, osh,
                                  scale, cap, aligned, w0, ns_total, split0,
                                  stream);
}

// The three type pairs; o null runs the partial kernel alone.
int dispatch(const void* q, const void* k, const void* v, const void* lengths,
             void* scratch, void* o, int q_dtype, int c_dtype, int B, int W,
             int H, int KV, int hd, int NS, int chunk, long long qsb,
             long long qsh, long long ksb, long long ksw, long long ksh,
             long long vsb, long long vsw, long long vsh, long long osb,
             long long osh, float scale, float cap, int w0, int ns_total,
             int split0, void* stream) {
  if (hd > kMaxHD || hd <= 0 || KV <= 0 || H % KV != 0 || H / KV > kMaxG ||
      NS <= 0 || ns_total > kMaxSplits || split0 < 0 ||
      split0 + NS > ns_total || chunk <= 0 || chunk % kTile != 0 ||
      static_cast<long long>(NS) * chunk < W || B <= 0 || B > 65535 ||
      KV > 65535 || w0 < 0 || !(cap >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const CacheStrides ks{ksb, ksw, ksh}, vs{vsb, vsw, vsh};
  const int* len = static_cast<const int*>(lengths);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && c_dtype == kF32)
    return launch<float, float>(q, k, v, len, sc, o, B, W, H, KV, hd, NS,
                                chunk, qsb, qsh, ks, vs, osb, osh, scale, cap,
                                w0, ns_total, split0, s);
  if (q_dtype == kBF16 && c_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, len, sc, o, B, W, H, KV, hd, NS, chunk, qsb, qsh, ks, vs, osb,
        osh, scale, cap, w0, ns_total, split0, s);
  if (q_dtype == kF32 && c_dtype == kBF16)
    return launch<float, __nv_bfloat16>(q, k, v, len, sc, o, B, W, H, KV, hd,
                                        NS, chunk, qsb, qsh, ks, vs, osb, osh,
                                        scale, cap, w0, ns_total, split0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro

// q: (B, H, hd) with (batch, head) element strides; k/v: (B, W, KV, hd)
// with (batch, slot, head) element strides; every head dim contiguous.
// lengths: (B,) int32. scratch: B * KV * NS * G * (2 + hd) floats. out:
// (B, H, hd) with (batch, head) strides, in q's type. q_dtype / c_dtype:
// the query's and the caches' type codes, both f32, both bf16, or f32
// over bf16. hd <= 256, H / KV <= 16, NS <= 256 splits of chunk keys (a
// multiple of 16), NS * chunk >= W. cap > 0 soft-caps the scaled scores at
// cap (cap tanh(s / cap)); 0 means no cap.
// Returns the launches' cudaError_t.
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* scratch, void* o, int q_dtype, int c_dtype, int B, int W, int H,
    int KV, int hd, int NS, int chunk, long long qsb, long long qsh,
    long long ksb, long long ksw, long long ksh, long long vsb, long long vsw,
    long long vsh, long long osb, long long osh, float scale, float cap,
    void* stream) {
  if (o == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return repro::dispatch(q, k, v, lengths, scratch, o, q_dtype, c_dtype, B,
                         W, H, KV, hd, NS, chunk, qsb, qsh, ksb, ksw, ksh, vsb,
                         vsw, vsh, osb, osh, scale, cap, 0, NS, 0, stream);
}

// The partial entry, for decode over a shard of a ring cut over ranks on
// its slots (context parallelism): k/v hold slots [w0, w0 + W) of the ring
// and lengths are the whole ring's, clipped here to the shard. Runs the
// partial kernel alone, its NS splits written as splits [split0, split0 +
// NS) of ns_total per (request, KV head) into scratch, B * KV * ns_total *
// G * (2 + hd) floats: m (rows of B * KV * ns_total * G), then l, then acc
// (rows x hd), a split's row order (request, KV head, split, query head of
// the group). The caller zero-fills the rest, so that a sum of the ranks'
// buffers gathers them. A split with no slot in its length writes m =
// -1e30, l = 0, acc = 0: the merge weighs it at exp(-1e30 - max) = 0.
// ns_total <= 256. Other arguments as repro_decode_attention's.
extern "C" int repro_decode_attention_partials(
    const void* q, const void* k, const void* v, const void* lengths,
    void* scratch, int q_dtype, int c_dtype, int B, int W, int H, int KV,
    int hd, int NS, int chunk, int w0, int ns_total, int split0,
    long long qsb, long long qsh, long long ksb, long long ksw, long long ksh,
    long long vsb, long long vsw, long long vsh, float scale, float cap,
    void* stream) {
  return repro::dispatch(q, k, v, lengths, scratch, nullptr, q_dtype, c_dtype,
                         B, W, H, KV, hd, NS, chunk, qsb, qsh, ksb, ksw, ksh,
                         vsb, vsw, vsh, 0, 0, scale, cap, w0, ns_total, split0,
                         stream);
}

// The merge entry: the ns_total splits of every (request, KV head) in
// scratch (the partial entry's layout, all ranks' splits gathered) merged
// in split order, as the whole-ring call merges its own, into o (B, H, hd)
// with (batch, head) strides, in o_dtype (f32 or bf16).
extern "C" int repro_decode_attention_merge(
    const void* scratch, void* o, int o_dtype, int B, int H, int KV, int hd,
    int ns_total, long long osb, long long osh, void* stream) {
  using namespace repro;
  if (hd > kMaxHD || hd <= 0 || KV <= 0 || H % KV != 0 || H / KV > kMaxG ||
      ns_total <= 0 || ns_total > kMaxSplits || B <= 0 || B > 65535 ||
      KV > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / KV;
  const long long rows = static_cast<long long>(B) * KV * ns_total * G;
  const float* m_part = static_cast<const float*>(scratch);
  const float* l_part = m_part + rows;
  const float* acc_part = m_part + 2 * rows;
  const dim3 grid((G * hd + kMergeThreads - 1) / kMergeThreads, KV, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (o_dtype == kF32)
    decode_merge_kernel<float><<<grid, kMergeThreads, 0, s>>>(
        m_part, l_part, acc_part, static_cast<float*>(o), ns_total, G, hd, osb,
        osh);
  else if (o_dtype == kBF16)
    decode_merge_kernel<__nv_bfloat16><<<grid, kMergeThreads, 0, s>>>(
        m_part, l_part, acc_part, static_cast<__nv_bfloat16*>(o), ns_total, G,
        hd, osb, osh);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
