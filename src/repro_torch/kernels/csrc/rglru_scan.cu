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
// one add over 12 bytes moved in f32 (a and u read, h written) or 8 in
// bf16: at (4, 3000, 4096) f32 that is 590 MB, 176 us at 3.35 TB/s. The
// arithmetic is a chain of S dependent steps per channel, some 8 cycles
// each: 3,000 steps are ~15 us, far under the bytes' time. The kernel only
// has to be fed.
//
// Why the order stays sequential in time: a chunked or look-back scan
// ((prod a, h) per time chunk, then a pass over the chunks) sums in
// another order, so it could not stay bitwise equal to the plain loop, and
// its two-pass form reads a and u twice. The TPU kernel is sequential in
// time too: one read of (a, u) and one write of h.
//
// What the design does about the bound: keep enough bytes in flight on
// every SM, all the time.
//
// * A warp owns a strip of kStrip = 32 channels of one batch row, one
//   block a warp, so the grid is B * ceil(D / 32) warps (512 at RG's
//   shape, about 4 an SM). Lane i owns channel i of the strip and carries
//   h in a register through all S steps, in order.
// * Each warp has its own ring of `stages` tiles in shared memory, a tile
//   holding `steps` time steps x 32 channels of a and of u. The warp fills
//   it with 16-byte cp.async copies, a tile one commit group: while it
//   steps through tile k, tiles k + 1 .. k + stages - 1 are in flight.
//   Only cp.async.wait_group and __syncwarp order a warp's ring; no warp
//   waits on another and there is no __syncthreads. A lane reads its
//   channel's column of the tile (32 distinct banks in f32) and stores h
//   straight to global memory, one coalesced row of the strip a step.
//   The wrapper plans (steps, stages) from the warps an SM holds
//   (kernels/rglru_scan.py::tiles): two tiles in flight and about 32 KB
//   an SM, so at RG's shape (4 warps an SM) 3 tiles of 16 steps in f32,
//   4 KB a tile. Deeper rings measured slower there; one warp an SM
//   (B = 1) takes 16 KB tiles.
// * Ragged edges: the last tile copies only its rows, so nothing past S is
//   read; copies of a strip's chunks past D are src-size 0 (zero fill,
//   nothing read) and those lanes store nothing.
// * The copies need 16-byte aligned base pointers, row strides and D * elt.
//   A call that does not have them (D = 300 in bf16, a view at an odd
//   offset) takes rglru_elem_kernel: the same warps, per-element loads
//   issued one kUnroll-step tile ahead of the arithmetic.
//
// Backward (repro_rglru_scan_bwd, rglru_bwd_kernel): with the forward's h
// saved and the incoming gradient dh, g_t = dh_t + a_{t+1} g_{t+1} runs from
// t = S - 1 down, and
//
//   du_t = g_t,   da_t = g_t h_{t-1} (h_{-1} = h0, or 0),   dh0 = a_0 g_0.
//
// The TPU kernel has no gradient (the JAX package trains through the
// reference scan under XLA); training on the card needs this one. One lane
// a (b, d) channel walks time backwards with the same rounding (each product
// and sum apart), so it is bit for bit the plain reverse loop
// (rglru_scan.py::rglru_scan_bwd_plain). Bytes bound it, as the forward: a,
// h and dh read, da and du written, 5 B S D 4 bytes in f32 (492 MB at
// RecurrentGemma's training shape (2, 3000, 4096), 147 us at 3.35 TB/s).
// Blocks of one warp (32 channels of one batch row) spread the B * D / 32
// warps over every SM; each lane loads the kUnroll steps before the ones it
// is computing, coalesced along d. The saved a is read in its own type and
// strides, h and dh are contiguous f32.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kStrip = 32;       // channels a warp owns, one a lane
constexpr int kMaxStages = 8;    // ring tiles (rglru_scan.py MAX_STAGES)
constexpr int kUnroll = 16;      // steps the per-element path loads ahead
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float rglru_step(float a, float h, float u) {
  return __fadd_rn(__fmul_rn(a, h), u);
}

// wait until at most `pending` of this thread's cp.async groups are in
// flight; the count is uniform across the warp
__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<kMaxStages - 2>(); break;
  }
}

struct Scan {
  int S, D, strips;              // strips a batch row: ceil(D / kStrip)
  long long asb, ass, usb, uss;  // element strides of a and u
};

template <typename T>
__global__ void __launch_bounds__(kStrip)
rglru_ring_kernel(const T* __restrict__ a, const T* __restrict__ u,
                  const float* __restrict__ h0, float* __restrict__ h,
                  Scan p, int steps, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kE = 16 / sizeof(T);     // elements a 16-byte copy moves
  constexpr int kCpr = kStrip / kE;      // copies a tile row: 8 f32, 4 bf16
  const int lane = threadIdx.x;
  const int b = blockIdx.x / p.strips;
  const int d0 = (blockIdx.x % p.strips) * kStrip;
  const bool live = d0 + lane < p.D;
  const T* ab = a + b * p.asb + d0;
  const T* ub = u + b * p.usb + d0;
  float* hp = h + (static_cast<long long>(b) * p.S) * p.D + d0 + lane;
  float hv = h0 != nullptr && live
                 ? h0[static_cast<long long>(b) * p.D + d0 + lane] : 0.f;
  const int tile = steps * kStrip;       // elements of one array a tile
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int n_tiles = (p.S + steps - 1) / steps;

  // tile k into ring slot `slot`, one commit group (empty past the end,
  // which keeps every lane's count of groups the same)
  auto issue = [&](int k, int slot) {
    if (k < n_tiles) {
      const int t0 = k * steps;
      const int n = min(steps, p.S - t0) * kCpr;
      T* as = ring + slot * 2 * tile;
      T* us = as + tile;
      for (int c = lane; c < n; c += kStrip) {
        const int r = c / kCpr;
        const int col = (c % kCpr) * kE;
        const bool in = d0 + col < p.D;
        const long long t = t0 + r;
        cp_async16(as + r * kStrip + col, in ? ab + t * p.ass + col : ab, in);
        cp_async16(us + r * kStrip + col, in ? ub + t * p.uss + col : ub, in);
      }
    }
    cp_async_commit();
  };

  for (int k = 0; k < stages - 1; ++k) issue(k, k);
  int slot = 0;
  for (int k = 0; k < n_tiles; ++k) {
    cp_async_wait_upto(stages - 2);  // this lane's copies of tile k landed
    __syncwarp();                    // ... and every lane's; slot k - 1 free
    issue(k + stages - 1, slot == 0 ? stages - 1 : slot - 1);
    const T* as = ring + slot * 2 * tile + lane;
    const T* us = as + tile;
    const int rows = min(steps, p.S - k * steps);
#pragma unroll 8
    for (int r = 0; r < rows; ++r) {
      hv = rglru_step(to_f32(as[r * kStrip]), hv, to_f32(us[r * kStrip]));
      if (live) *hp = hv;
      hp += p.D;
    }
    slot = slot + 1 == stages ? 0 : slot + 1;
  }
  cp_async_wait_all();
}

template <typename T>
__global__ void __launch_bounds__(kStrip)
rglru_elem_kernel(const T* __restrict__ a, const T* __restrict__ u,
                  const float* __restrict__ h0, float* __restrict__ h,
                  Scan p) {
  const int b = blockIdx.x / p.strips;
  const int d = (blockIdx.x % p.strips) * kStrip + threadIdx.x;
  if (d >= p.D) return;
  const T* ab = a + b * p.asb + d;
  const T* ub = u + b * p.usb + d;
  float* hp = h + (static_cast<long long>(b) * p.S) * p.D + d;
  float hv = h0 != nullptr ? h0[static_cast<long long>(b) * p.D + d] : 0.f;
  T an[kUnroll], un[kUnroll];
  auto load = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (t0 + i < p.S) {
        an[i] = ab[(t0 + i) * p.ass];
        un[i] = ub[(t0 + i) * p.uss];
      }
    }
  };
  load(0);
  for (int t0 = 0; t0 < p.S; t0 += kUnroll) {
    T ac[kUnroll], uc[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      ac[i] = an[i];
      uc[i] = un[i];
    }
    if (t0 + kUnroll < p.S) load(t0 + kUnroll);  // in flight meanwhile
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (t0 + i < p.S) {
        hv = rglru_step(to_f32(ac[i]), hv, to_f32(uc[i]));
        hp[static_cast<long long>(t0 + i) * p.D] = hv;
      }
    }
  }
}

// One lane a channel d of batch row blockIdx.y, walking t = S - 1 .. 0;
// the loads of the kUnroll steps below the ones being computed are in
// flight meanwhile.
template <typename T>
__global__ void __launch_bounds__(kStrip)
rglru_bwd_kernel(const T* __restrict__ a, const float* __restrict__ h,
                 const float* __restrict__ h0, const float* __restrict__ dh,
                 float* __restrict__ da, float* __restrict__ du,
                 float* __restrict__ dh0, Scan p) {
  const int b = blockIdx.y;
  const int d = blockIdx.x * kStrip + threadIdx.x;
  if (d >= p.D) return;
  const T* ab = a + b * p.asb + d;
  const long long row = static_cast<long long>(b) * p.S * p.D + d;
  const float* hb = h + row;
  const float* gb = dh + row;
  float* dab = da + row;
  float* dub = du + row;
  const float hinit =
      h0 != nullptr ? h0[static_cast<long long>(b) * p.D + d] : 0.f;
  T an[kUnroll];
  float hn[kUnroll], gn[kUnroll];
  // steps t0 - i, i < kUnroll: a_t (in its type, widened where used),
  // h_{t-1} and dh_t
  auto load = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int t = t0 - i;
      if (t >= 0) {
        an[i] = ab[static_cast<long long>(t) * p.ass];
        hn[i] = t > 0 ? hb[static_cast<long long>(t - 1) * p.D] : hinit;
        gn[i] = gb[static_cast<long long>(t) * p.D];
      }
    }
  };
  float carry = 0.f;  // a_{t+1} g_{t+1}
  load(p.S - 1);
  for (int t0 = p.S - 1; t0 >= 0; t0 -= kUnroll) {
    T ac[kUnroll];
    float hc[kUnroll], gc[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      ac[i] = an[i];
      hc[i] = hn[i];
      gc[i] = gn[i];
    }
    if (t0 - kUnroll >= 0) load(t0 - kUnroll);  // in flight meanwhile
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int t = t0 - i;
      if (t >= 0) {
        const float g = __fadd_rn(gc[i], carry);
        dub[static_cast<long long>(t) * p.D] = g;
        dab[static_cast<long long>(t) * p.D] = __fmul_rn(g, hc[i]);
        carry = __fmul_rn(to_f32(ac[i]), g);
      }
    }
  }
  if (dh0 != nullptr) dh0[static_cast<long long>(b) * p.D + d] = carry;
}

template <typename T>
cudaError_t launch(const void* a, const void* u, const float* h0, float* h,
                   int B, Scan p, int steps, int stages, int aligned,
                   cudaStream_t stream) {
  const long long blocks = static_cast<long long>(B) * p.strips;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const T* at = static_cast<const T*>(a);
  const T* ut = static_cast<const T*>(u);
  if (!aligned) {
    rglru_elem_kernel<T><<<static_cast<int>(blocks), kStrip, 0, stream>>>(
        at, ut, h0, h, p);
    return cudaGetLastError();
  }
  // the copies need every row start on 16 bytes and whole 16-byte chunks
  const long long e = 16 / sizeof(T);
  const bool ok = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(u) % 16 == 0 && p.D % e == 0 &&
                  p.asb % e == 0 && p.ass % e == 0 && p.usb % e == 0 &&
                  p.uss % e == 0;
  const long long smem =
      static_cast<long long>(stages) * 2 * steps * kStrip * sizeof(T);
  if (!ok || steps < 1 || stages < 2 || stages > kMaxStages ||
      smem > kMaxSmem)
    return cudaErrorInvalidValue;
  // rings past 48 KB (forced ones; the plan's stay within it), once per
  // instantiation
  static bool raised = false;
  if (!raised && smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rglru_ring_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  rglru_ring_kernel<T><<<static_cast<int>(blocks), kStrip,
                         static_cast<size_t>(smem), stream>>>(
      at, ut, h0, h, p, steps, stages);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// a/u: (B, S, D) with a contiguous channel dim and the given (batch, time)
// element strides; h0: (B, D) contiguous f32 or null; h: (B, S, D)
// contiguous f32. aligned != 0 takes the cp.async ring of `stages` tiles
// of `steps` time steps (refused unless pointers, strides and D * elt are
// on 16 bytes and the ring fits 227 KB); aligned == 0 the per-element
// loads. Returns the launch's cudaError_t.
extern "C" int repro_rglru_scan(const void* a, const void* u, const void* h0,
                                void* h, int dtype, int B, int S, int D,
                                long long asb, long long ass, long long usb,
                                long long uss, int steps, int stages,
                                int aligned, void* stream) {
  using namespace repro;
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scan p{S, D, (D + kStrip - 1) / kStrip, asb, ass, usb, uss};
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(a, u, h0f, hf, B, p, steps, stages, aligned, s);
    case kBF16:
      return launch<__nv_bfloat16>(a, u, h0f, hf, B, p, steps, stages,
                                   aligned, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// a: (B, S, D) with a contiguous channel dim and the given (batch, time)
// element strides; h and dh: (B, S, D) contiguous f32 (the forward's output
// and its gradient); h0: (B, D) contiguous f32 or null. Writes da and du
// (B, S, D) contiguous f32 and, when dh0 is not null, dh0 (B, D) f32.
// Returns the launch's cudaError_t.
extern "C" int repro_rglru_scan_bwd(const void* a, const void* h,
                                    const void* h0, const void* dh, void* da,
                                    void* du, void* dh0, int dtype, int B,
                                    int S, int D, long long asb,
                                    long long ass, void* stream) {
  using namespace repro;
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scan p{S, D, (D + kStrip - 1) / kStrip, asb, ass, 0, 0};
  const dim3 grid(static_cast<unsigned>(p.strips), static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* hf = static_cast<const float*>(h);
  const float* h0f = static_cast<const float*>(h0);
  const float* dhf = static_cast<const float*>(dh);
  float* daf = static_cast<float*>(da);
  float* duf = static_cast<float*>(du);
  float* dh0f = static_cast<float*>(dh0);
  switch (dtype) {
    case kF32:
      rglru_bwd_kernel<float><<<grid, kStrip, 0, s>>>(
          static_cast<const float*>(a), hf, h0f, dhf, daf, duf, dh0f, p);
      break;
    case kBF16:
      rglru_bwd_kernel<__nv_bfloat16><<<grid, kStrip, 0, s>>>(
          static_cast<const __nv_bfloat16*>(a), hf, h0f, dhf, daf, duf, dh0f,
          p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
