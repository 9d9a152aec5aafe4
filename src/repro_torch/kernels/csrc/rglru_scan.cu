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
// Backward (repro_rglru_scan_bwd): with the forward's h saved and the
// incoming gradient dh, g_t = dh_t + a_{t+1} g_{t+1} runs from t = S - 1
// down, and
//
//   du_t = g_t,   da_t = g_t h_{t-1} (h_{-1} = h0, or 0),   dh0 = a_0 g_0.
//
// The TPU kernel has no gradient (the JAX package trains through the
// reference scan under XLA); training on the card needs this one. Each lane
// walks its channel backwards in time with the same rounding (each product
// and sum apart), so it is bit for bit the plain reverse loop
// (rglru_scan.py::rglru_scan_bwd_plain). Bytes bound it, as the forward: a,
// h and dh read, da and du written, 5 B S D 4 bytes in f32 (492 MB at
// RecurrentGemma's training shape (2, 3000, 4096), 147 us at 3.35 TB/s),
// 32 (elt + 16) bytes a strip a step. At that shape the grid is only 256
// warps, about 2 an SM, so each warp has to keep about half an SM's bytes
// in flight.
//
// * rglru_bwd_ring_kernel does for the backward what rglru_ring_kernel does
//   for the forward: a warp owns 32 channels of one batch row and carries
//   a_{t+1} g_{t+1} in a register; it walks tiles of `steps` time steps from
//   the last tile down, through its own ring of `stages` tiles filled by
//   16-byte cp.async copies, one commit group a tile, ordered only by
//   cp.async.wait_group and __syncwarp. A tile holds three streams: a_t in
//   its own type and strides, dh_t (f32, contiguous) and h_{t-1}, the h rows
//   shifted by one step (row t = 0 copies h0, or zero-fills). da_t and du_t
//   go straight to global memory, one coalesced row of the strip a step.
// * With two warps an SM, a warp's step time is the kernel's time, so the
//   loop is built for latency: rows are read from the tile kBwdGroup at a
//   time into registers, then the chain runs over them, then their du and
//   da rows are stored under one predicate. Read a step at a time, every
//   step waited for its shared-memory load behind a branch around its
//   stores, ~90 cycles a step, and the ring ran no faster than the
//   per-element path (310 against 301 us at (2, 3000, 4096) on an H100).
//   The wrapper plans two tiles of 64 steps (kernels/rglru_scan.py::
//   bwd_tiles), 24 KB in flight a warp in f32: the tile's length, which
//   spreads each tile's wait and copy issue over its steps, set the time
//   more than the bytes in flight did (chip_smoke.py's backward sweep).
// * rglru_bwd_kernel, the per-element path, serves calls whose pointers,
//   strides or D * elt are off 16 bytes: one lane a channel, the loads of
//   the kUnroll steps below the ones it computes in flight meanwhile.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kStrip = 32;       // channels a warp owns, one a lane
constexpr int kMaxStages = 8;    // ring tiles (rglru_scan.py MAX_STAGES)
constexpr int kUnroll = 16;      // steps the per-element path loads ahead
constexpr int kBwdGroup = 8;     // rows the backward ring reads at once
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

// bytes of one ring tile row (a time step of a strip): a, dh and h_{t-1}
template <typename T>
__host__ __device__ constexpr int bwd_row_bytes() {
  return kStrip * (static_cast<int>(sizeof(T)) + 8);
}

// A warp a (strip, batch row), walking its strip's tiles of `steps` time
// steps from the last down through a ring of `stages` tiles; a slot holds
// the tile's a, then dh, then h_{t-1}, row r being time step t0 + r. Each
// lane copies fixed 16-byte columns of every kRowsPerCopy-th row, so the
// copy loops carry no division. The rows are walked kBwdGroup at a time:
// the group's a, dh and h_{t-1} are read from shared memory into registers
// first, then the chain runs over them, then the group's du and da rows
// are stored under one predicate: one shared-memory latency a group, not
// one a step, and no branch a step.
template <typename T>
__global__ void __launch_bounds__(kStrip)
rglru_bwd_ring_kernel(const T* __restrict__ a, const float* __restrict__ h,
                      const float* __restrict__ h0,
                      const float* __restrict__ dh, float* __restrict__ da,
                      float* __restrict__ du, float* __restrict__ dh0,
                      Scan p, int steps, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kE = 16 / sizeof(T);     // a elements a 16-byte copy moves
  constexpr int kCpa = kStrip / kE;      // copies of a tile row of a: 8 f32
  constexpr int kCpf = kStrip / 4;       // ... of dh or h: 8
  const int lane = threadIdx.x;
  const int b = blockIdx.x / p.strips;
  const int d0 = (blockIdx.x % p.strips) * kStrip;
  const bool live = d0 + lane < p.D;
  const long long row0 = static_cast<long long>(b) * p.S * p.D + d0;
  const int tile = steps * kStrip;       // elements of one stream a tile
  const int slot_bytes = steps * bwd_row_bytes<T>();
  const int n_tiles = (p.S + steps - 1) / steps;
  // this lane's copy columns and first rows: a, then dh and h
  const int col_a = (lane % kCpa) * kE, r_a = lane / kCpa;
  const int col_f = (lane % kCpf) * 4, r_f = lane / kCpf;
  const bool in_a = d0 + col_a < p.D, in_f = d0 + col_f < p.D;
  const T* a_src = a + b * p.asb + d0 + col_a;
  const float* g_src = dh + row0 + col_f;
  const float* h_src = h + row0 + col_f;
  const float* h0_src =
      h0 != nullptr && in_f ? h0 + static_cast<long long>(b) * p.D + d0 + col_f
                            : nullptr;

  auto slot_at = [&](int slot) { return smem_raw + slot * slot_bytes; };
  // tile n_tiles - 1 - j into ring slot `slot`, one commit group (empty
  // past the first tile, which keeps every lane's count of groups the same)
  auto issue = [&](int j, int slot) {
    if (j < n_tiles) {
      const int t0 = (n_tiles - 1 - j) * steps;
      const int rows = min(steps, p.S - t0);
      T* as = reinterpret_cast<T*>(slot_at(slot));
      float* gs = reinterpret_cast<float*>(as + tile);
      float* hs = gs + tile;
      for (int r = r_a; r < rows; r += kStrip / kCpa)
        cp_async16(as + r * kStrip + col_a,
                   in_a ? a_src + (t0 + r) * p.ass : a, in_a);
      for (int r = r_f; r < rows; r += kStrip / kCpf) {
        const long long t = t0 + r;
        cp_async16(gs + r * kStrip + col_f, in_f ? g_src + t * p.D : dh,
                   in_f);
        // h_{t-1}; row t = 0 takes h0, or zero
        const float* src = t > 0 ? (in_f ? h_src + (t - 1) * p.D : nullptr)
                                 : h0_src;
        cp_async16(hs + r * kStrip + col_f, src ? src : dh, src != nullptr);
      }
    }
    cp_async_commit();
  };

  for (int j = 0; j < stages - 1; ++j) issue(j, j);
  float carry = 0.f;  // a_{t+1} g_{t+1}
  int slot = 0;
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait_upto(stages - 2);  // this lane's copies of tile j landed
    __syncwarp();                    // ... and every lane's; slot j - 1 free
    issue(j + stages - 1, slot == 0 ? stages - 1 : slot - 1);
    const T* as = reinterpret_cast<const T*>(slot_at(slot)) + lane;
    const float* gs = reinterpret_cast<const float*>(
        reinterpret_cast<const T*>(slot_at(slot)) + tile) + lane;
    const float* hs = gs + tile;
    const int t0 = (n_tiles - 1 - j) * steps;
    int r = min(steps, p.S - t0);  // rows left, walked from the last
    // du and da of row r - 1
    float* up = du + row0 + static_cast<long long>(t0 + r - 1) * p.D + lane;
    float* dp = da + row0 + static_cast<long long>(t0 + r - 1) * p.D + lane;
    for (; r >= kBwdGroup; r -= kBwdGroup) {
      T av[kBwdGroup];
      float gv[kBwdGroup], hv[kBwdGroup];
#pragma unroll
      for (int i = 0; i < kBwdGroup; ++i) {
        const int k = (r - 1 - i) * kStrip;
        av[i] = as[k];
        gv[i] = gs[k];
        hv[i] = hs[k];
      }
#pragma unroll
      for (int i = 0; i < kBwdGroup; ++i) {
        gv[i] = __fadd_rn(gv[i], carry);
        hv[i] = __fmul_rn(gv[i], hv[i]);
        carry = __fmul_rn(to_f32(av[i]), gv[i]);
      }
      if (live) {
#pragma unroll
        for (int i = 0; i < kBwdGroup; ++i) {
          up[-static_cast<long long>(i) * p.D] = gv[i];
          dp[-static_cast<long long>(i) * p.D] = hv[i];
        }
      }
      up -= static_cast<long long>(kBwdGroup) * p.D;
      dp -= static_cast<long long>(kBwdGroup) * p.D;
    }
    for (; r > 0; --r) {  // the tile's first rows, under a group
      const int k = (r - 1) * kStrip;
      const float g = __fadd_rn(gs[k], carry);
      if (live) {
        *up = g;
        *dp = __fmul_rn(g, hs[k]);
      }
      carry = __fmul_rn(to_f32(as[k]), g);
      up -= p.D;
      dp -= p.D;
    }
    slot = slot + 1 == stages ? 0 : slot + 1;
  }
  cp_async_wait_all();
  if (dh0 != nullptr && live)
    dh0[static_cast<long long>(b) * p.D + d0 + lane] = carry;
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

template <typename T>
cudaError_t launch_bwd(const void* a, const void* h, const void* h0,
                       const void* dh, void* da, void* du, void* dh0, int B,
                       Scan p, int steps, int stages, int aligned,
                       cudaStream_t stream) {
  const T* at = static_cast<const T*>(a);
  const float* hf = static_cast<const float*>(h);
  const float* h0f = static_cast<const float*>(h0);
  const float* dhf = static_cast<const float*>(dh);
  float* daf = static_cast<float*>(da);
  float* duf = static_cast<float*>(du);
  float* dh0f = static_cast<float*>(dh0);
  if (!aligned) {
    const dim3 grid(static_cast<unsigned>(p.strips),
                    static_cast<unsigned>(B));
    rglru_bwd_kernel<T><<<grid, kStrip, 0, stream>>>(at, hf, h0f, dhf, daf,
                                                     duf, dh0f, p);
    return cudaGetLastError();
  }
  const long long blocks = static_cast<long long>(B) * p.strips;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  // the copies need every row start on 16 bytes and whole 16-byte chunks
  const long long e = 16 / sizeof(T);
  auto on16 = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  const bool ok = on16(a) && on16(h) && on16(dh) &&
                  (h0 == nullptr || on16(h0)) && p.D % e == 0 &&
                  p.D % 4 == 0 && p.asb % e == 0 && p.ass % e == 0;
  const long long smem =
      static_cast<long long>(stages) * steps * bwd_row_bytes<T>();
  if (!ok || steps < 1 || stages < 2 || stages > kMaxStages ||
      smem > kMaxSmem)
    return cudaErrorInvalidValue;
  static bool raised = false;  // rings past 48 KB, once per instantiation
  if (!raised && smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rglru_bwd_ring_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  rglru_bwd_ring_kernel<T><<<static_cast<int>(blocks), kStrip,
                             static_cast<size_t>(smem), stream>>>(
      at, hf, h0f, dhf, daf, duf, dh0f, p, steps, stages);
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
// aligned != 0 takes the cp.async ring of `stages` tiles of `steps` time
// steps (refused unless a, h, dh and h0 start on 16 bytes, a's strides and
// D * elt are whole 16 bytes and the ring fits 227 KB); aligned == 0 the
// per-element loads. Returns the launch's cudaError_t.
extern "C" int repro_rglru_scan_bwd(const void* a, const void* h,
                                    const void* h0, const void* dh, void* da,
                                    void* du, void* dh0, int dtype, int B,
                                    int S, int D, long long asb,
                                    long long ass, int steps, int stages,
                                    int aligned, void* stream) {
  using namespace repro;
  if (B <= 0 || S <= 0 || D <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scan p{S, D, (D + kStrip - 1) / kStrip, asb, ass, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_bwd<float>(a, h, h0, dh, da, du, dh0, B, p, steps,
                               stages, aligned, s);
    case kBF16:
      return launch_bwd<__nv_bfloat16>(a, h, h0, dh, da, du, dh0, B, p, steps,
                                       stages, aligned, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
