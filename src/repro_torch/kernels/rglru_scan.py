"""RG-LRU diagonal linear recurrence: h_t = a_t * h_{t-1} + u_t.

a, u: (B, S, D) -> h: (B, S, D) float32, with an optional initial state
h0 (B, D) (zeros when absent). ``rglru_scan`` runs the hand-written CUDA
kernel ``csrc/rglru_scan.cu`` on CUDA tensors and ``rglru_scan_plain`` on
CPU tensors; on any other device it raises.

The kernel gives each warp a strip of STRIP channels of one batch row and
streams the strip's a and u through a ring of ``stages`` tiles of
``steps`` time steps in shared memory. ``tiles`` plans the ring from the
warps an SM holds; ``is_aligned`` says whether the 16-byte copies that fill
it can serve a call (else the kernel loads element by element).

Under autograd a CUDA call goes through ``RGLRUScanFn``, whose backward
is a kernel of the same source: g_t = dh_t + a_{t+1} g_{t+1} from the last
step down, du_t = g_t, da_t = g_t h_{t-1}, dh0 = a_0 g_0, bit for bit
``rglru_scan_bwd_plain``. It walks each strip's tiles from the last down
through the same kind of ring, a tile holding a, dh and h shifted by one
step (``bwd_tiles`` plans it, ``is_aligned_bwd`` says whether the copies
can serve), else per-element loads. On the CPU autograd differentiates
``rglru_scan_plain``.

On ``meta`` tensors (the dry-run) the scan and, under autograd through
``RGLRUScanFn``, its backward check their inputs, launch and count
nothing, return outputs of the kernels' shapes and book their work into
``roofline.analysis``.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.roofline import analysis as ra

STRIP = 32               # csrc/rglru_scan.cu kStrip: channels a warp owns
MAX_STAGES = 8           # csrc/rglru_scan.cu kMaxStages: ring tiles
IN_FLIGHT = 32 * 1024    # a and u bytes the plan keeps in flight on an SM
STAGES = 3               # ring tiles: two in flight while one is read
MIN_TILE = 2 * 1024      # a and u bytes of a tile, at least
MAX_TILE = 16 * 1024     # ... and at most
BWD_STEPS = 64           # time steps of a backward tile, at most
BWD_SMEM = 192 * 1024    # backward ring bytes the plan lets an SM's warps hold
MAX_RESIDENT = 32        # one-warp blocks an SM holds, at most

# kernel launches since the last ops.reset_launch_counts(), forward and
# backward; incremented under the lock, since worker threads launch too
launches = 0
bwd_launches = 0
COUNT_LOCK = threading.Lock()


def rglru_scan_plain(a, u, h0=None):
    """A sequential loop over time in float32 (JAX ``ref.rglru_scan_ref``).

    Each step rounds the product and the sum apart, as the kernel does, so
    the two agree bit for bit.
    """
    a32, u32 = a.float(), u.float()
    b, s, d = a.shape
    h = torch.zeros(b, d, dtype=torch.float32, device=a.device) \
        if h0 is None else h0.float()
    out = torch.empty(b, s, d, dtype=torch.float32, device=a.device)
    for t in range(s):
        h = a32[:, t] * h + u32[:, t]
        out[:, t] = h
    return out


def rglru_scan_bwd_plain(a, h, dh, h0=None):
    """(da, du, dh0) float32 from the forward's a and output h and the
    gradient dh of h: the reverse loop g_t = dh_t + a_{t+1} g_{t+1}, du_t =
    g_t, da_t = g_t h_{t-1} (h_{-1} = h0, or 0), dh0 = a_0 g_0 (None
    without h0). Each step rounds the product and the sum apart, as the
    kernel does, so the two agree bit for bit."""
    a32, dh32 = a.float(), dh.float()
    b, s, d = a.shape
    carry = torch.zeros(b, d, dtype=torch.float32, device=a.device)
    da = torch.empty(b, s, d, dtype=torch.float32, device=a.device)
    du = torch.empty(b, s, d, dtype=torch.float32, device=a.device)
    h_init = torch.zeros_like(carry) if h0 is None else h0.float()
    for t in range(s - 1, -1, -1):
        g = dh32[:, t] + carry
        du[:, t] = g
        da[:, t] = g * (h[:, t - 1] if t > 0 else h_init)
        carry = a32[:, t] * g
    return da, du, None if h0 is None else carry


def _check(a, u, h0):
    if a.dim() != 3 or u.shape != a.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)}, u {tuple(u.shape)}")
    b, s, d = a.shape
    if b == 0 or s == 0 or d == 0 or b > 65535 or s >= 2 ** 31:
        raise ValueError(f"rglru_scan: unsupported shape {tuple(a.shape)}")
    if a.dtype not in _build.DTYPE_CODES or u.dtype != a.dtype:
        raise TypeError(f"rglru_scan: dtypes {a.dtype}, {u.dtype}")
    if u.device != a.device:
        raise ValueError("rglru_scan: a and u on different devices")
    if a.stride(2) != 1 or u.stride(2) != 1:
        raise ValueError("rglru_scan: a and u need a contiguous channel dim")
    if h0 is not None:
        if h0.shape != (b, d) or h0.dtype != torch.float32 \
                or h0.device != a.device or not h0.is_contiguous():
            raise ValueError(f"rglru_scan: h0 must be contiguous float32 "
                             f"{(b, d)}, got {h0.dtype} {tuple(h0.shape)}")


def tiles(b: int, s: int, d: int, elt: int, sms: int):
    """(steps, stages): the ring of each warp, ``stages`` tiles of
    ``steps`` time steps of its strip's a and u, for (B, S, D) inputs of
    ``elt`` bytes an element on ``sms`` SMs.

    The B * ceil(D / STRIP) warps put ``resident`` warps on an SM; each
    keeps two tiles in flight while it reads a third, and the tiles are
    sized so that an SM has about IN_FLIGHT bytes in flight: 4 KB tiles
    at RecurrentGemma's B = 4 (16 steps in f32), 16 KB at B = 1. More in
    flight measured slower at B = 4, and shorter tiles slower at B = 1
    (chip_smoke.py's ring sweep). A tile is MIN_TILE to MAX_TILE bytes,
    a power of two of steps, never longer than S."""
    resident = -(-b * -(-d // STRIP) // sms)
    row = 2 * STRIP * elt                 # a and u of one time step
    tile = min(max(IN_FLIGHT // (2 * resident), MIN_TILE), MAX_TILE)
    steps = min(1 << ((tile // row).bit_length() - 1), s)
    return steps, min(STAGES, -(-s // steps) + 1)


def bwd_tiles(b: int, s: int, d: int, elt: int, sms: int):
    """(steps, stages) of the backward's ring: two tiles (one read while
    the other is in flight) of BWD_STEPS time steps, halved while the rings
    of the warps an SM holds (B * ceil(D / STRIP) over ``sms``) would pass
    BWD_SMEM; never longer than S. A tile row (a time step of a strip)
    holds a in its type and dh and h_{t-1} in f32, STRIP * (elt + 8) bytes,
    so an SM keeps 24 KB in flight a warp in f32. Unlike the forward's, the
    backward's time is set by the tile's length more than by the bytes in
    flight (chip_smoke.py's backward tile sweep at RecurrentGemma's
    training shape: 64 x 2 within 3% of the fastest ring at B = 2 in f32,
    the fastest in bf16 and at B = 1, where 16-step tiles were 1.2-1.3x
    slower at any depth)."""
    resident = min(-(-b * -(-d // STRIP) // sms), MAX_RESIDENT)
    row = STRIP * (elt + 8)
    steps = BWD_STEPS
    while steps > 1 and resident * 2 * steps * row > BWD_SMEM:
        steps //= 2
    return min(steps, s), 2


def is_aligned(a, u) -> bool:
    """Whether the kernel's 16-byte copies can serve (a, u): both base
    pointers, both (batch, time) strides and D * elt on 16 bytes."""
    elt = a.element_size()
    return a.shape[2] * elt % 16 == 0 and all(
        t.data_ptr() % 16 == 0 and t.stride(0) * elt % 16 == 0
        and t.stride(1) * elt % 16 == 0 for t in (a, u))


def run_entry(a, u, h0=None, steps: Optional[int] = None,
              stages: Optional[int] = None, aligned: Optional[bool] = None):
    """Check CUDA tensors and run the kernel on them with the planned ring
    (``tiles``, ``is_aligned``) or, for measuring, a forced ``steps``,
    ``stages`` or path (``aligned`` False: per-element loads; True on
    inputs the copies cannot serve is refused). Counts nothing:
    ``rglru_scan`` is the counted launch."""
    _check(a, u, h0)
    b, s, d = a.shape
    plan = tiles(b, s, d, a.element_size(), _build.sm_count(a.device))
    steps = plan[0] if steps is None else steps
    stages = plan[1] if stages is None else stages
    ring = is_aligned(a, u) if aligned is None else aligned
    h = torch.empty(b, s, d, dtype=torch.float32, device=a.device)
    _build.check(_build.library().repro_rglru_scan(
        a.data_ptr(), u.data_ptr(), 0 if h0 is None else h0.data_ptr(),
        h.data_ptr(), _build.DTYPE_CODES[a.dtype], b, s, d,
        a.stride(0), a.stride(1), u.stride(0), u.stride(1), steps, stages,
        int(ring), _build.stream_ptr(a)), "rglru_scan")
    return h


def is_aligned_bwd(a, h, dh, h0=None) -> bool:
    """Whether the backward's 16-byte copies can serve: a as ``is_aligned``
    takes it, and h, dh and h0 starting on 16 bytes."""
    return is_aligned(a, a) and all(
        t.data_ptr() % 16 == 0 for t in (h, dh, h0) if t is not None)


def run_bwd_entry(a, h, dh, h0=None, steps: Optional[int] = None,
                  stages: Optional[int] = None,
                  aligned: Optional[bool] = None):
    """Check CUDA tensors and run the backward kernel: (da, du, dh0 or
    None), float32, contiguous. ``h`` is the forward's output, ``dh`` its
    gradient. The ring is planned (``bwd_tiles``, ``is_aligned_bwd``)
    unless ``steps``, ``stages`` or the path (``aligned`` False:
    per-element loads) are forced, as ``run_entry``'s. Counts nothing:
    ``RGLRUScanFn`` is the counted launch."""
    _check(a, a, h0)
    b, s, d = a.shape
    for name, t in (("h", h), ("dh", dh)):
        if t.shape != a.shape or t.dtype != torch.float32 \
                or t.device != a.device or not t.is_contiguous():
            raise ValueError(f"rglru_scan backward: {name} must be contiguous "
                             f"float32 {tuple(a.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    plan = bwd_tiles(b, s, d, a.element_size(), _build.sm_count(a.device))
    steps = plan[0] if steps is None else steps
    stages = plan[1] if stages is None else stages
    ring = is_aligned_bwd(a, h, dh, h0) if aligned is None else aligned
    da = torch.empty(b, s, d, dtype=torch.float32, device=a.device)
    du = torch.empty_like(da)
    dh0 = None if h0 is None else torch.empty(b, d, dtype=torch.float32,
                                              device=a.device)
    _build.check(_build.library().repro_rglru_scan_bwd(
        a.data_ptr(), h.data_ptr(), 0 if h0 is None else h0.data_ptr(),
        dh.data_ptr(), da.data_ptr(), du.data_ptr(),
        0 if dh0 is None else dh0.data_ptr(), _build.DTYPE_CODES[a.dtype], b,
        s, d, a.stride(0), a.stride(1), steps, stages, int(ring),
        _build.stream_ptr(a)),
        "rglru_scan backward")
    return da, du, dh0


def meta_entry(a, u, h0=None):
    """``run_entry`` on ``meta`` tensors: the same checks, no launch, the
    scan's work booked; h."""
    _check(a, u, h0)
    ra.record("rglru_scan", ra.rglru_work(*a.shape, a.element_size()))
    return torch.empty(a.shape, dtype=torch.float32, device="meta")


class RGLRUScanFn(torch.autograd.Function):
    """The scan on the card with its hand-written backward; saves a and the
    output h (the backward does not rescan). Each direction counts one
    launch."""

    @staticmethod
    def forward(ctx, a, u, h0):
        global launches
        if a.device.type == "meta":
            h = meta_entry(a, u, h0)
        else:
            h = run_entry(a, u, h0)
            with COUNT_LOCK:
                launches += 1
        ctx.save_for_backward(a, h, h0)
        ctx.u_dtype = u.dtype
        return h

    @staticmethod
    def backward(ctx, dh):
        global bwd_launches
        a, h, h0 = ctx.saved_tensors
        if a.device.type == "meta":
            ra.record("rglru_scan_bwd",
                      ra.rglru_bwd_work(*a.shape, a.element_size()))
            da = torch.empty(a.shape, dtype=torch.float32, device="meta")
            du = torch.empty_like(da)
            dh0 = None if h0 is None else torch.empty_like(h0)
        else:
            da, du, dh0 = run_bwd_entry(a, h, dh.float().contiguous(), h0)
            with COUNT_LOCK:
                bwd_launches += 1
        return da.to(a.dtype), du.to(ctx.u_dtype), dh0


def rglru_scan(a, u, h0=None):
    """h (B, S, D) float32; CUDA kernel on CUDA tensors, plain on CPU. A
    CUDA call that autograd records goes through ``RGLRUScanFn``."""
    global launches
    kind = _build.device_kind("rglru_scan", a)
    if kind == "cpu":
        return rglru_scan_plain(a, u, h0)
    if _build.wants_grad(a, u, h0):
        return RGLRUScanFn.apply(a, u, h0)
    if kind == "meta":
        return meta_entry(a, u, h0)
    h = run_entry(a, u, h0)
    with COUNT_LOCK:
        launches += 1
    return h
