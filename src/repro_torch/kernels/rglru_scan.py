"""RG-LRU diagonal linear recurrence: h_t = a_t * h_{t-1} + u_t.

a, u: (B, S, D) -> h: (B, S, D) float32, with an optional initial state
h0 (B, D) (zeros when absent). ``rglru_scan`` runs the hand-written CUDA
kernel ``csrc/rglru_scan.cu`` on CUDA tensors and ``rglru_scan_plain`` on
CPU tensors; on any other device it raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# kernel launches since the last ops.reset_launch_counts()
launches = 0


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


def rglru_scan(a, u, h0=None):
    """h (B, S, D) float32; CUDA kernel on CUDA tensors, plain on CPU."""
    global launches
    if a.device.type == "cpu":
        return rglru_scan_plain(a, u, h0)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {a.device}")
    _check(a, u, h0)
    b, s, d = a.shape
    h = torch.empty(b, s, d, dtype=torch.float32, device=a.device)
    lib = _build.library()
    _build.check(lib.repro_rglru_scan(
        a.data_ptr(), u.data_ptr(), 0 if h0 is None else h0.data_ptr(),
        h.data_ptr(), _build.DTYPE_CODES[a.dtype], b, s, d,
        a.stride(0), a.stride(1), u.stride(0), u.stride(1),
        _build.stream_ptr(a)), "rglru_scan")
    launches += 1
    return h
