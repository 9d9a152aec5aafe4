"""BvSB (Best-versus-Second-Best) confidence + top-1 — paper Eq. 2.

    BvSB = P1 - P2 = (1 - exp(m2 - m1)) / sum_j exp(l_j - m1)

``bvsb`` runs the hand-written CUDA kernel ``csrc/bvsb.cu`` on a CUDA
tensor and ``bvsb_plain`` on a CPU tensor; on any other device it
raises. ``bvsb_plain`` is the plain PyTorch version the CPU tests hold to
the JAX package and ``chip_smoke.py`` holds the kernel to on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# kernel launches since the last ops.reset_launch_counts()
launches = 0


def bvsb_plain(logits: torch.Tensor):
    """(B, V) logits -> (bvsb (B,) f32, top1 (B,) int32), float32 softmax.

    Top-1 is ``torch.argmax`` (first index on ties); the runner-up is the
    max over the row with that one column masked, so a duplicated
    maximum gives a margin of exactly 0. The softmax is written out
    (exp(x - max) / sum): the CPU's fused ``torch.softmax`` kernel is off
    by ~1e-6 at p ~ 1, more than the JAX reference.
    """
    x = logits.float()
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    top1 = torch.argmax(p, dim=-1)
    p1 = p.gather(-1, top1[:, None])[:, 0]
    p2 = p.scatter(-1, top1[:, None], float("-inf")).amax(dim=-1)
    return p1 - p2, top1.to(torch.int32)


def bvsb(logits: torch.Tensor):
    """(B, V) logits -> (bvsb (B,) f32, top1 (B,) int32).

    CPU tensor: ``bvsb_plain``. CUDA tensor (f32 or bf16, unit column
    stride, any row stride): the CUDA kernel, on the current stream.
    """
    global launches
    if logits.device.type == "cpu":
        return bvsb_plain(logits)
    if logits.device.type != "cuda":
        raise ValueError(f"bvsb: no kernel for device {logits.device}")
    if logits.dim() != 2:
        raise ValueError(f"bvsb: logits must be (B, V), got {tuple(logits.shape)}")
    if logits.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"bvsb: unsupported dtype {logits.dtype}")
    b, v = logits.shape
    if b == 0 or v == 0 or v >= 2 ** 31 or b >= 2 ** 31:
        raise ValueError(f"bvsb: unsupported shape {tuple(logits.shape)}")
    if logits.stride(1) != 1:
        raise ValueError("bvsb: logits need a unit column stride")
    conf = torch.empty(b, dtype=torch.float32, device=logits.device)
    top1 = torch.empty(b, dtype=torch.int32, device=logits.device)
    lib = _build.library()
    _build.check(lib.repro_bvsb(
        logits.data_ptr(), _build.DTYPE_CODES[logits.dtype], b,
        logits.stride(0), v, conf.data_ptr(), top1.data_ptr(),
        _build.stream_ptr(logits)), "bvsb")
    launches += 1
    return conf, top1
