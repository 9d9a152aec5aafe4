"""BvSB (Best-versus-Second-Best) confidence + top-1 — paper Eq. 2.

    BvSB = P1 - P2 = (1 - exp(m2 - m1)) / sum_j exp(l_j - m1)

``bvsb`` runs the hand-written CUDA kernel ``csrc/bvsb.cu`` on a CUDA
tensor and ``bvsb_plain`` on a CPU tensor; on any other device it
raises. ``bvsb_plain`` is the plain PyTorch version the CPU tests hold to
the JAX package and ``chip_smoke.py`` holds the kernel to on the card.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from repro_torch.kernels import _build

BLOCKS_PER_SM = 4   # chunk blocks the plan aims at on each SM
MIN_CHUNK = 4096    # columns a chunk block folds at least
MIN_CHUNKS = 4      # rows too short for this many chunks stay one block
VEC = 8             # chunk widths in 16-byte vectors of bf16 (2 of f32)

# kernel launches since the last ops.reset_launch_counts(); incremented
# under the lock, since worker threads launch too
launches = 0
COUNT_LOCK = threading.Lock()


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


def chunks(b: int, v: int, sms: int):
    """(number of chunks, columns per chunk) that each row of (B, V) logits
    is cut into, one kernel block a chunk. A row under MIN_CHUNKS *
    MIN_CHUNK columns stays one block, which writes the result itself: the
    merge launch costs more than the cut saves there (chip_smoke.py's
    chunk sweep). A longer row is cut into chunks of at least MIN_CHUNK
    columns, as many as give BLOCKS_PER_SM blocks on each of ``sms`` SMs:
    at most max(1, ceil(BLOCKS_PER_SM * sms / b)). Widths are whole
    16-byte vectors of either dtype; no chunk is empty."""
    n = v // MIN_CHUNK
    if n < MIN_CHUNKS:
        return _cut(v, 1)
    return _cut(v, min(n, -(-BLOCKS_PER_SM * sms // b)))


def _cut(v: int, n: int):
    """A row of v columns cut into about n chunks of whole vectors."""
    per = VEC * -(-v // (n * VEC))
    return -(-v // per), per


def _check(logits):
    if logits.dim() != 2:
        raise ValueError(f"bvsb: logits must be (B, V), got {tuple(logits.shape)}")
    if logits.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"bvsb: unsupported dtype {logits.dtype}")
    b, v = logits.shape
    if b == 0 or v == 0 or v >= 2 ** 31 or b >= 2 ** 31:
        raise ValueError(f"bvsb: unsupported shape {tuple(logits.shape)}")
    if logits.stride(1) != 1:
        raise ValueError("bvsb: logits need a unit column stride")


def run_entry(logits: torch.Tensor, n_chunks: Optional[int] = None):
    """Check a CUDA tensor and run the kernel on it, cut into the planned
    chunks (``chunks``) or, for measuring, into about ``n_chunks``. Counts
    nothing: ``bvsb`` is the counted launch."""
    _check(logits)
    b, v = logits.shape
    n, per = chunks(b, v, _build.sm_count(logits.device)) \
        if n_chunks is None else _cut(v, n_chunks)
    conf = torch.empty(b, dtype=torch.float32, device=logits.device)
    top1 = torch.empty(b, dtype=torch.int32, device=logits.device)
    # one (m1, m2, z, idx) tuple of 16 bytes per (row, chunk)
    part = torch.empty(b * n * 4, dtype=torch.float32,
                       device=logits.device) if n > 1 else None
    _build.check(_build.library().repro_bvsb(
        logits.data_ptr(), _build.DTYPE_CODES[logits.dtype], b,
        logits.stride(0), v, n, per, 0 if part is None else part.data_ptr(),
        conf.data_ptr(), top1.data_ptr(), _build.stream_ptr(logits)), "bvsb")
    return conf, top1


def bvsb(logits: torch.Tensor):
    """(B, V) logits -> (bvsb (B,) f32, top1 (B,) int32).

    CPU tensor: ``bvsb_plain``. CUDA tensor (f32 or bf16, unit column
    stride, any row stride): the CUDA kernel, on the current stream. The
    kernel has no backward: a CUDA call that autograd would record raises.
    """
    global launches
    if logits.device.type == "cpu":
        return bvsb_plain(logits)
    if logits.device.type != "cuda":
        raise ValueError(f"bvsb: no kernel for device {logits.device}")
    _build.refuse_grad("bvsb", logits)
    out = run_entry(logits)
    with COUNT_LOCK:
        launches += 1
    return out
