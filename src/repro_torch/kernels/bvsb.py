"""BvSB (Best-versus-Second-Best) confidence + top-1 — paper Eq. 2.

    BvSB = P1 - P2 = (1 - exp(m2 - m1)) / sum_j exp(l_j - m1)

``bvsb`` runs the hand-written CUDA kernel ``csrc/bvsb.cu`` on a CUDA
tensor and ``bvsb_plain`` on a CPU tensor; on any other device it
raises. ``bvsb_plain`` is the plain PyTorch version the CPU tests hold to
the JAX package and ``chip_smoke.py`` holds the kernel to on the card.

Over a vocabulary cut across the model ranks (``launch.distributed.
vocab_parallel_bvsb``), ``bvsb_partials`` folds a rank's columns into one
(m1, m2, z, global top-1 index) tuple a row and ``bvsb_merge`` merges the
ranks' tuples, in rank order, into BvSB and top-1: the same two kernels
(chunk and merge), with the one-device semantics (first index on ties, a
maximum duplicated across ranks gives margin 0). ``bvsb_partials_plain``
and ``bvsb_merge_plain`` are their plain versions.

On ``meta`` tensors (the dry-run, ``launch/dryrun.py``) each wrapper
checks its inputs as for the card, launches nothing, counts no launch,
returns outputs of the kernel's shapes and dtypes and books the kernel's
work (``roofline.analysis.record``).
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.roofline import analysis as ra

BLOCKS_PER_SM = 4   # chunk blocks the plan aims at on each SM
MIN_CHUNK = 4096    # columns a chunk block folds at least
MIN_CHUNKS = 4      # rows too short for this many chunks stay one block
VEC = 8             # chunk widths in 16-byte vectors of bf16 (2 of f32)

# kernel launches since the last ops.reset_launch_counts(); incremented
# under the lock, since worker threads launch too
launches = 0
partials_launches = 0
merge_launches = 0
COUNT_LOCK = threading.Lock()
# a tuple's index is a float: exact below 2^24 (the largest head, 256,256)
MAX_INDEX = 1 << 24


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


def _fold_plain(x: torch.Tensor):
    """(m1, m2, z, idx) of each row of f32 ``x`` as the kernel folds it:
    the max, the runner-up with that one column masked (a duplicated
    maximum gives m2 = m1), sum exp(x - m1) (0 where m1 is -inf), the
    first index of the max."""
    m1 = x.amax(dim=-1)
    idx = torch.argmax(x, dim=-1)
    m2 = x.scatter(-1, idx[:, None], float("-inf")).amax(dim=-1)
    live = m1 != float("-inf")
    z = torch.exp(x - torch.where(live, m1, 0.0)[:, None]).sum(dim=-1)
    return m1, m2, torch.where(live, z, 0.0), idx


def bvsb_partials_plain(logits: torch.Tensor, col_offset: int = 0):
    """(B, V) logits, columns [col_offset, col_offset + V) of a wider row ->
    (B, 4) f32 tuples (m1, m2, z, col_offset + top-1 index)."""
    m1, m2, z, idx = _fold_plain(logits.float())
    return torch.stack([m1, m2, z, (idx + col_offset).float()], dim=-1)


def _merge_tuples_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's merge of two (..., 4) tuple sets: the larger m1 and its
    index (the smaller index on equal m1), m2 the largest of both m2 and
    the smaller m1, z rescaled to the new m1 (a side at m1 = -inf adding
    0)."""
    m1 = torch.maximum(a[..., 0], b[..., 0])
    m2 = torch.maximum(torch.maximum(a[..., 1], b[..., 1]),
                       torch.minimum(a[..., 0], b[..., 0]))

    def scaled(t):
        dead = t[..., 0] == float("-inf")
        return torch.where(dead, 0.0, t[..., 2] * torch.exp(
            torch.where(dead, 0.0, t[..., 0] - m1)))
    idx = torch.where(a[..., 0] > b[..., 0], a[..., 3], torch.where(
        b[..., 0] > a[..., 0], b[..., 3], torch.minimum(a[..., 3], b[..., 3])))
    return torch.stack([m1, m2, scaled(a) + scaled(b), idx], dim=-1)


def bvsb_merge_plain(parts: torch.Tensor):
    """(B, n, 4) tuples, a row's n shards in index order -> (bvsb (B,) f32,
    top1 (B,) int32): the tuples merged one after another."""
    s = parts[:, 0].float()
    for j in range(1, parts.shape[1]):
        s = _merge_tuples_plain(s, parts[:, j].float())
    conf = (1.0 - torch.exp(s[:, 1] - s[:, 0])) / s[:, 2]
    return conf, s[:, 3].to(torch.int32)


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


def run_partials_entry(logits: torch.Tensor, col_offset: int,
                       n_chunks: Optional[int] = None):
    """``bvsb_partials``'s launch on a CUDA tensor, uncounted: the
    planned chunks (``chunks``) or, for measuring, about ``n_chunks``."""
    _check(logits)
    b, v = logits.shape
    _check_offset(col_offset, v)
    n, per = chunks(b, v, _build.sm_count(logits.device)) \
        if n_chunks is None else _cut(v, n_chunks)
    tuples = torch.empty(b, 4, dtype=torch.float32, device=logits.device)
    part = torch.empty(b * n * 4, dtype=torch.float32,
                       device=logits.device) if n > 1 else None
    _build.check(_build.library().repro_bvsb_partials(
        logits.data_ptr(), _build.DTYPE_CODES[logits.dtype], b,
        logits.stride(0), v, n, per, 0 if part is None else part.data_ptr(),
        tuples.data_ptr(), col_offset, _build.stream_ptr(logits)),
        "bvsb_partials")
    return tuples


def run_merge_entry(parts: torch.Tensor):
    """``bvsb_merge``'s launch on a CUDA tensor, uncounted."""
    _check_parts(parts)
    parts = parts.contiguous()
    if parts.data_ptr() % 16:
        parts = parts.clone()
    b, n, _ = parts.shape
    conf = torch.empty(b, dtype=torch.float32, device=parts.device)
    top1 = torch.empty(b, dtype=torch.int32, device=parts.device)
    _build.check(_build.library().repro_bvsb_merge(
        parts.data_ptr(), b, n, conf.data_ptr(), top1.data_ptr(),
        _build.stream_ptr(parts)), "bvsb_merge")
    return conf, top1


def _meta_conf_top1(b: int):
    return (torch.empty(b, dtype=torch.float32, device="meta"),
            torch.empty(b, dtype=torch.int32, device="meta"))


def _check_offset(col_offset: int, v: int):
    if col_offset < 0 or col_offset + v > MAX_INDEX:
        raise ValueError(f"bvsb_partials: columns [{col_offset}, "
                         f"{col_offset + v}) pass 2^24, where a float index "
                         f"stops being exact")


def _check_parts(parts):
    if parts.dim() != 3 or parts.shape[-1] != 4 or \
            parts.dtype != torch.float32 or 0 in parts.shape[:2]:
        raise ValueError(f"bvsb_merge: parts must be (B, n, 4) float32, got "
                         f"{tuple(parts.shape)} {parts.dtype}")


def bvsb_partials(logits: torch.Tensor, col_offset: int = 0):
    """(B, V) logits, a rank's columns [col_offset, col_offset + V) of the
    vocabulary -> (B, 4) f32 tuples (m1, m2, z, global top-1 index).

    CPU tensor: ``bvsb_partials_plain``. CUDA tensor (f32 or bf16, unit
    column stride): the chunk kernel (and the merge kernel where a row
    takes several chunks), on the current stream, counted once a call. No
    backward: a CUDA call autograd would record raises."""
    global partials_launches
    kind = _build.device_kind("bvsb_partials", logits)
    if kind == "cpu":
        return bvsb_partials_plain(logits, col_offset)
    _build.refuse_grad("bvsb_partials", logits)
    if kind == "meta":
        _check(logits)
        b, v = logits.shape
        _check_offset(col_offset, v)
        ra.record("bvsb_partials",
                  ra.bvsb_partials_work(b, v, logits.element_size()))
        return torch.empty(b, 4, dtype=torch.float32, device="meta")
    out = run_partials_entry(logits, col_offset)
    with COUNT_LOCK:
        partials_launches += 1
    return out


def bvsb_merge(parts: torch.Tensor):
    """(B, n, 4) tuples, each row's n shards in index order -> (bvsb (B,)
    f32, top1 (B,) int32). CPU tensor: ``bvsb_merge_plain``; CUDA tensor:
    the merge kernel, a warp a row, counted."""
    global merge_launches
    kind = _build.device_kind("bvsb_merge", parts)
    if kind == "cpu":
        return bvsb_merge_plain(parts)
    _build.refuse_grad("bvsb_merge", parts)
    if kind == "meta":
        _check_parts(parts)
        ra.record("bvsb_merge", ra.bvsb_merge_work(*parts.shape[:2]))
        return _meta_conf_top1(parts.shape[0])
    out = run_merge_entry(parts)
    with COUNT_LOCK:
        merge_launches += 1
    return out


def bvsb(logits: torch.Tensor):
    """(B, V) logits -> (bvsb (B,) f32, top1 (B,) int32).

    CPU tensor: ``bvsb_plain``. CUDA tensor (f32 or bf16, unit column
    stride, any row stride): the CUDA kernel, on the current stream. The
    kernel has no backward: a CUDA call that autograd would record raises.
    """
    global launches
    kind = _build.device_kind("bvsb", logits)
    if kind == "cpu":
        return bvsb_plain(logits)
    _build.refuse_grad("bvsb", logits)
    if kind == "meta":
        _check(logits)
        ra.record("bvsb", ra.bvsb_work(*logits.shape, logits.element_size()))
        return _meta_conf_top1(logits.shape[0])
    out = run_entry(logits)
    with COUNT_LOCK:
        launches += 1
    return out
