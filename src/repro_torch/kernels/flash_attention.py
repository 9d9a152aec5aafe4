"""Causal / sliding-window prefill attention with GQA, and non-causal
attention over keys of another length (an encoder-decoder's
cross-attention).

q: (B, S, H, hd); k/v: (B, T, KV, hd) -> (B, S, H, hd) in q's dtype, the
KV head of query head h being h // (H // KV); causal attention needs T =
S. ``flash_attention`` runs the hand-written CUDA kernels of
``csrc/flash_attention.cu`` on CUDA tensors (``uses_tensor_cores`` says
which: tensor cores for long sequences, CUDA-core FMAs for short ones)
and ``flash_attention_plain`` on CPU tensors; on any other device it
raises.

Under autograd a CUDA call goes through ``FlashAttentionFn``: the forward
kernel also writes each row's log-sum-exp, and the backward runs the
hand-written kernels of ``csrc/flash_attention_bwd.cu`` (FA2: D =
rowsum(dO o O), then dK/dV a key tile a block, then dQ a query tile a
block, no atomics; ``uses_tensor_cores_bwd`` says whether on tensor cores
or CUDA-core FMAs, and ``bwd_splits`` how many blocks share a key tile's
query rows). ``flash_attention_bwd_plain`` is the same arithmetic in
PyTorch; on the CPU autograd differentiates ``flash_attention_plain``.

``soft_cap`` c (None or 0: none) replaces each scaled score s by c tanh(s /
c) before the mask, as the JAX package's attention does under
``cfg.logit_soft_cap``; the kernels take it as a runtime float behind a
compile-time flag, and the backward takes the cap's derivative.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.roofline import analysis as ra

NEG_INF = -1e30
MAX_HEAD_DIM = 256  # csrc/flash_attention.cu kMaxHD
# the tensor-core backward (csrc/flash_attention_bwd.cu namespace tensor):
# keys a dK/dV block (kM)
BWD_KEYS = 64
MAX_BWD_SPLITS = 16
BWD_WAVES = 12         # dK/dV blocks wanted per SM before splitting stops
MIN_SPLIT_TILES = 16   # streamed row tiles a split walks, at least
# min(S, T) from which the C entry points pick the tensor-core kernels, at
# hd <= 128 and above (csrc/flash_attention.cu and flash_attention_bwd.cu
# kTensorCoreMinSeq, kTensorCoreMinSeqWide)
TC_MIN_SEQ = (48, 80)
TC_MIN_SEQ_BWD = (40, 16)


def bwd_rows(hd: int) -> int:
    """Packed query rows a streamed tile of the tensor-core dK/dV kernel
    (n_tile): 64 at hd <= 128, 32 above."""
    return 64 if hd <= 128 else 32

# kernel launches since the last ops.reset_launch_counts(), forward and
# backward; incremented under the lock, since worker threads launch too
launches = 0
bwd_launches = 0
COUNT_LOCK = threading.Lock()


def _check_lengths(s: int, t: int, causal: bool):
    if causal and t != s:
        raise ValueError(f"flash_attention: causal attention of {s} queries "
                         f"over {t} keys; causal needs as many keys as "
                         "queries")


def _scale(hd: int) -> float:
    return float(np.float32(1.0 / np.sqrt(hd)))


def cap_operand(soft_cap) -> float:
    """The kernels' cap operand: 0 for no cap (None or 0, as the JAX
    package's ``if soft_cap:``)."""
    if not soft_cap:
        return 0.0
    if not soft_cap > 0:
        raise ValueError(f"soft cap {soft_cap} must be positive")
    return float(soft_cap)


def _masked_scores(q, k, causal, window, soft_cap=None):
    """(scaled scores (B, KV, G, S, T) f32, soft-capped where ``soft_cap``
    is set, with masked entries at NEG_INF; the mask (S, T); tanh(s / c) of
    the scaled scores s under a cap c, else None)."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    _check_lengths(s, t, causal)
    qg = q.reshape(b, s, kvh, h // kvh, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * _scale(hd)
    th = None
    if soft_cap:
        th = torch.tanh(scores / soft_cap)
        scores = th * soft_cap
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    ok = kpos <= qpos if causal else torch.ones(s, t, dtype=torch.bool,
                                                device=q.device)
    if window is not None:
        ok = ok & ((qpos - kpos) < window)
    return scores.masked_fill(~ok, NEG_INF), ok, th


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None, soft_cap=None):
    """The masked-einsum form, float32 softmax (JAX ``flash_attention_ref``
    at T = S, JAX ``dense_attention`` at T != S and with a soft cap)."""
    b, s, h, hd = q.shape
    scores, _, _ = _masked_scores(q, k, causal, window, soft_cap)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def attention_lse_plain(q, k, *, causal: bool = True,
                        window: Optional[int] = None, soft_cap=None):
    """Each row's log-sum-exp of the scaled (soft-capped), masked scores,
    (B, H, S) f32: what the forward kernel writes for the backward."""
    b, s, h, _ = q.shape
    scores, _, _ = _masked_scores(q, k, causal, window, soft_cap)
    return torch.logsumexp(scores, dim=-1).reshape(b, h, s)


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: Optional[int] = None, soft_cap=None):
    """(dq, dk, dv) in the inputs' type from the forward's output ``o`` and
    row log-sum-exp ``lse`` (B, H, S) and the output gradient ``do``, by
    the FA2 formulas in f32: P = exp(s - lse), D = rowsum(dO o O), dS = P o
    (dO V^T - D), dV = P^T dO, dK = dS^T Q scale, dQ = dS K scale. Under a
    soft cap c, s is the capped score and dS takes the cap's derivative, P
    o (dO V^T - D) o (1 - t^2) with t = tanh(s_scaled / c)."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scores, ok, th = _masked_scores(q, k, causal, window, soft_cap)
    p = torch.exp(scores - lse.reshape(b, kvh, g, s)[..., None]) * ok
    do_g = do.reshape(b, s, kvh, g, hd).float()
    d = (do_g * o.reshape(b, s, kvh, g, hd).float()).sum(-1)   # (B,S,KV,G)
    dp = torch.einsum("bskgh,btkh->bkgst", do_g, v.float())
    ds = p * (dp - d.permute(0, 2, 3, 1)[..., None])
    if th is not None:
        ds = ds * (1 - th * th)
    dv = torch.einsum("bkgst,bskgh->btkh", p, do_g)
    dk = torch.einsum("bkgst,bskgh->btkh", ds,
                      q.reshape(b, s, kvh, g, hd).float()) * _scale(hd)
    dq = torch.einsum("bkgst,btkh->bskgh", ds, k.float()) * _scale(hd)
    return (dq.reshape(b, s, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def uses_tensor_cores(s: int, hd: int, t: Optional[int] = None) -> bool:
    """Whether the C entry point runs the tensor-core kernel at ``s``
    queries over ``t`` keys (default ``s``) of head dim ``hd`` (else the
    CUDA-core FMA kernel), as the kernel library decides it; needs the
    library."""
    return bool(_build.library().repro_flash_uses_tensor_cores(
        s, s if t is None else t, hd))


def uses_tensor_cores_bwd(s: int, hd: int, t: Optional[int] = None) -> bool:
    """Whether the backward's C entry point runs the tensor-core kernels
    at ``s`` queries over ``t`` keys (default ``s``) of head dim ``hd``
    (else the CUDA-core FMA kernels); needs the library."""
    return bool(_build.library().repro_flash_bwd_uses_tensor_cores(
        s, s if t is None else t, hd))


def tensor_core_rule(s: int, hd: int, t: Optional[int] = None,
                     backward: bool = False) -> bool:
    """The C entry points' choice without the library: the tensor-core
    kernels from min(S, T) = TC_MIN_SEQ (TC_MIN_SEQ_BWD for the backward)
    up, the first value at hd <= 128, the second above. ``chip_smoke.py``
    holds it to ``uses_tensor_cores`` / ``uses_tensor_cores_bwd``."""
    first, wide = TC_MIN_SEQ_BWD if backward else TC_MIN_SEQ
    return min(s, s if t is None else t) >= (first if hd <= 128 else wide)


def bwd_splits(b: int, s: int, t: int, h: int, kv: int, hd: int,
               window: Optional[int], sms: int) -> int:
    """Blocks of the tensor-core dK/dV kernel that share one key tile's
    query rows, each summing its share into an f32 partial that a second
    pass adds in split order. One while the b * kv key-tile columns give
    BWD_WAVES blocks an SM; else as many as reach that, at most
    MAX_BWD_SPLITS, each walking at least MIN_SPLIT_TILES row tiles of
    the rows a key tile sees (a window's span of positions, G rows each)."""
    blocks = -(-t // BWD_KEYS) * kv * b
    want = -(-BWD_WAVES * sms // blocks)
    span = s if window is None else min(s, window + BWD_KEYS - 1)
    tiles = -(-span * (h // kv) // bwd_rows(hd))
    return max(1, min(MAX_BWD_SPLITS, want, tiles // MIN_SPLIT_TILES))


def _check(q, k, v, causal):
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, s, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    _check_lengths(s, k.shape[1], causal)
    kvh = k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: {h} heads over {kvh} KV heads")
    if not (0 < hd <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"[1, {MAX_HEAD_DIM}]")
    if b == 0 or s == 0 or k.shape[1] == 0 or b > 65535 or h > 65535:
        raise ValueError(f"flash_attention: unsupported shape {tuple(q.shape)}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} needs a contiguous "
                             "head dim")


def run_entry(entry, q, k, v, *, causal: bool = True,
              window: Optional[int] = None, soft_cap=None, extra=(),
              with_lse: bool = False):
    """Check CUDA tensors and run the C entry point ``entry`` of the kernel
    library on them (``extra``: its arguments after the stream); the new
    output, and with ``with_lse`` also each row's log-sum-exp (B, H, S)
    f32. Counts nothing: ``flash_attention`` is the counted launch."""
    _check(q, k, v, causal)
    cap = cap_operand(soft_cap)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    b, s, h, hd = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device) \
        if with_lse else None
    _build.check(entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[q.dtype], b, s, k.shape[1], h, k.shape[2], hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), 0 if window is None else int(window), _scale(hd), cap,
        0 if lse is None else lse.data_ptr(), _build.stream_ptr(q), *extra),
        "flash_attention")
    return (out, lse) if with_lse else out


def run_bwd_entry(q, k, v, o, lse, do, *, causal: bool = True,
                  window: Optional[int] = None, soft_cap=None, kernel: int = 0,
                  splits: Optional[int] = None):
    """Check CUDA tensors and run the backward kernels on them: (dq, dk,
    dv), contiguous, in q's type. ``o`` and ``lse`` are the forward's
    output and row log-sum-exp (under the same ``soft_cap``). ``kernel`` 0 lets the entry point pick
    from the shape (``uses_tensor_cores_bwd``), 1 forces the FMA kernels
    and 2 the tensor-core ones; ``splits`` (tensor cores only) defaults to
    ``bwd_splits``. Counts nothing: ``FlashAttentionFn`` is the counted
    launch."""
    _check(q, k, v, causal)
    cap = cap_operand(soft_cap)
    if kernel not in (0, 1, 2):
        raise ValueError(f"flash_attention backward: kernel {kernel}")
    b, s, h, hd = q.shape
    if do.shape != q.shape or o.shape != q.shape or do.dtype != q.dtype \
            or o.dtype != q.dtype or do.stride(3) != 1 or o.stride(3) != 1:
        raise ValueError(f"flash_attention backward: o {tuple(o.shape)} "
                         f"{o.dtype}, do {tuple(do.shape)} {do.dtype} against "
                         f"q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"flash_attention backward: lse {tuple(lse.shape)} "
                         f"{lse.dtype}, needs contiguous f32 {(b, h, s)}")
    t, kvh = k.shape[1], k.shape[2]
    tensor_cores = kernel == 2 or (kernel == 0
                                   and uses_tensor_cores_bwd(s, hd, t))
    if splits is None:
        splits = bwd_splits(b, s, t, h, kvh, hd, window,
                            _build.sm_count(q.device)) if tensor_cores else 1
    if splits < 1 or (splits > 1 and not tensor_cores) \
            or b * splits > 65535:
        raise ValueError(f"flash_attention backward: {splits} splits")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    delta = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    part = torch.empty(2 * splits * k.numel(), dtype=torch.float32,
                       device=q.device) if splits > 1 else None
    lib = _build.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _build.DTYPE_CODES[q.dtype], b, s,
            t, h, kvh, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], *do.stride()[:3], int(causal),
            0 if window is None else int(window), _scale(hd), cap,
            _build.stream_ptr(q), splits,
            0 if part is None else part.data_ptr())
    _build.check(lib.repro_flash_attention_bwd(*args) if kernel == 0 else
                 lib.repro_flash_attention_bwd_kernel(*args, kernel),
                 "flash_attention backward")
    return dq, dk, dv


def _meta_work(q, k, causal, window, backward=False):
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    work = ra.flash_bwd_work if backward else ra.flash_work
    return work(b, s, t, h, kvh, hd, q.element_size(), causal=causal,
                window=window,
                tensor_cores=tensor_core_rule(s, hd, t, backward))


def meta_entry(q, k, v, *, causal: bool = True,
               window: Optional[int] = None, soft_cap=None,
               with_lse: bool = False):
    """``run_entry`` on ``meta`` tensors: the same checks, no launch, the
    forward's work booked; (out, and with ``with_lse`` the lse)."""
    _check(q, k, v, causal)
    cap_operand(soft_cap)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    ra.record("flash_attention", _meta_work(q, k, causal, window))
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if not with_lse:
        return out
    b, s, h, _ = q.shape
    return out, torch.empty(b, h, s, dtype=torch.float32, device="meta")


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention on the card with its hand-written backward: the
    forward kernel keeps each row's log-sum-exp, and the backward
    recomputes P from it (no (S, T) matrix is saved). Each direction
    counts one launch."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, soft_cap):
        global launches
        if q.device.type == "meta":
            out, lse = meta_entry(q, k, v, causal=causal, window=window,
                                  soft_cap=soft_cap, with_lse=True)
        else:
            out, lse = run_entry(_build.library().repro_flash_attention, q, k,
                                 v, causal=causal, window=window,
                                 soft_cap=soft_cap, with_lse=True)
            with COUNT_LOCK:
                launches += 1
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.soft_cap = causal, window, soft_cap
        return out

    @staticmethod
    def backward(ctx, do):
        global bwd_launches
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "meta":
            ra.record("flash_attention_bwd",
                      _meta_work(q, k, ctx.causal, ctx.window, backward=True))
            return (torch.empty(q.shape, dtype=q.dtype, device="meta"),
                    torch.empty(k.shape, dtype=k.dtype, device="meta"),
                    torch.empty(v.shape, dtype=v.dtype, device="meta"),
                    None, None, None)
        if do.stride(3) != 1:
            do = do.contiguous()
        dq, dk, dv = run_bwd_entry(q, k, v, out, lse, do, causal=ctx.causal,
                                   window=ctx.window, soft_cap=ctx.soft_cap)
        with COUNT_LOCK:
            bwd_launches += 1
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, soft_cap=None):
    """Attention of q over k/v; CUDA kernel on CUDA tensors, plain on CPU.
    The C entry point picks the kernel from the shape
    (``uses_tensor_cores``). A CUDA call that autograd records goes
    through ``FlashAttentionFn`` (forward and backward kernels).
    ``causal`` with k/v of another length than q raises ValueError;
    ``soft_cap`` c caps the scaled scores at c tanh(s / c)."""
    global launches
    kind = _build.device_kind("flash_attention", q)
    if kind == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     soft_cap=soft_cap)
    if _build.wants_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, soft_cap)
    if kind == "meta":
        return meta_entry(q, k, v, causal=causal, window=window,
                          soft_cap=soft_cap)
    out = run_entry(_build.library().repro_flash_attention, q, k, v,
                    causal=causal, window=window, soft_cap=soft_cap)
    with COUNT_LOCK:
        launches += 1
    return out
