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
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256  # csrc/flash_attention.cu kMaxHD

# kernel launches since the last ops.reset_launch_counts(); incremented
# under the lock, since worker threads launch too
launches = 0
COUNT_LOCK = threading.Lock()


def _check_lengths(s: int, t: int, causal: bool):
    if causal and t != s:
        raise ValueError(f"flash_attention: causal attention of {s} queries "
                         f"over {t} keys; causal needs as many keys as "
                         "queries")


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None):
    """The masked-einsum form, float32 softmax (JAX ``flash_attention_ref``
    at T = S, JAX ``dense_attention`` at T != S)."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    _check_lengths(s, t, causal)
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, hd).float()
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float())
    scores = scores * float(np.float32(1.0 / np.sqrt(hd)))
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    ok = kpos <= qpos if causal else torch.ones(s, t, dtype=torch.bool,
                                                device=q.device)
    if window is not None:
        ok = ok & ((qpos - kpos) < window)
    scores = scores.masked_fill(~ok, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def uses_tensor_cores(s: int, hd: int, t: Optional[int] = None) -> bool:
    """Whether the C entry point runs the tensor-core kernel at ``s``
    queries over ``t`` keys (default ``s``) of head dim ``hd`` (else the
    CUDA-core FMA kernel), as the kernel library decides it; needs the
    library."""
    return bool(_build.library().repro_flash_uses_tensor_cores(
        s, s if t is None else t, hd))


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
              window: Optional[int] = None, extra=()):
    """Check CUDA tensors and run the C entry point ``entry`` of the kernel
    library on them (``extra``: its arguments after the stream); the new
    output. Counts nothing: ``flash_attention`` is the counted launch."""
    _check(q, k, v, causal)
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    b, s, h, hd = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _build.check(entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[q.dtype], b, s, k.shape[1], h, k.shape[2], hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        int(causal), 0 if window is None else int(window),
        float(np.float32(1.0 / np.sqrt(hd))), _build.stream_ptr(q), *extra),
        "flash_attention")
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """Attention of q over k/v; CUDA kernel on CUDA tensors, plain on CPU.
    The C entry point picks the kernel from the shape
    (``uses_tensor_cores``). ``causal`` with k/v of another length than q
    raises ValueError."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    out = run_entry(_build.library().repro_flash_attention, q, k, v,
                    causal=causal, window=window)
    with COUNT_LOCK:
        launches += 1
    return out
