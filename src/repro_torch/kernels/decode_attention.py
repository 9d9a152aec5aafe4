"""Single-token decode attention with GQA over a (ring) KV cache.

q: (B, H, hd); k/v caches: (B, W, KV, hd); lengths: (B,) int, the number
of valid slots: slots [0, length) of each request are attended, the rest
are masked. Returns (B, H, hd) in q's dtype; the KV head of query head h
is h // (H // KV). The dtypes are all float32, all bfloat16, or a float32
q over bfloat16 caches (the JAX package's default cache under a float32
model), which computes in float32 as JAX does. ``decode_attention`` runs
the hand-written CUDA kernel ``csrc/decode_attention.cu`` on CUDA tensors
and ``decode_attention_plain`` on CPU tensors; on any other device it
raises.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_HEAD_DIM = 256   # csrc/decode_attention.cu kMaxHD
MAX_GROUP = 16       # csrc/decode_attention.cu kMaxG: query heads per KV head
MAX_SPLITS = 256     # csrc/decode_attention.cu kMaxSplits
TILE = 16            # csrc/decode_attention.cu kTile: keys per ring slot
BLOCKS_PER_SM = 1    # partial-kernel blocks the plan gives each SM

# kernel launches since the last ops.reset_launch_counts()
launches = 0

# (q dtype, cache dtype) pairs the kernel takes
DTYPE_PAIRS = ((torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16))


def decode_attention_plain(q, k_cache, v_cache, lengths):
    """The masked-einsum form, float32 softmax (JAX ``decode_attention_ref``)."""
    b, w, kvh, hd = k_cache.shape
    h = q.shape[1]
    qg = q.reshape(b, kvh, h // kvh, hd).float()
    scores = torch.einsum("bkgh,bwkh->bkgw", qg, k_cache.float())
    scores = scores * float(np.float32(1.0 / np.sqrt(hd)))
    valid = torch.arange(w, device=q.device)[None, :] \
        < lengths.to(q.device)[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgw,bwkh->bkgh", p, v_cache.float())
    return out.reshape(b, h, hd).to(q.dtype)


def _check(q, k, v, lengths):
    if not (q.device == k.device == v.device == lengths.device):
        raise ValueError("decode_attention: q, caches and lengths on "
                         "different devices")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    b, h, hd = q.shape
    _, w, kvh, _ = k.shape
    if k.shape[0] != b or k.shape[3] != hd or lengths.shape != (b,):
        raise ValueError(f"decode_attention: caches {tuple(k.shape)} or "
                         f"lengths {tuple(lengths.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if kvh == 0 or h % kvh or h // kvh > MAX_GROUP:
        raise ValueError(f"decode_attention: {h} heads over {kvh} KV heads "
                         f"(at most {MAX_GROUP} per KV head)")
    if not (0 < hd <= MAX_HEAD_DIM):
        raise ValueError(f"decode_attention: head dim {hd} not in "
                         f"[1, {MAX_HEAD_DIM}]")
    if b == 0 or w == 0 or b > 65535 or kvh > 65535 or w >= 2 ** 31:
        raise ValueError(f"decode_attention: unsupported shape "
                         f"{tuple(k.shape)}")
    if (q.dtype, k.dtype) not in DTYPE_PAIRS or v.dtype != k.dtype:
        raise TypeError(f"decode_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if lengths.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"decode_attention: lengths dtype {lengths.dtype}")
    for name, t in (("q", q), ("k_cache", k), ("v_cache", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"decode_attention: {name} needs a contiguous "
                             "head dim")


def splits(b: int, kvh: int, w: int, sms: int):
    """(number of splits, keys per split) of the window: whole TILE-key
    tiles per split, as many splits as keep the b * kvh * splits blocks
    within one wave of BLOCKS_PER_SM on each of ``sms`` SMs, no more
    splits than tiles or MAX_SPLITS, none empty."""
    return _cut(w, max(1, min(-(-w // TILE), BLOCKS_PER_SM * sms // (b * kvh),
                              MAX_SPLITS)))


def _cut(w: int, n: int):
    """A window of w slots cut into about n splits of whole tiles."""
    chunk = TILE * -(-w // (n * TILE))
    return -(-w // chunk), chunk


def run_entry(q, k_cache, v_cache, lengths, n_splits: Optional[int] = None):
    """Check CUDA tensors and run the kernel on them with the planned
    splits (``splits``) or, for measuring, about ``n_splits`` splits of
    whole tiles. Counts nothing: ``decode_attention`` is the counted
    launch."""
    _check(q, k_cache, v_cache, lengths)
    b, h, hd = q.shape
    _, w, kvh, _ = k_cache.shape
    g = h // kvh
    ns, chunk = splits(b, kvh, w, _build.sm_count(q.device)) \
        if n_splits is None else _cut(w, n_splits)
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty(b, h, hd, dtype=q.dtype, device=q.device)
    # one scratch buffer: running max, running sum, then the unnormalised
    # output of every (request, KV head, split, query head of the group)
    rows = b * kvh * ns * g
    scratch = torch.empty(rows * (2 + hd), dtype=torch.float32,
                          device=q.device)
    _build.check(_build.library().repro_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODES[q.dtype], _build.DTYPE_CODES[k_cache.dtype],
        b, w, h, kvh, hd, ns, chunk,
        q.stride(0), q.stride(1), *k_cache.stride()[:3],
        *v_cache.stride()[:3], out.stride(0), out.stride(1),
        float(np.float32(1.0 / np.sqrt(hd))), _build.stream_ptr(q)),
        "decode_attention")
    return out


def decode_attention(q, k_cache, v_cache, lengths):
    """Attention of one query token per request over its cache; CUDA
    kernel on CUDA tensors, plain on CPU. Lengths must be >= 1 (a request
    always sees at least its own token); lengths above W mean W."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    out = run_entry(q, k_cache, v_cache, lengths)
    launches += 1
    return out
