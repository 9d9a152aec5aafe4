"""Single-token decode attention with GQA over a (ring) KV cache.

q: (B, H, hd); k/v caches: (B, W, KV, hd); lengths: (B,) int, the number
of valid slots: slots [0, length) of each request are attended, the rest
are masked. Returns (B, H, hd) in q's dtype; the KV head of query head h
is h // (H // KV). The dtypes are all float32, all bfloat16, or a float32
q over bfloat16 caches (the JAX package's default cache under a float32
model), which computes in float32 as JAX does. ``soft_cap`` c (None or 0: none)
replaces each scaled score s by c tanh(s / c) before the mask, as the JAX
package's ``attn_decode`` does under ``cfg.logit_soft_cap``.
``decode_attention`` runs the hand-written CUDA kernel
``csrc/decode_attention.cu`` on CUDA tensors and ``decode_attention_plain``
on CPU tensors; on any other device it raises.

Over a ring cut over ``ranks`` model ranks on its W slots (decode context
parallelism: rank j holds slots [j W/m, (j+1) W/m) of every KV head),
``decode_attention_partials`` runs the kernel's partial entry on a rank's
shard, the lengths (the whole ring's) clipped to it, and returns a buffer
of every rank's splits, zero but for this rank's; the ranks' buffers
summed (``MeshContext.all_reduce_model``) gather them, and
``decode_attention_merge`` merges the splits rank by rank, split by split,
into the output of all H heads. Their plain versions are
``decode_attention_partials_plain`` and ``decode_attention_merge_plain``.
The buffer holds m (rows of B * KV * splits * G, the running maximum), l
(the running sum) and acc (rows x hd, the unnormalised output), a row's
order (request, KV head, split, query head of the group), the splits of
rank 0 first; a split with no slot within its length has m = -1e30, l = 0
and acc = 0, and weighs exp(-1e30 - max) = 0 in the merge.

On ``meta`` tensors (the dry-run) each wrapper checks its inputs and
plans its splits as for the card (``_build.sm_count`` gives a ``meta``
device the production card's SMs), launches and counts nothing, returns
outputs of the kernel's shapes and books its work into
``roofline.analysis``. The lengths are unknown there, so the work is a
full ring's (or shard's), as the dry-run's decode shapes hold it.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.roofline import analysis as ra
from repro_torch.kernels.flash_attention import cap_operand

NEG_INF = -1e30
MAX_HEAD_DIM = 256   # csrc/decode_attention.cu kMaxHD
MAX_GROUP = 16       # csrc/decode_attention.cu kMaxG: query heads per KV head
MAX_SPLITS = 256     # csrc/decode_attention.cu kMaxSplits
TILE = 16            # csrc/decode_attention.cu kTile: keys per ring slot
BLOCKS_PER_SM = 1    # partial-kernel blocks the plan gives each SM
SHARD_MIN_KEYS = 64  # slots a split of a shard covers at least

# kernel launches since the last ops.reset_launch_counts(); incremented
# under the lock, since worker threads launch too
launches = 0
partials_launches = 0
merge_launches = 0
COUNT_LOCK = threading.Lock()

# (q dtype, cache dtype) pairs the kernel takes
DTYPE_PAIRS = ((torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.float32, torch.bfloat16))


def decode_attention_plain(q, k_cache, v_cache, lengths, soft_cap=None):
    """The masked-einsum form, float32 softmax (JAX ``decode_attention_ref``;
    with a soft cap, the softmax of JAX's ``attn_decode``)."""
    b, w, kvh, hd = k_cache.shape
    h = q.shape[1]
    qg = q.reshape(b, kvh, h // kvh, hd).float()
    scores = torch.einsum("bkgh,bwkh->bkgw", qg, k_cache.float())
    scores = scores * float(np.float32(1.0 / np.sqrt(hd)))
    if soft_cap:
        scores = torch.tanh(scores / soft_cap) * soft_cap
    valid = torch.arange(w, device=q.device)[None, :] \
        < lengths.to(q.device)[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgw,bwkh->bkgh", p, v_cache.float())
    return out.reshape(b, h, hd).to(q.dtype)


def _scale(hd: int) -> float:
    return float(np.float32(1.0 / np.sqrt(hd)))


def partials_rows(b: int, kvh: int, g: int, n_splits: int) -> int:
    """Rows of a partials buffer: one a (request, KV head, split, query
    head of the group)."""
    return b * kvh * n_splits * g


def _views(parts, b, kvh, g, hd):
    """(m, l, acc) views of a partials buffer: (B, KV, NS, G) twice and
    (B, KV, NS, G, hd), NS every rank's splits."""
    rows = parts.numel() // (2 + hd)
    ns = rows // (b * kvh * g)
    if rows * (2 + hd) != parts.numel() or ns * b * kvh * g != rows:
        raise ValueError(f"decode_attention_merge: a buffer of "
                         f"{parts.numel()} floats is no partials buffer of "
                         f"(B {b}, KV {kvh}, G {g}, hd {hd})")
    return (parts[:rows].view(b, kvh, ns, g),
            parts[rows:2 * rows].view(b, kvh, ns, g),
            parts[2 * rows:].view(b, kvh, ns, g, hd))


def decode_attention_partials_plain(q, k_shard, v_shard, lengths, rank=0,
                                    ranks=1, soft_cap=None, n_splits=1):
    """The partial entry's function over about ``n_splits`` splits of the
    shard (the kernel's plan cut, whole TILE-key tiles): for each split,
    the float32 maximum m of the scaled (capped) scores of the slots below
    the length clipped to the shard, l = sum exp(s - m) and acc = sum
    exp(s - m) v over them, written at this rank's splits of a zeroed
    buffer of all ranks'."""
    b, ws, kvh, hd = k_shard.shape
    g = q.shape[1] // kvh
    ns, chunk = _cut(ws, n_splits)
    parts = torch.zeros(partials_rows(b, kvh, g, ranks * ns) * (2 + hd),
                        dtype=torch.float32, device=q.device)
    m_all, l_all, acc_all = _views(parts, b, kvh, g, hd)
    qg = q.reshape(b, kvh, g, hd).float()
    s = torch.einsum("bkgh,bwkh->bkgw", qg, k_shard.float()) * _scale(hd)
    if soft_cap:
        s = torch.tanh(s / soft_cap) * soft_cap
    local = torch.clamp(lengths.to(q.device).long() - rank * ws, 0, ws)
    valid = torch.arange(ws, device=q.device)[None, :] < local[:, None]
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    for i in range(ns):
        lo, hi = i * chunk, min((i + 1) * chunk, ws)
        si = s[..., lo:hi]
        m = si.amax(dim=-1)
        p = torch.where(valid[:, None, None, lo:hi],
                        torch.exp(si - m[..., None]), 0.0)
        m_all[:, :, rank * ns + i] = m
        l_all[:, :, rank * ns + i] = p.sum(dim=-1)
        acc_all[:, :, rank * ns + i] = torch.einsum(
            "bkgw,bwkh->bkgh", p, v_shard[:, lo:hi].float())
    return parts


def decode_attention_merge_plain(parts, q, kv_heads: int):
    """The merge entry's function: for each (request, KV head, query head)
    the splits weighed by exp(m - max m) and added in split order, acc over
    max(l, 1e-30), in q's dtype: (B, H, hd) of the query ``q`` (B, H, hd)
    whose partials ``parts`` holds over a ring of ``kv_heads`` KV heads."""
    b, h, hd = q.shape
    m, l, acc = _views(parts, b, kv_heads, h // kv_heads, hd)
    w = torch.exp(m - m.amax(dim=2, keepdim=True))
    den = torch.zeros_like(l[:, :, 0])
    num = torch.zeros_like(acc[:, :, 0])
    for i in range(m.shape[2]):
        den = den + l[:, :, i] * w[:, :, i]
        num = num + acc[:, :, i] * w[:, :, i, :, None]
    out = num / torch.clamp(den, min=1e-30)[..., None]
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


def shard_splits(b: int, kvh: int, w: int, sms: int, ranks: int):
    """``splits`` for a rank's shard of ``w`` slots, with no more than
    MAX_SPLITS / ``ranks`` splits, so that the merge of every rank's fits
    its MAX_SPLITS, each of at least SHARD_MIN_KEYS slots: the ranks
    gather every split's (m, l, acc), G (hd + 2) floats, so a split of 16
    keys would make the gathered buffer as large as the shard itself (at
    RecurrentGemma's (4, 512, 1, 16, 256) shard, 8.4 MB against 2.1 MB
    with the floor)."""
    return _cut(w, max(1, min(-(-w // SHARD_MIN_KEYS),
                              BLOCKS_PER_SM * sms // (b * kvh),
                              MAX_SPLITS // ranks)))


def run_entry(q, k_cache, v_cache, lengths, n_splits: Optional[int] = None,
              soft_cap=None):
    """Check CUDA tensors and run the kernel on them with the planned
    splits (``splits``) or, for measuring, about ``n_splits`` splits of
    whole tiles. Counts nothing: ``decode_attention`` is the counted
    launch."""
    _check(q, k_cache, v_cache, lengths)
    cap = cap_operand(soft_cap)
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
        _scale(hd), cap, _build.stream_ptr(q)), "decode_attention")
    return out


def _plan_partials(q, k_shard, v_shard, lengths, rank, ranks):
    """Check a partial entry's inputs; its (splits, slots a split)."""
    _check(q, k_shard, v_shard, lengths)
    if not 0 <= rank < ranks or ranks > MAX_SPLITS:
        raise ValueError(f"decode_attention_partials: rank {rank} of "
                         f"{ranks}")
    b, ws, kvh = k_shard.shape[:3]
    ns, chunk = shard_splits(b, kvh, ws, _build.sm_count(q.device), ranks)
    if ranks * ns > MAX_SPLITS:
        raise ValueError(f"decode_attention_partials: {ranks} x {ns} splits "
                         f"pass {MAX_SPLITS}")
    return ns, chunk


def _check_merge(parts, q, kv_heads):
    """Check a merge entry's inputs; the buffer's (m, l, acc) views."""
    b, h, hd = q.shape
    if parts.dtype != torch.float32 or not parts.is_contiguous() or \
            parts.device != q.device:
        raise ValueError("decode_attention_merge: a contiguous float32 "
                         "buffer on q's device")
    if q.dtype not in _build.DTYPE_CODES or kv_heads <= 0 or h % kv_heads \
            or h // kv_heads > MAX_GROUP or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention_merge: q {tuple(q.shape)} "
                         f"{q.dtype} over {kv_heads} KV heads")
    return _views(parts, b, kv_heads, h // kv_heads, hd)


def run_partials_entry(q, k_shard, v_shard, lengths, rank=0, ranks=1,
                       soft_cap=None):
    """``decode_attention_partials``' launch on CUDA tensors over the
    planned splits (``shard_splits``), uncounted."""
    ns, chunk = _plan_partials(q, k_shard, v_shard, lengths, rank, ranks)
    cap = cap_operand(soft_cap)
    b, h, hd = q.shape
    _, ws, kvh, _ = k_shard.shape
    g = h // kvh
    lengths = lengths.to(torch.int32).contiguous()
    parts = torch.zeros(partials_rows(b, kvh, g, ranks * ns) * (2 + hd),
                        dtype=torch.float32, device=q.device)
    _build.check(_build.library().repro_decode_attention_partials(
        q.data_ptr(), k_shard.data_ptr(), v_shard.data_ptr(),
        lengths.data_ptr(), parts.data_ptr(), _build.DTYPE_CODES[q.dtype],
        _build.DTYPE_CODES[k_shard.dtype], b, ws, h, kvh, hd, ns, chunk,
        rank * ws, ranks * ns, rank * ns, q.stride(0), q.stride(1),
        *k_shard.stride()[:3], *v_shard.stride()[:3], _scale(hd), cap,
        _build.stream_ptr(q)), "decode_attention_partials")
    return parts


def run_merge_entry(parts, q, kv_heads: int):
    """``decode_attention_merge``'s launch on CUDA tensors, uncounted."""
    b, h, hd = q.shape
    m, _, _ = _check_merge(parts, q, kv_heads)
    out = torch.empty(b, h, hd, dtype=q.dtype, device=q.device)
    _build.check(_build.library().repro_decode_attention_merge(
        parts.data_ptr(), out.data_ptr(), _build.DTYPE_CODES[q.dtype], b, h,
        kv_heads, hd, m.shape[2], out.stride(0), out.stride(1),
        _build.stream_ptr(q)), "decode_attention_merge")
    return out


def decode_attention(q, k_cache, v_cache, lengths, soft_cap=None):
    """Attention of one query token per request over its cache; CUDA
    kernel on CUDA tensors, plain on CPU. Lengths must be >= 1 (a request
    always sees at least its own token); lengths above W mean W;
    ``soft_cap`` c caps the scaled scores at c tanh(s / c). The kernel has
    no backward: a CUDA call that autograd would record raises."""
    global launches
    kind = _build.device_kind("decode_attention", q)
    if kind == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, lengths, soft_cap)
    _build.refuse_grad("decode_attention", q, k_cache, v_cache)
    if kind == "meta":
        _check(q, k_cache, v_cache, lengths)
        cap_operand(soft_cap)
        b, h, hd = q.shape
        _, w, kvh, _ = k_cache.shape
        ra.record("decode_attention", ra.decode_work(
            b, h, hd, kvh, b * w, q.element_size(), k_cache.element_size()))
        return torch.empty(b, h, hd, dtype=q.dtype, device="meta")
    out = run_entry(q, k_cache, v_cache, lengths, soft_cap=soft_cap)
    with COUNT_LOCK:
        launches += 1
    return out


def decode_attention_partials(q, k_shard, v_shard, lengths, rank=0, ranks=1,
                              soft_cap=None):
    """Rank ``rank`` of ``ranks``' partials of one query token per request,
    q (B, H, hd) with every head, over its shard (B, W/m, KV, hd) of a
    ring of W slots cut on its slots: slots [rank W/m, (rank + 1) W/m);
    ``lengths`` (B,) are the whole ring's (0 allowed: an empty shard).
    Returns the buffer of every rank's splits, this rank's filled (module
    docstring). CUDA kernel (its partial entry) on CUDA tensors, counted;
    plain on CPU tensors. No backward: a CUDA call autograd would record
    raises."""
    global partials_launches
    kind = _build.device_kind("decode_attention_partials", q)
    if kind == "cpu":
        return decode_attention_partials_plain(q, k_shard, v_shard, lengths,
                                               rank, ranks, soft_cap)
    _build.refuse_grad("decode_attention_partials", q, k_shard, v_shard)
    if kind == "meta":
        ns, _ = _plan_partials(q, k_shard, v_shard, lengths, rank, ranks)
        cap_operand(soft_cap)
        b, h, hd = q.shape
        _, ws, kvh, _ = k_shard.shape
        ra.record("decode_attention_partials", ra.decode_partials_work(
            b, h, hd, kvh, b * ws, ns, q.element_size(),
            k_shard.element_size()))
        return torch.zeros(partials_rows(b, kvh, h // kvh, ranks * ns)
                           * (2 + hd), dtype=torch.float32, device="meta")
    out = run_partials_entry(q, k_shard, v_shard, lengths, rank, ranks,
                             soft_cap=soft_cap)
    with COUNT_LOCK:
        partials_launches += 1
    return out


def decode_attention_merge(parts, q, kv_heads: int):
    """The gathered partials of every rank -> (B, H, hd) in q's dtype, the
    attention of q (B, H, hd) over the whole ring of ``kv_heads`` KV
    heads. CUDA kernel (the merge entry) on CUDA tensors, counted; plain
    on CPU tensors."""
    global merge_launches
    kind = _build.device_kind("decode_attention_merge", parts)
    if kind == "cpu":
        return decode_attention_merge_plain(parts, q, kv_heads)
    _build.refuse_grad("decode_attention_merge", parts, q)
    if kind == "meta":
        m, _, _ = _check_merge(parts, q, kv_heads)
        b, h, hd = q.shape
        ra.record("decode_attention_merge", ra.decode_merge_work(
            b, h, hd, kv_heads, m.shape[2], q.element_size()))
        return torch.empty(b, h, hd, dtype=q.dtype, device="meta")
    out = run_merge_entry(parts, q, kv_heads)
    with COUNT_LOCK:
        merge_launches += 1
    return out
