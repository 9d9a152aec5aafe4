"""Causal GQA self-attention, cross-attention, and cached single-token
decode of both.

Every full-sequence attention (self, or an encoder-decoder's
cross-attention of S text positions over T encoder frames) goes through
``kernels.ops.flash_attention`` and every decode step through
``kernels.ops.decode_attention``: the hand-written CUDA kernels on the
card, their plain versions on the CPU. The JAX package reaches the same
functions through XLA (``repro.models.attention.attention_core`` and the
dense softmax of ``attn_decode`` / ``cross_attn_decode``); the tests hold
this port to both.

Decode keeps a ring-buffer KV cache of W = min(cache_len, window) slots
per request: the key of absolute position p lives in slot p % W.

``cfg.logit_soft_cap`` soft-caps the scores of the decoder's
self-attention and its decode, as the JAX package does (the kernels take
the cap); an encoder's self-attention and every cross-attention take none,
as in the JAX package, whatever the config says.

Over model ranks (``common.MeshContext``) attention is tensor-parallel
where the ranks divide the query heads (``Heads``): rank j computes query
heads [j H/m, (j+1) H/m) (wq's columns, wo's rows) and the KV heads they
read, a contiguous run since query head h reads KV head h // G: wk / wv
hold the rank's KV heads where the ranks divide them too, else every KV
head (``models.layout``' departure). The input enters through
``into_model``, the row-cut product leaves through ``out_of_model``. A
ring of W slots that the ranks divide is cut on its slots (decode context
parallelism, ``cache_shardings``): rank j holds slots [j W/m, (j+1) W/m)
of every KV head, the entry carries the whole ring's size under "slots",
and a decode step gathers the query's heads and runs the decode kernel's
partial entry over the rank's slots, gathers the partials and merges
them, every rank then holding every head's output. The cross-attention's
K/V stay whole on every rank.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.layout import heads_split, ring_split


@dataclasses.dataclass(frozen=True)
class Heads:
    """The heads one model rank computes: query heads [h0, h0 + hn), which
    read KV heads [kv0, kv0 + kvn) of the ``kv_all``; ``kv_cut`` where wk
    / wv hold just those KV heads (else all of them); ``tp`` where the
    heads are cut at all."""
    h0: int
    hn: int
    kv0: int
    kvn: int
    kv_cut: bool
    tp: bool
    kv_all: int

    @property
    def kv_stored(self) -> int:
        return self.kvn if self.kv_cut else self.kv_all


def head_layout(cfg, mctx=common.LOCAL) -> Heads:
    """This rank's ``Heads``: all of them where the model ranks do not
    divide the query heads."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    m = mctx.model_size
    if not heads_split(cfg, m):
        return Heads(0, h, 0, kv, False, False, kv)
    g = h // kv
    h0, hn = mctx.part(h, "a head count")
    if hn % g and g % hn:
        raise ValueError(f"{hn} query heads a rank do not align with groups "
                         f"of {g} query heads a KV head")
    kv0 = h0 // g
    kvn = (h0 + hn - 1) // g - kv0 + 1
    return Heads(h0, hn, kv0, kvn, heads_split(cfg, m, kv=True), True, kv)


class Attention(nn.Module):
    """Attention parameters, named and shaped as the JAX ``attn_init``
    makes them: wq (d, H hd), wk/wv (d, KV hd), wo (H hd, d), over model
    ranks the rank's heads' columns (rows of wo); the QK norms where the
    config has them, but never for cross-attention."""

    def __init__(self, cfg, *, device, dtype, cross=False, mctx=common.LOCAL):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        h, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
        self.heads = head_layout(cfg, mctx)
        kw = dict(device=device, dtype=dtype)
        block = "xattn" if cross else "attn"
        for leaf, whole in (("wq", (d, h)), ("wk", (d, kv)), ("wv", (d, kv)),
                            ("wo", (h, d))):
            common.cut_param(self, (block, leaf), whole, cfg, mctx=mctx, **kw)
        if cfg.qk_norm and not cross:
            self.q_norm = common.RMSNorm(hd, **kw)
            self.k_norm = common.RMSNorm(hd, **kw)


def _enter(p: Attention, x, mctx):
    """x into the heads' region, and a replicated weight the rank uses a
    part of (its gradient then summed over the model ranks)."""
    if not p.heads.tp:
        return x, (lambda w: w)
    return mctx.into_model(x), mctx.into_model


def _leave(p: Attention, out, mctx):
    """(B, S, hn, hd) heads -> (B, S, d) through wo, summed over the ranks
    where the heads are cut."""
    b, s = out.shape[:2]
    y = out.reshape(b, s, -1) @ p.wo
    return mctx.out_of_model(y) if p.heads.tp else y


def _qkv(p: Attention, x, cfg, mctx=common.LOCAL):
    """q (B, S, hn, hd) of the rank's query heads; k, v (B, S, kv_stored,
    hd)."""
    b, s, _ = x.shape
    L, hd = p.heads, cfg.resolved_head_dim
    x, shared = _enter(p, x, mctx)
    wk, wv = (p.wk, p.wv) if L.kv_cut else (shared(p.wk), shared(p.wv))
    q = (x @ p.wq).view(b, s, L.hn, hd)
    k = (x @ wk).view(b, s, L.kv_stored, hd)
    v = (x @ wv).view(b, s, L.kv_stored, hd)
    if cfg.qk_norm:
        q = common.rmsnorm(shared(p.q_norm.scale), q, cfg.norm_eps)
        k = common.rmsnorm(shared(p.k_norm.scale), k, cfg.norm_eps)
    return q, k, v


def read_kv(p: Attention, t):
    """The KV heads the rank's query heads read, of ``t`` (B, T, ., hd)
    holding every KV head (a view) or just the rank's (``t`` itself)."""
    L = p.heads
    if t.shape[2] != L.kv_all or L.kvn == L.kv_all:
        return t
    return t[:, :, L.kv0:L.kv0 + L.kvn]


def all_kv(p: Attention, t, mctx=common.LOCAL):
    """Every KV head of ``t`` (B, T, kv_stored, hd), gathered over the
    model ranks where wk / wv are cut (``MeshContext.gather_model``)."""
    return mctx.gather_model(t, 2) if p.heads.kv_cut else t


def attention_core(q, k, v, *, causal=True, window=None, soft_cap=None):
    """q: (B, S, H, hd), k/v: (B, T, KV, hd) -> (B, S, H, hd); causal
    needs T = S; ``soft_cap`` c (None or 0: none) caps the scaled scores at
    c tanh(s / c). JAX's ``windowed_attention`` drops the cap where it
    falls back to ``dense_attention`` (window + 512 >= S > 1,024); this
    caps there too, as ``dense_attention`` does."""
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               soft_cap=soft_cap)


def _rotate(q, k, positions, pos3, cfg):
    """RoPE at ``positions`` (B, S), or M-RoPE at ``pos3`` (3, B, S) where
    the config has M-RoPE sections and the caller gives ``pos3``."""
    if pos3 is not None and cfg.mrope_sections:
        return (common.apply_mrope(t, pos3, cfg.rope_theta,
                                   cfg.mrope_sections) for t in (q, k))
    return (common.apply_rope(t, positions, cfg.rope_theta) for t in (q, k))


def self_attention(p: Attention, x, positions, cfg, *, window=None,
                   pos3=None, causal=True, mctx=common.LOCAL):
    """x: (B, S, d); positions: (B, S) int; pos3: (3, B, S) M-RoPE ids or
    None; ``causal`` False for an encoder's bidirectional attention, which
    takes no soft cap (the JAX package's ``_enc_self_attention``).
    Returns (out (B, S, d), (k, v)), k already rotated, of the rank's
    stored KV heads (``all_kv`` gathers every head for a cache)."""
    q, k, v = _qkv(p, x, cfg, mctx)
    q, k = _rotate(q, k, positions, pos3, cfg)
    out = attention_core(q, read_kv(p, k), read_kv(p, v), causal=causal,
                         window=window,
                         soft_cap=cfg.logit_soft_cap if causal else None)
    return _leave(p, out, mctx), (k, v)


def cross_attention(p: Attention, x, enc_kv, cfg, mctx=common.LOCAL):
    """Decoder cross-attention, non-causal, no RoPE. x: (B, S, d); enc_kv:
    (k, v) each (B, T, kv_stored, hd) from ``encode_kv``, or every KV
    head. The JAX package also projects x to k and v here and drops them;
    only q is computed."""
    b, s, _ = x.shape
    x, _ = _enter(p, x, mctx)
    q = (x @ p.wq).view(b, s, p.heads.hn, cfg.resolved_head_dim)
    k, v = enc_kv
    out = attention_core(q, read_kv(p, k), read_kv(p, v), causal=False)
    return _leave(p, out, mctx)


def encode_kv(p: Attention, enc_out, cfg, mctx=common.LOCAL):
    """Cross-attention K/V (B, T, kv_stored, hd) each, from the encoder
    output (B, T, d)."""
    b, t, _ = enc_out.shape
    shape = (b, t, p.heads.kv_stored, cfg.resolved_head_dim)
    enc_out, shared = _enter(p, enc_out, mctx)
    if not p.heads.kv_cut:
        return (enc_out @ shared(p.wk)).view(shape), \
            (enc_out @ shared(p.wv)).view(shape)
    return (enc_out @ p.wk).view(shape), (enc_out @ p.wv).view(shape)


def cross_attn_decode(p: Attention, x1, enc_kv, cfg, mctx=common.LOCAL):
    """One query a request over its T encoder frames: x1 (B, 1, d); enc_kv
    (k, v) each (B, T, KV, hd), every KV head, in x1's dtype or bf16, all
    T slots valid (the decode kernel's ring, every length T). Returns (B,
    1, d)."""
    b = x1.shape[0]
    k, v = enc_kv
    x1, _ = _enter(p, x1, mctx)
    q = (x1[:, 0] @ p.wq).view(b, p.heads.hn, cfg.resolved_head_dim)
    lengths = torch.full((b,), k.shape[1], dtype=torch.int32,
                         device=x1.device)
    out = ops.decode_attention(q, read_kv(p, k), read_kv(p, v), lengths)
    return _leave(p, out[:, None], mctx)


# ---------------------------------------------------------------------------
# cached decode
# ---------------------------------------------------------------------------
def init_kv_cache(batch, cache_len, cfg, dtype, device=None,
                  mctx=common.LOCAL):
    """An empty ring of ``cache_len`` slots: (B, W, KV, hd) each, or, where
    the model ranks divide W, this rank's (B, W/m, KV, hd) and the whole
    ring's W under "slots"."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    cut = ring_split(cache_len, mctx.model_size)
    w = cache_len // mctx.model_size if cut else cache_len
    shape = (batch, w, kv, hd)
    out = {"k": torch.zeros(shape, dtype=dtype, device=device),
           "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cut:
        out["slots"] = cache_len
    return out


def ring_slots(cache) -> int:
    """W, the slots of the whole ring whose entry (or shard) ``cache`` is."""
    return cache.get("slots", cache["k"].shape[1])


def fill_kv_cache(cache, k, v, mctx=common.LOCAL, p=None):
    """Write prefill K/V (B, S, KV, hd) into a ring of W slots (or this
    rank's shard of it), in place: every KV head, or where ``p`` is given
    the KV heads its wk / wv hold, gathered here (``all_kv``).

    S <= W: positions 0..S-1 go to slots 0..S-1. S > W: only the last W
    positions are kept, position p in slot p % W (the JAX package slices
    them and rolls by (S - W) % W, which is the same placement). A shard
    takes its slots [j W/m, (j + 1) W/m) of that placement."""
    w, s = ring_slots(cache), k.shape[1]
    if s > w:
        roll = (s - w) % w
        k = torch.roll(k[:, s - w:], roll, dims=1)
        v = torch.roll(v[:, s - w:], roll, dims=1)
    if p is not None:
        k, v = all_kv(p, k, mctx), all_kv(p, v, mctx)
    ws = cache["k"].shape[1]
    lo = mctx.model_rank * ws if "slots" in cache else 0
    k, v = k[:, lo:lo + ws], v[:, lo:lo + ws]
    cache["k"][:, :k.shape[1]] = k.to(cache["k"].dtype)
    cache["v"][:, :v.shape[1]] = v.to(cache["v"].dtype)
    return cache


def ring_lengths(pos, w):
    """Valid slots of a ring of W slots whose newest token sits at
    absolute position ``pos`` (B,): min(pos + 1, W).

    The JAX package's ``attn_decode`` masks slot j by its absolute
    position abs_j = pos - ((pos % W - j) mod W): valid iff abs_j >= 0
    (and pos - abs_j < window, which always holds, since W <= window).
    For pos >= W - 1 every (slot - j) mod W <= W - 1 <= pos: all W slots
    are valid. For pos < W the slot is pos itself, so j <= pos gives
    abs_j = j >= 0 and j > pos gives abs_j = j - W < 0: exactly the slots
    j < pos + 1. Both cases are slots [0, min(pos + 1, W)), the length
    operand of ``ops.decode_attention``."""
    return torch.clamp(pos + 1, max=w)


def _write_slot(cache, k_new, v_new, pos, mctx):
    """The new token's K/V (B, KV, hd) into slot pos % W of the ring, on
    the rank whose shard holds it (rows whose slot is elsewhere keep their
    values: no host sync to pick the rows)."""
    b, ws = k_new.shape[0], cache["k"].shape[1]
    rows = torch.arange(b, device=pos.device)
    slot = pos % ring_slots(cache)
    if "slots" not in cache:
        cache["k"][rows, slot] = k_new.to(cache["k"].dtype)
        cache["v"][rows, slot] = v_new.to(cache["v"].dtype)
        return
    local = slot - mctx.model_rank * ws
    mine = ((local >= 0) & (local < ws))[:, None, None]
    local = torch.clamp(local, 0, ws - 1)
    for key, new in (("k", k_new), ("v", v_new)):
        old = cache[key][rows, local]
        cache[key][rows, local] = torch.where(mine, new.to(old.dtype), old)


def attn_decode(p: Attention, x1, cache, pos, cfg, *, pos3=None,
                mctx=common.LOCAL):
    """One token per request. x1: (B, 1, d); cache: ring (B, W, KV, hd),
    or this rank's shard of it, updated in place (slot pos % W); pos:
    (B,) absolute position of the new token; pos3: its (3, B, 1) M-RoPE
    ids or None. Returns (out (B, 1, d), cache). Soft-capped at
    ``cfg.logit_soft_cap``, as the JAX package's ``attn_decode``.

    Over model ranks one all_reduce gathers what the rank lacks: the
    query's heads where the ring is cut, the new token's K/V where wk /
    wv are; a cut ring's partials take one more."""
    b, hd = x1.shape[0], cfg.resolved_head_dim
    L, h, kv = p.heads, cfg.num_heads, cfg.num_kv_heads
    q, k_new, v_new = _qkv(p, x1, cfg, mctx)
    q, k_new = _rotate(q, k_new, pos[:, None], pos3, cfg)
    q, k_new, v_new = q[:, 0], k_new[:, 0], v_new[:, 0]
    cut = "slots" in cache
    want_q = cut and L.tp
    if want_q or L.kv_cut:
        # one gather: [query heads | K heads | V heads], zero but the rank's
        buf = q.new_zeros(b, h + 2 * kv, hd)
        if want_q:
            buf[:, L.h0:L.h0 + L.hn] = q
        if L.kv_cut:
            buf[:, h + L.kv0:h + L.kv0 + L.kvn] = k_new
            buf[:, h + kv + L.kv0:h + kv + L.kv0 + L.kvn] = v_new
        mctx.all_reduce_model(buf, kind="gather")
        if want_q:
            q = buf[:, :h]
        if L.kv_cut:
            k_new, v_new = buf[:, h:h + kv], buf[:, h + kv:]
    _write_slot(cache, k_new, v_new, pos, mctx)
    lengths = ring_lengths(pos, ring_slots(cache))
    if cut:
        parts = ops.decode_attention_partials(
            q, cache["k"], cache["v"], lengths, mctx.model_rank,
            mctx.model_size, soft_cap=cfg.logit_soft_cap)
        out = ops.decode_attention_merge(
            mctx.all_reduce_model(parts, kind="gather"), q, kv)
        out = out[:, L.h0:L.h0 + L.hn]
    else:
        out = ops.decode_attention(q, read_kv(p, cache["k"]),
                                   read_kv(p, cache["v"]), lengths,
                                   soft_cap=cfg.logit_soft_cap)
    return _leave(p, out[:, None], mctx), cache
