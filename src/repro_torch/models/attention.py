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
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import common


class Attention(nn.Module):
    """Attention parameters, named and shaped as the JAX ``attn_init``
    makes them: wq (d, H hd), wk/wv (d, KV hd), wo (H hd, d); the QK norms
    where the config has them, but never for cross-attention."""

    def __init__(self, cfg, *, device, dtype, cross=False):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        kw = dict(device=device, dtype=dtype)
        self.wq = common.param(d, h * hd, **kw)
        self.wk = common.param(d, kv * hd, **kw)
        self.wv = common.param(d, kv * hd, **kw)
        self.wo = common.param(h * hd, d, **kw)
        if cfg.qk_norm and not cross:
            self.q_norm = common.RMSNorm(hd, **kw)
            self.k_norm = common.RMSNorm(hd, **kw)


def _qkv(p: Attention, x, cfg):
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p.wq).view(b, s, h, hd)
    k = (x @ p.wk).view(b, s, kv, hd)
    v = (x @ p.wv).view(b, s, kv, hd)
    if cfg.qk_norm:
        q = p.q_norm(q, cfg.norm_eps)
        k = p.k_norm(k, cfg.norm_eps)
    return q, k, v


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
                   pos3=None, causal=True):
    """x: (B, S, d); positions: (B, S) int; pos3: (3, B, S) M-RoPE ids or
    None; ``causal`` False for an encoder's bidirectional attention, which
    takes no soft cap (the JAX package's ``_enc_self_attention``).
    Returns (out (B, S, d), (k, v)), k already rotated, for the cache."""
    q, k, v = _qkv(p, x, cfg)
    q, k = _rotate(q, k, positions, pos3, cfg)
    out = attention_core(q, k, v, causal=causal, window=window,
                         soft_cap=cfg.logit_soft_cap if causal else None)
    b, s, _, _ = out.shape
    return out.reshape(b, s, -1) @ p.wo, (k, v)


def cross_attention(p: Attention, x, enc_kv, cfg):
    """Decoder cross-attention, non-causal, no RoPE. x: (B, S, d); enc_kv:
    (k, v) each (B, T, KV, hd) from ``encode_kv``. The JAX package also
    projects x to k and v here and drops them; only q is computed."""
    b, s, _ = x.shape
    q = (x @ p.wq).view(b, s, cfg.num_heads, cfg.resolved_head_dim)
    out = attention_core(q, *enc_kv, causal=False)
    return out.reshape(b, s, -1) @ p.wo


def encode_kv(p: Attention, enc_out, cfg):
    """Cross-attention K/V (B, T, KV, hd) each, from the encoder output
    (B, T, d)."""
    b, t, _ = enc_out.shape
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return ((enc_out @ p.wk).view(b, t, kv, hd),
            (enc_out @ p.wv).view(b, t, kv, hd))


def cross_attn_decode(p: Attention, x1, enc_kv, cfg):
    """One query a request over its T encoder frames: x1 (B, 1, d); enc_kv
    (k, v) each (B, T, KV, hd) in x1's dtype or bf16, all T slots valid
    (the decode kernel's ring, every length T). Returns (B, 1, d)."""
    b = x1.shape[0]
    k, v = enc_kv
    q = (x1[:, 0] @ p.wq).view(b, cfg.num_heads, cfg.resolved_head_dim)
    lengths = torch.full((b,), k.shape[1], dtype=torch.int32,
                         device=x1.device)
    out = ops.decode_attention(q, k, v, lengths)
    return out.reshape(b, 1, -1) @ p.wo


# ---------------------------------------------------------------------------
# cached decode
# ---------------------------------------------------------------------------
def init_kv_cache(batch, cache_len, cfg, dtype, device=None):
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, cache_len, kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def fill_kv_cache(cache, k, v):
    """Write prefill K/V (B, S, KV, hd) into a ring of W slots, in place.

    S <= W: positions 0..S-1 go to slots 0..S-1. S > W: only the last W
    positions are kept, position p in slot p % W (the JAX package slices
    them and rolls by (S - W) % W, which is the same placement)."""
    w, s = cache["k"].shape[1], k.shape[1]
    if s > w:
        roll = (s - w) % w
        k = torch.roll(k[:, s - w:], roll, dims=1)
        v = torch.roll(v[:, s - w:], roll, dims=1)
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


def attn_decode(p: Attention, x1, cache, pos, cfg, *, pos3=None):
    """One token per request. x1: (B, 1, d); cache: ring (B, W, KV, hd),
    updated in place (slot pos % W); pos: (B,) absolute position of the
    new token; pos3: its (3, B, 1) M-RoPE ids or None. Returns (out (B,
    1, d), cache). Soft-capped at ``cfg.logit_soft_cap``, as the JAX
    package's ``attn_decode``."""
    b = x1.shape[0]
    w = cache["k"].shape[1]
    q, k_new, v_new = _qkv(p, x1, cfg)
    q, k_new = _rotate(q, k_new, pos[:, None], pos3, cfg)
    slot = pos % w
    rows = torch.arange(b, device=pos.device)
    cache["k"][rows, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v_new[:, 0].to(cache["v"].dtype)
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"],
                               ring_lengths(pos, w),
                               soft_cap=cfg.logit_soft_cap)
    return out.reshape(b, 1, -1) @ p.wo, cache
