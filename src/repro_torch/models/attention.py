"""Causal GQA self-attention for the dense decoder.

Every self-attention goes through ``kernels.ops.flash_attention``: the
hand-written CUDA kernel on the card, its plain version on the CPU. The
JAX package reaches the same function through XLA's dense path
(``repro.models.attention.attention_core``) at the tiers' lengths; the
tests hold this port to both.
"""
from __future__ import annotations

from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import common


class Attention(nn.Module):
    """Attention parameters, named and shaped as the JAX ``attn_init``
    makes them: wq (d, H hd), wk/wv (d, KV hd), wo (H hd, d)."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        kw = dict(device=device, dtype=dtype)
        self.wq = common.param(d, h * hd, **kw)
        self.wk = common.param(d, kv * hd, **kw)
        self.wv = common.param(d, kv * hd, **kw)
        self.wo = common.param(h * hd, d, **kw)
        if cfg.qk_norm:
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
    """q: (B, S, H, hd), k/v: (B, S, KV, hd) -> (B, S, H, hd)."""
    if soft_cap is not None:
        raise NotImplementedError(
            "soft-capped attention has no kernel in repro_torch yet "
            "(ROADMAP.md Queue A, the rest of the model zoo)")
    return ops.flash_attention(q, k, v, causal=causal, window=window)


def self_attention(p: Attention, x, positions, cfg, *, window=None):
    """x: (B, S, d); positions: (B, S) int. Returns (B, S, d)."""
    q, k, v = _qkv(p, x, cfg)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    out = attention_core(q, k, v, causal=True, window=window,
                         soft_cap=cfg.logit_soft_cap)
    b, s, _, _ = out.shape
    return out.reshape(b, s, -1) @ p.wo
