"""The decoder stack: ``attn``, ``lattn`` and ``rglru`` layers, a
full-sequence forward that can fill the decode cache, and the cached
one-token decode step.

Counterpart of the JAX package's ``transformer.init_params`` (the
parameter layout), ``forward``, ``init_cache`` and ``decode_step`` for
dense and hybrid (RecurrentGemma) configs. The JAX package stacks its
layers into super-blocks of the layer pattern for ``lax.scan``; here they
are an ``nn.ModuleList`` run by a Python loop. Parameter names follow the
JAX tree (``layers.{i}.attn.wq`` is ``blocks[k]["attn"]["wq"][sb]`` for
layer i = sb * len(pattern) + k), so ``models.model.params_from_jax`` can
map one onto the other. The cache is a list with one entry per layer: a
ring KV cache for ``attn``/``lattn``, the (h, conv tail) state for
``rglru``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import common, recurrent

KINDS = ("attn", "lattn", "rglru")


def _window_for(cfg, kind):
    if kind == "lattn":
        return cfg.local_attn_window
    return cfg.sliding_window  # None for full attention


def _cache_len_for(cfg, kind, cache_len):
    w = _window_for(cfg, kind)
    return min(cache_len, w) if w else cache_len


class DecoderLayer(nn.Module):
    def __init__(self, cfg, kind, *, device, dtype):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(kind)
        kw = dict(device=device, dtype=dtype)
        self.kind = kind
        self.norm1 = common.RMSNorm(cfg.d_model, **kw)
        if kind == "rglru":
            self.rglru = recurrent.RGLRU(cfg, **kw)
        else:
            self.attn = attn.Attention(cfg, **kw)
        if cfg.d_ff:
            self.norm2 = common.RMSNorm(cfg.d_model, **kw)
            self.mlp = common.MLP(cfg.d_model, cfg.d_ff, **kw)

    def _mlp(self, x, cfg):
        if cfg.d_ff:
            x = x + self.mlp(self.norm2(x, cfg.norm_eps), cfg.mlp_act)
        return x

    def forward(self, x, positions, cfg, *, collect_cache=False,
                cache_len=None):
        """Returns (x, cache entry or None)."""
        h = self.norm1(x, cfg.norm_eps)
        cache = None
        if self.kind == "rglru":
            out, state = recurrent.rglru_block(self.rglru, h)
            if collect_cache:
                cache = state
        else:
            out, (k, v) = attn.self_attention(
                self.attn, h, positions, cfg,
                window=_window_for(cfg, self.kind))
            if collect_cache:
                w = _cache_len_for(cfg, self.kind, cache_len)
                cache = attn.fill_kv_cache(
                    attn.init_kv_cache(x.shape[0], w, cfg, x.dtype, x.device),
                    k, v)
        return self._mlp(x + out, cfg), cache

    def decode(self, x1, cache, pos, cfg):
        """One token. Returns (x1, new cache entry)."""
        h = self.norm1(x1, cfg.norm_eps)
        if self.kind == "rglru":
            out, cache = recurrent.rglru_decode(self.rglru, h, cache)
        else:
            out, cache = attn.attn_decode(self.attn, h, cache, pos, cfg)
        return self._mlp(x1 + out, cfg), cache


class Model(nn.Module):
    """Decoder: tokens (B, S) -> logits (B, S, padded vocab)."""

    def __init__(self, cfg, *, device, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embed = common.Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.final_norm = common.RMSNorm(cfg.d_model, **kw)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, kind, **kw) for kind in cfg.pattern)
        if not cfg.tie_embeddings:
            self.lm_head = common.Embedding(cfg.vocab_size, cfg.d_model, **kw)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @property
    def head_table(self) -> torch.Tensor:
        return (self.embed if self.cfg.tie_embeddings else self.lm_head).table

    def _out(self, x, return_hidden):
        x = self.final_norm(x, self.cfg.norm_eps)
        if return_hidden:
            return x
        return common.lm_head_apply(self.head_table, x, self.cfg.vocab_size)

    def forward(self, tokens, *, collect_cache=False, cache_len=None,
                return_hidden=False):
        """tokens: (B, S). Returns (logits (B, S, padded vocab), or the
        final hidden states (B, S, d) with ``return_hidden``; the cache
        for ``decode_step`` with ``collect_cache``, else None). The
        attention caches hold min(cache_len, window) slots, cache_len
        defaulting to S."""
        cfg = self.cfg
        x = common.embed_apply(self.embed.table, tokens)
        b, s = tokens.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        cache_len = cache_len or s
        caches = []
        for layer in self.layers:
            x, c = layer(x, positions, cfg, collect_cache=collect_cache,
                         cache_len=cache_len)
            caches.append(c)
        return self._out(x, return_hidden), caches if collect_cache else None

    def init_cache(self, batch, cache_len, dtype=torch.bfloat16):
        """An empty cache: rings of min(cache_len, window) slots and conv
        tails in ``dtype``, zero float32 recurrent states. bfloat16 by
        default, as the JAX package's ``init_cache``: an f32 model
        decodes over it in f32 (the decode-attention kernel widens the
        rings as it loads them; the first step's conv tail comes back
        f32, as JAX's does)."""
        cfg, dev = self.cfg, self.device
        return [recurrent.rglru_init_state(batch, cfg.d_model, dtype, dev)
                if layer.kind == "rglru" else
                attn.init_kv_cache(batch, _cache_len_for(cfg, layer.kind,
                                                         cache_len),
                                   cfg, dtype, dev)
                for layer in self.layers]

    def decode_step(self, tokens1, cache, pos, *, return_hidden=False):
        """tokens1: (B, 1); pos: (B,) absolute position of the new token.
        Returns (logits (B, 1, padded vocab), or the hidden states with
        ``return_hidden``; the new cache). The attention rings are
        updated in place."""
        cfg = self.cfg
        x = common.embed_apply(self.embed.table, tokens1)
        new = []
        for layer, c in zip(self.layers, cache):
            x, c = layer.decode(x, c, pos, cfg)
            new.append(c)
        return self._out(x, return_hidden), new
