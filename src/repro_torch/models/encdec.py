"""Encoder-decoder transformer (SeamlessM4T's speech encoder and text
decoder, arXiv:2308.11596).

Counterpart of the JAX package's ``models/encdec.py``. As there, the
modality frontend is a stub: the encoder takes precomputed frame
embeddings (B, F, d). The encoder is a stack of pre-norm layers with
bidirectional self-attention (RoPE at frames 0..F-1, ``causal=False``
through the flash kernel, T = S = F); the decoder is a stack of causal
self-attention, cross-attention of its S positions over the F encoded
frames (the flash kernel with T = F != S, no RoPE), and the gated MLP.
Cross-attention K/V come from the encoder output once per layer and are
carried in the decode cache, where one query a request attends all F
frames through the decode-attention kernel.

Parameter names follow the JAX tree: ``frontend_proj``, ``embed.table``,
``enc_blocks.{i}.attn.wq`` is ``enc_blocks["attn"]["wq"][i]`` (stacked
over ``encoder_layers``), ``dec_blocks.{i}.xattn.wk`` is
``dec_blocks["xattn"]["wk"][i]`` (stacked over ``num_layers``),
``enc_norm``, ``final_norm``, the untied ``lm_head.table``. The cache is a
list with one entry per decoder layer: {"self": ring {"k", "v"}, "cross":
(k, v)}.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import common


def _ring_len(cfg, cache_len):
    """Slots of a decoder layer's self ring: min(cache_len, window)."""
    w = cfg.sliding_window
    return min(cache_len, w) if w else cache_len


class EncoderLayer(nn.Module):
    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = common.RMSNorm(cfg.d_model, **kw)
        self.attn = attn.Attention(cfg, **kw)
        self.norm2 = common.RMSNorm(cfg.d_model, **kw)
        self.mlp = common.MLP(cfg.d_model, cfg.d_ff, **kw)

    def forward(self, x, positions, cfg):
        """Bidirectional self-attention, then the MLP."""
        out, _ = attn.self_attention(self.attn, self.norm1(x, cfg.norm_eps),
                                     positions, cfg, causal=False)
        x = x + out
        return x + self.mlp(self.norm2(x, cfg.norm_eps), cfg.mlp_act)


class DecoderLayer(EncoderLayer):
    """An encoder layer's parameters plus the cross-attention's: ``normx``
    and ``xattn``."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__(cfg, device=device, dtype=dtype)
        kw = dict(device=device, dtype=dtype)
        self.normx = common.RMSNorm(cfg.d_model, **kw)
        self.xattn = attn.Attention(cfg, cross=True, **kw)

    def forward(self, x, positions, enc_kv, cfg):
        """Causal self-attention, cross-attention over ``enc_kv``, the MLP.
        Returns (x, (k, v) of the self-attention, k rotated)."""
        eps = cfg.norm_eps
        out, kv = attn.self_attention(self.attn, self.norm1(x, eps),
                                      positions, cfg,
                                      window=cfg.sliding_window)
        x = x + out
        x = x + attn.cross_attention(self.xattn, self.normx(x, eps), enc_kv,
                                     cfg)
        return x + self.mlp(self.norm2(x, eps), cfg.mlp_act), kv

    def decode(self, x1, cache, pos, cfg):
        """One token over the layer's cache entry; returns (x1, entry)."""
        eps = cfg.norm_eps
        out, ring = attn.attn_decode(self.attn, self.norm1(x1, eps),
                                     cache["self"], pos, cfg)
        x1 = x1 + out
        x1 = x1 + attn.cross_attn_decode(self.xattn, self.normx(x1, eps),
                                         cache["cross"], cfg)
        x1 = x1 + self.mlp(self.norm2(x1, eps), cfg.mlp_act)
        return x1, {"self": ring, "cross": cache["cross"]}


class EncDecModel(nn.Module):
    """tokens (B, S) over audio frame embeddings (B, F, d) -> logits (B,
    S, padded vocab)."""

    def __init__(self, cfg, *, device, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        d = cfg.d_model
        self.frontend_proj = common.param(d, d, **kw)
        self.embed = common.Embedding(cfg.vocab_size, d, **kw)
        self.enc_blocks = nn.ModuleList(
            EncoderLayer(cfg, **kw) for _ in range(cfg.encoder_layers))
        self.enc_norm = common.RMSNorm(d, **kw)
        self.dec_blocks = nn.ModuleList(
            DecoderLayer(cfg, **kw) for _ in range(cfg.num_layers))
        self.final_norm = common.RMSNorm(d, **kw)
        self.lm_head = common.Embedding(cfg.vocab_size, d, **kw)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @property
    def head_table(self) -> torch.Tensor:
        """The untied LM head, as the JAX package's step factories pick
        it."""
        return self.lm_head.table

    def loss(self, tokens, labels=None, *, audio_embeds=None, remat=False):
        """Not ported yet: training an encoder-decoder (ROADMAP.md Queue A).
        Only decoder-only models train in this port."""
        raise NotImplementedError(
            "EncDecModel.loss: training an encoder-decoder is not ported to "
            "repro_torch yet (ROADMAP.md Queue A)")

    def encode(self, audio_embeds):
        """(B, F, d) stub-frontend frames -> encoder output (B, F, d)."""
        cfg = self.cfg
        x = audio_embeds @ self.frontend_proj
        b, f, _ = x.shape
        positions = torch.arange(f, device=x.device).expand(b, f)
        for layer in self.enc_blocks:
            x = layer(x, positions, cfg)
        return self.enc_norm(x, cfg.norm_eps)

    def _out(self, x, return_hidden):
        x = self.final_norm(x, self.cfg.norm_eps)
        if return_hidden:
            return x
        return common.lm_head_apply(self.head_table, x, self.cfg.vocab_size)

    def forward(self, tokens, *, audio_embeds, collect_cache=False,
                cache_len=None, return_hidden=False):
        """Teacher-forced forward. tokens: (B, S); audio_embeds: (B, F, d).
        Returns (logits (B, S, padded vocab), or the final hidden states
        with ``return_hidden``; the cache with ``collect_cache``, else
        None). The self rings hold min(cache_len, window) slots,
        cache_len defaulting to S, filled with the last of the S
        positions from slot 0 (the JAX package's fill); the cross K/V are
        the encoder's, in the activations' dtype."""
        cfg = self.cfg
        enc_out = self.encode(audio_embeds)
        x = common.embed_apply(self.embed.table, tokens)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        w = _ring_len(cfg, cache_len or s)
        caches = []
        for layer in self.dec_blocks:
            enc_kv = attn.encode_kv(layer.xattn, enc_out, cfg)
            x, (k, v) = layer(x, positions, enc_kv, cfg)
            if collect_cache:
                ring = attn.init_kv_cache(b, w, cfg, x.dtype, x.device)
                caches.append({"self": attn.fill_kv_cache(
                    ring, k[:, -w:], v[:, -w:]), "cross": enc_kv})
        return self._out(x, return_hidden), caches if collect_cache else None

    def init_cache(self, batch, cache_len, dtype=torch.bfloat16):
        """An empty cache: each decoder layer's self ring of min(cache_len,
        window) slots and its cross K/V over ``cfg.audio_frames`` frames,
        zeros in ``dtype`` (bfloat16 by default, as the JAX package's
        ``init_cache``); ``prefill_cross`` fills the cross part."""
        cfg = self.cfg
        shape = (batch, cfg.audio_frames, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        return [{"self": attn.init_kv_cache(batch, _ring_len(cfg, cache_len),
                                            cfg, dtype, self.device),
                 "cross": tuple(torch.zeros(shape, dtype=dtype,
                                            device=self.device)
                                for _ in range(2))}
                for _ in self.dec_blocks]

    def prefill_cross(self, audio_embeds, cache):
        """Run the encoder and put each layer's cross K/V into ``cache``, in
        the encoder output's dtype, as the JAX package's ``prefill_cross``
        returns them. Returns the new cache; the rings are kept."""
        enc_out = self.encode(audio_embeds)
        return [{"self": c["self"],
                 "cross": attn.encode_kv(layer.xattn, enc_out, self.cfg)}
                for layer, c in zip(self.dec_blocks, cache)]

    def decode_step(self, tokens1, cache, pos, *, return_hidden=False):
        """tokens1: (B, 1); pos: (B,) absolute position of the new token;
        cache with its cross K/V filled (``forward(collect_cache=True)``
        or ``prefill_cross``). Returns (logits (B, 1, padded vocab), or
        the hidden states with ``return_hidden``; the new cache). The self
        rings are updated in place."""
        x = common.embed_apply(self.embed.table, tokens1)
        new = []
        for layer, c in zip(self.dec_blocks, cache):
            x, c = layer.decode(x, c, pos, self.cfg)
            new.append(c)
        return self._out(x, return_hidden), new
