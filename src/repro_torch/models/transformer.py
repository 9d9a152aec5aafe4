"""The dense decoder: ``attn`` layers, full-sequence forward, no cache.

Counterpart of the JAX package's ``transformer.init_params`` (the
parameter layout) and ``transformer.forward`` for dense configs. The JAX
package stacks its layers along a leading axis for ``lax.scan``; here
they are an ``nn.ModuleList`` run by a Python loop. Parameter names
follow the JAX tree (``layers.{i}.attn.wq`` is ``blocks[0]["attn"]["wq"][i]``),
so ``models.model.params_from_jax`` can map one onto the other.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import common


class DecoderLayer(nn.Module):
    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = common.RMSNorm(cfg.d_model, **kw)
        self.attn = attn.Attention(cfg, **kw)
        if cfg.d_ff:
            self.norm2 = common.RMSNorm(cfg.d_model, **kw)
            self.mlp = common.MLP(cfg.d_model, cfg.d_ff, **kw)

    def forward(self, x, positions, cfg):
        h = self.norm1(x, cfg.norm_eps)
        x = x + attn.self_attention(self.attn, h, positions, cfg,
                                    window=cfg.sliding_window)
        if cfg.d_ff:
            x = x + self.mlp(self.norm2(x, cfg.norm_eps), cfg.mlp_act)
        return x


class Model(nn.Module):
    """Dense decoder: tokens (B, S) -> logits (B, S, padded vocab)."""

    def __init__(self, cfg, *, device, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embed = common.Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.final_norm = common.RMSNorm(cfg.d_model, **kw)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, **kw) for _ in range(cfg.num_layers))
        if not cfg.tie_embeddings:
            self.lm_head = common.Embedding(cfg.vocab_size, cfg.d_model, **kw)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def forward(self, tokens):
        cfg = self.cfg
        x = common.embed_apply(self.embed.table, tokens)
        b, s = tokens.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        for layer in self.layers:
            x = layer(x, positions, cfg)
        x = self.final_norm(x, cfg.norm_eps)
        head = self.embed if cfg.tie_embeddings else self.lm_head
        return common.lm_head_apply(head.table, x, cfg.vocab_size)
