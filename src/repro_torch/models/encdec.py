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

Training (``loss``, ``forward(..., remat=, with_aux=)``) runs the same
layers; with ``remat`` each encoder layer, and each decoder layer with its
cross K/V projection, goes through ``torch.utils.checkpoint`` (JAX
checkpoints the decoder's scanned layer), so its activations are
recomputed in the backward, the same bits. The model has no MoE: its aux
loss is 0. On a mesh (``mctx``) every attention and MLP of both stacks is
cut over the model ranks as the decoder's are (``attention.py``,
``common.MLP``), the embedding and head tables by rows; the cache's cross
K/V hold every KV head on every rank (gathered once where wk / wv are
cut), as ``cache_shardings`` replicates them, and each rank reads its
heads' from them. Stored FSDP (``mctx.fsdp``), each encoder layer, and
each decoder layer with its cross K/V projection, gathers its leaves over
the data ranks inside its remat region (``common.gathered``), as the
decoder-only stack does.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models.transformer import _whole_head, run_gathered


def _ring_len(cfg, cache_len):
    """Slots of a decoder layer's self ring: min(cache_len, window)."""
    w = cfg.sliding_window
    return min(cache_len, w) if w else cache_len


class EncoderLayer(nn.Module):
    def __init__(self, cfg, *, device, dtype, mctx=common.LOCAL):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = common.RMSNorm(cfg.d_model, **kw)
        self.attn = attn.Attention(cfg, mctx=mctx, **kw)
        self.norm2 = common.RMSNorm(cfg.d_model, **kw)
        self.mlp = common.MLP(cfg.d_model, cfg.d_ff, mctx=mctx, **kw)

    def forward(self, x, positions, cfg, mctx=common.LOCAL):
        """Bidirectional self-attention, then the MLP."""
        out, _ = attn.self_attention(self.attn, self.norm1(x, cfg.norm_eps),
                                     positions, cfg, causal=False, mctx=mctx)
        x = x + out
        return x + self.mlp(self.norm2(x, cfg.norm_eps), cfg.mlp_act, mctx)


class DecoderLayer(EncoderLayer):
    """An encoder layer's parameters plus the cross-attention's: ``normx``
    and ``xattn``."""

    def __init__(self, cfg, *, device, dtype, mctx=common.LOCAL):
        super().__init__(cfg, device=device, dtype=dtype, mctx=mctx)
        kw = dict(device=device, dtype=dtype)
        self.normx = common.RMSNorm(cfg.d_model, **kw)
        self.xattn = attn.Attention(cfg, cross=True, mctx=mctx, **kw)

    def forward(self, x, positions, enc_kv, cfg, mctx=common.LOCAL):
        """Causal self-attention, cross-attention over ``enc_kv``, the MLP.
        Returns (x, (k, v) of the self-attention, k rotated)."""
        eps = cfg.norm_eps
        out, kv = attn.self_attention(self.attn, self.norm1(x, eps),
                                      positions, cfg,
                                      window=cfg.sliding_window, mctx=mctx)
        x = x + out
        x = x + attn.cross_attention(self.xattn, self.normx(x, eps), enc_kv,
                                     cfg, mctx)
        return x + self.mlp(self.norm2(x, eps), cfg.mlp_act, mctx), kv

    def decode(self, x1, cache, pos, cfg, mctx=common.LOCAL):
        """One token over the layer's cache entry; returns (x1, entry)."""
        eps = cfg.norm_eps
        out, ring = attn.attn_decode(self.attn, self.norm1(x1, eps),
                                     cache["self"], pos, cfg, mctx=mctx)
        x1 = x1 + out
        x1 = x1 + attn.cross_attn_decode(self.xattn, self.normx(x1, eps),
                                         cache["cross"], cfg, mctx)
        x1 = x1 + self.mlp(self.norm2(x1, eps), cfg.mlp_act, mctx)
        return x1, {"self": ring, "cross": cache["cross"]}


def _decoder_layer(layer, store, x, positions, enc_out, cfg,
                   mctx=common.LOCAL):
    """A decoder layer with its cross K/V projected from ``enc_out`` (one
    unit of remat, as JAX's scanned layer), its FSDP leaves gathered
    through ``store`` (the model's context): (x, self (k, v), cross K/V of
    the rank's stored KV heads)."""
    with common.gathered(layer, store):
        enc_kv = attn.encode_kv(layer.xattn, enc_out, cfg, mctx)
        x, kv = layer(x, positions, enc_kv, cfg, mctx)
    return x, kv, enc_kv


class EncDecModel(nn.Module):
    """tokens (B, S) over audio frame embeddings (B, F, d) -> logits (B,
    S, padded vocab)."""

    def __init__(self, cfg, *, device, dtype=torch.float32,
                 mctx=common.LOCAL):
        super().__init__()
        self.cfg = cfg
        self.mctx = mctx
        kw = dict(device=device, dtype=dtype)
        d = cfg.d_model
        self.frontend_proj = common.param(d, d, **kw)
        self.embed = common.Embedding(cfg.vocab_size, d, mctx=mctx, **kw)
        self.enc_blocks = nn.ModuleList(
            EncoderLayer(cfg, mctx=mctx, **kw)
            for _ in range(cfg.encoder_layers))
        self.enc_norm = common.RMSNorm(d, **kw)
        self.dec_blocks = nn.ModuleList(
            DecoderLayer(cfg, mctx=mctx, **kw) for _ in range(cfg.num_layers))
        self.final_norm = common.RMSNorm(d, **kw)
        self.lm_head = common.Embedding(cfg.vocab_size, d, mctx=mctx, **kw)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @property
    def head_table(self) -> torch.Tensor:
        """The untied LM head, as the JAX package's step factories pick
        it (as stored: this rank's rows and data part)."""
        return self.lm_head.table

    def head_rows(self) -> torch.Tensor:
        """This model rank's rows of the head, gathered whole over the data
        ranks where the model stores it FSDP."""
        return common.stored(self.lm_head, "table", self.mctx)

    def loss(self, tokens, labels=None, *, audio_embeds, remat=False):
        """(ce + aux, {"ce", "aux"}), JAX ``Model.loss`` over
        ``encdec.forward``: the mean cross-entropy of the decoder's
        next-token labels (``labels`` (B, S), IGNORE where none; by
        default the tokens shifted by one, IGNORE last) over the audio
        frames ``audio_embeds`` (B, F, d); aux is 0."""
        if labels is None:
            labels = torch.cat([tokens[:, 1:], torch.full_like(
                tokens[:, :1], common.IGNORE)], dim=1)
        hidden, _, aux = self(tokens, audio_embeds=audio_embeds,
                              return_hidden=True, remat=remat, with_aux=True)
        ce = common.cross_entropy(
            common.lm_head_apply(_whole_head(self), hidden,
                                 self.cfg.vocab_size),
            labels, self.cfg.vocab_size)
        return ce + aux, {"ce": ce, "aux": aux}

    def encode(self, audio_embeds, remat=False, mctx=None):
        """(B, F, d) stub-frontend frames -> encoder output (B, F, d)."""
        cfg, mctx = self.cfg, mctx or self.mctx
        x = audio_embeds.to(self.frontend_proj.dtype) @ self.frontend_proj
        b, f, _ = x.shape
        positions = torch.arange(f, device=x.device).expand(b, f)
        for layer in self.enc_blocks:
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    run_gathered, layer, self.mctx, x, positions, cfg, mctx,
                    use_reentrant=False)
            else:
                x = run_gathered(layer, self.mctx, x, positions, cfg, mctx)
        return self.enc_norm(x, cfg.norm_eps)

    def _out(self, x, return_hidden):
        x = self.final_norm(x, self.cfg.norm_eps)
        if return_hidden:
            return x
        return common.lm_head_apply(_whole_head(self), x,
                                    self.cfg.vocab_size)

    def forward(self, tokens, *, audio_embeds, collect_cache=False,
                cache_len=None, return_hidden=False, remat=False,
                with_aux=False, mctx=None):
        """Teacher-forced forward. tokens: (B, S); audio_embeds: (B, F, d).
        Returns (logits (B, S, padded vocab), or the final hidden states
        with ``return_hidden``; the cache with ``collect_cache``, else
        None), and with ``with_aux`` a third item, the aux loss: a float32
        0, as JAX's ``encdec.forward`` returns it. The self rings hold
        min(cache_len, window) slots, cache_len defaulting to S, filled
        with the last of the S positions from slot 0 (the JAX package's
        fill); the cross K/V are the encoder's, in the activations' dtype.
        ``remat`` recomputes each layer in the backward; ``mctx`` (the
        model's own by default) may replicate the batch over the data
        axis."""
        cfg, mctx = self.cfg, mctx or self.mctx
        enc_out = self.encode(audio_embeds, remat, mctx)
        x = common.embed_apply(common.stored(self.embed, "table", self.mctx),
                               tokens, mctx)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        w = _ring_len(cfg, cache_len or s)
        caches = []
        for layer in self.dec_blocks:
            if remat:
                x, (k, v), enc_kv = torch.utils.checkpoint.checkpoint(
                    _decoder_layer, layer, self.mctx, x, positions, enc_out,
                    cfg, mctx, use_reentrant=False)
            else:
                x, (k, v), enc_kv = _decoder_layer(
                    layer, self.mctx, x, positions, enc_out, cfg, mctx)
            if collect_cache:
                ring = attn.init_kv_cache(b, w, cfg, x.dtype, x.device, mctx)
                caches.append({"self": attn.fill_kv_cache(
                    ring, k[:, -w:], v[:, -w:], mctx, layer.attn),
                    "cross": _all_kv(layer.xattn, enc_kv, mctx)})
        out = (self._out(x, return_hidden), caches if collect_cache else None)
        if with_aux:
            return out + (torch.zeros((), dtype=torch.float32,
                                      device=x.device),)
        return out

    def init_cache(self, batch, cache_len, dtype=torch.bfloat16):
        """An empty cache: each decoder layer's self ring of min(cache_len,
        window) slots and its cross K/V over ``cfg.audio_frames`` frames,
        zeros in ``dtype`` (bfloat16 by default, as the JAX package's
        ``init_cache``); ``prefill_cross`` fills the cross part."""
        cfg = self.cfg
        shape = (batch, cfg.audio_frames, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        return [{"self": attn.init_kv_cache(batch, _ring_len(cfg, cache_len),
                                            cfg, dtype, self.device,
                                            self.mctx),
                 "cross": tuple(torch.zeros(shape, dtype=dtype,
                                            device=self.device)
                                for _ in range(2))}
                for _ in self.dec_blocks]

    def prefill_cross(self, audio_embeds, cache):
        """Run the encoder and put each layer's cross K/V into ``cache``, in
        the encoder output's dtype, as the JAX package's ``prefill_cross``
        returns them. Returns the new cache; the rings are kept."""
        enc_out = self.encode(audio_embeds)
        out = []
        for layer, c in zip(self.dec_blocks, cache):
            with common.gathered(layer.xattn, self.mctx):
                kv = attn.encode_kv(layer.xattn, enc_out, self.cfg, self.mctx)
            out.append({"self": c["self"],
                        "cross": _all_kv(layer.xattn, kv, self.mctx)})
        return out

    def decode_step(self, tokens1, cache, pos, *, return_hidden=False,
                    mctx=None):
        """tokens1: (B, 1); pos: (B,) absolute position of the new token;
        cache with its cross K/V filled (``forward(collect_cache=True)``
        or ``prefill_cross``). Returns (logits (B, 1, padded vocab), or
        the hidden states with ``return_hidden``; the new cache). The self
        rings are updated in place. ``mctx`` as in ``forward``."""
        mctx = mctx or self.mctx
        x = common.embed_apply(common.stored(self.embed, "table", self.mctx),
                               tokens1, mctx)
        new = []
        for layer, c in zip(self.dec_blocks, cache):
            with common.gathered(layer, self.mctx):
                x, c = layer.decode(x, c, pos, self.cfg, mctx)
            new.append(c)
        return self._out(x, return_hidden), new


def _all_kv(p, enc_kv, mctx):
    """A cross-attention's (k, v) with every KV head, for the cache."""
    return tuple(attn.all_kv(p, t, mctx) for t in enc_kv)
