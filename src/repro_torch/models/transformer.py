"""The decoder stack: ``attn``, ``lattn`` and ``rglru`` layers, each with a
dense or MoE MLP sublayer, and the self-contained xLSTM ``mlstm`` and
``slstm`` layers; a full-sequence forward that can fill the decode cache
(with Qwen2-VL's vision embeddings and M-RoPE positions in front of the
text), and the cached one-token decode step.

Counterpart of the JAX package's ``transformer.init_params`` (the
parameter layout), ``forward``, ``vlm_positions``, ``init_cache`` and
``decode_step`` for the dense, MoE, hybrid (RecurrentGemma), SSM (xLSTM)
and VLM configs. The JAX package keeps ``first_dense_layers`` as an
unrolled prefix, stacks the rest into super-blocks of the layer pattern
for ``lax.scan`` and unrolls a remainder as a tail; here every layer is
an entry of one ``nn.ModuleList`` run by a Python loop. Parameter names
follow the JAX tree (``layers.{i}.attn.wq`` is
``blocks[k]["attn"]["wq"][sb]`` for layer i = prefix + sb * len(pattern)
+ k), so ``models.model.params_from_jax`` can map one onto the other. The
cache is a list with one entry per layer: a ring KV cache for
``attn``/``lattn``, the (h, conv tail) state for ``rglru``, the float32
cell states for ``mlstm`` / ``slstm``.

Training (``Model.loss``, ``forward(..., with_aux=True)``) runs the same
layers and sums the MoE layers' load-balance losses, as the JAX ``forward``
returns them. With ``remat`` each layer's forward goes through
``torch.utils.checkpoint.checkpoint`` (non-reentrant): its activations
are dropped and recomputed in the backward, JAX's ``jax.checkpoint(...,
nothing_saveable)`` per super-block taken a layer at a time. The
recompute repeats the forward's bits (the kernels and the MoE dispatch
are deterministic), so the gradients are those of no remat.

On a mesh the model is built for one rank (``mctx``, a
``common.MeshContext``) and holds that rank's part of each layer
(``models.layout``): its attention heads, MLP columns, RG-LRU
channels, experts (``moe.py``) and embedding rows, split over the model
group; ``forward`` and ``decode_step`` take the rank's rows of the batch.
The xLSTM blocks, the norms and the router are whole on every rank. The
caches hold the rank's part too: a ring's slots where the model ranks
divide them (``attention.py``), an RG-LRU state's channels.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import common, moe, recurrent, xlstm

KINDS = ("attn", "lattn", "rglru", "mlstm", "slstm")
# the self-contained xLSTM layers (no MLP sublayer): (prefill, decode)
XLSTM_BLOCKS = {"mlstm": (xlstm.mlstm_block, xlstm.mlstm_block_decode),
                "slstm": (xlstm.slstm_block, xlstm.slstm_block_decode)}


def _window_for(cfg, kind):
    if kind == "lattn":
        return cfg.local_attn_window
    return cfg.sliding_window  # None for full attention


def _cache_len_for(cfg, kind, cache_len):
    w = _window_for(cfg, kind)
    return min(cache_len, w) if w else cache_len


class DecoderLayer(nn.Module):
    """Layer ``index`` of the stack: its mixer, then the MLP sublayer where
    the config has one, MoE from layer ``cfg.first_dense_layers`` on (an
    xLSTM layer has none)."""

    def __init__(self, cfg, kind, index, *, device, dtype, mctx=common.LOCAL):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(kind)
        kw = dict(device=device, dtype=dtype)
        self.kind = kind
        self.norm1 = common.RMSNorm(cfg.d_model, **kw)
        if kind == "rglru":
            self.rglru = recurrent.RGLRU(cfg, mctx=mctx, **kw)
        elif kind == "mlstm":
            self.mlstm = xlstm.MLSTM(cfg, **kw)
        elif kind == "slstm":
            self.slstm = xlstm.SLSTM(cfg, **kw)
        else:
            self.attn = attn.Attention(cfg, mctx=mctx, **kw)
        if (cfg.d_ff or cfg.is_moe) and kind not in XLSTM_BLOCKS:
            self.norm2 = common.RMSNorm(cfg.d_model, **kw)
            if cfg.is_moe and index >= cfg.first_dense_layers:
                self.moe = moe.MoE(cfg, mctx=mctx, **kw)
            else:
                self.mlp = common.MLP(cfg.d_model, cfg.d_ff, mctx=mctx, **kw)

    def _mlp(self, x, cfg, with_aux=False, mctx=common.LOCAL):
        """(x after the MLP sublayer, the MoE load-balance loss times its
        coefficient where ``with_aux`` and the layer is MoE, else None)."""
        if hasattr(self, "moe"):
            h = self.norm2(x, cfg.norm_eps)
            if with_aux:
                y, aux = moe.moe_apply(self.moe, h, cfg, mctx,
                                       return_aux=True)
                return x + y, aux
            return x + self.moe(h, cfg, mctx), None
        if hasattr(self, "mlp"):
            return x + self.mlp(self.norm2(x, cfg.norm_eps), cfg.mlp_act,
                                mctx), None
        return x, None

    def forward(self, x, positions, cfg, *, pos3=None, collect_cache=False,
                cache_len=None, with_aux=False, mctx=common.LOCAL):
        """Returns (x, cache entry or None, the layer's MoE aux loss where
        ``with_aux`` and the layer is MoE, else None)."""
        h = self.norm1(x, cfg.norm_eps)
        cache = None
        if self.kind == "rglru":
            out, state = recurrent.rglru_block(self.rglru, h, mctx=mctx)
            if collect_cache:
                cache = state
        elif self.kind in XLSTM_BLOCKS:
            out, state = XLSTM_BLOCKS[self.kind][0](
                getattr(self, self.kind), h, cfg)
            if collect_cache:
                cache = state
        else:
            out, (k, v) = attn.self_attention(
                self.attn, h, positions, cfg,
                window=_window_for(cfg, self.kind), pos3=pos3, mctx=mctx)
            if collect_cache:
                w = _cache_len_for(cfg, self.kind, cache_len)
                cache = attn.fill_kv_cache(
                    attn.init_kv_cache(x.shape[0], w, cfg, x.dtype, x.device,
                                       mctx),
                    k, v, mctx, self.attn)
        x, aux = self._mlp(x + out, cfg, with_aux, mctx)
        return x, cache, aux

    def decode(self, x1, cache, pos, cfg, *, pos3=None, mctx=common.LOCAL):
        """One token. Returns (x1, new cache entry)."""
        h = self.norm1(x1, cfg.norm_eps)
        if self.kind == "rglru":
            out, cache = recurrent.rglru_decode(self.rglru, h, cache, mctx)
        elif self.kind in XLSTM_BLOCKS:
            out, cache = XLSTM_BLOCKS[self.kind][1](
                getattr(self, self.kind), h, cfg, cache)
        else:
            out, cache = attn.attn_decode(self.attn, h, cache, pos, cfg,
                                          pos3=pos3, mctx=mctx)
        return self._mlp(x1 + out, cfg, mctx=mctx)[0], cache


class Model(nn.Module):
    """Decoder: tokens (B, S) -> logits (B, S, padded vocab). ``mctx``: the
    rank of a mesh it is built for (``LOCAL``: one card)."""

    def __init__(self, cfg, *, device, dtype=torch.float32,
                 mctx=common.LOCAL):
        super().__init__()
        self.cfg = cfg
        self.mctx = mctx
        kw = dict(device=device, dtype=dtype)
        self.embed = common.Embedding(cfg.vocab_size, cfg.d_model,
                                      mctx=mctx, **kw)
        self.final_norm = common.RMSNorm(cfg.d_model, **kw)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, kind, i, mctx=mctx, **kw)
            for i, kind in enumerate(cfg.pattern))
        if not cfg.tie_embeddings:
            self.lm_head = common.Embedding(cfg.vocab_size, cfg.d_model,
                                            mctx=mctx, **kw)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    @property
    def head_table(self) -> torch.Tensor:
        return (self.embed if self.cfg.tie_embeddings else self.lm_head).table

    def _out(self, x, return_hidden):
        x = self.final_norm(x, self.cfg.norm_eps)
        return x if return_hidden else self.head(x)

    def _embed(self, tokens, vision_embeds, mctx):
        """(x (B, S, d), positions (B, S), M-RoPE ids (3, B, S) or None),
        the vision embeddings in front of the text where given."""
        x = common.embed_apply(self.embed.table, tokens, mctx)
        b = x.shape[0]
        pos3 = None
        if vision_embeds is not None:
            x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
            pos3 = vlm_positions(b, vision_embeds.shape[1], tokens.shape[1],
                                 x.device)
        s = x.shape[1]
        return x, torch.arange(s, device=x.device).expand(b, s), pos3

    def forward(self, tokens, *, vision_embeds=None, collect_cache=False,
                cache_len=None, return_hidden=False, remat=False,
                with_aux=False, mctx=None):
        """tokens: (B, S_text); vision_embeds: (B, V, d) or None, which
        makes the sequence [vision | text] with M-RoPE positions
        (``vlm_positions``). Returns (logits (B, S, padded vocab), or the
        final hidden states (B, S, d) with ``return_hidden``; the cache
        for ``decode_step`` with ``collect_cache``, else None), S = V +
        S_text. The attention caches hold min(cache_len, window) slots,
        cache_len defaulting to S. With ``with_aux`` a third item, the MoE
        layers' load-balance losses summed (a float32 scalar, 0 without
        MoE), as JAX ``forward`` returns it; ``remat`` recomputes each
        layer's activations in the backward. ``mctx`` (the model's own by
        default) may replicate the batch over the data axis
        (``MeshContext.replicated``)."""
        cfg = self.cfg
        mctx = mctx or self.mctx
        x, positions, pos3 = self._embed(tokens, vision_embeds, mctx)
        kw = dict(pos3=pos3, collect_cache=collect_cache,
                  cache_len=cache_len or x.shape[1], with_aux=with_aux,
                  mctx=mctx)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device) \
            if with_aux else None
        caches = []
        for layer in self.layers:
            if remat:
                x, c, aux = torch.utils.checkpoint.checkpoint(
                    layer, x, positions, cfg, use_reentrant=False, **kw)
            else:
                x, c, aux = layer(x, positions, cfg, **kw)
            if aux is not None:
                aux_total = aux_total + aux
            caches.append(c)
        out = (self._out(x, return_hidden), caches if collect_cache else None)
        return out + (aux_total,) if with_aux else out

    def head(self, hidden):
        """Logits over the padded vocab of final hidden states (one card:
        over model ranks the step factories' vocab-parallel heads take
        the rank's rows)."""
        return common.lm_head_apply(_whole_head(self), hidden,
                                    self.cfg.vocab_size)

    def loss(self, tokens, labels=None, *, vision_embeds=None, remat=False):
        """(ce + aux, {"ce", "aux"}), JAX ``Model.loss``: the mean
        cross-entropy of the next-token labels (``labels`` (B, S_text),
        IGNORE where none; by default the tokens shifted by one) plus the
        MoE aux loss. A VLM's vision prefix takes no part in the CE."""
        if labels is None:
            labels = torch.cat([tokens[:, 1:], torch.full_like(
                tokens[:, :1], common.IGNORE)], dim=1)
        hidden, _, aux = self(tokens, vision_embeds=vision_embeds,
                              return_hidden=True, remat=remat, with_aux=True)
        if hidden.shape[1] != labels.shape[1]:
            hidden = hidden[:, -labels.shape[1]:]
        ce = common.cross_entropy(self.head(hidden), labels,
                                  self.cfg.vocab_size)
        return ce + aux, {"ce": ce, "aux": aux}

    def init_cache(self, batch, cache_len, dtype=torch.bfloat16):
        """An empty cache: rings of min(cache_len, window) slots and conv
        tails in ``dtype``, zero float32 recurrent states (the xLSTM
        cells' float32 whatever ``dtype`` is, the sLSTM's m at
        -GATE_CLAMP). bfloat16 by default, as the JAX package's
        ``init_cache``: an f32 model decodes over it in f32 (the
        decode-attention kernel widens the rings as it loads them; the
        first step's conv tail comes back f32, as JAX's does)."""
        cfg, dev = self.cfg, self.device
        d = cfg.d_model

        def entry(kind, layer):
            if kind == "rglru":
                return recurrent.rglru_init_state(
                    batch, layer.rglru.w_out.shape[0], dtype, dev)
            if kind == "mlstm":
                return xlstm.mlstm_init_state(batch, cfg.num_heads,
                                              d // cfg.num_heads, dev)
            if kind == "slstm":
                return xlstm.slstm_init_state(batch, d, cfg.slstm_num_heads,
                                              dev)
            return attn.init_kv_cache(
                batch, _cache_len_for(cfg, kind, cache_len), cfg, dtype, dev,
                self.mctx)
        return [entry(layer.kind, layer) for layer in self.layers]

    def decode_step(self, tokens1, cache, pos, *, return_hidden=False,
                    mctx=None):
        """tokens1: (B, 1); pos: (B,) absolute position of the new token.
        Returns (logits (B, 1, padded vocab), or the hidden states with
        ``return_hidden``; the new cache). The attention rings are
        updated in place."""
        cfg = self.cfg
        mctx = mctx or self.mctx
        x = common.embed_apply(self.embed.table, tokens1, mctx)
        # M-RoPE decodes at the absolute position on all three axes, as the
        # JAX package does (its prefill starts the text at the grid size)
        pos3 = pos[None, :, None].expand(3, -1, 1) if cfg.mrope_sections \
            else None
        new = []
        for layer, c in zip(self.layers, cache):
            x, c = layer.decode(x, c, pos, cfg, pos3=pos3, mctx=mctx)
            new.append(c)
        return self._out(x, return_hidden), new


def _whole_head(model):
    """The model's head table, which must be whole: a model of a rank of a
    mesh holds its rows only, and its logits go through the step
    factories' vocab-parallel heads."""
    if model.mctx.model_size > 1:
        raise ValueError("a model built for a mesh holds its rank's rows of "
                         "the head: use launch.distributed's steps "
                         "(vocab_parallel_ce / vocab_parallel_bvsb)")
    return model.head_table


def vlm_positions(b, v, s_text, device=None):
    """M-RoPE position ids (3, B, V + S_text): the V vision embeddings on
    a g x g grid (g = max(int(sqrt(V)), 1); t 0, h = i // g, w = i % g),
    then the text at g, g + 1, ... on all three axes."""
    g = max(int(v ** 0.5), 1)
    idx = torch.arange(v, device=device)
    tix = g + torch.arange(s_text, device=device)
    pos = torch.stack([torch.cat([torch.zeros_like(idx), tix]),
                       torch.cat([idx // g, tix]),
                       torch.cat([idx % g, tix])])
    return pos[:, None, :].expand(3, b, v + s_text)
