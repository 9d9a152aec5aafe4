"""Prefill and decode step factories: the zoo's serving entry point on one
card.

Counterpart of the JAX package's ``launch/distributed.py``
``make_prefill_step`` and ``make_serve_step``. A prefill runs the prompts
through the model once, fills the decode cache and returns the paper's
forwarding inputs for the last position: BvSB confidence and top-1
(Eq. 2). A serve step decodes ONE new token per request over that cache
and returns the same two. The JAX package shards the LM head over the
vocab and merges per-shard (max, runner-up, sum) across its model axis
(``vocab_parallel_bvsb``); on one card that merge is the identity, so
the head's product for the last position only goes to ``torch.matmul``
(as JAX leaves it to XLA outside any kernel) and the margin to
``ops.bvsb``. No (B, S, V) logits are ever built.

    prefill = make_prefill_step(model)
    serve = make_serve_step(model)
    conf, top1, cache = prefill(tokens, cache_len)       # tokens (B, S)
    conf, top1, cache = serve(top1[:, None], cache, pos)  # pos (B,)

An encoder-decoder model's prefill also takes the audio frame
embeddings (``prefill(tokens, audio_embeds=a)``, a (B, F, d)), as the JAX
step takes ``batch["audio_embeds"]``; its serve step is the same call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

# what the JAX package's vocab-parallel BvSB writes into padded columns
PAD_LOGIT = -1e30


def head_bvsb(hidden, table, vocab_size: int):
    """hidden: (B, 1, d) final hidden states -> (bvsb (B,) f32, top1 (B,)
    int32): the one-card form of ``vocab_parallel_bvsb``."""
    logits = hidden[:, 0, :].float() @ table.float().T        # (B, PV)
    if table.shape[0] != vocab_size:
        pad = torch.arange(table.shape[0], device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, PAD_LOGIT)
    return ops.bvsb(logits)


def make_prefill_step(model):
    """``prefill_step(tokens (B, S), cache_len=None, vision_embeds=None,
    audio_embeds=None) -> (conf, top1, cache)``. ``vision_embeds`` (B, V,
    d) go in front of the text (the JAX step's
    ``batch["vision_embeds"]``); ``audio_embeds`` (B, F, d) are an
    encoder-decoder's encoder input (``batch["audio_embeds"]``). The
    attention caches hold min(cache_len or V + S, window) slots, so a
    caller that decodes n tokens past a full-attention prompt passes
    cache_len >= V + S + n."""
    cfg = model.cfg

    def prefill_step(tokens, cache_len=None, vision_embeds=None,
                     audio_embeds=None):
        inputs = {"vision_embeds": vision_embeds} if audio_embeds is None \
            else {"audio_embeds": audio_embeds}
        with torch.inference_mode():
            hidden, cache = model(tokens, collect_cache=True,
                                  cache_len=cache_len, return_hidden=True,
                                  **inputs)
            conf, top1 = head_bvsb(hidden[:, -1:, :], model.head_table,
                                   cfg.vocab_size)
        return conf, top1, cache

    return prefill_step


def make_serve_step(model):
    """``serve_step(tokens1 (B, 1), cache, pos (B,)) -> (conf, top1,
    cache)``: one decode token per request; ``pos`` is the absolute
    position of that token."""
    cfg = model.cfg

    def serve_step(tokens1, cache, pos):
        with torch.inference_mode():
            hidden, cache = model.decode_step(tokens1, cache, pos,
                                              return_hidden=True)
            conf, top1 = head_bvsb(hidden, model.head_table, cfg.vocab_size)
        return conf, top1, cache

    return serve_step
