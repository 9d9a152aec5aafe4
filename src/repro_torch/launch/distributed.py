"""Train, prefill and decode step factories: the zoo's training and
serving entry points on one card.

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

The train step is the JAX ``make_train_step`` on one card: the forward
with ``remat`` (each layer recomputed in the backward), the loss through
``head_ce`` (the one-card ``vocab_parallel_ce``), gradients accumulated
over ``accum_steps`` slices of the batch as JAX's scan accumulates them
(here a loop), then one AdamW update of the model's parameters in place:

    step = make_train_step(model, remat=True, accum_steps=1)
    opt_state = optimizer.init(trainable(model))
    opt_state, metrics = step(opt_state, {"tokens": t, "labels": l})
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import IGNORE
from repro_torch.training import optimizer as opt
from repro_torch.training.trainer import (accumulate, grads_of, to_device,
                                          trainable)

# what the JAX package's vocab-parallel heads write into padded columns
PAD_LOGIT = -1e30


def head_ce(hidden, table, labels, vocab_size: int):
    """hidden (B, S, d), table (PV, d), labels (B, S) -> the mean
    cross-entropy over labels != -100: the one-card form of
    ``vocab_parallel_ce`` (its pmax and psums over the vocab shards are
    the identity here). Padded columns are set to -1e30; the max
    stabiliser carries no gradient. The head's product stays
    ``torch.matmul``, as JAX leaves it to XLA."""
    logits = hidden.float() @ table.float().T                 # (B, S, PV)
    if table.shape[0] != vocab_size:
        pad = torch.arange(table.shape[0], device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, PAD_LOGIT)
    m = logits.detach().amax(dim=-1)
    z = torch.exp(logits - m[..., None]).sum(-1)
    mask = labels != IGNORE
    safe = torch.where(mask, labels, 0).long()
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (m + torch.log(z) - gold) * mask
    return nll.sum() / torch.clamp(mask.sum().float(), min=1.0)


def default_accum_steps(n_params: float, global_batch: int,
                        data_shards: int) -> int:
    """Gradient-accumulation depth: keeps per-device live activations of
    the layer-remat carry within HBM for the big dense configs."""
    if global_batch < 2 * data_shards:
        return 1
    per = 8 if n_params > 2e10 else (4 if n_params > 4e9 else 1)
    while global_batch % (per * data_shards) != 0 and per > 1:
        per //= 2
    return per


def make_loss_fn(model, *, remat: bool = True):
    """``loss_fn(batch) -> (ce + aux, {"ce", "aux"})``, the train step's
    loss: the forward (``remat``: each layer recomputed in the backward),
    then ``head_ce`` over the text positions (a VLM's vision prefix
    dropped). ``batch``: tokens and labels (B, S) on the model's device,
    and a VLM's ``vision_embeds``."""
    cfg = model.cfg

    def loss_fn(batch):
        labels = batch["labels"]
        hidden, _, aux = model(
            batch["tokens"], vision_embeds=batch.get("vision_embeds"),
            return_hidden=True, remat=remat, with_aux=True)
        if hidden.shape[1] != labels.shape[1]:  # vlm: vision prefix
            hidden = hidden[:, -labels.shape[1]:]
        ce = head_ce(hidden, model.head_table, labels, cfg.vocab_size)
        return ce + aux, {"ce": ce, "aux": aux}

    return loss_fn


def make_train_step(model, *, remat: bool = True, accum_steps: int = 1,
                    adamw: opt.AdamWConfig = opt.AdamWConfig()):
    """``train_step(opt_state, batch) -> (opt_state, metrics)`` on the
    model's device (metrics: loss, ce, aux, grad_norm, lr as 0-d
    tensors). ``batch``: tokens and labels (B, S), and a VLM's
    ``vision_embeds``, whose prefix takes no part in the loss. The model's
    parameters are made trainable and updated in place; ``opt_state`` is
    ``optimizer.init(trainable(model))``."""
    params = trainable(model)
    loss_fn = make_loss_fn(model, remat=remat)

    def train_step(opt_state, batch):
        batch = to_device(batch, model.device)
        if accum_steps <= 1:
            loss, metrics, grads = grads_of(loss_fn, params, batch)
        else:
            loss, metrics, grads = accumulate(loss_fn, params, batch,
                                              accum_steps)
        _, opt_state, om = opt.update(params, grads, opt_state, adamw)
        return opt_state, {"loss": loss, **metrics, **om}

    return train_step


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
