"""Train, prefill and decode step factories: the zoo's training and
serving entry points, on one card or over a (data, model) mesh.

Counterpart of the JAX package's ``launch/distributed.py``. A prefill
runs the prompts through the model once, fills the decode cache and
returns the paper's forwarding inputs for the last position: BvSB
confidence and top-1 (Eq. 2). A serve step decodes ONE new token per
request over that cache and returns the same two. The train step is the
forward with ``remat`` (each layer recomputed in the backward), the
cross-entropy over the head, gradients accumulated over ``accum_steps``
slices of the batch as JAX's scan accumulates them (here a loop), then
one AdamW update of the model's parameters in place. No (B, S, V)
logits are gathered anywhere.

    prefill = make_prefill_step(model)
    serve = make_serve_step(model)
    conf, top1, cache = prefill(tokens, cache_len)       # tokens (B, S)
    conf, top1, cache = serve(top1[:, None], cache, pos)  # pos (B,)
    step = make_train_step(model, remat=True, accum_steps=1)
    opt_state = optimizer.init(trainable(model))
    opt_state, metrics = step(opt_state, {"tokens": t, "labels": l})

An encoder-decoder model's prefill also takes the audio frame
embeddings (``prefill(tokens, audio_embeds=a)``, a (B, F, d)), and its
train batch ``audio_embeds``, as the JAX steps take
``batch["audio_embeds"]``.

On one card (``mesh=None``) the head's product for the last position
goes to ``torch.matmul`` and the margin to ``ops.bvsb`` (``head_bvsb``),
the loss to ``head_ce``. On a mesh (``launch.mesh.make_model_mesh``,
every rank calling the same step with the same global arrays and a model
built with ``mesh=``) the steps run the JAX package's three parallel
regions:

* the layers' tensor parallelism: attention heads, MLP features,
  RG-LRU channels, xLSTM heads, the MoE layers' experts, the embedding's
  rows, and decode attention over a ring cut on its slots (``models/``,
  ``launch/shardings.py``);
* ``vocab_parallel_ce``: model rank j holds rows [j PV/m, (j+1) PV/m) of
  the head, a max over the model group, z and the gold logit summed over
  it, the labels' count over the data group;
* ``vocab_parallel_bvsb``: over more than one model rank, the BvSB
  kernel's partial entry on the rank's columns, the (m1, m2, z, index)
  tuples gathered over the model group in rank order and merged by its
  merge entry (one-device semantics).

The batch is split over the data axis: each rank takes its rows, and the
prefill and serve steps return conf and top-1 of the whole batch on every
rank (gathered exactly: zeros elsewhere, summed), the cache of its own
rows. A batch the data axis does not divide is replicated over it, as
the JAX serve step's ``eff_batch_axes``. The train step sums the
gradients over the data group (``training.trainer.all_reduce_grads``).
Gathers are all_reduce sums of zero-filled buffers, since ``gloo`` (ranks
sharing one card) reduces CUDA tensors but does not gather them.

A model built with ``fsdp=True`` (``param_shardings(fsdp=True)``, the
JAX train step's placement) stores each matrix's other dim over the data
ranks; the steps run it unchanged. Each layer gathers its leaves over the
data group when it runs (inside its remat region, so the backward gathers
again), the head's table is gathered where the CE and BvSB read it
(``head_rows``), and the gradients of those leaves come out of the
gathers' backward already summed over the data group and cut to the
rank's shard (ZeRO-3's reduce-scatter), so ``all_reduce_grads`` skips
them and AdamW's moments live on the shard. Serving usually keeps
``fsdp=False`` (weights resident, no gathers on the decode path); an
FSDP model's prefill and serve steps gather a layer at a time too, under
``inference_mode``, as JAX's ``--serve-fsdp`` baseline places it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.models.common import IGNORE, LOCAL, mesh_context
from repro_torch.models.model import data_parts, model_parts
from repro_torch.training import optimizer as opt
from repro_torch.training.trainer import (accumulate, all_reduce_grads,
                                          data_rows, grads_of,
                                          mesh_grad_norm, model_inputs,
                                          to_device, trainable)

# what the JAX package's vocab-parallel heads write into padded columns
PAD_LOGIT = -1e30


def _shard_logits(h, table, mctx, vocab_size):
    """f32 logits of ``h`` (..., d) over ``table``, this rank's rows of the
    head (the model's own: ``common.Embedding`` holds them), the columns
    past the vocabulary at PAD_LOGIT; and the first column."""
    vloc = table.shape[0]
    v0 = mctx.model_rank * vloc
    logits = h.float() @ table.float().T
    if v0 + vloc > vocab_size:
        pad = torch.arange(v0, v0 + vloc, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, PAD_LOGIT)
    return logits, v0


def vocab_parallel_ce(hidden, table, labels, mctx, vocab_size: int):
    """hidden (B, S, d) and labels (B, S), this data rank's rows; table
    (PV/m, d), this rank's rows [j PV/m, (j+1) PV/m) of the head -> the
    mean cross-entropy over the global batch's labels != -100, JAX's
    ``vocab_parallel_ce``. ``hidden`` enters through
    ``MeshContext.into_model`` (its gradient summed over the model group);
    padded columns are -1e30; the max
    stabiliser carries no gradient and is a MAX over the model group; z
    and the gold logit are summed over it (``out_of_model``), the loss's
    numerator and the labels' count over the data group. The head's
    product stays ``torch.matmul``, as JAX leaves it to XLA."""
    logits, v0 = _shard_logits(mctx.into_model(hidden), table, mctx,
                               vocab_size)
    vloc = logits.shape[-1]
    m = mctx.all_reduce_model(logits.detach().amax(dim=-1),
                              dist.ReduceOp.MAX)
    z = mctx.out_of_model(torch.exp(logits - m[..., None]).sum(-1))
    mask = labels != IGNORE
    safe = torch.where(mask, labels, 0).long()
    inrange = (safe >= v0) & (safe < v0 + vloc)
    loc = torch.clamp(safe - v0, 0, vloc - 1)
    gold = torch.gather(logits, -1, loc[..., None])[..., 0]
    gold = mctx.out_of_model(torch.where(inrange, gold, 0.0))
    nll = (m + torch.log(z) - gold) * mask
    num = mctx.sum_data(nll.sum())
    den = mctx.all_reduce_data(mask.sum().float())
    return num / torch.clamp(den, min=1.0)


def head_ce(hidden, table, labels, vocab_size: int):
    """The one-card ``vocab_parallel_ce``: its collectives the identity."""
    return vocab_parallel_ce(hidden, table, labels, LOCAL, vocab_size)


def vocab_parallel_bvsb(hidden, table, mctx, vocab_size: int):
    """hidden (B, 1, d), this data rank's rows; table (PV/m, d), this
    rank's rows of the head -> (bvsb (B,) f32, top1 (B,) int32) of those
    rows, Eq. 2 over the whole vocabulary
    with no (B, PV) logits gathered: the BvSB kernel's partial entry folds
    the rank's columns into (m1, m2, z, global index) tuples, gathered over
    the model group in rank order, and its merge entry merges them. With
    one model rank the whole row goes to ``ops.bvsb``, one launch."""
    logits, v0 = _shard_logits(hidden[:, 0, :], table, mctx, vocab_size)
    if mctx.model_size == 1:
        return ops.bvsb(logits)
    parts = ops.bvsb_partials(logits, v0)                     # (B, 4)
    buf = parts.new_zeros(parts.shape[0], mctx.model_size, 4)
    buf[:, mctx.model_rank] = parts
    return ops.bvsb_merge(mctx.all_reduce_model(buf))


def head_bvsb(hidden, table, vocab_size: int):
    """hidden: (B, 1, d) final hidden states -> (bvsb (B,) f32, top1 (B,)
    int32): the one-card ``vocab_parallel_bvsb``."""
    return vocab_parallel_bvsb(hidden, table, LOCAL, vocab_size)


def gather_rows(conf, top1, mctx, b: int):
    """The whole batch's (conf (b,), top1 (b,)) on every data rank from
    each rank's rows: a zeroed (b, 2) f32 buffer, the rank's rows filled
    (top-1 as a float, exact below 2^24), summed over the data group."""
    if mctx.data_size == 1:
        return conf, top1
    buf = conf.new_zeros(b, 2)
    rows = mctx.data_rows(b)
    buf[rows, 0] = conf
    buf[rows, 1] = top1.float()
    mctx.all_reduce_data(buf)
    return buf[:, 0].contiguous(), buf[:, 1].to(torch.int32)


def _batch_context(mctx, b: int):
    """The mesh context for a global batch of ``b``: split over the data
    axis where it divides b (and b is at least its size), else
    replicated, the JAX serve step's ``eff_batch_axes``."""
    if mctx.data_size > 1 and (b % mctx.data_size or b < mctx.data_size):
        return mctx.replicated()
    return mctx


def _context(model, mesh):
    mctx = mesh_context(mesh)
    if mctx.model_size != model.mctx.model_size or \
            mctx.model_rank != model.mctx.model_rank:
        raise ValueError("the model was built for another mesh: build it "
                         "with build_model / init_params(..., mesh=mesh)")
    return mctx


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


def make_loss_fn(model, *, remat: bool = True, mctx=LOCAL):
    """``loss_fn(batch) -> (ce + aux, {"ce", "aux"})``, the train step's
    loss: the forward (``remat``: each layer recomputed in the backward),
    then ``vocab_parallel_ce`` over the text positions (a VLM's vision
    prefix dropped). ``batch``: this data rank's tokens and labels (B, S)
    on the model's device, and a VLM's ``vision_embeds`` or an
    encoder-decoder's ``audio_embeds``. On a mesh the loss and aux are
    the global batch's on every rank."""
    cfg = model.cfg

    def loss_fn(batch):
        labels = batch["labels"]
        hidden, _, aux = model(
            batch["tokens"], return_hidden=True, remat=remat, with_aux=True,
            mctx=mctx, **model_inputs(model, batch))
        if hidden.shape[1] != labels.shape[1]:  # vlm: vision prefix
            hidden = hidden[:, -labels.shape[1]:]
        ce = vocab_parallel_ce(hidden, model.head_rows(), labels, mctx,
                               cfg.vocab_size)
        return ce + aux, {"ce": ce, "aux": aux}

    return loss_fn


def make_train_step(model, mesh=None, *, remat: bool = True,
                    accum_steps: int = 1,
                    adamw: opt.AdamWConfig = opt.AdamWConfig()):
    """``train_step(opt_state, batch) -> (opt_state, metrics)`` on the
    model's device (metrics: loss, ce, aux, grad_norm, lr as 0-d
    tensors). ``batch``: the global batch's tokens and labels (B, S), and
    a VLM's ``vision_embeds`` (its prefix takes no part in the loss) or an
    encoder-decoder's ``audio_embeds``. The model's parameters are made
    trainable and updated in place; ``opt_state`` is
    ``optimizer.init(trainable(model))``. On a mesh each rank takes its
    rows (with ``accum_steps``, its share of each global microbatch), and
    the gradients are summed over the data group before the update (an
    FSDP leaf's already by its gather's backward), the clipping norm over
    the whole model (``mesh_grad_norm``)."""
    mctx = _context(model, mesh)
    params = trainable(model)
    loss_fn = make_loss_fn(model, remat=remat, mctx=mctx)
    sharded, fsdp = set(model_parts(model)), set(data_parts(model))

    def train_step(opt_state, batch):
        batch = to_device(batch, model.device)
        if accum_steps <= 1:
            loss, metrics, grads = grads_of(loss_fn, params,
                                            data_rows(batch, mctx))
        else:
            loss, metrics, grads = accumulate(loss_fn, params, batch,
                                              accum_steps, mctx)
        all_reduce_grads(grads, mctx, fsdp)
        _, opt_state, om = opt.update(params, grads, opt_state, adamw,
                                      mesh_grad_norm(grads, sharded, mctx,
                                                     fsdp))
        return opt_state, {"loss": loss, **metrics, **om}

    return train_step


def make_prefill_step(model, mesh=None):
    """``prefill_step(tokens (B, S), cache_len=None, vision_embeds=None,
    audio_embeds=None) -> (conf, top1, cache)``. ``vision_embeds`` (B, V,
    d) go in front of the text (the JAX step's
    ``batch["vision_embeds"]``); ``audio_embeds`` (B, F, d) are an
    encoder-decoder's encoder input (``batch["audio_embeds"]``). The
    attention caches hold min(cache_len or V + S, window) slots, so a
    caller that decodes n tokens past a full-attention prompt passes
    cache_len >= V + S + n. On a mesh the arrays are the global batch's,
    conf and top-1 come back for all B rows on every rank, and the cache
    holds this rank's rows (all B where the data axis does not divide
    B)."""
    cfg = model.cfg
    mctx = _context(model, mesh)

    def prefill_step(tokens, cache_len=None, vision_embeds=None,
                     audio_embeds=None):
        b = tokens.shape[0]
        ctx = _batch_context(mctx, b)
        rows = ctx.data_rows(b)
        inputs = {"vision_embeds": vision_embeds} if audio_embeds is None \
            else {"audio_embeds": audio_embeds}
        inputs = {k: None if v is None else v[rows] for k, v in inputs.items()}
        with torch.inference_mode():
            hidden, cache = model(tokens[rows], collect_cache=True,
                                  cache_len=cache_len, return_hidden=True,
                                  mctx=ctx, **inputs)
            conf, top1 = vocab_parallel_bvsb(hidden[:, -1:, :],
                                             model.head_rows(), ctx,
                                             cfg.vocab_size)
            conf, top1 = gather_rows(conf, top1, ctx, b)
        return conf, top1, cache

    return prefill_step


def make_serve_step(model, mesh=None):
    """``serve_step(tokens1 (B, 1), cache, pos (B,)) -> (conf, top1,
    cache)``: one decode token per request; ``pos`` is the absolute
    position of that token. On a mesh ``tokens1`` and ``pos`` are the
    global batch's and the cache this rank's, as the prefill step left
    it; the data axis splits the batch where it divides B, else the batch
    is replicated over it, as in the prefill."""
    cfg = model.cfg
    mctx = _context(model, mesh)

    def serve_step(tokens1, cache, pos):
        b = tokens1.shape[0]
        ctx = _batch_context(mctx, b)
        rows = ctx.data_rows(b)
        with torch.inference_mode():
            hidden, cache = model.decode_step(tokens1[rows], cache, pos[rows],
                                              return_hidden=True, mctx=ctx)
            conf, top1 = vocab_parallel_bvsb(hidden, model.head_rows(), ctx,
                                             cfg.vocab_size)
            conf, top1 = gather_rows(conf, top1, ctx, b)
        return conf, top1, cache

    return serve_step
