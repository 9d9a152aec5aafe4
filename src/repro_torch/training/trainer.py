"""Training loop on one card: a train step with microbatching and remat,
metrics, periodic checkpoints.

Counterpart of the JAX package's ``training/trainer.py``. The parameters
live in the model and are updated in place (``optimizer.update``), so a
step is ``train_step(opt_state, batch) -> (opt_state, metrics)`` where
JAX's also takes and returns the parameters. Gradients come from
``torch.autograd.grad`` of ``Model.loss``; on the card every attention
and RG-LRU scan of the forward and the backward runs through the
hand-written kernels (``kernels.ops``). A batch is a dict of (B, S)
``tokens`` and ``labels`` (numpy or tensors; moved to the model's
device), for a VLM ``vision_embeds``, for an encoder-decoder
``audio_embeds`` (B, F, d).

On a (data, model) mesh (``launch.distributed.make_train_step(model,
mesh)``) each rank differentiates its share of the global batch
(``data_rows``, ``accumulate``), its loss its local sum over the global
count of labels; ``all_reduce_grads`` then sums every gradient over the
data group, leaf by leaf in a fixed order, but an FSDP leaf's (a model
built with ``fsdp=True``), which its gather's backward has summed and cut
to the rank's shard; AdamW runs on what each rank stores, its moments
on the shard.

    model = init_model(cfg)                       # on the card
    model, opt_state, history = train(model, data, steps, TrainConfig())
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models.common import LOCAL
from repro_torch.models.model import init_params, resolve_device
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: opt.AdamWConfig = opt.AdamWConfig()
    microbatch: Optional[int] = None   # split global batch into chunks
    remat: bool = True
    log_every: int = 10
    ckpt_every: int = 0
    ckpt_path: str = "checkpoints/model.npz"


def init_model(cfg, seed: int = 0, *, device="cuda", dtype=torch.float32):
    """A model for ``cfg`` with weights drawn from ``seed`` on ``device``
    (the card by default; raises without one unless ``device="cpu"``),
    its parameters trainable."""
    dev = resolve_device(device)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                        device=dev, dtype=dtype)
    trainable(model)
    return model


def trainable(model) -> Dict[str, torch.nn.Parameter]:
    """Turn gradients on for every parameter of ``model`` (the port builds
    them without) and return them by name, the optimizer's tree."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return params


def to_device(batch: dict, device) -> dict:
    """The batch's arrays as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(
        v, torch.Tensor) else v).to(device) for k, v in batch.items()}


def model_inputs(model, batch: dict) -> dict:
    """The forward's extra inputs from ``batch``: an encoder-decoder's
    ``audio_embeds``, else a VLM's ``vision_embeds`` (None without)."""
    if model.cfg.is_encoder_decoder:
        return {"audio_embeds": batch["audio_embeds"]}
    return {"vision_embeds": batch.get("vision_embeds")}


def data_rows(batch: dict, mctx=LOCAL) -> dict:
    """This data rank's rows of every array of a global batch."""
    if mctx.data_size == 1:
        return batch
    rows = mctx.data_rows(batch["tokens"].shape[0])
    return {k: v[rows] for k, v in batch.items()}


def all_reduce_grads(grads: Dict[str, torch.Tensor], mctx=LOCAL,
                     fsdp=frozenset()):
    """Sum every gradient over the data group in place, leaf by leaf in the
    parameters' order (one all_reduce a leaf, so two runs give the same
    bits), but the FSDP leaves named in ``fsdp`` (``models.model.
    data_parts``): their gathers' backward summed them over the data group
    already, and a second sum would double them. One card, or one data
    rank: nothing."""
    if mctx.data_group is None:
        return grads
    for name in grads:
        if name not in fsdp:
            grads[name] = mctx.all_reduce_data(grads[name].contiguous())
    return grads


def mesh_grad_norm(grads: Dict[str, torch.Tensor], sharded, mctx=LOCAL,
                   fsdp=frozenset()):
    """The global norm of the whole model's gradient on every rank, where
    the leaves named in ``sharded`` hold this model rank's part
    (``models.model.model_parts``: heads, features, channels, experts,
    vocabulary rows) and those in ``fsdp`` this data rank's part
    (``models.model.data_parts``): a leaf's squares summed over the groups
    that cut it, a replicated leaf's added once. None where no leaf is cut
    (``optimizer.update`` then takes ``global_norm`` itself)."""
    if mctx.model_group is None and not fsdp:
        return None
    # the squares of leaves cut by: neither, model only, data only, both
    parts = torch.zeros(4, dtype=torch.float32,
                        device=next(iter(grads.values())).device)
    for name, g in grads.items():
        i = int(name in sharded) + 2 * int(name in fsdp)
        parts[i] = parts[i] + torch.sum(torch.square(g.float()))
    cut_data = mctx.all_reduce_data(parts[2:].clone()) if fsdp else \
        parts[2:]
    cut_model = mctx.all_reduce_model(parts[1] + cut_data[1])
    return torch.sqrt(parts[0] + cut_model + cut_data[0])


def grads_of(loss_fn, params: Dict[str, torch.Tensor], batch: dict):
    """(loss, metrics, grads by name) of ``loss_fn(batch) -> (loss,
    metrics)``; a parameter the loss does not reach gets zeros."""
    loss, metrics = loss_fn(batch)
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(params.items(), gs)}
    return loss.detach(), {k: torch.as_tensor(v).detach()
                           for k, v in metrics.items()}, grads


def accumulate(loss_fn, params, batch: dict, n_chunks: int, mctx=LOCAL):
    """``grads_of`` over the batch cut into ``n_chunks`` equal slices of
    its leading dim, each slice's loss, metrics and gradients added as x /
    n_chunks in float32, in the JAX package's order. On a mesh ``batch``
    is the global batch and slice c is this data rank's share of global
    slice c (rows [c mb + r mb / n, c mb + (r + 1) mb / n)), as JAX's
    shard_map inside its scan splits each global microbatch."""
    b = batch["tokens"].shape[0]
    if b % (n_chunks * mctx.data_size):
        raise ValueError(f"batch {b} does not split into {n_chunks} chunks "
                         f"over {mctx.data_size} data ranks")
    mb = b // n_chunks
    grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    loss, metrics = None, None
    for c in range(n_chunks):
        sl = data_rows({k: v[c * mb:(c + 1) * mb] for k, v in batch.items()},
                       mctx)
        lc, mc, gc = grads_of(loss_fn, params, sl)
        for n in grads:
            grads[n] = grads[n] + gc[n].float() / n_chunks
        loss = lc / n_chunks if loss is None else loss + lc / n_chunks
        metrics = {k: v / n_chunks for k, v in mc.items()} if metrics is None \
            else {k: metrics[k] + mc[k] / n_chunks for k in metrics}
    return loss, metrics, grads


def make_train_step(model, tcfg: TrainConfig):
    """``train_step(opt_state, batch) -> (opt_state, metrics)``: the loss
    and its gradients (over ``tcfg.microbatch``-row chunks, accumulated,
    when it is smaller than the batch), then one AdamW update of the
    model's parameters in place. Metrics: loss, ce, aux, grad_norm, lr
    (0-d tensors)."""
    params = trainable(model)

    def loss_fn(batch):
        return model.loss(batch["tokens"], batch.get("labels"),
                          remat=tcfg.remat, **model_inputs(model, batch))

    def train_step(opt_state, batch):
        batch = to_device(batch, model.device)
        mb = tcfg.microbatch
        b = batch["tokens"].shape[0]
        if mb is None or mb >= b:
            loss, metrics, grads = grads_of(loss_fn, params, batch)
        else:
            loss, metrics, grads = accumulate(loss_fn, params, batch, b // mb)
        _, opt_state, om = opt.update(params, grads, opt_state, tcfg.adamw)
        return opt_state, {"loss": loss, **metrics, **om}

    return train_step


def train(model, data, steps: int, tcfg: TrainConfig = TrainConfig(), *,
          verbose: bool = True):
    """Train ``model`` in place on its own device for ``steps`` steps of
    ``data.batch_at(step)``. Returns (model, opt_state, history): a history
    row (loss, ce, aux, grad_norm, lr, step, wall seconds) every
    ``log_every`` steps and at the last; a checkpoint of the model every
    ``ckpt_every`` steps (``checkpoint.save_model``)."""
    params = trainable(model)
    opt_state = opt.init(params)
    step_fn = make_train_step(model, tcfg)
    history = []
    t0 = time.time()
    for step in range(steps):
        opt_state, metrics = step_fn(opt_state, data.batch_at(step))
        if step % tcfg.log_every == 0 or step == steps - 1:
            row = {k: float(v) for k, v in metrics.items()}
            row["step"] = step
            row["wall"] = time.time() - t0
            history.append(row)
            if verbose:
                print(f"step {step:5d} loss {row['loss']:.4f} "
                      f"lr {row['lr']:.2e} gnorm {row['grad_norm']:.2f}")
        if tcfg.ckpt_every and step and step % tcfg.ckpt_every == 0:
            ckpt.save_model(tcfg.ckpt_path, model, step)
    return model, opt_state, history
