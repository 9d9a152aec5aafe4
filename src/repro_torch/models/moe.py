"""Mixture-of-Experts sublayer, with expert parallelism over the model
ranks.

Counterpart of the JAX package's ``models/moe.py``. Model rank j of a
mesh holds experts [j E/m, (j + 1) E/m) (``MeshContext.expert_range``);
on one card (``LOCAL``) that is every expert and each mesh function below
is the identity, the one code path. Each rank, for its data shard's
tokens:

  1. ``route``: f32 router logits (the router stays f32 whatever the
     model's type), softmax, top-k, the k gates renormalised; the full
     router, on every model rank;
  2. ``dispatch``: each of the N * k assignments, in token-major then
     top-k-slot order, that goes to one of the rank's experts takes the
     next slot of that expert's buffer of ``capacity(N, cfg)`` rows (N the
     rank's own tokens); an assignment past the capacity, or to another
     rank's expert, goes to a dummy bucket (row E_local), as GShard's
     capacity factor drops it and JAX's ``_local_expert_compute`` parks
     it;
  3. the expert FFNs as batched products over the (E_local, C, d) buffer
     (the JAX package runs them as ``jnp.einsum`` outside any Pallas
     kernel, so they stay library products here);
  4. the combine: each assignment's output row gathered back and weighted
     by its gate (0 if dropped or not local), and a token's k
     contributions summed in top-k-slot order, one add after another. No
     atomic scatter, so two calls on the card give the same bits;
  5. the ranks' partial outputs summed over the model group
     (``MeshContext.out_of_model``, JAX's psum).

Steps 2 and 4 outside autograd (serving) go through ``ops.moe_dispatch``
and ``ops.moe_combine``: on a card the two CUDA kernels of
``kernels/moe_route.py``, which fill the buffer and sum the k
contributions without a dummy bucket, bit for bit the PyTorch ops that
run on the CPU and under autograd.

The gradient: the tokens and the gates enter the region through
``MeshContext.into_model`` (the backward sums their cotangents over the
model group, each rank having seen only its experts' assignments). The
router is not wrapped: the aux loss is computed from the same router
probabilities on every model rank, and summing the router's gradient
over the model group would count that part m times; the gates' summed
cotangent carries the experts' part back into it instead. The aux loss
is the mean over the data group (JAX's pmean over the batch axes).

Shared experts (DeepSeekMoE / Moonlight, the JAX ``_shared_expert``) are
a ``common.MLP`` of width f x n_shared added to the routed output, cut
over the model ranks like a dense MLP where they divide its width: its
partial output joins the routed one inside the region, one sum over the
model group for both (else it is whole on every rank and added after).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import _build, moe_route, ops
from repro_torch.models import common

CAPACITY_FACTOR = 1.25


class MoE(nn.Module):
    """The parameters, named and shaped as the JAX ``moe_init`` makes them:
    router (d, E) f32, w_gate / w_up (E_local, d, f), w_down (E_local, f,
    d), and ``shared.{w_gate, w_up, w_down}`` at width f x n_shared.
    E_local = E / model ranks; this rank's experts start at ``e0``."""

    def __init__(self, cfg, *, device, dtype, mctx=common.LOCAL):
        super().__init__()
        d, e = cfg.d_model, cfg.num_experts
        f = cfg.moe_d_ff or cfg.d_ff
        self.e0 = mctx.expert_range(e)[0]
        kw = dict(device=device, dtype=dtype)
        self.router = common.param(d, e, device=device, dtype=torch.float32)
        for leaf, whole in (("w_gate", (e, d, f)), ("w_up", (e, d, f)),
                            ("w_down", (e, f, d))):
            common.cut_param(self, ("moe", leaf), whole, mctx=mctx, **kw)
        if cfg.num_shared_experts:
            self.shared = common.MLP(d, f * cfg.num_shared_experts,
                                     mctx=mctx, block=("moe", "shared"), **kw)

    def forward(self, x, cfg, mctx=common.LOCAL):
        return moe_apply(self, x, cfg, mctx)


def capacity(n: int, cfg) -> int:
    """Buffer rows an expert gets for ``n`` tokens: the JAX package's
    ``max(int(CAPACITY_FACTOR * n * k / E), 8)``, in Python floats."""
    return max(int(CAPACITY_FACTOR * n * cfg.num_experts_per_tok
                   / cfg.num_experts), 8)


def route(x_flat, router_w, cfg):
    """Top-k routing of x_flat (N, d). Returns (gates (N, k) f32, ids (N,
    k) int64, probs (N, E) f32). The softmax is written out as
    ``jax.nn.softmax`` computes it, its max shift outside the gradient.
    Every step is differentiable but the integer ids, as in JAX."""
    logits = x_flat.float() @ router_w.float()
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    probs = e / e.sum(dim=-1, keepdim=True)
    gates, ids = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, ids, probs


dispatch = moe_route.dispatch_plain


def local_expert_compute(x_flat, w_gate, w_up, w_down, gates, ids, act, cap,
                         e0=0):
    """Steps 2-4 above for the experts [e0, e0 + len(w_gate)). x_flat (N,
    d) -> (N, d), the tokens' outputs from those experts alone. Outside
    autograd (serving) the way into and out of the buffer is the kernel
    pair of ``kernels/moe_route.py`` through ``ops`` (on the CPU their
    plain versions); under autograd it is those plain versions, the
    differentiable ops."""
    if _build.wants_grad(x_flat, w_gate, w_up, w_down, gates):
        into, out_of = moe_route.moe_dispatch_plain, \
            moe_route.moe_combine_plain
    else:
        into, out_of = ops.moe_dispatch, ops.moe_combine
    expert, row, keep, buf = into(ids, x_flat, w_gate.shape[0], cap, e0)
    h = act(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    return out_of(torch.bmm(h, w_down), expert, row, keep, gates)


def aux_load_balance_loss(probs, ids, cfg):
    """Switch-style load-balance loss from router probs and assignments.
    The assignments are counted into a buffer of E (a scatter-add of ones,
    exact below 2^24 a bucket): ``torch.bincount``'s output size depends on
    the data, so ``meta`` tensors (the dry-run) cannot run it."""
    e = cfg.num_experts
    flat = ids.reshape(-1)
    counts = torch.zeros(e, dtype=torch.float32, device=ids.device
                         ).scatter_add_(0, flat, torch.ones(
                             flat.shape, dtype=torch.float32,
                             device=ids.device))
    frac = counts / torch.clamp(counts.sum(), min=1.0)
    return e * torch.sum(probs.mean(dim=0) * frac)


def moe_apply(p: MoE, x, cfg, mctx=common.LOCAL, *,
              return_aux: bool = False):
    """x: (B, S, d), this rank's rows -> (B, S, d) [, the aux loss (the
    mean over the data group) times the config's coefficient]."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    gates, ids, probs = route(xf, p.router, cfg)
    xin = mctx.into_model(xf)
    y = local_expert_compute(xin, p.w_gate, p.w_up, p.w_down,
                             mctx.into_model(gates), ids,
                             common.activation(cfg.mlp_act),
                             capacity(b * s, cfg), p.e0)
    shared = p.shared if cfg.num_shared_experts else None
    if shared is not None and shared.tp:
        y = y + shared.partial(xin, cfg.mlp_act).to(y.dtype)
    y = mctx.out_of_model(y).reshape(b, s, d).to(x.dtype)
    if shared is not None and not shared.tp:
        y = y + shared(x, cfg.mlp_act).to(y.dtype)
    if return_aux:
        aux = aux_load_balance_loss(probs, ids, cfg)
        if mctx.data_size > 1:
            aux = mctx.sum_data(aux) / mctx.data_size
        return y, aux * cfg.router_aux_loss_coef
    return y
