"""Mixture-of-Experts sublayer on one card.

Counterpart of the JAX package's ``models/moe.py`` on one device, where
its shard_map holds every expert (E_local = E) and its psum is the
identity:

  1. ``route``: f32 router logits (the router stays f32 whatever the
     model's type), softmax, top-k, the k gates renormalised;
  2. ``dispatch``: each of the N * k assignments, in token-major then
     top-k-slot order, takes the next slot of its expert's buffer of
     ``capacity(N, cfg)`` rows; an assignment past the capacity is dropped
     into a dummy bucket (row E), as GShard's capacity factor drops it;
  3. the expert FFNs as batched products over the (E, C, d) buffer (the
     JAX package runs them as ``jnp.einsum`` outside any Pallas kernel, so
     they stay library products here);
  4. the combine: each assignment's output row gathered back and weighted
     by its gate (0 if dropped), and a token's k contributions summed in
     top-k-slot order, one add after another. No atomic scatter, so two
     calls on the card give the same bits.

Shared experts (DeepSeekMoE / Moonlight, the JAX ``_shared_expert``) are
a ``common.MLP`` of width f x n_shared added to the routed output. Expert parallelism over
``torch.distributed`` is not ported yet (ROADMAP.md Queue A).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import common

CAPACITY_FACTOR = 1.25


class MoE(nn.Module):
    """The parameters, named and shaped as the JAX ``moe_init`` makes them:
    router (d, E) f32, w_gate / w_up (E, d, f), w_down (E, f, d), and
    ``shared.{w_gate, w_up, w_down}`` at width f x n_shared."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        d, e = cfg.d_model, cfg.num_experts
        f = cfg.moe_d_ff or cfg.d_ff
        kw = dict(device=device, dtype=dtype)
        self.router = common.param(d, e, device=device, dtype=torch.float32)
        self.w_gate = common.param(e, d, f, **kw)
        self.w_up = common.param(e, d, f, **kw)
        self.w_down = common.param(e, f, d, **kw)
        if cfg.num_shared_experts:
            self.shared = common.MLP(d, f * cfg.num_shared_experts, **kw)

    def forward(self, x, cfg):
        return moe_apply(self, x, cfg)


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


def dispatch(ids, num_experts: int, cap: int):
    """Buffer slots of the N * k assignments ``ids`` (N, k), token-major
    then top-k slot: (expert (N k,), row (N k,), kept (N k,) bool). The
    p-th assignment to an expert takes row p; those at p >= ``cap`` are
    dropped to (num_experts, 0), the dummy bucket.

    p is the JAX package's cumsum of a one-hot over the assignments, taken
    along rows of the transposed (E, N k) one-hot: the same integers, but
    a scan along the contiguous dim, where CUDA's scan down the N k rows
    of an (N k, E) one-hot runs one thread a column (14.6 ms a layer at
    granite's 65,536 assignments on an H100)."""
    flat = ids.reshape(-1)
    experts = torch.arange(num_experts, device=flat.device)
    hot = flat[None, :] == experts[:, None]
    row = torch.gather(hot.cumsum(1), 0, flat[None, :])[0] - 1
    keep = row < cap
    return (torch.where(keep, flat, num_experts), torch.where(keep, row, 0),
            keep)


def local_expert_compute(x_flat, w_gate, w_up, w_down, gates, ids, cfg, act,
                         cap):
    """Steps 2-4 above for every expert. x_flat (N, d) -> (N, d)."""
    n, d = x_flat.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    expert, row, keep = dispatch(ids, e, cap)
    tok = torch.arange(n, device=x_flat.device).repeat_interleave(k)
    # kept assignments own distinct rows; dropped ones all land in the
    # dummy bucket, which is cut off before the products
    buf = x_flat.new_zeros(e + 1, cap, d)
    buf[expert, row] = torch.where(keep[:, None], x_flat[tok], 0)
    buf = buf[:e]
    h = act(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    out = torch.cat([torch.bmm(h, w_down), buf.new_zeros(1, cap, d)])
    contrib = out[expert, row] * (gates.reshape(-1) * keep).to(
        out.dtype)[:, None]
    contrib = contrib.view(n, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


def aux_load_balance_loss(probs, ids, cfg):
    """Switch-style load-balance loss from router probs and assignments."""
    e = cfg.num_experts
    counts = torch.bincount(ids.reshape(-1), minlength=e).float()
    frac = counts / torch.clamp(counts.sum(), min=1.0)
    return e * torch.sum(probs.mean(dim=0) * frac)


def moe_apply(p: MoE, x, cfg, *, return_aux: bool = False):
    """x: (B, S, d) -> (B, S, d) [, aux loss times the config's
    coefficient]."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    gates, ids, probs = route(xf, p.router, cfg)
    y = local_expert_compute(xf, p.w_gate, p.w_up, p.w_down, gates, ids, cfg,
                             common.activation(cfg.mlp_act),
                             capacity(b * s, cfg))
    y = y.reshape(b, s, d).to(x.dtype)
    if cfg.num_shared_experts:
        y = y + p.shared(x, cfg.mlp_act).to(y.dtype)
    if return_aux:
        return y, aux_load_balance_loss(probs, ids, cfg) \
            * cfg.router_aux_loss_coef
    return y
