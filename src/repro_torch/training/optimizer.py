"""AdamW with a cosine schedule and global-norm clipping, in PyTorch.

Counterpart of the JAX package's ``training/optimizer.py``, op for op:
float32 moments, the gradients clipped by their global norm before the
moments, decoupled weight decay on tensors of two or more dimensions
only. Not ``torch.optim.AdamW``, which applies its decay to the
parameters before the Adam step and to every tensor.

``params`` is a dict name -> tensor (``trainable(model)`` gives a
model's parameters so) and ``grads`` a dict with the same names; the
state holds the moments under the same names and the step count. Unlike
the JAX package, whose arrays are immutable, ``update`` writes the new
parameters and moments in place, which keeps a model's optimizer at
three copies of its weights. All scalars stay 0-d tensors on the
parameters' device, so a step makes no host round trip.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor): linear warm-up, then a
    cosine from ``lr`` down to ``min_lr_frac * lr``; float32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def init(params: Dict[str, torch.Tensor]) -> dict:
    """Zero float32 moments beside each parameter, step 0 (int32)."""
    first = next(iter(params.values()))
    return {
        "mu": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in params.items()},
        "nu": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    total = None
    for x in tree.values():
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def update(params, grads, opt_state, cfg: AdamWConfig):
    """One AdamW step: (params, opt_state, {"grad_norm", "lr"}), the
    parameters and moments updated in place."""
    step = opt_state["step"] + 1
    gn = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1.0 - cfg.beta1 ** step.float()
    b2c = 1.0 - cfg.beta2 ** step.float()
    for name, p in params.items():
        mu, nu = opt_state["mu"][name], opt_state["nu"][name]
        g = grads[name].float() * clip
        mu.mul_(cfg.beta1).add_((1 - cfg.beta1) * g)
        nu.mul_(cfg.beta2).add_((1 - cfg.beta2) * torch.square(g))
        mhat = mu / b1c
        nhat = nu / b2c
        delta = mhat / (torch.sqrt(nhat) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gn, "lr": lr}
