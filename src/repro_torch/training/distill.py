"""Knowledge distillation of the light (device) model from the heavy
(server) model: the substrate of a cascade pair (paper Sec. II-A: the
light model should agree with the heavy one on easy samples and be
uncertain where it would disagree).

Counterpart of the JAX package's ``training/distill.py``. Loss = CE
(student, labels) + kd_weight * KL(teacher_T || student_T) + the
student's MoE aux loss. The teacher runs under ``torch.no_grad()``,
JAX's ``stop_gradient``: on the card its attention takes the forward
kernel alone.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.common import cross_entropy
from repro_torch.training import optimizer as opt
from repro_torch.training.trainer import grads_of, to_device, trainable


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    kd_weight: float = 1.0
    temperature: float = 2.0
    adamw: opt.AdamWConfig = opt.AdamWConfig(lr=1e-3, total_steps=2000)


def kd_loss(student_logits, teacher_logits, temperature):
    t = temperature
    sp = torch.log_softmax(student_logits.float() / t, dim=-1)
    tp = torch.softmax(teacher_logits.float() / t, dim=-1)
    return -(tp * sp).sum(-1).mean() * (t * t)


def make_distill_step(student, teacher, dcfg: DistillConfig):
    """``step(opt_state, batch) -> (opt_state, metrics)``: one AdamW update
    of the student's parameters in place; metrics loss, ce, kd, grad_norm,
    lr. ``opt_state`` is ``optimizer.init`` of ``trainable(student)``."""
    params = trainable(student)

    def loss_fn(batch):
        tokens = batch["tokens"]
        hidden, _, aux = student(tokens, return_hidden=True, with_aux=True)
        s_logits = student.head(hidden)
        with torch.no_grad():
            t_logits, _ = teacher(tokens)
        labels = batch.get("labels")
        ce = cross_entropy(s_logits, labels, student.cfg.vocab_size) \
            if labels is not None else torch.zeros((), device=hidden.device)
        kd = kd_loss(s_logits, t_logits, dcfg.temperature)
        return ce + dcfg.kd_weight * kd + aux, {"ce": ce, "kd": kd}

    def step(opt_state, batch):
        batch = to_device(batch, student.device)
        loss, metrics, grads = grads_of(loss_fn, params, batch)
        _, opt_state, om = opt.update(params, grads, opt_state, dcfg.adamw)
        return opt_state, {"loss": loss, **metrics, **om}

    return step
