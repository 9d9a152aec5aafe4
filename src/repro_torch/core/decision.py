"""Forwarding decision functions (paper Sec. IV-A).

The decision function d^i (Eq. 3) forwards a sample to the server when the
light model's confidence falls below the device's threshold c_{i,t}:

    d^i(f_l^i(x)) = 0 (keep local)  if  conf >= c_{i,t}
                    1 (forward)     if  conf <  c_{i,t}

Confidence metrics: BvSB (Eq. 2, the paper's default — the CUDA kernel on
the card), top-1 softmax, and entropy-based (Sec. IV-A alternatives).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops


def bvsb_confidence(logits):
    """(B, V) logits -> (confidence (B,), top1 (B,))."""
    return ops.bvsb(logits)


def top1_confidence(logits):
    p = torch.softmax(logits.float(), dim=-1)
    conf, top1 = p.max(dim=-1)
    return conf, top1.to(torch.int32)


def entropy_confidence(logits):
    """Normalized 1 - H(p)/log V, so higher = more confident, range [0,1]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ent = -(logp.exp() * logp).sum(dim=-1)
    conf = 1.0 - ent / math.log(logits.shape[-1])
    return conf, logits.argmax(dim=-1).to(torch.int32)


METRICS = {
    "bvsb": bvsb_confidence,
    "top1": top1_confidence,
    "entropy": entropy_confidence,
}


def decide(confidence, threshold):
    """Eq. 3: returns 1 (forward) where confidence < threshold."""
    return (confidence < threshold).to(torch.int32)
