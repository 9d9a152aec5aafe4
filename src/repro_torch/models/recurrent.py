"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Counterpart of the JAX package's ``models/recurrent.py``. Block: pre-norm
x -> two branches, the gate GeLU(x W_gate) and the recurrence (x W_rnn
-> causal depthwise conv of width 4 -> RG-LRU); out = (gate * h) W_out.

RG-LRU cell, c = 8:

    r_t = sigmoid(x_t W_a + b_a)      i_t = sigmoid(x_t W_x + b_x)
    a_t = exp(-c softplus(lam) r_t)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

The full-sequence path runs the recurrence through ``ops.rglru_scan``
(the CUDA kernel on the card, its plain loop on the CPU); the JAX package
computes the same function with ``lax.associative_scan``. Decode is one
elementwise step carrying (h, conv tail) and launches no scan.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import common

RG_LRU_C = 8.0
CONV_WIDTH = 4
GATE_BLOCKS = 16  # block-diagonal gate heads; one block when d % 16 != 0
LAM_INIT = 0.65   # a ~ U(0.9, 0.999) at r = 1 (the paper's init range)
ZERO_INIT = ("conv_b", "b_a", "b_x")


class RGLRU(nn.Module):
    """RG-LRU parameters, named and shaped as the JAX ``rglru_init`` makes
    them: w_gate/w_rnn (d, d), conv_w (4, d), conv_b (d,), w_a/w_x
    block-diagonal (nb, d/nb, d/nb), b_a/b_x (d,), lam (d,) float32,
    w_out (d, d)."""

    def __init__(self, cfg, *, device, dtype):
        super().__init__()
        d = cfg.d_model
        nb = GATE_BLOCKS if d % GATE_BLOCKS == 0 else 1
        bs = d // nb
        kw = dict(device=device, dtype=dtype)
        self.w_gate = common.param(d, d, **kw)
        self.w_rnn = common.param(d, d, **kw)
        self.conv_w = common.param(CONV_WIDTH, d, **kw)
        self.conv_b = common.param(d, **kw)
        self.w_a = common.param(nb, bs, bs, **kw)
        self.b_a = common.param(d, **kw)
        self.w_x = common.param(nb, bs, bs, **kw)
        self.b_x = common.param(d, **kw)
        self.lam = common.param(d, device=device, dtype=torch.float32)
        self.w_out = common.param(d, d, **kw)


def _block_proj(x, w):
    """x: (..., d) @ block-diagonal w (nb, bs, bs) -> (..., d)."""
    nb, bs, _ = w.shape
    xb = x.reshape(x.shape[:-1] + (nb, bs))
    return torch.einsum("...nk,nkj->...nj", xb, w).reshape(x.shape)


def _causal_conv(x, w, b, tail=None):
    """Depthwise causal conv of width 4. x: (B, S, d); tail: (B, 3, d) of
    the inputs before x, or None (zeros). Returns (out, new tail)."""
    if tail is None:
        tail = x.new_zeros(x.shape[0], CONV_WIDTH - 1, x.shape[2])
    xp = torch.cat([tail, x], dim=1)                       # (B, S + 3, d)
    s = x.shape[1]
    out = sum(xp[:, i:i + s, :] * w[CONV_WIDTH - 1 - i]
              for i in range(CONV_WIDTH))
    return out + b, xp[:, -(CONV_WIDTH - 1):, :]


def _gates(p: RGLRU, xr):
    """(a, u) of the recurrence, both float32."""
    xr32 = xr.float()
    r = torch.sigmoid(_block_proj(xr32, p.w_a.float()) + p.b_a.float())
    i = torch.sigmoid(_block_proj(xr32, p.w_x.float()) + p.b_x.float())
    log_a = -RG_LRU_C * F.softplus(p.lam) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i * xr32)


def rglru_block(p: RGLRU, x, state=None):
    """x: (B, S, d); state: None or dict(h (B, d), conv_tail (B, 3, d)).
    Returns (out (B, S, d), new state)."""
    gate = F.gelu(x @ p.w_gate, approximate="tanh")
    xr = x @ p.w_rnn
    tail = state["conv_tail"] if state is not None else None
    xr, new_tail = _causal_conv(xr, p.conv_w, p.conv_b, tail)
    a, u = _gates(p, xr)
    h = ops.rglru_scan(a, u, state["h"] if state is not None else None)
    out = (gate.float() * h).to(x.dtype) @ p.w_out
    return out, {"h": h[:, -1, :], "conv_tail": new_tail}


def rglru_decode(p: RGLRU, x1, state):
    """One step. x1: (B, 1, d); state as above. Returns (out, new state)."""
    gate = F.gelu(x1 @ p.w_gate, approximate="tanh")
    xr = x1 @ p.w_rnn
    xr, new_tail = _causal_conv(xr, p.conv_w, p.conv_b, state["conv_tail"])
    a, u = _gates(p, xr)                                    # (B, 1, d)
    h = a[:, 0] * state["h"] + u[:, 0]
    out = (gate[:, 0].float() * h).to(x1.dtype) @ p.w_out
    return out[:, None, :], {"h": h, "conv_tail": new_tail}


def rglru_init_state(batch, d, dtype=torch.float32, device=None):
    return {
        "h": torch.zeros(batch, d, dtype=torch.float32, device=device),
        "conv_tail": torch.zeros(batch, CONV_WIDTH - 1, d, dtype=dtype,
                                 device=device),
    }
