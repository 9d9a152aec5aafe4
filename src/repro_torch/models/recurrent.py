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

Over model ranks the block is tensor-parallel on its channels: rank j
takes channels [j d/m, (j+1) d/m): w_gate / w_rnn's columns, the
block-diagonal gates' blocks [j nb/m, (j+1) nb/m) (the model ranks must
divide GATE_BLOCKS, as ``MeshContext.expert_range`` asks of the experts),
w_out's rows; conv_w, conv_b, b_a, b_x and lam stay whole on every rank
(their specs are replicated) and the rank reads its channels of them
through ``into_model``. The scan and the decode state (h, conv tail) hold
the rank's channels.
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

    def __init__(self, cfg, *, device, dtype, mctx=common.LOCAL):
        super().__init__()
        d = cfg.d_model
        nb = GATE_BLOCKS if d % GATE_BLOCKS == 0 else 1
        bs = d // nb
        b0, nbl = mctx.part(nb, "the RG-LRU's gate blocks")
        # this rank's channels (all of them on one card)
        self.cols = slice(b0 * bs, (b0 + nbl) * bs)
        self.tp = mctx.model_size > 1
        for leaf, whole in (("w_gate", (d, d)), ("w_rnn", (d, d)),
                            ("conv_w", (CONV_WIDTH, d)), ("conv_b", (d,)),
                            ("w_a", (nb, bs, bs)), ("b_a", (d,)),
                            ("w_x", (nb, bs, bs)), ("b_x", (d,)),
                            ("lam", (d,)), ("w_out", (d, d))):
            common.cut_param(self, ("rglru", leaf), whole, mctx=mctx,
                             device=device, dtype=torch.float32
                             if leaf == "lam" else dtype)

    def channels(self, mctx):
        """(conv_w, conv_b, b_a, b_x, lam) at this rank's channels, entered
        into the region (their gradients summed over the model ranks)."""
        leaves = (self.conv_w, self.conv_b, self.b_a, self.b_x, self.lam)
        if not self.tp:
            return leaves
        return tuple(mctx.into_model(t)[..., self.cols] for t in leaves)


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


def _gates(p: RGLRU, xr, b_a=None, b_x=None, lam=None):
    """(a, u) of the recurrence, both float32; b_a, b_x and lam the rank's
    channels of them (all of p's by default)."""
    if b_a is None:
        b_a, b_x, lam = p.b_a, p.b_x, p.lam
    xr32 = xr.float()
    r = torch.sigmoid(_block_proj(xr32, p.w_a.float()) + b_a.float())
    i = torch.sigmoid(_block_proj(xr32, p.w_x.float()) + b_x.float())
    log_a = -RG_LRU_C * F.softplus(lam) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i * xr32)


def _branches(p: RGLRU, x, tail, mctx):
    """(gate, a, u, new conv tail) of the rank's channels."""
    if p.tp:
        x = mctx.into_model(x)
    conv_w, conv_b, b_a, b_x, lam = p.channels(mctx)
    gate = F.gelu(x @ p.w_gate, approximate="tanh")
    xr, new_tail = _causal_conv(x @ p.w_rnn, conv_w, conv_b, tail)
    a, u = _gates(p, xr, b_a, b_x, lam)
    return gate, a, u, new_tail


def _out(p: RGLRU, y, mctx):
    out = y @ p.w_out
    return mctx.out_of_model(out) if p.tp else out


def rglru_block(p: RGLRU, x, state=None, mctx=common.LOCAL):
    """x: (B, S, d); state: None or dict(h (B, dl), conv_tail (B, 3, dl)),
    dl the rank's channels. Returns (out (B, S, d), new state)."""
    tail = state["conv_tail"] if state is not None else None
    gate, a, u, new_tail = _branches(p, x, tail, mctx)
    h = ops.rglru_scan(a, u, state["h"] if state is not None else None)
    out = _out(p, (gate.float() * h).to(x.dtype), mctx)
    return out, {"h": h[:, -1, :], "conv_tail": new_tail}


def rglru_decode(p: RGLRU, x1, state, mctx=common.LOCAL):
    """One step. x1: (B, 1, d); state as above. Returns (out, new state)."""
    gate, a, u, new_tail = _branches(p, x1, state["conv_tail"], mctx)
    h = a[:, 0] * state["h"] + u[:, 0]                      # (B, dl)
    out = _out(p, (gate[:, 0].float() * h).to(x1.dtype), mctx)
    return out[:, None, :], {"h": h, "conv_tail": new_tail}


def rglru_init_state(batch, d, dtype=torch.float32, device=None):
    return {
        "h": torch.zeros(batch, d, dtype=torch.float32, device=device),
        "conv_tail": torch.zeros(batch, CONV_WIDTH - 1, d, dtype=dtype,
                                 device=device),
    }
