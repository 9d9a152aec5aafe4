"""Shared building blocks: init, RMSNorm, group norm, RoPE and M-RoPE,
gated MLP, embeddings, the LM loss.

Plain functions on tensors, in the JAX package's layout: activations
(B, S, d), heads (B, S, H, hd), weights applied as ``x @ W`` with W of
shape (d_in, d_out). The small modules here, in ``attention.py`` and in
``transformer.py`` hold the parameters, named as the JAX parameter tree
names them, and call these.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn


# the label that takes no part in the loss
IGNORE = -100


def param(*shape, device, dtype) -> nn.Parameter:
    """An uninitialised parameter that does not require grad (serving
    needs none); the model's init or the weight converter fills it, and
    the trainers turn gradients on for what they train."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


class RMSNorm(nn.Module):
    def __init__(self, d, *, device, dtype):
        super().__init__()
        self.scale = param(d, device=device, dtype=dtype)

    def forward(self, x, eps):
        return rmsnorm(self.scale, x, eps)


class MLP(nn.Module):
    def __init__(self, d, f, *, device, dtype):
        super().__init__()
        self.w_gate = param(d, f, device=device, dtype=dtype)
        self.w_up = param(d, f, device=device, dtype=dtype)
        self.w_down = param(f, d, device=device, dtype=dtype)

    def forward(self, x, act):
        return mlp_apply(self.w_gate, self.w_up, self.w_down, x, act)


class Embedding(nn.Module):
    """Embedding table over the padded vocab, shared with the LM head
    when the config ties them."""

    def __init__(self, vocab, d, *, device, dtype):
        super().__init__()
        self.table = param(padded_vocab(vocab), d, device=device, dtype=dtype)


def trunc_normal_(t: torch.Tensor, scale: float,
                  generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` with a normal truncated to [-2, 2], times ``scale``.

    The distribution of the JAX package's ``dense_init``, not its bits.
    Drawn on the generator's device: in place when that is ``t``'s
    device, else drawn there and copied (a CPU generator gives the same
    weights on every device).
    """
    with torch.no_grad():
        if torch.device(generator.device) == t.device \
                and t.dtype == torch.float32:
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
            return t.mul_(scale)
        draw = torch.empty(t.shape, dtype=torch.float32,
                           device=generator.device)
        torch.nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        t.copy_(draw * scale)
    return t


def rmsnorm(scale, x, eps=1e-6):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(dt)


def groupnorm(x, eps=1e-6):
    """Headwise group norm of the xLSTM cells, x: (..., H, hd): each head
    normalised over hd in float32, with the population variance (JAX's
    ``jnp.var``), no scale; out in x's dtype."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) int. Rotates split halves
    (``x1, x2 = split(x, 2)``), not interleaved pairs."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions.float()[..., None] * freqs              # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, theta: float, sections):
    """Qwen2-VL multimodal RoPE [arXiv:2409.12191]. x: (B, S, H, hd);
    positions3: (3, B, S) int (t, h, w) position ids; sections: the
    per-axis frequency blocks, summing to hd / 2. Frequency block i takes
    its angle from axis i; the halves rotate as in ``apply_rope``."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (hd/2,)
    ang_axes = positions3.float()[..., None] * freqs        # (3, B, S, hd/2)
    parts, off = [], 0
    for ax, sec in enumerate(sections):
        parts.append(ang_axes[ax, :, :, off:off + sec])
        off += sec
    ang = torch.cat(parts, dim=-1)                          # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation(act: str):
    """The gated MLP's activation: SiLU, or tanh GELU (jax.nn.gelu's
    default) for ``gelu``."""
    if act == "silu":
        return F.silu
    return functools.partial(F.gelu, approximate="tanh")


def mlp_apply(w_gate, w_up, w_down, x, act: str = "silu"):
    """Gated MLP: SwiGLU for ``silu``, GeGLU (tanh GELU, as jax.nn.gelu)
    for ``gelu``."""
    return (activation(act)(x @ w_gate) * (x @ w_up)) @ w_down


def padded_vocab(vocab_size: int, multiple: int = 128) -> int:
    return ((vocab_size + multiple - 1) // multiple) * multiple


def embed_apply(table, tokens):
    return table[tokens.long()]


def lm_head_apply(table, x, vocab_size: int):
    """Logits over the PADDED vocab, padding columns set to finfo.min, so
    softmax/BvSB see them and give them exactly zero mass."""
    logits = x @ table.T
    pv = table.shape[0]
    if pv != vocab_size:
        pad = torch.arange(pv, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, torch.finfo(logits.dtype).min)
    return logits


def cross_entropy(logits, labels, vocab_size: int):
    """Mean cross-entropy over the positions whose label is not IGNORE
    (JAX ``models.model.cross_entropy``); ``logits`` may be vocab-padded,
    the padding at finfo.min (``lm_head_apply``), so it takes no mass."""
    logits = logits.float()
    mask = labels != IGNORE
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)
