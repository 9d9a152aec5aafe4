"""The plain reference: the classification forward of a configuration
written out in plain PyTorch, float32 with TF32 off.

It follows the published decoder and the departures its configuration
file lists: RMSNorm, RoPE over split halves, causal attention scaled by
1/sqrt(head_dim), SwiGLU MLPs, top-k MoE with renormalised gates and a
capacity of ``max(int(1.25 N k / E), 8)`` rows an expert (assignments past
it, counted token-major then top-k slot, are dropped), shared experts as one
gated MLP, the head at the last position, then BvSB (Eq. 2) over the real
vocabulary. It imports torch and numpy and nothing of the program.

``precision`` "tf32" is the control: the same arithmetic with every matrix
product in TF32 (on a card the library's TF32 path, on the CPU the
operands rounded to TF32's 10-bit mantissa).
"""
from __future__ import annotations

import contextlib
import math

import torch

CAPACITY_FACTOR = 1.25


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class _Products:
    """Matrix products in the reference's precision."""

    def __init__(self, precision: str, device: torch.device):
        if precision not in ("f32", "tf32"):
            raise ValueError(precision)
        self.emulate = precision == "tf32" and device.type != "cuda"

    def mm(self, a, b):
        if self.emulate:
            return _round_tf32(a) @ _round_tf32(b)
        return a @ b


@contextlib.contextmanager
def _tf32(on: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x (B, L, H, hd) at positions 0..L-1, split halves rotated."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = torch.arange(x.shape[1], dtype=torch.float32,
                       device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(x, w, p, cfg, P):
    b, n, d = x.shape
    hq, kv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    flat = x.reshape(b * n, d)
    q = P.mm(flat, w[p + "attn.wq"]).view(b, n, hq, hd)
    k = P.mm(flat, w[p + "attn.wk"]).view(b, n, kv, hd)
    v = P.mm(flat, w[p + "attn.wv"]).view(b, n, kv, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    g = hq // kv
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))   # (B, H, L, hd)
    s = P.mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    mask = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    s = torch.exp(s - s.amax(-1, keepdim=True))
    a = s / s.sum(-1, keepdim=True)
    o = P.mm(a, v).permute(0, 2, 1, 3).reshape(b * n, hq * hd)
    return P.mm(o, w[p + "attn.wo"]).view(b, n, d)


def gated_mlp(x, wg, wu, wd, P):
    return P.mm(torch.nn.functional.silu(P.mm(x, wg)) * P.mm(x, wu), wd)


def moe(x, w, p, cfg, P):
    """x (N, d) -> (N, d): routed experts under the capacity rule, plus the
    shared experts."""
    n, d = x.shape
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    logits = P.mm(x, w[p + "moe.router"])
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    cap = max(int(CAPACITY_FACTOR * n * k / e), 8)
    flat = ids.reshape(-1)                                  # token-major
    onehot = torch.nn.functional.one_hot(flat, e)
    row = (onehot.cumsum(0) * onehot).sum(-1) - 1           # p-th to expert
    keep = row < cap
    tok = torch.arange(n, device=x.device).repeat_interleave(k)
    contrib = torch.zeros(n * k, d, dtype=x.dtype, device=x.device)
    for j in range(e):
        sel = torch.nonzero((flat == j) & keep)[:, 0]
        if sel.numel():
            y = gated_mlp(x[tok[sel]], w[p + "moe.w_gate"][j],
                          w[p + "moe.w_up"][j], w[p + "moe.w_down"][j], P)
            contrib[sel] = y * gates.reshape(-1)[sel, None]
    out = contrib.view(n, k, d).sum(1)
    if cfg["num_shared_experts"]:
        out = out + gated_mlp(x, w[p + "moe.shared.w_gate"],
                              w[p + "moe.shared.w_up"],
                              w[p + "moe.shared.w_down"], P)
    return out


def last_logits(w: dict, cfg: dict, tokens: torch.Tensor,
                precision: str = "f32") -> torch.Tensor:
    """tokens (B, L) -> float32 logits (B, vocab_size) at the last position."""
    P = _Products(precision, tokens.device)
    with torch.no_grad(), _tf32(precision == "tf32"):
        b, n = tokens.shape
        d, eps = cfg["d_model"], cfg["norm_eps"]
        x = w["embed.table"][tokens.long()]
        for i in range(cfg["num_layers"]):
            p = f"layers.{i}."
            x = x + attention(rmsnorm(x, w[p + "norm1.scale"], eps), w, p,
                              cfg, P)
            h = rmsnorm(x, w[p + "norm2.scale"], eps).reshape(b * n, d)
            if p + "moe.router" in w:
                y = moe(h, w, p, cfg, P)
            else:
                y = gated_mlp(h, w[p + "mlp.w_gate"], w[p + "mlp.w_up"],
                              w[p + "mlp.w_down"], P)
            x = x + y.view(b, n, d)
        last = rmsnorm(x[:, -1], w["final_norm.scale"], eps)
        head = w["embed.table" if cfg["tie_embeddings"] else "lm_head.table"]
        return P.mm(last, head[:cfg["vocab_size"]].T)


def bvsb(logits: torch.Tensor):
    """(B, V) -> (BvSB (B,), top-1 (B,), the top probability (B,)): Eq. 2
    from a float32 softmax, top-1 the first index of the maximum."""
    p = torch.softmax(logits.float(), dim=-1)
    top1 = torch.argmax(p, dim=-1)
    p1 = p.gather(-1, top1[:, None])[:, 0]
    p2 = p.scatter(-1, top1[:, None], -1.0).amax(-1)
    return p1 - p2, top1, p1
