"""Operations and bytes, frozen: the work of a classify step and of the two
hand-written kernels on its path, from shapes alone, and the H100's
data-sheet rates.

The kernel counts are a copy of ``repro_torch/roofline/analysis.py``'s
``flash_pairs``, ``flash_work`` and ``bvsb_work`` (each input byte read
once, each output byte written once); they live here so that a change to
the program cannot move the yardstick.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM5 data sheet, dense: HBM3 bytes/s, FP32 on the CUDA
# cores, TF32 on the tensor cores (FLOP/s)
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12


@dataclasses.dataclass(frozen=True)
class Work:
    bytes: float
    flops: float
    rate: float          # FLOP/s of the operations' type

    def bound_s(self) -> float:
        """The least time the chip could take: the larger of the bytes
        over HBM bandwidth and the operations over their peak."""
        return max(self.bytes / HBM_BPS, self.flops / self.rate)


def flash_pairs(s: int, t: int, causal: bool = True, window=None) -> int:
    """(query, key) pairs attention keeps: min(i + 1, window) keys for
    query i when causal, every one of S x T otherwise."""
    w = window or s
    if not causal:
        return s * t
    if s > w:
        return w * (w + 1) // 2 + (s - w) * w
    return s * (s + 1) // 2


def flash_work(b, s, t, h, kv, hd, elt=4, *, causal=True,
               window=None) -> Work:
    """The forward: q, k, v read and out written once in their type; a q.k
    and a p.v FMA (2 FLOP each) per kept pair, head and head dim. Float32
    at its fastest runs as three TF32 products an FMA pair (3xTF32) at the
    TF32 rate, bf16 as one at the bf16 rate: the least time either type
    could take."""
    moved = (2 * b * s * h * hd + 2 * b * t * kv * hd) * elt
    ops = 4 * hd * flash_pairs(s, t, causal, window) * b * h
    if elt == 4:
        return Work(moved, 3 * ops, TF32_FLOPS)
    raise ValueError("only float32 cells are counted")


def bvsb_work(b: int, v: int, elt: int = 4) -> Work:
    """(B, V) logits read, conf and top-1 written; a compare, subtract, exp
    and add an element, on the CUDA cores."""
    return Work(b * v * elt + b * 8, 4 * b * v, FP32_FLOPS)


def classify_flops(cfg: dict, batch: int, length: int) -> float:
    """FLOPs that classification needs for ``batch`` samples of ``length``
    tokens: the trunk over every token (2 FLOP a multiply-add of the active
    weights: attention projections, the k routed experts, the shared
    experts or the dense MLP, the router; causal attention's q.k and p.v
    over the kept pairs) and the head at each sample's last position only.
    The embedding is a lookup and counts nothing."""
    d, hd = cfg["d_model"], cfg["head_dim"]
    hq, kv = cfg["num_heads"], cfg["num_kv_heads"]
    proj = d * hq * hd * 2 + d * kv * hd * 2
    attn = 4 * hd * hq * flash_pairs(length, length)       # a sample a layer
    per_token = 0
    for i in range(cfg["num_layers"]):
        if i < cfg["first_dense_layers"] or not cfg["num_experts"]:
            mlp = 3 * d * cfg["d_ff"]
        else:
            f = cfg["moe_d_ff"]
            mlp = (3 * d * f * (cfg["num_experts_per_tok"]
                                + cfg["num_shared_experts"])
                   + d * cfg["num_experts"])
        per_token += 2 * (proj + mlp)
    head = 2 * d * cfg["vocab_size"]
    return batch * (length * per_token + cfg["num_layers"] * attn + head)
