"""The cell's inputs, made from ``--seed``: the model's weights, drawn on
the device, and the fleet's token arrays, drawn on the host.

The weights are named and shaped as the program's state dict names them
(``layers.{i}.attn.wq`` ...), the loading convention that lets the harness
hand one set of values to both the program and the reference. Every matrix
is normal(0, ``init_std``) and every norm scale 1. They are drawn in a few
large calls from one ``torch.Generator`` on the device, one flat buffer of
at most ``CHUNK`` values at a time, so that the same seed gives the same
values on every call and nothing holds two copies of the model at once.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

CHUNK = 1 << 28            # values a draw call fills at most (1 GiB of f32)
SEED_MASK = (1 << 63) - 1  # torch generators take seeds below 2**64


def padded_vocab(vocab: int, multiple: int = 128) -> int:
    return (vocab + multiple - 1) // multiple * multiple


def layout(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, "normal" or "ones") of every leaf of the model that
    ``cfg`` describes, in a fixed order."""
    d, hd = cfg["d_model"], cfg["head_dim"]
    h, kv = cfg["num_heads"] * hd, cfg["num_kv_heads"] * hd
    pv = padded_vocab(cfg["vocab_size"])
    leaves = [("embed.table", (pv, d), "normal"),
              ("final_norm.scale", (d,), "ones")]
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}."
        leaves += [(p + "norm1.scale", (d,), "ones"),
                   (p + "attn.wq", (d, h), "normal"),
                   (p + "attn.wk", (d, kv), "normal"),
                   (p + "attn.wv", (d, kv), "normal"),
                   (p + "attn.wo", (h, d), "normal"),
                   (p + "norm2.scale", (d,), "ones")]
        if i < cfg["first_dense_layers"] or not cfg["num_experts"]:
            f = cfg["d_ff"]
            leaves += [(p + "mlp.w_gate", (d, f), "normal"),
                       (p + "mlp.w_up", (d, f), "normal"),
                       (p + "mlp.w_down", (f, d), "normal")]
            continue
        e, f = cfg["num_experts"], cfg["moe_d_ff"]
        leaves += [(p + "moe.router", (d, e), "normal"),
                   (p + "moe.w_gate", (e, d, f), "normal"),
                   (p + "moe.w_up", (e, d, f), "normal"),
                   (p + "moe.w_down", (e, f, d), "normal")]
        if cfg["num_shared_experts"]:
            fs = f * cfg["num_shared_experts"]
            leaves += [(p + "moe.shared.w_gate", (d, fs), "normal"),
                       (p + "moe.shared.w_up", (d, fs), "normal"),
                       (p + "moe.shared.w_down", (fs, d), "normal")]
    if not cfg["tie_embeddings"]:
        leaves.append(("lm_head.table", (pv, d), "normal"))
    return leaves


def draw(cfg: dict, seed: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (name, float32 tensor on ``device``) for every leaf of
    ``layout(cfg)``. The normal leaves come out of flat buffers of at most
    CHUNK values, each filled by one call of a generator seeded with
    ``seed``; a leaf is a view of its buffer, so a caller that copies it
    and lets it go holds one buffer at a time."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & SEED_MASK)
    std = float(cfg["init_std"])
    group: List[Tuple[str, tuple]] = []
    size = 0

    def flush():
        buf = torch.empty(size, dtype=torch.float32, device=device)
        buf.normal_(0.0, std, generator=gen)
        off = 0
        for name, shape in group:
            n = int(np.prod(shape))
            yield name, buf[off:off + n].view(shape)
            off += n

    for name, shape, kind in layout(cfg):
        if kind == "ones":
            yield name, torch.ones(shape, dtype=torch.float32, device=device)
            continue
        n = int(np.prod(shape))
        if group and size + n > CHUNK:
            yield from flush()
            group, size = [], 0
        group.append((name, shape))
        size += n
    if group:
        yield from flush()


def load_into(model: torch.nn.Module, cfg: dict, seed: int) -> None:
    """Fill the program's ``model`` with the seed's weights: every leaf of
    ``layout(cfg)`` and no other, at its shape and in float32, or raise."""
    params = dict(model.named_parameters())
    want = {name: shape for name, shape, _ in layout(cfg)}
    have = {name: tuple(p.shape) for name, p in params.items()}
    if want != have:
        missing = sorted(set(want) - set(have))
        extra = sorted(set(have) - set(want))
        wrong = sorted(n for n in set(want) & set(have) if want[n] != have[n])
        raise ValueError(f"the program's model does not match the layout: "
                         f"missing {missing[:4]}, extra {extra[:4]}, "
                         f"shapes {wrong[:4]}")
    device = next(iter(params.values())).device
    with torch.no_grad():
        for name, value in draw(cfg, seed, device):
            p = params[name]
            if p.dtype != torch.float32:
                raise ValueError(f"{name} is {p.dtype}, the cell states "
                                 "float32")
            p.copy_(value)


def reference_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seed's weights as a dict, drawn again for the reference."""
    return dict(draw(cfg, seed, device))


def tokens(n_devices: int, samples: int, length: int, vocab: int,
           seed: int) -> np.ndarray:
    """(N, M, L) int32 token ids uniform over [0, vocab), one block draw
    from a generator keyed by (seed, 1): the fleet's samples."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 1]))
    return rng.integers(0, vocab, (n_devices, samples, length),
                        dtype=np.int32)


def check_rng(seed: int) -> np.random.Generator:
    """The generator, keyed by (seed, 2), that draws which batches the
    correctness check compares."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), 2]))
