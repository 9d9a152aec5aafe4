"""Stand-ins for every model input: tensors on the ``meta`` device with
the JAX package's shapes and dtypes, which allocate nothing.

Counterpart of the JAX package's ``launch/inputs.py`` (its
``ShapeDtypeStruct`` stand-ins). For decode shapes the cache is the full
context's (ONE new token over a cache of seq_len). Dense full-attention
configs at long_500k take their sliding-window variant (window 4096), as
there.

    batch = batch_specs(cfg, INPUT_SHAPES["train_4k"])   # {"tokens", "labels"}
    tokens1, cache, pos = decode_specs(None, cfg, INPUT_SHAPES["decode_32k"])
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import torch

from repro_torch.configs.base import ArchConfig, InputShape

LONG_WINDOW = 4096  # sliding-window variant for dense archs at 500k
META = torch.device("meta")


def arch_for_shape(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """The config a shape runs: the windowed long-context variant of a
    dense full-attention config (and of the encoder-decoder) at
    long_500k, else ``cfg``."""
    if shape.name == "long_500k" and cfg.sliding_window is None \
            and cfg.layer_pattern is None and not cfg.is_encoder_decoder:
        cfg = cfg.with_(sliding_window=LONG_WINDOW)
    if shape.name == "long_500k" and cfg.is_encoder_decoder:
        cfg = cfg.with_(sliding_window=LONG_WINDOW)
    return cfg


def batch_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, Any]:
    """The train / prefill batch: int32 ``tokens`` (and ``labels`` for a
    train shape), a VLM's f32 ``vision_embeds`` (min(vision tokens, S / 2)
    of the S positions), an encoder-decoder's f32 ``audio_embeds``."""
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {}
    s_text = s
    if cfg.family == "vlm":
        v = min(cfg.vision_tokens, s // 2)
        s_text = s - v
        out["vision_embeds"] = torch.empty(b, v, cfg.d_model,
                                           dtype=torch.float32, device=META)
    if cfg.is_encoder_decoder:
        out["audio_embeds"] = torch.empty(b, cfg.audio_frames, cfg.d_model,
                                          dtype=torch.float32, device=META)
    out["tokens"] = torch.empty(b, s_text, dtype=torch.int32, device=META)
    if shape.kind == "train":
        out["labels"] = torch.empty(b, s_text, dtype=torch.int32,
                                    device=META)
    return out


def _meta_model(model, cfg, dtype=torch.float32):
    from repro_torch.models.model import build_model
    return model if model is not None else build_model(cfg, device=META,
                                                       dtype=dtype)


def cache_specs(model, cfg: ArchConfig, shape: InputShape,
                dtype=torch.bfloat16) -> Any:
    """The decode cache at the shape's batch and context, from the
    model's ``init_cache`` (a model built on ``meta`` when ``model`` is
    None)."""
    return _meta_model(model, cfg).init_cache(shape.global_batch,
                                              shape.seq_len, dtype)


def decode_specs(model, cfg: ArchConfig, shape: InputShape) -> tuple:
    """(tokens1 (B, 1) int32, cache, pos (B,) int32) of a serve step."""
    b = shape.global_batch
    return (torch.empty(b, 1, dtype=torch.int32, device=META),
            cache_specs(model, cfg, shape),
            torch.empty(b, dtype=torch.int32, device=META))


def params_specs(model, cfg: ArchConfig = None,
                 dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The parameters by name, as ``meta`` tensors (a model built on
    ``meta`` from ``cfg`` when ``model`` is None)."""
    return dict(_meta_model(model, cfg, dtype).named_parameters())


def cache_leaves(cache, cfg) -> Iterator[Tuple[tuple, int, torch.Tensor]]:
    """Each leaf of a port cache as (the JAX cache tree's path, the layer
    index into a stacked leaf or -1, the tensor): the decoder's layers
    under "prefix" / "blocks" / "tail" as ``transformer.init_cache``
    stacks them, an encoder-decoder's under its stacked "self" / "cross"."""
    from repro_torch.models.model import _jax_location
    for i, entry in enumerate(cache):
        if cfg.is_encoder_decoder:
            for key in ("k", "v"):
                yield ("self", key), i, entry["self"][key]
            for j, t in enumerate(entry["cross"]):
                yield ("cross", j), i, t
            continue
        path, layer, _ = _jax_location(f"layers.{i}.x", cfg)
        for key, t in entry.items():
            if isinstance(t, torch.Tensor):
                yield path[:-1] + (key,), layer, t
