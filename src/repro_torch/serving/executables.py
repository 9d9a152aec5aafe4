"""Process-wide cache of the serving path's classify functions.

The live cascade runs the same classification forward — model trunk,
last-position logits, confidence metric — from many call sites: every
``DeviceClient``, every ``ServedModel`` of a ``ServerEngine``, every
ladder bucket. This cache keys the function by what determines it:

    (model architecture, parameter names/shapes/dtypes, ladder bucket,
     confidence metric, kernel token of the model's device)

so N clients sharing a light model share one entry, and the number of
entries is bounded by the distinct buckets dispatched, never by client or
model count. The function takes the model as an argument, so models of
one architecture share it. PyTorch runs eagerly: an entry is a closure,
not a compiled artifact, and the cache keeps the JAX package's
hits/misses contract. ``kernels.ops.cache_token`` in the key keeps the
card's entries (CUDA kernels) apart from the CPU's (plain versions).
Lookups, inserts and the counters run under ``_LOCK``: the serving
transport's worker threads call ``classify_fn`` concurrently. The
model's head runs in a ``model.head`` span (``serving/spans.py``).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core import decision
from repro_torch.kernels import ops
from repro_torch.serving import spans

_CACHE: Dict[Tuple, Callable] = {}
_HITS = 0
_MISSES = 0
_LOCK = threading.Lock()


def _shape_key(model) -> Tuple:
    return tuple((name, tuple(p.shape), str(p.dtype))
                 for name, p in model.named_parameters())


def classify_fn(model, bucket: int, metric: str = "bvsb") -> Callable:
    """The ``(model, tokens (bucket, L)) -> (conf, pred)`` forward for this
    (architecture, parameter shapes, bucket, metric, device kind)."""
    global _HITS, _MISSES
    key = (repr(model.cfg), _shape_key(model), int(bucket), metric,
           ops.cache_token(model.device))
    with _LOCK:
        fn = _CACHE.get(key)
        if fn is None:
            _MISSES += 1
            metric_fn = decision.METRICS[metric]

            def fn(model, tokens):
                with torch.inference_mode():
                    hidden, _ = model(tokens, return_hidden=True)
                    with spans.span("model.head"):
                        logits = model.head(hidden)
                    return metric_fn(logits[:, -1, :])

            _CACHE[key] = fn
        else:
            _HITS += 1
    return fn


def cache_stats() -> Dict[str, int]:
    with _LOCK:
        return {"executables": len(_CACHE), "hits": _HITS,
                "misses": _MISSES}


def clear_cache() -> None:
    """Drop every cached function (tests that count from a cold cache)."""
    global _HITS, _MISSES
    with _LOCK:
        _CACHE.clear()
        _HITS = 0
        _MISSES = 0
