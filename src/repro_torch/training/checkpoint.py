"""Flat-npz checkpoints, in the JAX package's layout.

Leaves are stored under their path keys joined by ``/`` ("a/b/0/w"),
the step under ``__step__``, and a bfloat16 leaf as its raw uint16 bits
under ``__bf16__`` + key (npz has no bfloat16). A file goes to ``.tmp``
first and is renamed over the target, so a reader never sees half of
one. Either package reads what the other writes, bit for bit.

A tree is nested dicts, lists and tuples of tensors (or numpy arrays);
``restore`` rebuilds one shaped like a template, checking every leaf's
shape, and casts to the template's dtype and device. ``save_model`` /
``restore_model`` do the same for a module, its parameter names with
``.`` written as ``/``.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

SEP = "/"
BF16_TAG = "__bf16__"
STEP_KEY = "__step__"


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif tree is not None:
        yield SEP.join(path), tree


def _to_numpy(leaf):
    """(npz key prefix, array): bfloat16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return BF16_TAG, t.view(torch.int16).numpy().view(np.uint16)
        return "", t.numpy()
    return "", np.asarray(leaf)


def _save_flat(path: str, flat: dict, step: Optional[int]) -> None:
    if step is not None:
        flat[STEP_KEY] = np.asarray(step)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def save(path: str, tree: Any, step: Optional[int] = None) -> None:
    flat = {}
    for key, leaf in _leaves(tree):
        tag, arr = _to_numpy(leaf)
        flat[tag + key] = arr
    _save_flat(path, flat, step)


def _load(path: str):
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    step = int(data.pop(STEP_KEY)) if STEP_KEY in data else None
    return data, step


def _leaf_from(data, key, like: torch.Tensor) -> torch.Tensor:
    if BF16_TAG + key in data:
        arr = data[BF16_TAG + key]
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    elif key in data:
        t = torch.from_numpy(np.array(data[key]))
    else:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{key}: shape {tuple(t.shape)} != "
                         f"{tuple(like.shape)}")
    return t.to(dtype=like.dtype, device=like.device)


def _rebuild(tree, data, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, data, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, data, path + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    like = tree if isinstance(tree, torch.Tensor) else torch.as_tensor(tree)
    return _leaf_from(data, SEP.join(path), like)


def restore(path: str, template: Any):
    """(tree shaped like ``template``, with its leaves' dtypes and devices;
    step or None)."""
    data, step = _load(path)
    return _rebuild(template, data), step


def save_model(path: str, model: torch.nn.Module,
               step: Optional[int] = None) -> None:
    flat = {}
    for name, p in model.named_parameters():
        tag, arr = _to_numpy(p)
        flat[tag + name.replace(".", SEP)] = arr
    _save_flat(path, flat, step)


def restore_model(path: str, model: torch.nn.Module) -> Optional[int]:
    """Load a ``save_model`` file into ``model``'s parameters in place;
    the step or None."""
    data, step = _load(path)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(_leaf_from(data, name.replace(".", SEP), p))
    return step
