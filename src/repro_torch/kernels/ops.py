"""Kernel dispatch layer: the single entry point into the port's kernels.

Every hot-path consumer (``serving/executables.py`` and
``launch/distributed.py`` through BvSB, ``models/attention.py``,
``models/recurrent.py``) calls the functions here. Dispatch follows the
tensor's device, never a mode switch:

* a CPU tensor runs the kernel's plain PyTorch version;
* a CUDA tensor launches the hand-written CUDA kernel, or raises.

So a card can never quietly run the plain path. Each kernel wrapper
counts its launches (``launch_counts``), which is how a run shows that
it really went through the kernels. A count is incremented under its
module's ``COUNT_LOCK``, so launches from the serving transport's worker
threads are none of them lost.

Under autograd (grad mode on and an input that requires grad) a CUDA call
of flash attention or of the RG-LRU scan goes through the kernel's
``torch.autograd.Function``, whose backward is a kernel too, counted as
``flash_attention_bwd`` / ``rglru_scan_bwd``; BvSB and decode attention
have no backward, and such a call raises. No CUDA call returns an output
cut off from the graph. The serving step factories run under
``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import bvsb as _bvsb
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import rglru_scan as _rglru

bvsb = _bvsb.bvsb
flash_attention = _flash.flash_attention
decode_attention = _decode.decode_attention
rglru_scan = _rglru.rglru_scan

# kernel -> (its wrapper's module, the module's count of its launches)
_COUNTS = {"bvsb": (_bvsb, "launches"),
           "flash_attention": (_flash, "launches"),
           "decode_attention": (_decode, "launches"),
           "rglru_scan": (_rglru, "launches"),
           "flash_attention_bwd": (_flash, "bwd_launches"),
           "rglru_scan_bwd": (_rglru, "bwd_launches")}
_KERNELS = {name: mod for name, (mod, _) in _COUNTS.items()}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last ``reset_launch_counts``."""
    out = {}
    for name, (mod, attr) in _COUNTS.items():
        with mod.COUNT_LOCK:
            out[name] = getattr(mod, attr)
    return out


def reset_launch_counts() -> None:
    for mod, attr in _COUNTS.values():
        with mod.COUNT_LOCK:
            setattr(mod, attr, 0)


def cache_token(device) -> tuple:
    """What the executable cache folds into its key for ``device``: which
    implementation runs there (the CUDA kernels or the plain versions)."""
    kind = torch.device(device).type
    return ("cuda-kernels",) if kind == "cuda" else ("plain", kind)
