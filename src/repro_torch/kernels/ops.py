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

_KERNELS = {"bvsb": _bvsb, "flash_attention": _flash,
            "decode_attention": _decode, "rglru_scan": _rglru}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last ``reset_launch_counts``."""
    out = {}
    for name, mod in _KERNELS.items():
        with mod.COUNT_LOCK:
            out[name] = mod.launches
    return out


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        with mod.COUNT_LOCK:
            mod.launches = 0


def cache_token(device) -> tuple:
    """What the executable cache folds into its key for ``device``: which
    implementation runs there (the CUDA kernels or the plain versions)."""
    kind = torch.device(device).type
    return ("cuda-kernels",) if kind == "cuda" else ("plain", kind)
