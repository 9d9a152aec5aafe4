"""Kernel dispatch layer: the single entry point into the port's kernels.

Every hot-path consumer (``serving/executables.py`` and
``launch/distributed.py`` through BvSB, ``models/attention.py``,
``models/recurrent.py``, ``models/moe.py``) calls the functions here.
Dispatch follows the tensor's device, never a mode switch:

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
``flash_attention_bwd`` / ``rglru_scan_bwd``; BvSB, decode attention
(the partial and merge entries of both too) and the MoE dispatch and
combine have no backward, and such a call raises (``models/moe.py`` runs
the plain versions under autograd). No CUDA call returns an output
cut off from the graph. The serving step factories run under
``torch.inference_mode()``.

A ``meta`` tensor (the dry-run) launches nothing and counts nothing: each
wrapper returns outputs of its kernel's shapes and books the kernel's work
(``roofline.analysis``).

The planners' constants (``PLAN_KNOBS``: BvSB's chunks, decode's splits,
the scan's rings) are the modules' own unless ``kernels/autotune.py`` has
persisted winners for this card into ``TUNED_PLANS_PATH``:
``reload_plans`` sets them from the file's entry for the card's name (read
at import where the file exists and a card is present), and
``cache_token`` folds the plans in force into the executable cache's key,
so a retune never reuses an executable built under other plans. Nothing
tunes implicitly.
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Dict, Optional

import torch

from repro_torch.kernels import bvsb as _bvsb
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import moe_route as _moe
from repro_torch.kernels import rglru_scan as _rglru

bvsb = _bvsb.bvsb
bvsb_partials = _bvsb.bvsb_partials
bvsb_merge = _bvsb.bvsb_merge
flash_attention = _flash.flash_attention
decode_attention = _decode.decode_attention
decode_attention_partials = _decode.decode_attention_partials
decode_attention_merge = _decode.decode_attention_merge
rglru_scan = _rglru.rglru_scan
moe_dispatch = _moe.moe_dispatch
moe_combine = _moe.moe_combine

# kernel -> (its wrapper's module, the module's count of its launches)
_COUNTS = {"bvsb": (_bvsb, "launches"),
           "bvsb_partials": (_bvsb, "partials_launches"),
           "bvsb_merge": (_bvsb, "merge_launches"),
           "flash_attention": (_flash, "launches"),
           "decode_attention": (_decode, "launches"),
           "decode_attention_partials": (_decode, "partials_launches"),
           "decode_attention_merge": (_decode, "merge_launches"),
           "rglru_scan": (_rglru, "launches"),
           "flash_attention_bwd": (_flash, "bwd_launches"),
           "rglru_scan_bwd": (_rglru, "bwd_launches"),
           "moe_dispatch": (_moe, "dispatch_launches"),
           "moe_combine": (_moe, "combine_launches")}
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


# the planners' constants that autotune sweeps: kernel -> (module, names)
PLAN_KNOBS = {"bvsb": (_bvsb, ("BLOCKS_PER_SM", "MIN_CHUNK")),
              "decode_attention": (_decode, ("BLOCKS_PER_SM",
                                             "SHARD_MIN_KEYS")),
              "rglru_scan": (_rglru, ("IN_FLIGHT", "STAGES", "BWD_STEPS"))}
DEFAULT_PLANS = {k: {n: getattr(mod, n) for n in names}
                 for k, (mod, names) in PLAN_KNOBS.items()}
# autotune's winners by card name; not committed: the modules' constants
# stand where the file or the card's entry is missing
TUNED_PLANS_PATH = pathlib.Path(__file__).resolve().parent / \
    "tuned_plans.json"


def plans() -> Dict[str, Dict[str, int]]:
    """The planners' constants in force, by kernel."""
    return {k: {n: getattr(mod, n) for n in names}
            for k, (mod, names) in PLAN_KNOBS.items()}


def set_plans(values: Dict[str, Dict[str, int]]) -> None:
    """Set planners' constants ({kernel: {name: value}}); the names must be
    ``PLAN_KNOBS``'."""
    for kernel, knobs in values.items():
        mod, names = PLAN_KNOBS[kernel]
        for name, value in knobs.items():
            if name not in names:
                raise KeyError(f"{kernel} has no plan constant {name}")
            setattr(mod, name, int(value))


def reload_plans(path=None, card: Optional[str] = None) -> dict:
    """Put the planners' constants back to the modules' defaults, then set
    those that the tuned file (``path``, default TUNED_PLANS_PATH) holds
    for ``card`` (default: the name of the current CUDA device where one
    is present); the plans in force."""
    set_plans(DEFAULT_PLANS)
    path = pathlib.Path(path or TUNED_PLANS_PATH)
    if card is None and torch.cuda.is_available() and path.exists():
        card = torch.cuda.get_device_name()
    if card is not None and path.exists():
        entry = json.loads(path.read_text()).get(card, {})
        set_plans({k: v for k, v in entry.items() if k in PLAN_KNOBS})
    return plans()


def cache_token(device) -> tuple:
    """What the executable cache folds into its key for ``device``: which
    implementation runs there (the CUDA kernels or the plain versions),
    and on a card the planners' constants in force."""
    kind = torch.device(device).type
    if kind != "cuda":
        return ("plain", kind)
    return ("cuda-kernels",) + tuple(
        (k, n, v) for k, knobs in sorted(plans().items())
        for n, v in sorted(knobs.items()))


if os.path.exists(TUNED_PLANS_PATH):
    reload_plans()
