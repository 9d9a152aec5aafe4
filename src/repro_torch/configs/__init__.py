"""Config registry: ``get_config(name)``.

The port serves the five cascade tiers and RecurrentGemma-9B. The JAX
package's other architectures are not ported yet and raise ``KeyError``.
"""
from __future__ import annotations

from repro_torch.configs import recurrentgemma_9b
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.cascade_tiers import TIERS

ARCHS = {"recurrentgemma-9b": recurrentgemma_9b.CONFIG}

# the JAX package's model zoo, still to port (ROADMAP.md Queue A)
_UNPORTED = ("qwen3-32b", "granite-moe-1b-a400m", "moonshot-v1-16b-a3b",
             "gemma-7b", "qwen2-vl-7b", "deepseek-moe-16b",
             "seamless-m4t-medium", "xlstm-350m", "stablelm-12b")


def get_config(name: str) -> ArchConfig:
    if name in TIERS:
        return TIERS[name]
    if name in ARCHS:
        return ARCHS[name]
    if name in _UNPORTED:
        raise KeyError(f"arch {name!r} is not ported to repro_torch yet "
                       "(ROADMAP.md Queue A, the rest of the model zoo)")
    raise KeyError(f"unknown arch {name!r}; known: "
                   f"{sorted(TIERS) + sorted(ARCHS)}")


__all__ = ["ArchConfig", "get_config"]
