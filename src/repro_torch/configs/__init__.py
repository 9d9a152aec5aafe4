"""Config registry: ``get_config(name)``.

The port serves the five cascade tiers and every decoder-only
architecture of the JAX package's zoo: RecurrentGemma-9B, the three MoE
configs, the three dense GQA configs and Qwen2-VL-7B's language decoder.
The encoder-decoder and xLSTM configs are not ported yet and raise
``KeyError``.
"""
from __future__ import annotations

from repro_torch.configs import (deepseek_moe_16b, gemma_7b,
                                 granite_moe_1b_a400m, moonshot_v1_16b_a3b,
                                 qwen2_vl_7b, qwen3_32b, recurrentgemma_9b,
                                 stablelm_12b)
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.cascade_tiers import TIERS

ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    qwen3_32b, granite_moe_1b_a400m, moonshot_v1_16b_a3b, gemma_7b,
    recurrentgemma_9b, qwen2_vl_7b, deepseek_moe_16b, stablelm_12b)}

# the JAX package's model zoo, still to port (ROADMAP.md Queue A)
_UNPORTED = ("seamless-m4t-medium", "xlstm-350m")


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


__all__ = ["ARCHS", "ArchConfig", "get_config"]
