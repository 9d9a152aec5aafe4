"""Config registry: ``get_config(name)``.

The port serves the five cascade tiers and every architecture of the JAX
package's zoo: RecurrentGemma-9B, xLSTM-350M, the three MoE configs, the
three dense GQA configs, Qwen2-VL-7B's language decoder and the
SeamlessM4T-medium encoder-decoder. ``INPUT_SHAPES`` are the JAX
package's assigned input shapes.
"""
from __future__ import annotations

from repro_torch.configs import (deepseek_moe_16b, gemma_7b,
                                 granite_moe_1b_a400m, moonshot_v1_16b_a3b,
                                 qwen2_vl_7b, qwen3_32b, recurrentgemma_9b,
                                 seamless_m4t_medium, stablelm_12b,
                                 xlstm_350m)
from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, InputShape
from repro_torch.configs.cascade_tiers import TIERS

ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    qwen3_32b, granite_moe_1b_a400m, moonshot_v1_16b_a3b, gemma_7b,
    recurrentgemma_9b, qwen2_vl_7b, deepseek_moe_16b, seamless_m4t_medium,
    xlstm_350m, stablelm_12b)}


def get_config(name: str) -> ArchConfig:
    if name in TIERS:
        return TIERS[name]
    if name in ARCHS:
        return ARCHS[name]
    raise KeyError(f"unknown arch {name!r}; known: "
                   f"{sorted(TIERS) + sorted(ARCHS)}")


__all__ = ["ARCHS", "INPUT_SHAPES", "ArchConfig", "InputShape", "get_config"]
