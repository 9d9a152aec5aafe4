"""Moonshot Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B].

DeepSeek-V3-style fine-grained MoE: 64 routed experts top-6 + 2 shared
experts, first layer dense.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    source="hf:moonshotai/Moonlight-16B-A3B (assignment: 48L/2048d/16H/kv16)",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    first_dense_layers=1,
    mlp_act="silu",
)
