"""DeepSeekMoE-16B [arXiv:2401.06066].

Fine-grained MoE: 64 routed experts top-6 + 2 shared experts (expert FFN
dim 1408), first layer dense.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    source="arXiv:2401.06066 (DeepSeekMoE)",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    moe_d_ff=1408,
    vocab_size=102400,
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    first_dense_layers=1,
    mlp_act="silu",
)
