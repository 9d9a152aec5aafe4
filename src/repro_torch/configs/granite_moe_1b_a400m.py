"""IBM Granite 3.0 1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base].

Fine-grained MoE: 32 experts, top-8 routing, per-expert FFN dim 512.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    moe_d_ff=512,
    vocab_size=49155,
    num_experts=32,
    num_experts_per_tok=8,
    mlp_act="silu",
    tie_embeddings=True,
)
