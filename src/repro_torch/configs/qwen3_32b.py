"""Qwen3-32B [hf:Qwen/Qwen3-8B family card, scaled per assignment].

Dense decoder, GQA (64 query / 8 KV heads, head_dim 128), QK-RMSNorm,
SwiGLU MLP.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    source="hf:Qwen/Qwen3-8B (assignment: 64L/5120d/64H/kv8/ff25600)",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    mlp_act="silu",
    rope_theta=1_000_000.0,
)
