"""StableLM-2-12B [hf:stabilityai/stablelm-2-1_6b family card, scaled per
assignment].

Dense decoder, GQA 32 query / 8 KV heads (head_dim 160), SwiGLU MLP.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    source="hf:stabilityai/stablelm-2-12b (assignment: 40L/5120d/32H/kv8)",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    mlp_act="silu",
)
