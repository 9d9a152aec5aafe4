"""Gemma-7B [arXiv:2403.08295].

Dense decoder, 16 heads with head_dim 256 (multi-query on 2B; 7B uses
full MHA -> kv=16 per assignment), GeGLU MLP, 256k vocab.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    source="arXiv:2403.08295 (Gemma)",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp_act="gelu",
    tie_embeddings=True,
)
