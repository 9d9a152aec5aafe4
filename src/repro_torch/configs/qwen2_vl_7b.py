"""Qwen2-VL-7B [arXiv:2409.12191].

VLM: language decoder with M-RoPE (sections t/h/w = 16/24/24 over
head_dim/2 = 64) consuming ViT patch embeddings from the stub frontend
(dynamic-resolution vision encoder is out of scope per the task brief).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    source="arXiv:2409.12191 (Qwen2-VL)",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    mlp_act="silu",
    mrope_sections=(16, 24, 24),
    vision_tokens=1024,
    rope_theta=1_000_000.0,
)
