"""SeamlessM4T-medium [arXiv:2308.11596].

Encoder-decoder: 12-layer speech encoder (consumes stub-frontend frame
embeddings) + 12-layer text decoder with cross-attention, 256k vocab.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    source="arXiv:2308.11596 (SeamlessM4T)",
    num_layers=12,
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    audio_frames=1024,
    mlp_act="gelu",
)
