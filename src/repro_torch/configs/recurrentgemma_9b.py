"""RecurrentGemma-9B / Griffin [arXiv:2402.19427] (own copy of the JAX
package's config).

Hybrid: repeating (RG-LRU, RG-LRU, local-attention) pattern — 2:1 recurrent
to local-attention, window 2048, MQA (kv=1, head_dim 256). Natively
sub-quadratic: decode holds O(window + state) memory.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    source="arXiv:2402.19427 (Griffin/RecurrentGemma)",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    layer_pattern=("rglru", "rglru", "lattn"),
    local_attn_window=2048,
    mlp_act="gelu",
    tie_embeddings=True,
)
