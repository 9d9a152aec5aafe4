"""xLSTM-350M [arXiv:2405.04517].

SSM-family: alternating mLSTM (matrix memory, chunkwise-parallel) and
sLSTM (scalar memory, sequential) blocks; no separate FFN (d_ff=0, blocks
are self-contained). O(1) decode state -> runs long_500k natively.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    source="arXiv:2405.04517 (xLSTM)",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    layer_pattern=("mlstm", "slstm"),
    slstm_num_heads=4,
    tie_embeddings=True,
)
