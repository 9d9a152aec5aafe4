"""Cascade tier configs + device/server profiles (paper Table I).

Own copy of the JAX package's ``configs/cascade_tiers.py``. Each tier is
a small dense MHA decoder served by the live cascade; the paper's
measured device latencies and server batch-latency curves drive the
virtual clock. Latency in seconds; accuracy in [0, 1].
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.configs.base import ArchConfig


def _tiny(name, layers, d, heads, ff, vocab=2048):
    return ArchConfig(
        name=name, family="dense", source="cascade tier (live example model)",
        num_layers=layers, d_model=d, num_heads=heads, num_kv_heads=heads,
        head_dim=d // heads, d_ff=ff, vocab_size=vocab, tie_embeddings=True)


TIERS: Dict[str, ArchConfig] = {
    "tier-low": _tiny("tier-low", 2, 128, 4, 256),
    "tier-mid": _tiny("tier-mid", 3, 192, 4, 384),
    "tier-high": _tiny("tier-high", 4, 256, 8, 512),
    "tier-server-fast": _tiny("tier-server-fast", 6, 384, 8, 768),
    "tier-server-heavy": _tiny("tier-server-heavy", 8, 512, 8, 1024),
}


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    model: str
    tier: str          # low | mid | high
    accuracy: float    # ImageNet top-1
    latency: float     # on-device inference latency (s)


@dataclasses.dataclass(frozen=True)
class ServerProfile:
    name: str
    model: str
    accuracy: float
    base_latency: float          # batch-1 latency (s)
    max_batch: int               # diminishing-returns cap (paper Sec. V-A)
    batch_scaling: float = 0.05  # marginal per-extra-sample cost vs batch-1

    def batch_latency(self, b: int) -> float:
        """Latency of one batched inference at batch size b (s)."""
        return self.base_latency * (1.0 + self.batch_scaling * (b - 1))

    def throughput(self, b: int) -> float:
        return b / self.batch_latency(b)


DEVICE_PROFILES = {
    "low": DeviceProfile("low", "MobileNetV2 @ Sony Xperia C5", "low",
                         0.7185, 0.031),
    "mid": DeviceProfile("mid", "EfficientNetLite0 @ Samsung A71", "mid",
                         0.7502, 0.043),
    "high": DeviceProfile("high", "EfficientNetB0 @ Samsung S20 FE", "high",
                          0.7704, 0.033),
    "vit-high": DeviceProfile("vit-high", "MobileViT-x-small @ Pixel 7",
                              "high", 0.7464, 0.057),
}

SERVER_PROFILES = {
    "inceptionv3": ServerProfile("inceptionv3", "InceptionV3 @ T4",
                                 0.7829, 0.015, 64),
    "efficientnetb3": ServerProfile("efficientnetb3", "EfficientNetB3 @ T4",
                                    0.8149, 0.025, 16),
    "deit-base": ServerProfile("deit-base", "DeiT-Base-Distilled @ T4",
                               0.8341, 0.014, 32),
}

BATCH_LADDER: Tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)
