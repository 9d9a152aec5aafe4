"""Architecture configuration (own copy of the JAX package's ``ArchConfig``).

One frozen dataclass covers every architecture family; fields a family
does not use are ignored. The field set and defaults match the JAX
package, so ``repr(cfg)`` names the same architecture in both.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity ---------------------------------------------------------
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    source: str  # citation for the config numbers

    # trunk ------------------------------------------------------------
    num_layers: int = 12
    d_model: int = 1024
    num_heads: int = 16
    num_kv_heads: int = 16
    head_dim: Optional[int] = None  # default d_model // num_heads
    d_ff: int = 4096
    vocab_size: int = 32000
    max_seq_len: int = 532_480  # positional capacity (rope-based: free)

    # attention variants -------------------------------------------------
    qk_norm: bool = False                 # qwen3
    mlp_act: str = "silu"                 # silu (SwiGLU) | gelu (GeGLU)
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # local attention window (if set)
    logit_soft_cap: Optional[float] = None
    tie_embeddings: bool = False

    # MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: Optional[int] = None
    first_dense_layers: int = 0
    router_aux_loss_coef: float = 0.001

    # hybrid -------------------------------------------------------------
    # layer_pattern is tiled to num_layers; entries: "attn", "rglru",
    # "mlstm", "slstm". None => all-"attn".
    layer_pattern: Optional[Sequence[str]] = None
    rglru_d_conv: int = 4
    local_attn_window: int = 2048

    # ssm ----------------------------------------------------------------
    slstm_num_heads: int = 4

    # vlm ----------------------------------------------------------------
    vision_tokens: int = 0
    mrope_sections: Sequence[int] = ()

    # audio / encoder-decoder --------------------------------------------
    encoder_layers: int = 0
    audio_frames: int = 0

    # norm/init ----------------------------------------------------------
    norm_eps: float = 1e-6
    init_scale: float = 0.02

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def pattern(self) -> tuple:
        if self.layer_pattern is None:
            return ("attn",) * self.num_layers
        p = tuple(self.layer_pattern)
        reps = (self.num_layers + len(p) - 1) // len(p)
        return (p * reps)[: self.num_layers]

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Approximate parameter count (exact for our implementation)."""
        hd = self.resolved_head_dim
        d = self.d_model
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        if self.qk_norm:
            attn += 2 * hd
        dense_mlp = 3 * d * self.d_ff if self.d_ff else 0
        n = 0
        for kind in self.pattern:
            if kind == "attn":
                n += attn + dense_mlp + 2 * d
            elif kind == "rglru":
                # griffin recurrent block: in/out proj + conv + gates + mlp
                dr = d  # recurrence width
                n += 2 * d * dr + dr * self.rglru_d_conv + 2 * dr * dr + 2 * dr + dense_mlp + 2 * d
            elif kind == "mlstm":
                n += 4 * d * d + 3 * d * (d // 2) + dense_mlp + 2 * d
            elif kind == "slstm":
                n += 8 * d * d + dense_mlp + 2 * d
        if self.is_moe:
            n = 0
            e_ff = self.moe_d_ff or self.d_ff
            expert = 3 * d * e_ff
            router = d * self.num_experts
            for li, kind in enumerate(self.pattern):
                mlp = dense_mlp if li < self.first_dense_layers else (
                    self.num_experts * expert + self.num_shared_experts * expert + router)
                n += attn + mlp + 2 * d
        n += self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d  # lm head
        if self.is_encoder_decoder:
            enc = self.encoder_layers * (attn + dense_mlp + 2 * d)
            cross = len(self.pattern) * attn  # cross-attention per decoder layer
            n += enc + cross
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        e_ff = self.moe_d_ff or self.d_ff
        expert = 3 * d * e_ff
        inactive_per_layer = (self.num_experts - self.num_experts_per_tok) * expert
        n_moe_layers = self.num_layers - self.first_dense_layers
        return self.param_count() - n_moe_layers * inactive_per_layer

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """The JAX package's CPU-smoke-size variant of the same family:
        narrow widths, the family's layer pattern kept whole."""
        kw = dict(
            num_layers=2,
            d_model=min(self.d_model, 256),
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads > 1 else 1,
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 1024),
        )
        if self.is_moe:
            kw.update(num_experts=4, num_experts_per_tok=2,
                      num_shared_experts=min(self.num_shared_experts, 1),
                      moe_d_ff=64, first_dense_layers=min(self.first_dense_layers, 1))
        if self.layer_pattern is not None:
            kw["num_layers"] = max(2, len(tuple(self.layer_pattern)))
        if self.is_encoder_decoder:
            kw["encoder_layers"] = 2
            kw["audio_frames"] = min(self.audio_frames, 64) or 64
        if self.family == "vlm":
            kw["vision_tokens"] = 16
            kw["mrope_sections"] = (8, 12, 12)
        if self.sliding_window:
            kw["sliding_window"] = 128
        if self.family == "hybrid":
            kw["local_attn_window"] = 128
        return self.with_(**kw)


# ---------------------------------------------------------------------------
# input shapes (the JAX package's assigned ones)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
