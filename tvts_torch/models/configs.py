"""Model family configuration (counterpart of tvts_tpu/models/configs.py).

Plain dataclasses with the same fields and defaults as the JAX package, so one
configuration describes both towers.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    input_resolution: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    output_dim: int = 512
    num_frames: int = 12
    mask_ratio: float = 0.5
    mlp_ratio: float = 4.0
    act: str = "quick_gelu"  # "quick_gelu" (OpenAI CLIP) | "gelu" (OpenCLIP)
    # "openai": ln_post over all tokens, then proj; CLS = projected token 0.
    # "openclip": pooled = ln_post(CLS) @ proj; tokens = raw patch tokens @ proj.
    pool_style: str = "openai"
    ls_init: float | None = None  # LayerScale init (OpenCLIP option, None = off)
    patch_dropout: float = 0.0
    attentional_pool: bool = False
    n_queries: int = 256
    attn_pooler_heads: int = 8

    @property
    def patches_per_frame(self) -> int:
        return (self.input_resolution // self.patch_size) ** 2

    @property
    def n_keep(self) -> int:
        return int(self.patches_per_frame * (1.0 - self.mask_ratio))


@dataclasses.dataclass(frozen=True)
class TextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    layers: int = 12
    heads: int = 8
    output_dim: int = 512
    act: str = "quick_gelu"


@dataclasses.dataclass(frozen=True)
class SortConfig:
    embed_dim: int = 512
    depth: int = 2
    num_heads: int = 8
    num_classes: int = 4
    mlp_ratio: float = 4.0


@dataclasses.dataclass(frozen=True)
class TVTSv2Config:
    name: str
    vision: VisionConfig
    text: TextConfig
    sort: SortConfig
    num_clips: int = 4

    def eval_config(self) -> "TVTSv2Config":
        """Downstream/eval variant: no tube masking."""
        return dataclasses.replace(
            self, vision=dataclasses.replace(self.vision, mask_ratio=0.0)
        )


def tvtsv2_b_32() -> TVTSv2Config:
    return TVTSv2Config(
        name="TVTSv2_B_32",
        vision=VisionConfig(patch_size=32, width=768, layers=12, heads=12,
                            output_dim=512, mask_ratio=0.0),
        text=TextConfig(width=512, layers=12, heads=8, output_dim=512),
        sort=SortConfig(embed_dim=512, num_heads=8),
    )


def tvtsv2_b_16() -> TVTSv2Config:
    return TVTSv2Config(
        name="TVTSv2_B_16",
        vision=VisionConfig(patch_size=16, width=768, layers=12, heads=12,
                            output_dim=512, mask_ratio=0.5),
        text=TextConfig(width=512, layers=12, heads=8, output_dim=512),
        sort=SortConfig(embed_dim=512, num_heads=8),
    )


def tvtsv2_h_14() -> TVTSv2Config:
    return TVTSv2Config(
        name="TVTSv2_H_14",
        vision=VisionConfig(patch_size=14, width=1280, layers=32, heads=16,
                            output_dim=1024, mask_ratio=0.7, act="gelu",
                            pool_style="openclip"),
        text=TextConfig(width=1024, layers=24, heads=16, output_dim=1024, act="gelu"),
        sort=SortConfig(embed_dim=1024, num_heads=16),
    )


MODEL_REGISTRY = {
    "TVTSv2_B_32": tvtsv2_b_32,
    "TVTSv2_B_16": tvtsv2_b_16,
    "TVTSv2_H_14": tvtsv2_h_14,
}
