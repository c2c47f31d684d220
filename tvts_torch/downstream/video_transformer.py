"""The Frozen-in-Time-style SpaceTimeTransformer, the v1 downstream encoder
variant (counterpart of tvts_tpu/downstream/video_transformer.py; reference
v1/downstream/video_transformer.py, timm lineage). Against the CLIP-style
tower of models/space_time_vit.py:
- input [B, C, T, H, W] (permuted inside, reference :302-304);
- a per-frame 2-D conv patchify with a bias (`patch_embed.proj`, :54-76);
- timm's parameters: the zero-init `cls_token` added before the position
  embedding, `pos_embed` [1, n + 1, D] holding the CLS slot and
  `temporal_embed` [1, num_frames, D] (:236-242); the embedding truncated to
  the clip's tokens, so shorter clips run (:321);
- LayerNorm eps 1e-6 in float32 (:229), timm's Mlp (fc1, exact gelu, fc2),
  both block residuals from the block input x (:162-177);
- the head: `norm`, the CLS row, the optional `pre_logits` (fc + tanh), then
  `head` (:329-341).
The attention is models/layers.py's `var_attention`, plain (the JAX module
has no `use_pallas`): this encoder reaches no hand-written kernel. The
parameters carry the reference's timm names, so a reference state dict
loads unchanged (utils/convert.frozen_state_dict_from_jax maps the JAX
module's tree to them). The compute dtype is `compute_dtype` when set (bf16
over float32 weights), else the weights'.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tvts_torch.models.layers import LayerNormF32, VarAttention, lecun_normal_, linear

LN_EPS = 1e-6


def _reset_linear(layer: nn.Linear, generator: torch.Generator) -> None:
    """Flax Dense's init: lecun normal kernel, zero bias."""
    lecun_normal_(layer.weight, layer.in_features, generator)
    nn.init.zeros_(layer.bias)


class FrozenMlp(nn.Module):
    """fc1 -> exact gelu -> fc2 (timm's Mlp)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _reset_linear(self.fc1, generator)
        _reset_linear(self.fc2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(linear(x, self.fc1.weight, self.fc1.bias), approximate="none")
        return linear(x, self.fc2.weight, self.fc2.bias)


class FrozenBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm3 = LayerNormF32(dim, eps=LN_EPS)
        self.timeattn = VarAttention(dim, num_heads, zero_init=True)
        self.norm1 = LayerNormF32(dim, eps=LN_EPS)
        self.attn = VarAttention(dim, num_heads)
        self.norm2 = LayerNormF32(dim, eps=LN_EPS)
        self.mlp = FrozenMlp(dim, int(dim * mlp_ratio))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for ln in (self.norm3, self.norm1, self.norm2):
            ln.reset_parameters()
        self.timeattn.reset_parameters(generator)
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def forward(self, x: torch.Tensor, num_frames: int, patches_per_frame: int) -> torch.Tensor:
        t_out = self.timeattn(self.norm3(x), num_frames, patches_per_frame, "time")
        time_residual = x + t_out
        s_out = self.attn(self.norm1(time_residual), num_frames, patches_per_frame, "space")
        space_residual = x + s_out  # both residuals branch from the block input
        return space_residual + self.mlp(self.norm2(space_residual))


class VideoPatchEmbed(nn.Module):
    """The per-frame conv patchify, with a bias."""

    def __init__(self, embed_dim: int, patch_size: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, kernel_size=patch_size, stride=patch_size)


class _PreLogits(nn.Module):
    def __init__(self, dim: int, size: int):
        super().__init__()
        self.fc = nn.Linear(dim, size)


class SpaceTimeTransformer(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 16, num_classes: int = 174,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, num_frames: int = 16,
                 representation_size: int | None = None):
        super().__init__()
        self.patch_size, self.num_frames, self.num_classes = patch_size, num_frames, num_classes
        self.compute_dtype: torch.dtype | None = None  # None: the weights' dtype
        n = (img_size // patch_size) ** 2
        self.patch_embed = VideoPatchEmbed(embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n + 1, embed_dim))
        self.temporal_embed = nn.Parameter(torch.zeros(1, num_frames, embed_dim))
        self.blocks = nn.ModuleList(FrozenBlock(embed_dim, num_heads, mlp_ratio)
                                    for _ in range(depth))
        self.norm = LayerNormF32(embed_dim, eps=LN_EPS)
        width = embed_dim
        self.pre_logits = None
        if representation_size:
            self.pre_logits = _PreLogits(embed_dim, representation_size)
            width = representation_size
        self.head = nn.Linear(width, num_classes) if num_classes > 0 else None

    def set_compute_dtype(self, dtype: torch.dtype | None) -> None:
        self.compute_dtype = dtype

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX module's initializers, drawn from `generator`."""
        w = self.patch_embed.proj.weight
        lecun_normal_(w, w[0].numel(), generator)
        nn.init.zeros_(self.patch_embed.proj.bias)
        nn.init.zeros_(self.cls_token)
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        nn.init.zeros_(self.temporal_embed)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        self.norm.reset_parameters()
        for layer in (self.pre_logits and self.pre_logits.fc, self.head):
            if layer is not None:
                _reset_linear(layer, generator)

    def forward(self, video: torch.Tensor, return_features: bool = False) -> torch.Tensor:
        """video [B, C, T, H, W] -> logits [B, num_classes] (the CLS features
        with `return_features` or without a head)."""
        B, C, T, H, W = video.shape
        conv = self.patch_embed.proj
        dtype = self.compute_dtype or conv.weight.dtype
        frames = video.transpose(1, 2).reshape(B * T, C, H, W).to(dtype)
        x = F.conv2d(frames, conv.weight.to(dtype), conv.bias.to(dtype), stride=self.patch_size)
        n = x.shape[2] * x.shape[3]
        x = x.flatten(2).transpose(1, 2).reshape(B, T * n, -1)       # (t, h, w) order
        x = torch.cat([self.cls_token.to(dtype).expand(B, -1, -1), x], 1)
        pos = self.pos_embed.float()
        patches = pos[:, 1:].repeat(1, self.num_frames, 1) \
            + self.temporal_embed.float().repeat_interleave(n, dim=1)
        total = torch.cat([pos[:, :1], patches], 1)
        x = x + total[:, :x.shape[1]].to(dtype)  # truncated for clips under num_frames
        for blk in self.blocks:
            x = blk(x, T, n)
        feats = self.norm(x)[:, 0]
        if self.pre_logits is not None:
            feats = torch.tanh(linear(feats, self.pre_logits.fc.weight, self.pre_logits.fc.bias))
        if return_features or self.head is None:
            return feats
        return linear(feats, self.head.weight, self.head.bias)
