"""The TVTS v1 video tower: a joint space-time attention ViT with a Conv3d
tubelet patchify and per-tube masking (counterpart of
tvts_tpu/models/joint_vit.py; reference v1/model/video_encoder.py).

- patchify: Conv3d, kernel = stride = (tubelet, p, p), the reference's
  `patch_embed.proj` weight [D, 3, tubelet, p, p] (:78-99);
- positions: the spatial `pos_embed[:, 1:]` tiled over the tubes plus
  `temporal_embed[:n_tubes]` a tube, summed in float32 and cast to the
  compute dtype (:186-196);
- masking: `keep_ind` [B, n_tubes, n_keep] keeps a different spatial set in
  each tube (:199-207); None keeps every patch. Every patch is embedded and
  then gathered, as in the JAX package;
- CLS = cls_token + pos_embed[0], then pre-norm blocks of full attention
  over [CLS ; every kept token] (LayerNorm eps 1e-6, exact gelu), the final
  `norm` (eps 1e-6), and the optional `head` on every token (:218-222).
The block is the sort head's (models/sort.py `SortBlock`): the same
parameters under the same names (`norm1`, `attn.qkv`, `attn.proj`, `norm2`,
`mlp.fc1`, `mlp.fc2`) and the same arithmetic.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tvts_torch.models.configs import SortConfig
from tvts_torch.models.layers import LayerNormF32, lecun_normal_, linear
from tvts_torch.models.sort import SortBlock
from tvts_torch.utils.profiling import annotate

LN_EPS = 1e-6


class JointBlock(SortBlock):
    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__(SortConfig(embed_dim=dim, num_heads=heads, mlp_ratio=mlp_ratio))


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, patch_size: int, tubelet_size: int):
        super().__init__()
        k = (tubelet_size, patch_size, patch_size)
        self.proj = nn.Conv3d(3, embed_dim, kernel_size=k, stride=k)


class JointViT(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, heads: int = 12, num_frames: int = 16, tubelet_size: int = 2,
                 num_classes: int = 0):
        super().__init__()
        self.patch_size, self.tubelet_size, self.embed_dim = patch_size, tubelet_size, embed_dim
        self.compute_dtype: torch.dtype | None = None  # None: the weights' dtype
        N = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(embed_dim, patch_size, tubelet_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, N + 1, embed_dim))
        self.temporal_embed = nn.Parameter(torch.zeros(1, num_frames // tubelet_size, embed_dim))
        self.blocks = nn.ModuleList(JointBlock(embed_dim, heads) for _ in range(depth))
        self.norm = LayerNormF32(embed_dim, eps=LN_EPS)
        self.head = nn.Linear(embed_dim, num_classes) if num_classes > 0 else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializers, drawn from `generator`."""
        w = self.patch_embed.proj.weight
        lecun_normal_(w, w[0].numel(), generator)
        nn.init.zeros_(self.patch_embed.proj.bias)
        for p in (self.cls_token, self.pos_embed, self.temporal_embed):
            p.normal_(0.0, 0.02, generator=generator)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        self.norm.reset_parameters()
        if self.head is not None:
            lecun_normal_(self.head.weight, self.head.in_features, generator)
            nn.init.zeros_(self.head.bias)

    def embed(self, video: torch.Tensor, keep_ind: torch.Tensor | None = None) -> torch.Tensor:
        """video [B, T, C, H, W]; keep_ind [B, n_tubes, n_keep] or None ->
        the tokens [B, 1 + n_tubes * n_keep, D] in the compute dtype."""
        with annotate("tubelet_stem", video):
            B, T = video.shape[:2]
            n_tubes, D = T // self.tubelet_size, self.embed_dim
            conv = self.patch_embed.proj
            dtype = self.compute_dtype or conv.weight.dtype
            x = F.conv3d(video.transpose(1, 2).to(dtype), conv.weight.to(dtype),
                         conv.bias.to(dtype), stride=conv.stride)  # [B, D, n_tubes, h, w]
            x = x.flatten(3).permute(0, 2, 3, 1)                   # [B, n_tubes, N, D]
            x = x + (self.pos_embed[:, None, 1:]
                     + self.temporal_embed[0, None, :n_tubes, None]).to(dtype)
            if keep_ind is not None:
                keep = keep_ind[:, :n_tubes].long()
                x = torch.gather(x, 2, keep[..., None].expand(-1, -1, -1, D))
            cls = (self.cls_token[0, 0] + self.pos_embed[0, 0]).to(dtype)
            return torch.cat([cls.expand(B, 1, D), x.reshape(B, -1, D)], 1)

    def finish(self, x: torch.Tensor) -> torch.Tensor:
        """The last block's tokens -> the final norm (and the head)."""
        x = self.norm(x)
        if self.head is not None:
            x = linear(x, self.head.weight, self.head.bias)
        return x

    def forward(self, video: torch.Tensor, keep_ind: torch.Tensor | None = None) -> torch.Tensor:
        """video [B, T, C, H, W]; keep_ind [B, n_tubes, n_keep] or None ->
        [B, 1 + n_tubes * n_keep, D] after the final norm (and the head)."""
        x = self.embed(video, keep_ind)
        for blk in self.blocks:
            x = blk(x)
        return self.finish(x)
