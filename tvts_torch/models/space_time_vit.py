"""Divided space-time attention video ViT (counterpart of
tvts_tpu/models/space_time_vit.py).

- "openai" pool (B/32, B/16): ln_post over all tokens, then proj; the pooled
  embedding is projected token 0.
- "openclip" pool (H/14): pooled = ln_post(CLS) @ proj; tokens = raw patch
  tokens @ proj.
- Both block residuals branch from the block input x, not chained.
- Spatial positional embedding tiled over frames, temporal embedding repeated
  over patches, one tube keep set for every frame.

Parameter names are the reference `.pth` names (`video_model.` stripped), so a
released checkpoint loads with `load_state_dict(strict=True)`. The compute
dtype is `compute_dtype` when set (bf16 activations over f32 master weights,
the training setup), else the dtype of the weights; LayerNorm parameters stay
float32.
LayerScale, PatchDropout and the attentional pooler (H/14 options no shipped
config enables) are not ported yet: a config that sets them raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tvts_torch.models.configs import VisionConfig
from tvts_torch.models.layers import LayerNormF32, Mlp, VarAttention, lecun_normal_
from tvts_torch.ops.masking import gather_tube_tokens


class SpaceTimeBlock(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        D = cfg.width
        self.ln_3 = LayerNormF32(D)
        self.timeattn = VarAttention(D, cfg.heads, zero_init=True)
        self.ln_1 = LayerNormF32(D)
        self.attn = VarAttention(D, cfg.heads)
        self.ln_2 = LayerNormF32(D)
        self.mlp = Mlp(D, int(D * cfg.mlp_ratio), act=cfg.act)

    def forward(self, x: torch.Tensor, num_frames: int,
                patches_per_frame: int) -> torch.Tensor:
        t_out = self.timeattn(self.ln_3(x), num_frames, patches_per_frame, "time")
        time_residual = x + t_out
        s_out = self.attn(self.ln_1(time_residual), num_frames, patches_per_frame,
                          "space")
        space_residual = x + s_out  # both residuals branch from the block input
        return space_residual + self.mlp(self.ln_2(space_residual))


class Transformer(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        self.resblocks = nn.ModuleList(SpaceTimeBlock(cfg) for _ in range(cfg.layers))


class SpaceTimeViT(nn.Module):
    def __init__(self, cfg: VisionConfig):
        super().__init__()
        if cfg.ls_init is not None or cfg.patch_dropout > 0 or cfg.attentional_pool:
            raise NotImplementedError(
                "LayerScale, PatchDropout and the attentional pooler are not "
                "ported yet (H/14 item)")
        if cfg.pool_style not in ("openai", "openclip"):
            raise ValueError(f"unknown pool_style {cfg.pool_style!r}")
        self.cfg = cfg
        self.compute_dtype: torch.dtype | None = None
        D, p = cfg.width, cfg.patch_size
        self.conv1 = nn.Conv2d(3, D, kernel_size=p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(D))
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.patches_per_frame + 1, D))
        self.temporal_embedding = nn.Parameter(torch.empty(cfg.num_frames, D))
        self.ln_pre = LayerNormF32(D)
        self.transformer = Transformer(cfg)
        self.ln_post = LayerNormF32(D)
        self.proj = nn.Parameter(torch.empty(D, cfg.output_dim))

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.conv1.weight.dtype

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializers, drawn from `generator`."""
        cfg = self.cfg
        lecun_normal_(self.conv1.weight, 3 * cfg.patch_size ** 2, generator)
        scale = cfg.width ** -0.5
        for p in (self.class_embedding, self.positional_embedding,
                  self.temporal_embedding):
            p.normal_(0.0, scale, generator=generator)
        for blk in self.transformer.resblocks:
            for ln in (blk.ln_3, blk.ln_1, blk.ln_2):
                ln.reset_parameters()
            blk.timeattn.reset_parameters(generator)
            blk.attn.reset_parameters(generator)
            blk.mlp.reset_parameters(generator)
        self.ln_pre.reset_parameters()
        self.ln_post.reset_parameters()
        self.proj.normal_(0.0, scale, generator=generator)

    def embed(self, video: torch.Tensor,
              keep_ind: torch.Tensor | None = None) -> torch.Tensor:
        """The stem: patchify + pos/temporal embed + tube mask + CLS + ln_pre.
        video: [B, T, C, H, W] (or [B, C, H, W]). Returns [B, 1+T*n, D]."""
        cfg = self.cfg
        if video.ndim == 4:
            video = video[:, None]
        B, T, C, H, W = video.shape
        dtype = self.dtype
        x = F.conv2d(video.reshape(B * T, C, H, W).to(dtype), self.conv1.weight.to(dtype),
                     stride=cfg.patch_size)                  # [BT, D, h, w]
        x = x.flatten(2).transpose(1, 2).reshape(B, T, -1, cfg.width)
        pos = self.positional_embedding.float()
        x = x + (pos[None, None, 1:]
                 + self.temporal_embedding.float()[None, :T, None]).to(dtype)
        if keep_ind is not None:
            x = gather_tube_tokens(x, keep_ind)
        cls = (self.class_embedding.float() + pos[0]).to(dtype)
        x = torch.cat([cls.expand(B, 1, cfg.width), x.reshape(B, -1, cfg.width)], 1)
        return self.ln_pre(x)

    def pool(self, x: torch.Tensor, need_tokens: bool = True):
        """(pooled [B, out], tokens or None) from the tower output x [B, S, D].
        With need_tokens=False only row 0 is normalised and projected (exact:
        LayerNorm is per token)."""
        proj = self.proj.to(x.dtype)
        if self.cfg.pool_style == "openai":
            if not need_tokens:
                return self.ln_post(x[:, :1])[:, 0] @ proj, None
            full = self.ln_post(x) @ proj
            return full[:, 0], full
        pooled = self.ln_post(x[:, :1])[:, 0] @ proj
        return pooled, (x[:, 1:] @ proj if need_tokens else None)

    def forward(self, video: torch.Tensor, keep_ind: torch.Tensor | None = None):
        """Returns (pooled [B, out], order_tokens [B, S', out])."""
        x = self.embed(video, keep_ind)
        T = video.shape[1] if video.ndim == 5 else 1
        n_keep = (x.shape[1] - 1) // T
        for blk in self.transformer.resblocks:
            x = blk(x, T, n_keep)
        return self.pool(x)
