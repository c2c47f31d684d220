"""TVTS v1 (CVPR 2023): the DistilBERT text tower, the joint space-time
video ViT, the transcript-sorting head and two projections (counterpart of
tvts_tpu/models/tvts_v1.py; reference v1/model/model_dist_TVTS.py:18-143).

- text: DistilBERT's last_hidden_state[:, 0] (CLS), then
  txt_proj = ReLU -> Linear(768, 256);
- video: the JointViT tokens; the contrastive embedding is
  vid_proj(CLS) = Linear(768, 256);
- sort head: `SortTransformer(embed 768, 12 heads)` over the features before
  the projections: the detached per-clip text CLS [B, n_trans, 768] beside
  every video token (:101-117), with the last block on the text rows only.
Text ids arrive clip-major [n_trans * B, L] with their attention mask; the
text embedding is the mean over the n_trans clips. `forward` returns
(text_emb [B, 256], video_emb [B, 256], predict_order [B, n_trans, n_clips]
or None when n_trans == 1).

Parameter names are the reference's: `text_model.*` (HF DistilBERT),
`video_model.{patch_embed.proj, cls_token, pos_embed, temporal_embed,
blocks.{i}, norm}`, `txt_proj.1.*`, `vid_proj.0.*`, `pred_model.*`.
`set_compute_dtype(torch.bfloat16)` over float32 weights is the JAX
package's `TVTSv1(cfg, dtype=bfloat16)`: every linear, the patchify and the
embeddings compute in bf16 from float32 parameters, LayerNorms and softmax in
float32.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from tvts_torch.models.configs import SortConfig
from tvts_torch.models.distilbert import DistilBertConfig, DistilBertEncoder
from tvts_torch.models.joint_vit import JointViT
from tvts_torch.models.layers import lecun_normal_, linear
from tvts_torch.models.sort import SortTransformer


@dataclasses.dataclass(frozen=True)
class TVTSv1Config:
    name: str = "TVTS"
    img_size: int = 224
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    heads: int = 12
    num_frames: int = 16
    tubelet_size: int = 2
    projection_dim: int = 256
    num_clips: int = 4
    mask_ratio: float = 0.75
    max_text_len: int = 50
    sort_heads: int = 12
    text: DistilBertConfig = DistilBertConfig()

    @property
    def patches_per_frame(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def n_keep(self) -> int:
        return int(self.patches_per_frame * (1.0 - self.mask_ratio))

    @property
    def n_tubes(self) -> int:
        return self.num_frames // self.tubelet_size


class TVTSv1(nn.Module):
    def __init__(self, cfg: TVTSv1Config = TVTSv1Config()):
        super().__init__()
        self.cfg = cfg
        self.text_model = DistilBertEncoder(cfg.text)
        self.video_model = JointViT(
            img_size=cfg.img_size, patch_size=cfg.patch_size, embed_dim=cfg.embed_dim,
            depth=cfg.depth, heads=cfg.heads, num_frames=cfg.num_frames,
            tubelet_size=cfg.tubelet_size)
        self.txt_proj = nn.Sequential(nn.ReLU(), nn.Linear(cfg.text.dim, cfg.projection_dim))
        self.vid_proj = nn.Sequential(nn.Linear(cfg.embed_dim, cfg.projection_dim))
        self.pred_model = SortTransformer(SortConfig(
            embed_dim=cfg.embed_dim, num_heads=cfg.sort_heads, num_classes=cfg.num_clips))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializers, drawn from `generator`."""
        self.text_model.reset_parameters(generator)
        self.video_model.reset_parameters(generator)
        for layer in (self.txt_proj[1], self.vid_proj[0]):
            lecun_normal_(layer.weight, layer.in_features, generator)
            nn.init.zeros_(layer.bias)
        self.pred_model.reset_parameters(generator)

    def fsdp_units(self) -> list:
        """The modules parallel/partition.fsdp_shard shards one by one (the
        root takes the rest): each block of JointViT, DistilBERT and the sort
        head."""
        return [*self.video_model.blocks, *self.text_model.transformer.layer,
                *self.pred_model.blocks]

    def set_compute_dtype(self, dtype: torch.dtype | None) -> None:
        """Activation dtype of both towers and the head (None: the weights')."""
        self.text_model.compute_dtype = dtype
        self.video_model.compute_dtype = dtype

    def compute_text(self, input_ids: torch.Tensor, attention_mask: torch.Tensor):
        """-> (the CLS row before the projection [N, 768], projected [N, 256])."""
        before = self.text_model(input_ids, attention_mask)[:, 0]
        proj = self.txt_proj[1]
        return before, linear(F.relu(before), proj.weight, proj.bias)

    def compute_video(self, video: torch.Tensor, keep_ind: torch.Tensor | None = None):
        """-> (every token [B, S, 768], projected CLS [B, 256])."""
        tokens = self.video_model(video, keep_ind)
        proj = self.vid_proj[0]
        return tokens, linear(tokens[:, 0], proj.weight, proj.bias)

    def forward(self, video: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: torch.Tensor, keep_ind: torch.Tensor | None = None):
        bz = video.shape[0]
        before, projected = self.compute_text(input_ids, attention_mask)
        n_trans = before.shape[0] // bz
        text_emb = projected.reshape(n_trans, bz, -1).mean(0)
        tokens, video_emb = self.compute_video(video, keep_ind)
        predict_order = None
        if n_trans != 1:
            sort_text = before.detach().reshape(n_trans, bz, -1).transpose(0, 1)
            predict_order = self.pred_model(sort_text, tokens)
        return text_emb, video_emb, predict_order
