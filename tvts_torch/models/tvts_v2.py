"""TVTSv2 container (counterpart of tvts_tpu/models/tvts_v2.py): the text
tower, the space-time video tower and the transcript-sorting head under the
reference `.pth` layout.

The reference keeps the text tower's parameters at the top level of the
model (`text_token_embedding`, `text_positional_embedding`,
`text_model.resblocks.*`, `text_ln_final`, `text_projection`) beside
`video_model.*` and `pred_model.*`, so TVTSv2 extends `TextTransformer`.

`forward(video, text_ids, keep_ind)` is the training forward (reference
model_dist_TVTSv2_ViT_B_16.py:61-116): text ids arrive clip-major
[n_trans * B, ctx]; the contrastive text embedding is the mean over the
n_trans clips; the video embedding is the pooled CLS; the sort head reads the
per-clip text embeddings detached, as [B, n_trans, D], beside the video order
tokens. Returns (text_emb [B, D], video_emb [B, D], predict_order
[B, n_trans, n_trans] or None when n_trans == 1).

`remat=True` checkpoints every block of both towers (the sort head is not
rematerialised, as in the JAX package); `use_pallas=True` runs the video
tower's space attention core on the H9 kernel (forward only).
"""

from __future__ import annotations

import torch

from tvts_torch.models.configs import TVTSv2Config
from tvts_torch.models.sort import SortTransformer
from tvts_torch.models.space_time_vit import SpaceTimeViT
from tvts_torch.models.text import TextTransformer


class TVTSv2(TextTransformer):
    def __init__(self, cfg: TVTSv2Config, remat: bool = False, use_pallas: bool = False):
        super().__init__(cfg.text, remat=remat)
        self.cfg = cfg
        self.video_model = SpaceTimeViT(cfg.vision, remat=remat, use_pallas=use_pallas)
        self.pred_model = SortTransformer(cfg.sort)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.video_model.reset_parameters(generator)
        self.reset_text_parameters(generator)
        self.pred_model.reset_parameters(generator)

    def fsdp_units(self) -> list:
        """The modules parallel/partition.fsdp_shard shards one by one (the
        root takes the rest): each residual block of both towers and of the
        sort head."""
        return [*self.video_model.transformer.resblocks, *self.text_model.resblocks,
                *self.pred_model.blocks]

    def set_compute_dtype(self, dtype: torch.dtype | None) -> None:
        """Activation dtype of both towers (None: the weights' dtype)."""
        self.compute_dtype = dtype
        self.video_model.compute_dtype = dtype

    def compute_video(self, video: torch.Tensor, keep_ind: torch.Tensor | None = None):
        """[B, T, C, H, W] -> (pooled [B, out], order_tokens [B, S', out])."""
        return self.video_model(video, keep_ind)

    def forward(self, video: torch.Tensor, text_ids: torch.Tensor,
                keep_ind: torch.Tensor | None = None):
        bz = video.shape[0]
        text_emb = self.compute_text(text_ids)  # [n_trans * B, D]
        n_trans = text_emb.shape[0] // bz
        per_clip = text_emb.reshape(n_trans, bz, text_emb.shape[-1])
        video_emb, order_tokens = self.compute_video(video, keep_ind)
        predict_order = None
        if n_trans != 1:
            predict_order = self.pred_model(per_clip.detach().transpose(0, 1), order_tokens)
        return per_clip.mean(0), video_emb, predict_order
