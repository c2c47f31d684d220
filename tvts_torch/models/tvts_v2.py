"""TVTSv2 container (counterpart of tvts_tpu/models/tvts_v2.py): the text
tower and the space-time video tower under the reference `.pth` layout.

The reference keeps the text tower's parameters at the top level of the
model (`text_token_embedding`, `text_positional_embedding`,
`text_model.resblocks.*`, `text_ln_final`, `text_projection`) beside
`video_model.*`, so TVTSv2 extends `TextTransformer` with `video_model`.
The sort head (`pred_model.*`) and the training forward arrive with slice 3;
until then `__call__` raises.
"""

from __future__ import annotations

import torch

from tvts_torch.models.configs import TVTSv2Config
from tvts_torch.models.space_time_vit import SpaceTimeViT
from tvts_torch.models.text import TextTransformer


class TVTSv2(TextTransformer):
    def __init__(self, cfg: TVTSv2Config):
        super().__init__(cfg.text)
        self.cfg = cfg
        self.video_model = SpaceTimeViT(cfg.vision)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.video_model.reset_parameters(generator)
        self.reset_text_parameters(generator)

    def compute_video(self, video: torch.Tensor, keep_ind: torch.Tensor | None = None):
        """[B, T, C, H, W] -> (pooled [B, out], order_tokens [B, S', out])."""
        return self.video_model(video, keep_ind)

    def forward(self, *args, **kwargs):
        raise NotImplementedError("TVTSv2 training forward (sort head): slice 3")
