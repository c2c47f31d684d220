"""The fine-tuning video classifier (counterpart of tvts_tpu/downstream/model.py;
reference v1/downstream/modeling_finetune.py `vit_base_patch16_224`).

- patchify: the tubelet Conv3d, kernel = stride = (tubelet, p, p), tokens in
  (tube, h, w) order; no CLS token;
- positions: the FIXED sinusoidal table over every token (:213-215), cast to
  the compute dtype before it is added (the JAX module's order; JointViT
  sums its learned positions in float32);
- the port's JointBlock (pre-norm, LayerNorm eps 1e-6 in float32, exact
  gelu), then the token mean, `fc_norm` (float32, eps 1e-6) and `head`,
  initialised truncated normal with std 0.02 * head_init_scale
  (use_mean_pooling=False: `norm` on every token, then token 0);
- `remat=True` checkpoints each block (torch.utils.checkpoint) where autograd
  records, as run_class_finetuning.py builds it.
Parameter names are the reference's: `patch_embed.proj`, `blocks.{i}.*`,
`fc_norm`, `head`, so a v1 checkpoint's `video_model.*` tower loads by name.
The compute dtype is `compute_dtype` when set (bf16 over float32 weights),
else the weights'; the logits come out of `head` in it.

`load_pretrain_video_tower` carries a v1 pretraining checkpoint over as the
reference's strict=False load does (run_class_finetuning.py:316-341): only
`blocks.*` and `patch_embed.*` of its `video_model` tower; `fc_norm` and
`head` keep their initial values.
"""

from __future__ import annotations

import functools
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tvts_torch.models.joint_vit import LN_EPS, JointBlock, PatchEmbed
from tvts_torch.models.layers import LayerNormF32, lecun_normal_, linear
from tvts_torch.utils.convert import convert_v1_state_dict, merge_params


@functools.lru_cache(maxsize=8)
def sinusoid_table(n_position: int, d_hid: int) -> np.ndarray:
    """VideoMAE's get_sinusoid_encoding_table (modeling_finetune.py)."""
    pos = np.arange(n_position)[:, None]
    i = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (i // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    table.flags.writeable = False
    return table


class FinetuneViT(nn.Module):
    def __init__(self, num_classes: int = 174, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, heads: int = 12, num_frames: int = 16,
                 tubelet_size: int = 2, use_mean_pooling: bool = True,
                 head_init_scale: float = 0.001, remat: bool = False):
        super().__init__()
        self.depth, self.embed_dim, self.tubelet_size = depth, embed_dim, tubelet_size
        self.head_init_scale, self.remat = head_init_scale, remat
        self.compute_dtype: torch.dtype | None = None  # None: the weights' dtype
        self.patch_embed = PatchEmbed(embed_dim, patch_size, tubelet_size)
        self.blocks = nn.ModuleList(JointBlock(embed_dim, heads) for _ in range(depth))
        norm = LayerNormF32(embed_dim, eps=LN_EPS)
        if use_mean_pooling:
            self.fc_norm, self.norm = norm, None
        else:
            self.fc_norm, self.norm = None, norm
        self.head = nn.Linear(embed_dim, num_classes)
        n = (num_frames // tubelet_size) * (img_size // patch_size) ** 2
        self.register_buffer("pos_table", torch.from_numpy(sinusoid_table(n, embed_dim).copy()),
                             persistent=False)

    def set_compute_dtype(self, dtype: torch.dtype | None) -> None:
        self.compute_dtype = dtype

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initializers, drawn from `generator`."""
        w = self.patch_embed.proj.weight
        lecun_normal_(w, w[0].numel(), generator)
        nn.init.zeros_(self.patch_embed.proj.bias)
        for blk in self.blocks:
            blk.reset_parameters(generator)
        (self.fc_norm if self.fc_norm is not None else self.norm).reset_parameters()
        std = 0.02 * self.head_init_scale
        nn.init.trunc_normal_(self.head.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        nn.init.zeros_(self.head.bias)

    def forward_features(self, video: torch.Tensor) -> torch.Tensor:
        """video [B, T, C, H, W] normalised -> the pooled features [B, D]
        (after `fc_norm`), in the compute dtype."""
        conv = self.patch_embed.proj
        dtype = self.compute_dtype or conv.weight.dtype
        x = F.conv3d(video.transpose(1, 2).to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
                     stride=conv.stride)                    # [B, D, n_tubes, h, w]
        x = x.flatten(2).transpose(1, 2)                    # [B, S, D], (tube, h, w) order
        pos = self.pos_table
        if pos.shape[0] != x.shape[1]:
            pos = torch.from_numpy(sinusoid_table(x.shape[1], self.embed_dim).copy()).to(x.device)
        x = x + pos.to(dtype)
        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            x = checkpoint(blk, x, use_reentrant=False) if remat else blk(x)
        if self.fc_norm is not None:
            return self.fc_norm(x.mean(1))
        return self.norm(x)[:, 0]

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        """video [B, T, C, H, W] normalised -> logits [B, num_classes]."""
        return linear(self.forward_features(video), self.head.weight, self.head.bias)


# the tower parameters a v1 checkpoint carries over (run_class_finetuning.py:316-341)
TRANSFER_PREFIXES = ("blocks.", "patch_embed.")


def load_pretrain_video_tower(model: FinetuneViT, state_dict: Mapping) -> list[str]:
    """Overlay the `video_model` tower of a reference v1 state dict (or a bare
    tower state dict; tensors or arrays, `module.` prefix or not, VideoMAE
    q/v biases folded by convert_v1_state_dict) onto `model`: `blocks.*` and
    `patch_embed.*` only. Returns the names transferred."""
    sd = convert_v1_state_dict(state_dict)
    tower = {k[len("video_model."):]: v for k, v in sd.items() if k.startswith("video_model.")}
    if not tower:
        tower = sd
    transfer = {k: v for k, v in tower.items() if k.startswith(TRANSFER_PREFIXES)}
    merge_params(model, transfer)
    return sorted(transfer)
