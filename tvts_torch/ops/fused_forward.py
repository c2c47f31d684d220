"""Inference forward of SpaceTimeViT through the sub-path kernels (counterpart
of tvts_tpu/ops/fused_forward.py, the kernel_version-7 block loop).

Per block: H1 time -> H2 space (residual from the block input) -> H3 MLP. With
need_tokens=False the last block runs only what the pooled embedding needs:
H4 (the CLS row of the space sub-path) and the MLP on that one row. The stem
(patchify conv, positional and temporal adds, ln_pre), the last block's CLS-row
MLP and the pooling stay plain PyTorch, as they were XLA outside any kernel on
the TPU. Reads the parameters of a SpaceTimeViT, so it is checkpoint-compatible
with the eager module.
"""

from __future__ import annotations

import torch

from tvts_torch.models.space_time_vit import SpaceTimeViT
from tvts_torch.ops.block_kernels import (
    fused_mlp_block,
    fused_space_block,
    fused_space_cls_only,
    fused_time_block,
)


def space_time_vit_fused_forward(model: SpaceTimeViT, video: torch.Tensor,
                                 keep_ind: torch.Tensor | None = None,
                                 need_tokens: bool = True):
    """Equivalent to model(video, keep_ind). Returns (pooled, tokens); with
    need_tokens=False tokens is None and the last block is CLS-only."""
    cfg = model.cfg
    x = model.embed(video, keep_ind)
    T = video.shape[1] if video.ndim == 5 else 1
    blocks = model.transformer.resblocks
    for i, blk in enumerate(blocks):
        tr = fused_time_block(
            x, blk.ln_3.weight, blk.ln_3.bias, blk.timeattn.qkv.weight,
            blk.timeattn.qkv.bias, blk.timeattn.proj.weight, blk.timeattn.proj.bias,
            num_frames=T, num_heads=cfg.heads)
        space_w = (blk.ln_1.weight, blk.ln_1.bias, blk.attn.qkv.weight, blk.attn.qkv.bias,
                   blk.attn.proj.weight, blk.attn.proj.bias)
        if not need_tokens and i == len(blocks) - 1:
            cls = fused_space_cls_only(tr, x[:, :1].contiguous(), *space_w,
                                       num_frames=T, num_heads=cfg.heads)
            cls = cls + blk.mlp(blk.ln_2(cls))
            return model.pool(cls, need_tokens=False)
        x = fused_space_block(tr, x, *space_w, num_frames=T, num_heads=cfg.heads)
        x = fused_mlp_block(x, blk.ln_2.weight, blk.ln_2.bias, blk.mlp.c_fc.weight,
                            blk.mlp.c_fc.bias, blk.mlp.c_proj.weight,
                            blk.mlp.c_proj.bias, act=cfg.act)
    return model.pool(x, need_tokens)
