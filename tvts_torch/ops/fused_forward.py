"""Forwards of SpaceTimeViT and TVTSv2 through the sub-path kernels
(counterpart of tvts_tpu/ops/fused_forward.py): the inference tower (the
kernel_version-7 block loop), and the differentiable training tower and
train_apply (H5, H6, H7, H8).

Inference, per block: H1 time -> H2 space (residual from the block input) -> H3 MLP. With
need_tokens=False the last block runs only what the pooled embedding needs:
H4 (the CLS row of the space sub-path) and the MLP on that one row. The stem
(patchify conv, positional and temporal adds, ln_pre), the last block's CLS-row
MLP and the pooling stay plain PyTorch, as they were XLA outside any kernel on
the TPU. Reads the parameters of a SpaceTimeViT, so it is checkpoint-compatible
with the eager module.

The joint space-time towers (models/joint_vit.py's `JointBlock`: the VideoMAE
classifier downstream/model.FinetuneViT, ViT-B/16 to VideoMAE V2's ViT-g/14,
and TVTS v1's JointViT), inference: per block the attention sub-path
(ops/text_attention.fused_text_attention_block, non-causal: the LayerNorm
row pass, ln_gemm qkv, the H7 core at head dim 64 or 88, ln_gemm proj with
the residual), then H3 with exact GELU; both LayerNorms at the block's eps
(1e-6). The stem (the cuDNN Conv3d and positions), the pooling, `fc_norm` /
`norm` and the head stay plain PyTorch. Dispatch as the sub-paths': plain
versions on a CPU tensor, kernels on a CUDA bf16 tensor, else an error.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from tvts_torch.models.layers import linear
from tvts_torch.models.space_time_vit import SpaceTimeViT
from tvts_torch.ops.block_backward import mlp_subpath, space_subpath, time_subpath
from tvts_torch.ops.block_kernels import (
    fused_mlp_block,
    fused_space_block,
    fused_space_cls_only,
    fused_time_block,
    mlp_block_plain,
    space_block_plain,
    time_block_plain,
)
from tvts_torch.ops.text_attention import (
    fused_text_attention_block,
    sort_transformer_fused_forward,
    text_transformer_fused_forward,
)
from tvts_torch.parallel.partition import whole


def space_time_vit_fused_forward(model: SpaceTimeViT, video: torch.Tensor,
                                 keep_ind: torch.Tensor | None = None,
                                 need_tokens: bool = True):
    """Equivalent to model(video, keep_ind). Returns (pooled, tokens); with
    need_tokens=False tokens is None and the last block is CLS-only."""
    cfg = model.cfg
    if not need_tokens and cfg.attentional_pool:
        # the pooler cross-attends every token; the CLS-only last block keeps one
        raise NotImplementedError("need_tokens=False does not support the attentional "
                                  "pooler (cfg.attentional_pool set): its queries attend "
                                  "every token of the last block; pass need_tokens=True")
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


def joint_blocks_fused_forward(blocks, x: torch.Tensor) -> torch.Tensor:
    """The JointBlocks `blocks` on x [B, S, D] through the kernels (module
    notes); the weights cast to x's dtype (a no-op for bf16 weights)."""
    x = x.contiguous()  # the stem's tokens are a transposed view
    dt = x.dtype
    for blk in blocks:
        attn, mlp = blk.attn, blk.mlp
        x = fused_text_attention_block(x, blk.norm1.weight, blk.norm1.bias,
                                       attn.qkv.weight.to(dt), attn.qkv.bias.to(dt),
                                       attn.proj.weight.to(dt), attn.proj.bias.to(dt),
                                       attn.num_heads, causal=False, eps=blk.norm1.eps)
        x = fused_mlp_block(x, blk.norm2.weight, blk.norm2.bias, mlp.fc1.weight.to(dt),
                            mlp.fc1.bias.to(dt), mlp.fc2.weight.to(dt), mlp.fc2.bias.to(dt),
                            act="gelu", eps=blk.norm2.eps)
    return x


def finetune_vit_fused_forward(model, video: torch.Tensor) -> torch.Tensor:
    """Equivalent to model(video) for a downstream FinetuneViT, inference:
    the stem, the blocks on the kernels, the pooling and the head. video [B,
    T, C, H, W] -> logits [B, num_classes] in the compute dtype."""
    x = joint_blocks_fused_forward(model.blocks, model.embed(video))
    return linear(model.pool(x), model.head.weight, model.head.bias)


def joint_vit_fused_forward(model, video: torch.Tensor,
                            keep_ind: torch.Tensor | None = None) -> torch.Tensor:
    """Equivalent to model(video, keep_ind) for TVTS v1's JointViT, inference."""
    return model.finish(joint_blocks_fused_forward(model.blocks, model.embed(video, keep_ind)))


def space_time_vit_fused_train_forward(model: SpaceTimeViT, video: torch.Tensor,
                                       keep_ind: torch.Tensor | None = None,
                                       space_kernel: bool = True,
                                       time_kernel: bool = True,
                                       mlp_kernel: bool = False,
                                       mlp_save_hidden: bool = False):
    """The differentiable tower (counterpart of the JAX package's
    make_fused_train_forward): the stem, then per block H6 time -> H5 space
    (residual from the block input) -> the MLP sub-path, H8 with mlp_kernel
    (mlp_save_hidden: its hidden-saving form) and plain torch without (XLA in
    the JAX package's presets), then pool(need_tokens=True): the sort head
    reads every token, so there is no CLS-only tail. space_kernel /
    time_kernel=False run the plain sub-path instead, the plain time sub-path
    rematerialised in the backward (the JAX package's H/14 memory mode). The
    weights are cast to the compute dtype (differentiably: f32 masters get the
    gradient). Returns (pooled, tokens)."""
    cfg = model.cfg
    if cfg.ls_init is not None:
        # the sub-paths read the ln / attn / mlp parameters only
        raise NotImplementedError("the fused train forward does not support LayerScale "
                                  "(cfg.ls_init set); run the eager tower for such a config")
    x = model.embed(video, keep_ind)
    T = video.shape[1] if video.ndim == 5 else 1
    for blk in model.transformer.resblocks:
        x = whole(blk, _train_block, blk, x, T, cfg.heads, cfg.act, space_kernel, time_kernel,
                  mlp_kernel, mlp_save_hidden)
    return model.pool(x, need_tokens=True)


def _train_block(blk, x, T: int, heads: int, act: str, space_kernel: bool, time_kernel: bool,
                 mlp_kernel: bool, mlp_save_hidden: bool):
    """One block of the differentiable tower; it reads the block's
    parameters, so under sharding it runs with them whole
    (parallel/partition.whole: inside the block's FSDP2 window, its tp
    slices gathered; each rank's gradient comes back as its own slice)."""
    dt = x.dtype

    def weights(ln, first, second):
        return (ln.weight, ln.bias, first.weight.to(dt), first.bias.to(dt),
                second.weight.to(dt), second.bias.to(dt))

    tw = weights(blk.ln_3, blk.timeattn.qkv, blk.timeattn.proj)
    if time_kernel:
        tr = time_subpath(x, *tw, T, heads)
    elif torch.is_grad_enabled():
        tr = checkpoint(time_block_plain, x, *tw, T, heads, use_reentrant=False)
    else:
        tr = time_block_plain(x, *tw, T, heads)
    sw = weights(blk.ln_1, blk.attn.qkv, blk.attn.proj)
    x = (space_subpath if space_kernel else space_block_plain)(tr, x, *sw, T, heads)
    mw = weights(blk.ln_2, blk.mlp.c_fc, blk.mlp.c_proj)
    return (mlp_subpath(x, *mw, act, mlp_save_hidden) if mlp_kernel
            else mlp_block_plain(x, *mw, act))


def train_apply(model, batch: dict, *, space_kernel: bool = True, time_kernel: bool = True,
                text_kernel: bool = True, sort_kernel: bool = True,
                mlp_kernel: bool = False, mlp_save_hidden: bool = False,
                text_tune_from: int | None = None):
    """TVTSv2.forward through the kernels (counterpart of the JAX package's
    make_fused_train_apply, row layout, no mesh): (text_emb, video_emb,
    predict_order) of a batch dict, as model(video, text_ids, keep_ind)
    returns them. mlp_kernel runs the video tower's MLP sub-paths on H8.
    text_tune_from: the first trainable text block (the blocks below it take
    the dx-only H7 backward). Under sharding it runs inside the model's
    window, as model(...) would (parallel/partition.whole)."""
    return whole(model, _train_apply, model, batch, space_kernel, time_kernel, text_kernel,
                 sort_kernel, mlp_kernel, mlp_save_hidden, text_tune_from)


def _train_apply(model, batch, space_kernel, time_kernel, text_kernel, sort_kernel, mlp_kernel,
                 mlp_save_hidden, text_tune_from):
    video, text_ids = batch["video"], batch["text_ids"]
    bz = video.shape[0]
    text_emb = (text_transformer_fused_forward(model, text_ids, tune_from=text_tune_from)
                if text_kernel else model.compute_text(text_ids))
    n_trans = text_emb.shape[0] // bz
    per_clip = text_emb.reshape(n_trans, bz, text_emb.shape[-1])
    pooled, tokens = space_time_vit_fused_train_forward(
        model.video_model, video, batch.get("keep_ind"), space_kernel, time_kernel,
        mlp_kernel, mlp_save_hidden)
    predict_order = None
    if n_trans != 1:
        sort_text = per_clip.detach().transpose(0, 1)
        predict_order = (sort_transformer_fused_forward(model.pred_model, sort_text, tokens)
                         if sort_kernel else model.pred_model(sort_text, tokens))
    return per_clip.mean(0), pooled, predict_order
