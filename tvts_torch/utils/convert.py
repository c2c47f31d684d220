"""Weights carried across from the JAX package, and reference `.pth` reading.

`state_dict_from_jax` turns the JAX package's nested parameter tree (numpy
leaves) into a state dict under the reference names: the same names and
values `tvts_tpu.utils.torch_convert.export_state_dict(params,
ddp_prefix=False)` writes for a full TVTSv2 tree (or a bare video tower):
- 2-D kernels are transposed ([in, out] -> [out, in]);
- the patchify conv kernel [kh, kw, in, out] -> [out, in, kh, kw];
- LayerNorm `scale` and embedding `embedding` -> `weight`;
- direct parameters (`text_projection`, `proj`, the embeddings) keep their
  layout: `text_projection` and `proj` stay [in, out];
- the renames of `_RENAMES`: the text tower to its top-level reference names
  with nn.MultiheadAttention's in_proj/out_proj, the sort head's blocks and
  fc1/fc2, `blocks_{i}` -> `transformer.resblocks.{i}` for the video tower,
  and the attentional pooler's `attn_pool.attn.{q,k,v}_proj_weight`,
  `in_proj_bias`, `out_proj.*`; LayerScale's `ls_*.gamma` keeps its name.

The CLIP init and the reference checkpoint file (counterparts of
`torch_convert.py`'s `convert_clip_visual` :185, `convert_clip_full` :201,
`merge_params` :224 and `save_reference_checkpoint` :332) work on state
dicts under the reference names, which the port's modules carry, so no
parameter tree is involved; `load_reference_state_dict` is the JAX package's
`load_torch_state_dict` (:26), returning tensors.
The TVTS v1 maps (models/tvts_v1.py, whose modules carry the reference v1
names): `v1_state_dict_from_jax` is the inverse of the JAX package's
`convert_v1_state_dict` (torch_convert.py:127); `convert_v1_state_dict`
reads a reference v1 checkpoint as that function does (the VideoMAE
`attn.q_bias` / `v_bias` folded into `qkv.bias` with a zero k bias, the HF
DistilBERT keys under `text_model.` without their `distilbert.` prefix);
`inflate_mae_2d_to_3d` is its MAE patch-embed inflation (:173).
`finetune_state_dict_from_jax` turns the JAX downstream FinetuneViT's tree
into the port's (tvts_torch/downstream/model.py) state dict, the v1 video
tower's names at the top level; `frozen_state_dict_from_jax` the JAX
Frozen-style SpaceTimeTransformer's tree into the reference timm names that
tvts_torch/downstream/video_transformer.py carries (the inverse of the map
tests/test_frozen_video_transformer.py builds from a reference state dict).
numpy and torch only: no JAX and no `tvts_tpu` import.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

# applied in order to each dotted name
_RENAMES = tuple((re.compile(p), r) for p, r in (
    (r"^text_model\.token_embedding\.weight$", "text_token_embedding.weight"),
    (r"^text_model\.positional_embedding$", "text_positional_embedding"),
    (r"^text_model\.ln_final\.", "text_ln_final."),
    (r"^text_model\.text_projection$", "text_projection"),
    (r"^text_model\.blocks_(\d+)\.", r"text_model.resblocks.\1."),
    (r"^(text_model\..*)\.attn\.qkv\.weight$", r"\1.attn.in_proj_weight"),
    (r"^(text_model\..*)\.attn\.qkv\.bias$", r"\1.attn.in_proj_bias"),
    (r"^(text_model\..*)\.attn\.proj\.", r"\1.attn.out_proj."),
    (r"^pred_model\.blocks_(\d+)\.", r"pred_model.blocks.\1."),
    (r"^(pred_model\..*)\.mlp\.c_fc\.", r"\1.mlp.fc1."),
    (r"^(pred_model\..*)\.mlp\.c_proj\.", r"\1.mlp.fc2."),
    # the attentional pooler under nn.MultiheadAttention's names (kdim != embed_dim)
    (r"(^|\.)attn_pool\.([qkv])_proj\.weight$", r"\1attn_pool.attn.\2_proj_weight"),
    (r"(^|\.)attn_pool\.qkv_bias$", r"\1attn_pool.attn.in_proj_bias"),
    (r"(^|\.)attn_pool\.proj\.", r"\1attn_pool.attn.out_proj."),
    (r"(^|\.)blocks_(\d+)\.", r"\1transformer.resblocks.\2."),  # video tower
))


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_jax(params: Mapping) -> dict[str, np.ndarray]:
    """JAX parameter tree (a full TVTSv2 tree, or the video tower's own) ->
    reference-named state dict of float32 numpy arrays."""
    out: dict[str, np.ndarray] = {}
    for path, arr in _flatten(params):
        arr = np.asarray(arr, dtype=np.float32)
        leaf = path[-1]
        if leaf == "kernel":
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
            else:
                raise ValueError(f"unhandled kernel shape {arr.shape} at {path}")
            name = ".".join(path[:-1]) + ".weight"
        elif leaf in ("scale", "embedding"):
            name = ".".join(path[:-1]) + ".weight"
        else:  # bias and the direct parameters keep their names and layout
            name = ".".join(path)
        for pattern, repl in _RENAMES:
            name = pattern.sub(repl, name)
        out[name] = np.ascontiguousarray(arr)
    return out


def load_reference_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Tensors of a reference `.pth` (a bare state dict or a trainer
    checkpoint holding one under `state_dict`), DDP `module.` prefix stripped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {re.sub(r"^module\.", "", k): v for k, v in obj.items()
            if isinstance(v, torch.Tensor)}


# keys a CLIP or reference state dict holds that are no parameters (torch_convert._SKIP)
_SKIP = ("attn_mask", "num_batches_tracked", "logit_scale")


def convert_clip_visual(visual_sd: Mapping) -> dict:
    """A raw CLIP `visual.*` state dict -> video-tower entries: `in_proj_*`
    -> `qkv.*`, `out_proj` -> `proj` under `video_model.` (the reference's
    remap, model_dist_TVTSv2_ViT_B_16.py:33-45). The space-time parameters
    (timeattn, ln_3, temporal_embedding) are absent: fresh init keeps them."""
    out = {}
    for k, v in visual_sd.items():
        if any(s in k for s in _SKIP):
            continue
        k = re.sub(r"^visual\.", "", k).replace("in_proj_", "qkv.").replace("out_proj", "proj")
        out[f"video_model.{k}"] = v
    return out


def convert_clip_full(sd: Mapping) -> dict:
    """A raw OpenAI-CLIP state dict (`visual.*` and the text tower at the top
    level) -> reference-named entries: the visual tower through
    `convert_clip_visual`; the text tower's `transformer.resblocks.*` under
    `text_model.resblocks.*` (nn.MultiheadAttention names kept),
    `token_embedding` / `positional_embedding` / `ln_final` with the `text_`
    prefix, `text_projection` as it is; `logit_scale` dropped."""
    out = convert_clip_visual({k: v for k, v in sd.items() if k.startswith("visual.")})
    for k, v in sd.items():
        if k.startswith("visual.") or any(s in k for s in _SKIP):
            continue
        if k.startswith("transformer."):
            out["text_model." + k[len("transformer."):]] = v
        elif k == "text_projection":
            out[k] = v
        else:  # token_embedding.weight, positional_embedding, ln_final.*
            out[f"text_{k}"] = v
    return out


def merge_params(model: torch.nn.Module, state_dict: Mapping,
                 strict: bool = False) -> tuple[list[str], list[str]]:
    """Overlay `state_dict` (tensors or arrays) onto the model's parameters,
    cast to each parameter's dtype; the parameters it does not name keep
    their values (fresh init). Raises on a shape mismatch before anything is
    written, and with strict=True also on an entry the model lacks. Returns
    (missing, unused): the model's names the dict left alone, and the dict's
    names the model lacks."""
    own = model.state_dict()
    unused = [k for k in state_dict if k not in own]
    for k, v in state_dict.items():
        if k in own and tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: init {tuple(own[k].shape)} vs loaded "
                             f"{tuple(v.shape)}")
    if strict and unused:
        raise ValueError(f"unused loaded params: {unused}")
    with torch.no_grad():
        for k, v in state_dict.items():
            if k in own:
                own[k].copy_(torch.as_tensor(v))
    return [k for k in own if k not in state_dict], unused


def save_reference_checkpoint(model, path: str, arch: str, epoch: int = 0,
                              config: dict | None = None, monitor_best: float = 0.0,
                              optimizer: dict | None = None, step: int | None = None) -> None:
    """A `.pth` in the reference trainer's layout (base_trainer.py:165-189):
    {arch, epoch, state_dict (`module.`-prefixed reference names), optimizer
    (a state dict, empty by default), monitor_best, config}, plus `step`, the
    optimizer steps taken, where given. `model`: a module or its state dict."""
    weights = model.state_dict() if isinstance(model, torch.nn.Module) else model
    ckpt = {"arch": arch, "epoch": epoch,
            "state_dict": {f"module.{k}": v for k, v in weights.items()},
            "optimizer": optimizer or {}, "monitor_best": monitor_best, "config": config or {}}
    if step is not None:
        ckpt["step"] = step
    torch.save(ckpt, path)


# the JAX TVTSv1 tree's dotted names -> the reference v1 names, in order
_V1_RENAMES = tuple((re.compile(p), r) for p, r in (
    (r"^text_model\.(word_embeddings|position_embeddings)\.", r"text_model.embeddings.\1."),
    (r"^text_model\.emb_layer_norm\.", "text_model.embeddings.LayerNorm."),
    (r"^text_model\.blocks_(\d+)\.([qkv]_lin|out_lin)\.",
     r"text_model.transformer.layer.\1.attention.\2."),
    (r"^text_model\.blocks_(\d+)\.(lin[12])\.", r"text_model.transformer.layer.\1.ffn.\2."),
    (r"^text_model\.blocks_(\d+)\.", r"text_model.transformer.layer.\1."),
    (r"^video_model\.patch_embed\.", "video_model.patch_embed.proj."),
    (r"^(video_model|pred_model)\.blocks_(\d+)\.", r"\1.blocks.\2."),
    (r"\.mlp\.c_fc\.", ".mlp.fc1."),
    (r"\.mlp\.c_proj\.", ".mlp.fc2."),
    (r"^txt_proj\.", "txt_proj.1."),
    (r"^vid_proj\.", "vid_proj.0."),
))


def v1_state_dict_from_jax(params: Mapping) -> dict[str, np.ndarray]:
    """JAX TVTSv1 parameter tree (numpy leaves) -> the reference v1 state
    dict of float32 arrays: kernels transposed ([in, out] -> [out, in]; the
    tubelet conv [t, p, p, in, out] -> [out, in, t, p, p]), LayerNorm
    `scale` and embedding `embedding` -> `weight`, then `_V1_RENAMES`."""
    out: dict[str, np.ndarray] = {}
    for path, arr in _flatten(params):
        arr = np.asarray(arr, dtype=np.float32)
        leaf = path[-1]
        if leaf == "kernel":
            if arr.ndim not in (2, 5):
                raise ValueError(f"unhandled kernel shape {arr.shape} at {path}")
            arr = arr.T if arr.ndim == 2 else arr.transpose(4, 3, 0, 1, 2)
            name = ".".join(path[:-1]) + ".weight"
        elif leaf in ("scale", "embedding"):
            name = ".".join(path[:-1]) + ".weight"
        else:
            name = ".".join(path)
        for pattern, repl in _V1_RENAMES:
            name = pattern.sub(repl, name)
        out[name] = np.ascontiguousarray(arr)
    return out


def finetune_state_dict_from_jax(params: Mapping) -> dict[str, np.ndarray]:
    """JAX FinetuneViT parameter tree (numpy leaves) -> the port's FinetuneViT
    state dict: the v1 video tower's map (`patch_embed.proj`, `blocks.{i}`
    with fc1 / fc2), `fc_norm` and `head` transposed, under no prefix."""
    sd = v1_state_dict_from_jax({"video_model": params})
    return {k[len("video_model."):]: v for k, v in sd.items()}


_FROZEN_RENAMES = tuple((re.compile(p), r) for p, r in (
    (r"^blocks_(\d+)\.", r"blocks.\1."),
    (r"^patch_embed\.", "patch_embed.proj."),
    (r"^pre_logits\.", "pre_logits.fc."),
))


def frozen_state_dict_from_jax(params: Mapping) -> dict[str, np.ndarray]:
    """JAX downstream SpaceTimeTransformer tree (numpy leaves) -> the
    reference (timm) state dict of float32 arrays: kernels transposed ([in,
    out] -> [out, in]; the patch conv [p, p, in, out] -> [out, in, p, p]),
    LayerNorm `scale` -> `weight`, `blocks_{i}` -> `blocks.{i}`, the conv
    under `patch_embed.proj` and `pre_logits` under `pre_logits.fc`."""
    out: dict[str, np.ndarray] = {}
    for path, arr in _flatten(params):
        arr = np.asarray(arr, dtype=np.float32)
        leaf = path[-1]
        if leaf == "kernel":
            if arr.ndim not in (2, 4):
                raise ValueError(f"unhandled kernel shape {arr.shape} at {path}")
            arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
            name = ".".join(path[:-1]) + ".weight"
        elif leaf == "scale":
            name = ".".join(path[:-1]) + ".weight"
        else:
            name = ".".join(path)
        for pattern, repl in _FROZEN_RENAMES:
            name = pattern.sub(repl, name)
        out[name] = np.ascontiguousarray(arr)
    return out


def convert_v1_state_dict(sd: Mapping) -> dict:
    """A reference v1 state dict (`module.` stripped or not) -> entries under
    the port's names, as the JAX package reads it: each `attn.q_bias` /
    `attn.v_bias` pair becomes `attn.qkv.bias` = [q_bias, 0, v_bias]; the
    `text_model.*` keys go through `distilbert_state_dict`; CLIP-only keys
    (`_SKIP`) are dropped; the rest keep their names."""
    from tvts_torch.models.distilbert import distilbert_state_dict

    sd = {re.sub(r"^module\.", "", k): v for k, v in sd.items()}
    for k in [k for k in sd if k.endswith(".attn.q_bias")]:
        base = k[: -len("q_bias")]
        qb, vb = torch.as_tensor(sd.pop(k)), torch.as_tensor(sd.pop(base + "v_bias"))
        sd[base + "qkv.bias"] = torch.cat([qb, torch.zeros_like(qb), vb])
    text = distilbert_state_dict({k[len("text_model."):]: v for k, v in sd.items()
                                  if k.startswith("text_model.")})
    out = {k: v for k, v in sd.items()
           if not k.startswith("text_model.") and not any(s in k for s in _SKIP)}
    out.update({f"text_model.{k}": v for k, v in text.items()})
    return out


def inflate_mae_2d_to_3d(sd: Mapping, tubelet_size: int = 2) -> dict:
    """An MAE 2-D patch embed [D, 3, p, p] repeated over the tubelet's time
    axis -> [D, 3, tubelet, p, p] (reference model_dist_TVTS.py:56-59)."""
    out = dict(sd)
    key = "patch_embed.proj.weight"
    if key in out and out[key].ndim == 4:
        w = torch.as_tensor(out[key])
        out[key] = w[:, :, None].repeat(1, 1, tubelet_size, 1, 1)
    return out
