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
  fc1/fc2, and `blocks_{i}` -> `transformer.resblocks.{i}` for the video
  tower.
numpy only: no JAX and no `tvts_tpu` import.
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
