"""Weights carried across from the JAX package, and reference `.pth` reading.

`state_dict_from_jax` turns the JAX package's nested parameter tree (numpy
leaves) into a state dict under the reference names, the same names and
values `tvts_tpu.utils.torch_convert.export_state_dict(params,
ddp_prefix=False)` writes for the video tower:
- 2-D kernels are transposed ([in, out] -> [out, in]);
- the patchify conv kernel [kh, kw, in, out] -> [out, in, kh, kw];
- LayerNorm `scale` -> `weight`;
- `blocks_{i}` -> `transformer.resblocks.{i}`.
numpy only: no JAX and no `tvts_tpu` import.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_BLOCKS = re.compile(r"(^|\.)blocks_(\d+)\.")


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_jax(params: Mapping) -> dict[str, np.ndarray]:
    """JAX video-tower parameter tree (optionally under `video_model`) ->
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
        elif leaf == "scale":
            name = ".".join(path[:-1]) + ".weight"
        else:  # bias and the direct parameters keep their names
            name = ".".join(path)
        out[_BLOCKS.sub(r"\1transformer.resblocks.\2.", name)] = np.ascontiguousarray(arr)
    return out


def load_reference_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Tensors of a reference `.pth` (a bare state dict or a trainer
    checkpoint holding one under `state_dict`), DDP `module.` prefix stripped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {re.sub(r"^module\.", "", k): v for k, v in obj.items()
            if isinstance(v, torch.Tensor)}
