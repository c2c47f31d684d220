"""Model construction + initialisation / checkpoint loading (counterpart of
tvts_tpu/models/factory.py). This slice builds the video tower only."""

from __future__ import annotations

import torch

from tvts_torch.models.configs import MODEL_REGISTRY
from tvts_torch.models.layers import LayerNormF32
from tvts_torch.models.space_time_vit import SpaceTimeViT
from tvts_torch.utils.convert import load_reference_state_dict


def cast_tower_(model: SpaceTimeViT, dtype: torch.dtype) -> SpaceTimeViT:
    """Cast every parameter except the LayerNorms' (which stay float32)."""
    for module in model.modules():
        if not isinstance(module, LayerNormF32):
            for p in module.parameters(recurse=False):
                p.data = p.data.to(dtype)
    return model


def build_model(arch_type: str,
                load_checkpoint: str | None = None,
                eval_mode: bool = True,
                dtype: torch.dtype = torch.float32,
                device: str | torch.device = "cpu",
                seed: int = 0):
    """(cfg, video tower). Weights come from `load_checkpoint` (a reference
    `.pth`: `module.` stripped, the `video_model.*` subtree loaded strictly)
    or, without one, from the JAX package's initializers drawn from a
    generator seeded with `seed`. Initialised on the CPU, so one seed gives
    the same weights on every device."""
    cfg = MODEL_REGISTRY[arch_type]()
    if eval_mode:
        cfg = cfg.eval_config()
    model = SpaceTimeViT(cfg.vision)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    if load_checkpoint:
        sd = load_reference_state_dict(load_checkpoint)
        prefix = "video_model."
        model.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                               if k.startswith(prefix)}, strict=True)
    cast_tower_(model, dtype).to(device)
    model.train(not eval_mode)
    return cfg, model
