"""Model construction + initialisation / checkpoint loading (counterpart of
tvts_tpu/models/factory.py): both towers; the sort head waits for slice 3."""

from __future__ import annotations

import logging

import torch
from torch import nn

from tvts_torch.models.configs import MODEL_REGISTRY
from tvts_torch.models.layers import LayerNormF32
from tvts_torch.models.tvts_v2 import TVTSv2
from tvts_torch.utils.convert import load_reference_state_dict

log = logging.getLogger(__name__)


def cast_tower_(model: nn.Module, dtype: torch.dtype) -> nn.Module:
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
                seed: int = 0) -> tuple:
    """(cfg, TVTSv2). Weights come from `load_checkpoint` (a reference `.pth`:
    `module.` stripped, `video_model.*` and the text keys loaded strictly,
    `pred_model.*` dropped) or, without one, from the JAX package's
    initializers drawn from a generator seeded with `seed`. Initialised on
    the CPU, so one seed gives the same weights on every device."""
    cfg = MODEL_REGISTRY[arch_type]()
    if eval_mode:
        cfg = cfg.eval_config()
    model = TVTSv2(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    if load_checkpoint:
        sd = load_reference_state_dict(load_checkpoint)
        sort_head = [k for k in sd if k.startswith("pred_model.")]
        if sort_head:
            log.info("dropped %d pred_model.* keys of %s (the sort head is not ported yet)",
                     len(sort_head), load_checkpoint)
        model.load_state_dict({k: v for k, v in sd.items()
                               if not k.startswith("pred_model.")}, strict=True)
    cast_tower_(model, dtype).to(device)
    model.train(not eval_mode)
    return cfg, model
