"""Model construction + initialisation / checkpoint loading (counterpart of
tvts_tpu/models/factory.py)."""

from __future__ import annotations

import torch
from torch import nn

from tvts_torch.models.configs import MODEL_REGISTRY
from tvts_torch.models.layers import LayerNormF32
from tvts_torch.models.space_time_vit import LayerScale
from tvts_torch.models.tvts_v2 import TVTSv2
from tvts_torch.utils.convert import load_reference_state_dict


def cast_tower_(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every parameter except the LayerNorms' and the LayerScale gammas
    (which stay float32)."""
    for module in model.modules():
        if not isinstance(module, (LayerNormF32, LayerScale)):
            for p in module.parameters(recurse=False):
                p.data = p.data.to(dtype)
    return model


def build_model(arch_type: str,
                load_checkpoint: str | None = None,
                eval_mode: bool = True,
                dtype: torch.dtype = torch.float32,
                device: str | torch.device = "cuda",
                seed: int = 0,
                compute_dtype: torch.dtype | None = None,
                remat: bool = False,
                use_pallas: bool = False) -> tuple:
    """(cfg, TVTSv2) on `device` (the card unless the caller asks for the
    CPU). eval_mode=True gives the downstream config (no tube masking) in
    eval mode; eval_mode=False the masked training config in train mode.
    Weights come from `load_checkpoint` (a reference `.pth`, `module.`
    stripped, every key loaded strictly, the sort head included) or, without
    one, from the JAX package's initializers drawn from a generator seeded
    with `seed`, on the CPU, so one seed gives the same weights on every
    device. `dtype` is the parameters' dtype (LayerNorms stay float32);
    `compute_dtype` the activations' (bf16 over f32 masters for training).
    `remat` checkpoints every tower block in training; `use_pallas` runs the
    eager video tower's space attention core on the H9 kernel (forward only)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: no CUDA device; pass device='cpu' to build on the CPU")
    cfg = MODEL_REGISTRY[arch_type]()
    if eval_mode:
        cfg = cfg.eval_config()
    model = TVTSv2(cfg, remat=remat, use_pallas=use_pallas)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    if load_checkpoint:
        model.load_state_dict(load_reference_state_dict(load_checkpoint), strict=True)
    cast_tower_(model, dtype).to(device)
    model.set_compute_dtype(compute_dtype)
    model.train(not eval_mode)
    return cfg, model
