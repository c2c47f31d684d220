"""Model construction + initialisation / checkpoint loading (counterpart of
tvts_tpu/models/factory.py)."""

from __future__ import annotations

import logging

import torch
from torch import nn

from tvts_torch.models.configs import MODEL_REGISTRY
from tvts_torch.models.layers import LayerNormF32
from tvts_torch.models.space_time_vit import LayerScale
from tvts_torch.models.tvts_v1 import TVTSv1, TVTSv1Config
from tvts_torch.models.tvts_v2 import TVTSv2
from tvts_torch.utils.convert import (
    convert_v1_state_dict,
    load_reference_state_dict,
    merge_params,
)

log = logging.getLogger(__name__)


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
                use_pallas: bool = False,
                strict: bool = True) -> tuple:
    """(cfg, TVTSv2) on `device` (the card unless the caller asks for the
    CPU). eval_mode=True gives the downstream config (no tube masking) in
    eval mode; eval_mode=False the masked training config in train mode.
    Weights come from `load_checkpoint` (a reference `.pth`, `module.`
    stripped) or, without one, from the JAX package's initializers drawn from a
    generator seeded with `seed`, on the CPU, so one seed gives the same
    weights on every device. With strict=True the checkpoint must set every
    parameter and name nothing else (nothing is drawn); strict=False draws
    the initial weights and overlays the checkpoint on them (`merge_params`:
    missing keys keep their fresh values, unused keys are logged, a shape
    mismatch raises). The JAX package's strict load only refuses unused keys. `dtype` is the parameters' dtype (LayerNorms stay float32);
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
    if load_checkpoint and strict:  # the checkpoint sets every parameter, so none is drawn
        model.load_state_dict(load_reference_state_dict(load_checkpoint), strict=True)
    else:
        model.reset_parameters(torch.Generator().manual_seed(seed))
        if load_checkpoint:
            missing, unused = merge_params(model, load_reference_state_dict(load_checkpoint))
            log.info("loaded %s: %d keys kept their initial values, %d unused: %s",
                     load_checkpoint, len(missing), len(unused), unused)
    cast_tower_(model, dtype).to(device)
    model.set_compute_dtype(compute_dtype)
    model.train(not eval_mode)
    return cfg, model


def build_v1_model(cfg: TVTSv1Config = TVTSv1Config(),
                   load_checkpoint: str | None = None,
                   device: str | torch.device = "cuda",
                   seed: int = 0,
                   compute_dtype: torch.dtype | None = None) -> TVTSv1:
    """A TVTSv1 with float32 parameters in train mode on `device` (the card
    unless the caller asks for the CPU): every weight from `load_checkpoint`
    (a reference v1 `.pth` read by utils/convert.convert_v1_state_dict,
    loaded strictly) or, without one, from the JAX package's initializers
    drawn from a generator seeded with `seed` on the CPU. `compute_dtype` is
    the activations' (bf16 over the f32 parameters for training)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_v1_model: no CUDA device; pass device='cpu' to build on "
                           "the CPU")
    model = TVTSv1(cfg)
    if load_checkpoint:
        model.load_state_dict(convert_v1_state_dict(load_reference_state_dict(load_checkpoint)),
                              strict=True)
    else:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(device).set_compute_dtype(compute_dtype)
    return model
