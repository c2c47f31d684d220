"""The system under test as the harness builds it: tvts_torch's model from a
configuration file and seeded weights, through the port's own constructors
and its strict `load_state_dict` (build_model would draw initial weights on
the CPU first, 1.22 B of them for H/14, which every run would pay in set-up).
Imports of the program stay inside the functions, so that the harness, the
tests and the reference import without it."""

from __future__ import annotations

import torch

from benchmark import weights


def model_config(cfg: dict):
    """tvts_torch's TVTSv2Config of a configuration file."""
    from tvts_torch.models.configs import SortConfig, TextConfig, TVTSv2Config, VisionConfig

    return TVTSv2Config(name=cfg["arch"], vision=VisionConfig(**cfg["vision"]),
                        text=TextConfig(**cfg["text"]), sort=SortConfig(**cfg["sort"]),
                        num_clips=cfg["num_clips"])


def build(cfg: dict, seed: int, device, extract: bool):
    """(tvts_torch config, TVTSv2 on `device`): for extraction the eval
    config (no tube mask) with bf16 weights, LayerNorms float32, in eval
    mode; for training float32 masters computing in bf16, in train mode."""
    from tvts_torch.models.factory import cast_tower_
    from tvts_torch.models.tvts_v2 import TVTSv2

    config = model_config(cfg)
    if extract:
        config = config.eval_config()
    with torch.device(device):
        model = TVTSv2(config)
    model.load_state_dict(weights.make(cfg, seed, device, served=extract), strict=True)
    if extract:
        cast_tower_(model, torch.bfloat16)
    else:
        model.set_compute_dtype(torch.bfloat16)
    model.train(not extract)
    return config, model
