"""Optimizer: 4-group AdamW with frozen text layers and milestone LR decay
(counterpart of tvts_tpu/train/optim.py; reference
v2/train_dist_TVTSv2_ViT_B_16.py:66-125 and trainer.py:402-417).

Groups, by the port's (reference) parameter names:
- "new": `pred_model.*` and, in the video tower, `timeattn` / `ln_3` / `ls_3`:
  lr_new;
- "clip": the rest of the video tower, the tuned text blocks, and
  `text_token_embedding`, `text_positional_embedding`, `text_ln_final`,
  `text_projection`: lr_clip;
- "frozen": `text_model.resblocks.{i}` for i < text_layers - text_tune_layers:
  requires_grad False, no optimizer state (activation gradients still flow
  through these blocks to the embeddings below them);
- weight decay 0 for names holding bias / ln_ / norm, else weight_decay.
AdamW with betas (0.9, 0.999), eps 1e-6 and decoupled decay; torch's AdamW
puts the eps outside the bias-corrected square root and applies the decay to
the old parameter, as optax.adamw does. The LR decays by 0.1 after each
milestone epoch (1-based): lr(step) = base * 0.1^|{m : step >= m * steps_per_epoch}|.
`mu_dtype` (bf16 first moments) is not ported yet (the H/14 item).
"""

from __future__ import annotations

import dataclasses
import re

import torch

GROUPS = ("new_decay", "new_nodecay", "clip_decay", "clip_nodecay")
NO_DECAY_SUBSTRINGS = ("bias", "ln_", "norm")
_TEXT_BLOCK = re.compile(r"^text_model\.resblocks\.(\d+)\.")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr_new: float = 1e-4
    lr_clip: float = 1e-7
    weight_decay: float = 0.05
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-6
    text_layers: int = 12       # total text resblocks
    text_tune_layers: int = 3   # last-k trainable (3 for B/*, 6 for H/14)
    schedule: tuple = ()        # epoch milestones, e.g. (6, 8)
    steps_per_epoch: int = 1

    @property
    def text_tune_from(self) -> int:
        """Index of the first trainable text block."""
        return self.text_layers - self.text_tune_layers


def _label(name: str, cfg: OptimizerConfig) -> str:
    nd = "nodecay" if any(s in name for s in NO_DECAY_SUBSTRINGS) else "decay"
    if name.startswith("video_model."):
        new = "timeattn" in name or "ln_3" in name or "ls_3" in name
        return f"{'new' if new else 'clip'}_{nd}"
    block = _TEXT_BLOCK.match(name)
    if block:
        return f"clip_{nd}" if int(block.group(1)) >= cfg.text_tune_from else "frozen"
    if name.startswith("text_"):
        return f"clip_{nd}"
    return f"new_{nd}"


def label_params(model: torch.nn.Module, cfg: OptimizerConfig) -> dict[str, str]:
    """name -> new_decay / new_nodecay / clip_decay / clip_nodecay / frozen."""
    return {name: _label(name, cfg) for name, _ in model.named_parameters()}


def freeze_mask(model: torch.nn.Module, cfg: OptimizerConfig) -> dict[str, bool]:
    """name -> True for the frozen group."""
    return {name: label == "frozen" for name, label in label_params(model, cfg).items()}


def milestone_scale_fn(cfg: OptimizerConfig):
    """step -> LR multiplier: 0.1 per milestone epoch already ended."""
    boundaries = sorted(int(m) * cfg.steps_per_epoch for m in cfg.schedule)
    return lambda step: 0.1 ** sum(step >= b for b in boundaries)


def make_optimizer(model: torch.nn.Module, cfg: OptimizerConfig) -> torch.optim.AdamW:
    """The 4-group AdamW; freezes the frozen group (requires_grad False).
    Each group keeps its base LR under "base_lr" (the train step scales it)."""
    labels = label_params(model, cfg)
    groups = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        if labels[name] == "frozen":
            p.requires_grad_(False)
        else:
            groups[labels[name]].append(p)
    param_groups = []
    for g, params in groups.items():
        if params:
            lr = cfg.lr_new if g.startswith("new") else cfg.lr_clip
            wd = cfg.weight_decay if g.endswith("_decay") else 0.0
            param_groups.append({"params": params, "lr": lr, "base_lr": lr,
                                 "weight_decay": wd, "name": g})
    return torch.optim.AdamW(param_groups, betas=cfg.betas, eps=cfg.eps)
