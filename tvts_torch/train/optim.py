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

`mu_dtype` ("bfloat16": the first moment kept in bf16, the second moment and
the update in the parameter's dtype) halves the first-moment state; with bf16
parameters it is the JAX package's single-device H/14 recipe
(tools/train_bench.py --bf16_state). torch.optim.AdamW has no such switch, so
a config that sets it gets `StateDtypeAdamW`, the same update written out in
plain torch in optax's order of operations and rounding points.

TVTS v1 (`make_v1_optimizer`, scripts/train_dist_TVTS.py:89-100) trains
every parameter in one AdamW group: the config's lr, betas and weight decay
(on every parameter, biases and norms too), eps 1e-6, and the same
milestone decay.
"""

from __future__ import annotations

import dataclasses
import functools
import re

import numpy as np
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
    mu_dtype: str | None = None  # e.g. "bfloat16": the first moment's dtype

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


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`: a Python scalar enters a JAX operation in
    the array's dtype, and PyTorch would keep it in float32."""
    return torch.tensor(value, dtype=dtype).item()


class StateDtypeAdamW(torch.optim.Optimizer):
    """AdamW whose first moment is kept in `mu_dtype`, as optax.adamw(mu_dtype=)
    computes it: mu = (1 - b1) g + b1 mu and nu = (1 - b2) g^2 + b2 nu in the
    promoted dtype, the update mu_hat / (sqrt(nu_hat) + eps) + wd * p from the
    un-rounded mu, p += -lr * update, and only then mu rounded to `mu_dtype`.
    Every scalar enters an operation in the tensor's dtype."""

    def __init__(self, params, betas=(0.9, 0.999), eps=1e-6, mu_dtype=torch.bfloat16):
        super().__init__(params, dict(lr=0.0, weight_decay=0.0, betas=betas, eps=eps))
        self.mu_dtype = mu_dtype

    def load_state_dict(self, state_dict: dict) -> None:
        """torch.optim casts the state to each parameter's dtype on load:
        the first moment goes back to `mu_dtype` (exact: it was saved in it)."""
        super().load_state_dict(state_dict)
        for state in self.state.values():
            state["mu"] = state["mu"].to(self.mu_dtype)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("StateDtypeAdamW takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            by_dtype: dict = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p, dtype=self.mu_dtype)
                    state["nu"] = torch.zeros_like(p)
                state["step"] += 1
                by_dtype.setdefault((p.dtype, p.grad.dtype, state["step"]), []).append(p)
            for (P, G, step), params in by_dtype.items():
                self._update(params, P, G, step, group["lr"], group["weight_decay"], b1, b2,
                             group["eps"])

    def _update(self, params, P, G, step, lr, wd, b1, b2, eps):
        M, r = self.mu_dtype, _rounded
        grads = [p.grad for p in params]
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        U = torch.promote_types(G, M)  # dtype of the new first moment and of the update
        mu = [a.to(U) for a in torch._foreach_mul(grads, r(1 - b1, G))]
        torch._foreach_add_(mu, [a.to(U) for a in torch._foreach_mul(mus, r(b1, M))])
        nu = torch._foreach_mul(torch._foreach_mul(grads, grads), r(1 - b2, G))
        torch._foreach_add_(nu, torch._foreach_mul(nus, r(b2, P)))
        # 1 - decay ** count in float32, then cast to the moment's dtype
        bc1 = float(np.float32(1) - np.float32(b1) ** np.int32(step))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.int32(step))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, r(bc2, P)))
        torch._foreach_add_(denom, r(eps, P))
        update = torch._foreach_div(torch._foreach_div(mu, r(bc1, U)), denom)
        if wd:
            torch._foreach_add_(update, torch._foreach_mul(params, r(wd, P)))
        torch._foreach_mul_(update, r(-float(np.float32(lr)), U))
        torch._foreach_add_(params, update)
        for p, m, v in zip(params, mu, nu):
            self.state[p]["mu"] = m.to(M)
            self.state[p]["nu"] = v


def make_optimizer(model: torch.nn.Module, cfg: OptimizerConfig) -> torch.optim.Optimizer:
    """The 4-group AdamW; freezes the frozen group (requires_grad False).
    Each group keeps its base LR under "base_lr" (the train step scales it).
    With cfg.mu_dtype the optimizer is StateDtypeAdamW."""
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
    if cfg.mu_dtype is not None:
        return StateDtypeAdamW(param_groups, betas=cfg.betas, eps=cfg.eps,
                               mu_dtype=getattr(torch, cfg.mu_dtype))
    return torch.optim.AdamW(param_groups, betas=cfg.betas, eps=cfg.eps)


def make_v1_optimizer(model: torch.nn.Module, lr: float = 1e-4, betas=(0.9, 0.999),
                      weight_decay: float = 0.0, eps: float = 1e-6) -> torch.optim.Optimizer:
    """TVTS v1's single-group AdamW over every parameter (optax.adamw with no
    mask); the group keeps its base LR under "base_lr" for the train step."""
    return torch.optim.AdamW([{"params": list(model.parameters()), "lr": lr, "base_lr": lr,
                               "weight_decay": weight_decay, "name": "all"}],
                             betas=tuple(betas), eps=eps)
