"""Fine-tuning engine (counterpart of tvts_tpu/downstream/engine.py): the
per-step cosine schedule, layer-wise LR decay, soft-target cross-entropy, the
train and eval steps, the model EMA and the multi-view test merge.

- `cosine_schedule`: linear warmup from warmup_start, then cosine to the
  final value (reference utils.py cosine_scheduler), the step clamped to
  total - 1, in float32 as the JAX schedule computes it;
- layer decay: the LR of layer id l is scaled by decay^(num_layers + 1 - l);
  the patch embed is layer 0, block i layer i + 1, `fc_norm` and `head`
  layer num_layers + 1 (optim_factory.py get_num_layer_for_vit);
- `make_finetune_optimizer`: a parameter group per (layer, decay) label, as
  the JAX package's optax.multi_transform labels them: weight decay 0 on
  biases, tensors of rank <= 1 and NO_WD_PARAMS. The update is optax's
  adamw (eps outside the square root: train/optim.StateDtypeAdamW in float32).
  As in the JAX package, where optax.clip_by_global_norm sits inside each
  group's chain, EACH GROUP is clipped by its own gradient norm (the
  reference clips the whole model once; ROADMAP.md §3): gradients times
  max_norm / norm where norm >= max_norm (optax's (g / norm) * max_norm
  within a rounding), with no host synchronisation. `linear_probe` trains
  `head` and `fc_norm` only: the rest is frozen (requires_grad False, no
  state), where optax.set_to_zero leaves it unchanged;
- `soft_ce` in the JAX dtype order: log_softmax in the logits' dtype, the
  product with the float32 targets in float32;
- `EmaParams`: float32 e * d + p * (1 - d) with e * d fused into the sum,
  as XLA compiles the JAX update (timm ModelEma, decay 0.9999);
- `MultiViewAccumulator`: per-view logits averaged per video, then top-1/5
  (engine_for_finetuning.py:178-283's final_test / merge, in memory).
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from tvts_torch.train.optim import StateDtypeAdamW
from tvts_torch.utils.profiling import spanned

NO_WD_PARAMS = {"pos_embed", "cls_token", "temporal_embed"}


def cosine_schedule(base_value: float, final_value: float, epochs: int,
                    steps_per_epoch: int, warmup_epochs: int = 0,
                    warmup_start: float = 1e-6) -> Callable[[int], np.float32]:
    """step -> value: linear warmup, then cosine (utils.py cosine_scheduler)."""
    warmup_steps = int(warmup_epochs * steps_per_epoch)
    total = int(epochs * steps_per_epoch)
    f32 = np.float32

    def fn(step: int) -> np.float32:
        step = min(int(step), total - 1)
        if step < warmup_steps:
            return (f32(warmup_start) + f32(base_value - warmup_start) * f32(step)
                    / f32(max(warmup_steps, 1)))
        prog = f32(step - warmup_steps) / f32(max(total - warmup_steps, 1))
        return f32(final_value) + f32(0.5 * (base_value - final_value)) * (
            f32(1) + np.cos(f32(math.pi) * prog))

    return fn


def layer_id_for_param(name: str, num_layers: int) -> int:
    """get_num_layer_for_vit (optim_factory.py:26-38) on the port's names."""
    top = name.split(".")[0]
    if top in ("cls_token", "mask_token", "pos_embed", "patch_embed"):
        return 0
    if top == "blocks":
        return int(name.split(".")[1]) + 1
    return num_layers + 1  # norm / fc_norm / head


def param_labels(model: torch.nn.Module, num_layers: int,
                 linear_probe: bool = False) -> dict[str, str]:
    """name -> "l{layer}_{wd|nd}" or "frozen" (the JAX optimizer's labels)."""
    labels = {}
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        if linear_probe and top not in ("head", "fc_norm"):
            labels[name] = "frozen"
            continue
        lid = num_layers + 1 if linear_probe else layer_id_for_param(name, num_layers)
        nd = name.endswith("bias") or p.ndim <= 1 or top in NO_WD_PARAMS
        labels[name] = f"l{lid}_{'nd' if nd else 'wd'}"
    return labels


class LayerDecayAdamW(StateDtypeAdamW):
    """optax.multi_transform of chain(clip_by_global_norm, adamw) over the
    groups: each step sets every group's LR to lr_fn(count) * its scale (in
    float32, as the JAX package multiplies them), clips each group's
    gradients by that group's own norm, then takes the AdamW update."""

    def __init__(self, param_groups, lr_fn: Callable, clip_grad: float | None,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(param_groups, betas=betas, eps=eps, mu_dtype=torch.float32)
        self.lr_fn, self.clip_grad = lr_fn, clip_grad
        self.count = 0  # optimizer steps taken: the schedule's step

    @torch.no_grad()
    def step(self, closure=None):
        lr = np.float32(self.lr_fn(self.count))
        for group in self.param_groups:
            group["lr"] = float(lr * np.float32(group["scale"]))
            grads = [p.grad for p in group["params"] if p.grad is not None]
            if self.clip_grad and grads:
                norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
                factor = torch.where(norm < self.clip_grad, torch.ones_like(norm),
                                     self.clip_grad / norm)
                torch._foreach_mul_(grads, factor)
        super().step(closure)
        self.count += 1


def make_finetune_optimizer(model: torch.nn.Module, lr: float, weight_decay: float,
                            epochs: int, steps_per_epoch: int, warmup_epochs: int = 5,
                            min_lr: float = 1e-6, layer_decay: float = 0.75,
                            num_layers: int = 12, clip_grad: float | None = 5.0,
                            betas=(0.9, 0.999), linear_probe: bool = False):
    """(LayerDecayAdamW, {label: LR scale}): layer-decayed AdamW with the
    cosine LR; linear_probe freezes all but head / fc_norm
    (run_class_linear.py:341-346)."""
    lr_fn = cosine_schedule(lr, min_lr, epochs, steps_per_epoch, warmup_epochs)
    labels = param_labels(model, num_layers, linear_probe)
    groups: dict[str, list] = {}
    for name, p in model.named_parameters():
        if labels[name] == "frozen":
            p.requires_grad_(False)
        else:
            groups.setdefault(labels[name], []).append(p)
    scales, param_groups = {}, []
    for lab in sorted(groups):
        lid = int(lab[1:].split("_")[0])
        scales[lab] = layer_decay ** (num_layers + 1 - lid)
        param_groups.append({"params": groups[lab], "name": lab, "scale": scales[lab],
                             "weight_decay": weight_decay if lab.endswith("_wd") else 0.0})
    return LayerDecayAdamW(param_groups, lr_fn, clip_grad, betas=betas), scales


def soft_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """SoftTargetCrossEntropy: targets are probabilities [B, C]."""
    return (-targets * F.log_softmax(logits, dim=-1)).sum(-1).mean()


class ClsTrainStep:
    """step(video, targets) -> the loss (a detached device scalar): forward,
    soft_ce, backward, the optimizer's step."""

    def __init__(self, model: torch.nn.Module, optimizer: LayerDecayAdamW):
        self.model, self.optimizer = model, optimizer

    def __call__(self, video: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        loss = soft_ce(self.model(video), targets)
        loss.backward()
        self.optimizer.step()
        return loss.detach()


def make_cls_train_step(model: torch.nn.Module, optimizer: LayerDecayAdamW) -> ClsTrainStep:
    return ClsTrainStep(model, optimizer)


def make_cls_eval_step(model: torch.nn.Module,
                       use_fused: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """step(video) -> logits, without autograd, in the span `cls_eval`.
    use_fused: FinetuneViT's blocks on the kernels
    (ops/fused_forward.finetune_vit_fused_forward: bf16 on the card, the plain
    sub-paths on the CPU), else model(video)."""
    if use_fused:
        from tvts_torch.ops.fused_forward import finetune_vit_fused_forward

        forward = functools.partial(finetune_vit_fused_forward, model)
    else:
        forward = model

    @torch.no_grad()
    @spanned("cls_eval")
    def step(video: torch.Tensor) -> torch.Tensor:
        return forward(video)

    return step


class EmaParams:
    """Model EMA (the reference's timm ModelEma, decay 0.9999) of the
    parameters, float32, updated as e * d + p * (1 - d) with d and 1 - d in
    float32 and e * d fused into the sum."""

    def __init__(self, model: torch.nn.Module, decay: float = 0.9999):
        self.decay = decay
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p.detach().float().clone() for p in model.parameters()]

    @torch.no_grad()
    def update(self, model: torch.nn.Module) -> None:
        d = np.float32(self.decay)
        mixed = torch._foreach_mul([p.detach().float() for p in model.parameters()],
                                   float(np.float32(1) - d))
        # + d * e as one fused multiply-add (add's alpha), as XLA fuses e * d into the sum
        torch._foreach_add_(mixed, self.params, alpha=float(d))
        self.params = mixed

    def state_dict(self) -> dict[str, torch.Tensor]:
        return dict(zip(self.names, self.params))


class MultiViewAccumulator:
    """final_test / merge: per-view logits averaged per video, then top-1/5."""

    def __init__(self, num_samples: int, num_classes: int):
        self.sum = np.zeros((num_samples, num_classes), dtype=np.float64)
        self.count = np.zeros(num_samples, dtype=np.int64)
        self.labels = np.full(num_samples, -1, dtype=np.int64)

    def add(self, sample_idx, logits, labels):
        logits = np.asarray(logits, dtype=np.float64)
        for i, s in enumerate(np.asarray(sample_idx)):
            self.sum[s] += logits[i]
            self.count[s] += 1
            self.labels[s] = labels[i]

    def merge(self) -> dict:
        mask = self.count > 0
        avg = self.sum[mask] / self.count[mask, None]
        labels = self.labels[mask]
        pred = np.argsort(-avg, axis=1)
        top1 = float(np.mean(pred[:, 0] == labels))
        top5 = float(np.mean(np.any(pred[:, :5] == labels[:, None], axis=1)))
        return {"top1": top1, "top5": top5, "n": int(mask.sum())}
