"""Training and evaluation steps (counterpart of tvts_tpu/train/step.py;
reference v2/trainer/trainer.py:463-499): forward -> sim_matrix(video, text)
-> NormSoftmaxLoss + 2x sort cross-entropy -> backward -> AdamW step.

A batch is a dict of tensors on the model's device: "video" [B, T, 3, H, W],
"text_ids" [n_trans * B, ctx] clip-major, "keep_ind" [B, n_keep], "labels"
[B, n_trans]. `apply_fn(model, batch)` returns (text_emb, video_emb,
predict_order); the default is the eager `model(...)`,
ops/fused_forward.train_apply the kernel path. Frozen parameters carry
requires_grad False (train/optim.make_optimizer), so autograd computes no
weight gradient for them while activation gradients still flow through their
blocks: the JAX package's `_stop_frozen`. The multi-device step waits for the
distributed trainer.
"""

from __future__ import annotations

from typing import Callable

import torch

from tvts_torch.ops.losses import norm_softmax_loss, sort_accuracy, sort_loss
from tvts_torch.ops.sim import sim_matrix
from tvts_torch.train.optim import OptimizerConfig, milestone_scale_fn


def default_apply(model, batch):
    return model(batch["video"], batch["text_ids"], batch.get("keep_ind"))


def _losses(outputs, batch, temperature: float) -> tuple[torch.Tensor, dict]:
    """(loss, aux of detached scalars) of the forward's outputs."""
    text_emb, video_emb, pred_order = outputs
    loss_ct = norm_softmax_loss(sim_matrix(video_emb.float(), text_emb.float()), temperature)
    loss_ce = s_acc = torch.zeros((), device=loss_ct.device)
    if pred_order is not None and "labels" in batch:
        loss_ce = sort_loss(pred_order, batch["labels"])
        s_acc = sort_accuracy(pred_order, batch["labels"])
    loss = loss_ct + loss_ce
    aux = {"loss": loss, "loss_ct": loss_ct, "loss_ce": loss_ce, "sort_acc": s_acc}
    return loss, {k: v.detach() for k, v in aux.items()}


def make_loss_fn(temperature: float = 0.05, apply_fn: Callable | None = None) -> Callable:
    """loss_fn(model, batch) -> (loss, aux of detached scalars)."""
    fwd = apply_fn or default_apply
    return lambda model, batch: _losses(fwd(model, batch), batch, temperature)


def make_train_step(model, optimizer: torch.optim.Optimizer, cfg: OptimizerConfig,
                    temperature: float = 0.05, apply_fn: Callable | None = None) -> Callable:
    """step(batch) -> aux: one AdamW step with the milestone LR of the step
    count (the first step is step 0, as in optax)."""
    loss_fn = make_loss_fn(temperature, apply_fn)
    scale = milestone_scale_fn(cfg)
    count = [0]

    def train_step(batch):
        for group in optimizer.param_groups:
            group["lr"] = group["base_lr"] * scale(count[0])
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(model, batch)
        loss.backward()
        optimizer.step()
        count[0] += 1
        return aux

    return train_step


def make_eval_step(model, temperature: float = 0.05,
                   apply_fn: Callable | None = None) -> Callable:
    """Validation step: embeddings, sort accuracy and loss, no gradients."""
    fwd = apply_fn or default_apply

    @torch.no_grad()
    def eval_step(batch):
        outputs = fwd(model, batch)
        _, aux = _losses(outputs, batch, temperature)
        out = {"text_emb": outputs[0], "video_emb": outputs[1], "loss": aux["loss"]}
        if outputs[2] is not None and "labels" in batch:
            out["sort_acc"] = aux["sort_acc"]
        return out

    return eval_step
