"""Training and evaluation steps (counterpart of tvts_tpu/train/step.py;
reference v2/trainer/trainer.py:463-499): forward -> sim_matrix(video, text)
-> NormSoftmaxLoss + 2x sort cross-entropy -> backward -> AdamW step.

A batch is a dict of tensors on the model's device: "video" [B, T, 3, H, W],
"text_ids" [n_trans * B, ctx] clip-major, "keep_ind" [B, n_keep] (TVTS v1:
[B, n_tubes, n_keep]), "labels" [B, n_trans], and for TVTS v1 the text ids'
"attention_mask". `apply_fn(model, batch)` returns (text_emb, video_emb,
predict_order); the default is the eager `model(...)`,
ops/fused_forward.train_apply the kernel path. Frozen parameters carry
requires_grad False (train/optim.make_optimizer), so autograd computes no
weight gradient for them while activation gradients still flow through their
blocks: the JAX package's `_stop_frozen`.

Under a process group (parallel/mesh.create_mesh), a process a rank, each
rank runs `apply_fn` on its own batch (tp ranks on the same one); the video
and text embeddings are all-gathered over the mesh's data group (the dp x
fsdp ranks) into the whole batch's contrastive matrix and the sort loss and
its accuracy are averaged over it (parallel/collectives.py). Each rank's
gradient of that loss is then n x its share of the whole batch's gradient,
n = dp x fsdp (all_gather's transpose sums the cotangent over the data
ranks), and the steps differ in what they make of it:
- `make_train_step(..., mesh=)` is the JAX package's `make_train_step` over
  a mesh (tvts_tpu/train/step.py:89-104: one jitted step of the global
  batch), the one its Trainer and train scripts take: its gradient is the
  gradient of the whole batch's loss, as in one process. The gradients are
  SUM all-reduced over the data group (one flat buffer a dtype) and divided
  by dp x fsdp; a model sharded by parallel/partition.fsdp_shard has them
  reduce-scattered and averaged over dp x fsdp by FSDP2 instead, and no
  second reduction runs;
- `make_sharded_train_step` is the JAX package's explicit shard_map step
  (tvts_tpu/train/step.py:145-233), which only tests reach there: its
  gradients are SUM all-reduced over the data group and not divided, dp x
  fsdp x the gradient of the same loss on the whole batch.
Neither reduces over tp: under tensor parallelism (parallel/tensor_parallel.py)
a tp slice's gradient is this rank's own, and a tensor replicated over tp
gets the same gradient on every tp rank. Tp slices all have one shape, so a
reduction over the default group would sum one rank's heads into another's
without an error; every reduction here names the data group.
Without a process group both are the step of one process.

Under sequence parallelism (parallel/sequence_parallel.py: a video tower
with a `token_partition`, run by the eager forward) each sp rank
back-propagates through its own tokens only, so the parameters used between
the token split and the gather (`model.sp_parameters()`: the stem and every
block) end the backward with a partial gradient: they are also SUM
all-reduced over the mesh's sp group, one flat buffer a dtype, after the
data-group reduction (under FSDP2: this rank's shards, which match on the
ranks of one fsdp coordinate). Every other gradient is whole and the same on
every sp rank. The kernel paths (`apply_fn`) keep the tokens whole and take
no sp sum.

A trainable parameter the loss does not reach (the sort head on a batch
without labels: WebVid) gets a zero gradient before the update, as the JAX
step's gradient tree holds zeros there, so AdamW still decays its moments
and applies weight decay to it (torch.optim skips a parameter whose
gradient is None).
"""

from __future__ import annotations

from typing import Callable

import torch

from tvts_torch.ops.losses import norm_softmax_loss, sort_accuracy, sort_loss
from tvts_torch.ops.sim import sim_matrix
from tvts_torch.parallel.collectives import all_gather_embeddings, pmean
from tvts_torch.train.optim import OptimizerConfig, milestone_scale_fn


def default_apply(model, batch):
    """The eager forward; a batch with an "attention_mask" (TVTS v1's
    DistilBERT ids) passes it after the text ids, as the JAX package's does."""
    if "attention_mask" in batch:
        return model(batch["video"], batch["text_ids"], batch["attention_mask"],
                     batch.get("keep_ind"))
    return model(batch["video"], batch["text_ids"], batch.get("keep_ind"))


def _losses(outputs, batch, temperature: float, gather: bool = False,
            group=None) -> tuple[torch.Tensor, dict]:
    """(loss, aux of detached scalars) of the forward's outputs; `gather`:
    over the embeddings of the ranks of `group` (None: the default group),
    the sort terms averaged over them."""
    text_emb, video_emb, pred_order = outputs
    if gather:
        video_emb = all_gather_embeddings(video_emb, group)
        text_emb = all_gather_embeddings(text_emb, group)
    loss_ct = norm_softmax_loss(sim_matrix(video_emb.float(), text_emb.float()), temperature)
    loss_ce = s_acc = torch.zeros((), device=loss_ct.device)
    if pred_order is not None and "labels" in batch:
        loss_ce = sort_loss(pred_order, batch["labels"])
        s_acc = sort_accuracy(pred_order, batch["labels"])
        if gather:
            loss_ce, s_acc = pmean(loss_ce, group), pmean(s_acc, group)
    loss = loss_ct + loss_ce
    aux = {"loss": loss, "loss_ct": loss_ct, "loss_ce": loss_ce, "sort_acc": s_acc}
    return loss, {k: v.detach() for k, v in aux.items()}


def make_loss_fn(temperature: float = 0.05, apply_fn: Callable | None = None) -> Callable:
    """loss_fn(model, batch) -> (loss, aux of detached scalars)."""
    fwd = apply_fn or default_apply
    return lambda model, batch: _losses(fwd(model, batch), batch, temperature)


class TrainStep:
    """step(batch) -> aux: one optimizer step at the milestone LR of `count`,
    the optimizer steps taken so far (the first step is step 0, as in
    optax). `count` is the schedule's state: a checkpoint saves it and a
    resume sets it. With `mesh` a started process group, the loss gathered
    over its data group; `world_scale`: the summed gradients are not divided
    by dp x fsdp (the sharded step, module notes)."""

    def __init__(self, model, optimizer: torch.optim.Optimizer, cfg: OptimizerConfig,
                 temperature: float = 0.05, apply_fn: Callable | None = None, mesh=None,
                 world_scale: bool = False):
        from tvts_torch.parallel.partition import is_fsdp

        self.model, self.optimizer = model, optimizer
        self.fwd = apply_fn or default_apply
        self.temperature = temperature
        self.scale = milestone_scale_fn(cfg)
        self.gather = mesh is not None and mesh.distributed
        self.group = mesh.data_group if self.gather else None
        self.sharded = is_fsdp(model)
        if self.sharded and world_scale:
            raise ValueError("the sharded step keeps the JAX world x scale, which FSDP2's "
                             "averaged gradients do not give: use make_train_step")
        self.divisor = 1 if world_scale or not self.gather else mesh.data_size
        self.trainable = [p for group in optimizer.param_groups for p in group["params"]]
        self.sp_group, self.sp_params = None, []
        if self.gather and apply_fn is None and hasattr(model, "sp_parameters"):
            chosen = {id(p) for p in model.sp_parameters()}
            self.sp_params = [p for p in self.trainable if id(p) in chosen]
            self.sp_group = mesh.sp_group
        self.count = 0

    def __call__(self, batch: dict) -> dict:
        for group in self.optimizer.param_groups:
            group["lr"] = group["base_lr"] * self.scale(self.count)
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = _losses(self.fwd(self.model, batch), batch, self.temperature, self.gather,
                            self.group)
        loss.backward()
        for p in self.trainable:
            if p.grad is None:  # under FSDP a zero of the parameter's shard
                p.grad = torch.zeros_like(p)
        if self.gather and not self.sharded:
            _sum_grads(self.trainable, self.group, self.divisor)
        if self.sp_params:
            _sum_grads(self.sp_params, self.sp_group)
        self.optimizer.step()
        self.count += 1
        return aux


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (FSDP2's gradients), else t."""
    return t.to_local() if hasattr(t, "to_local") else t


def _sum_grads(params: list, group, divisor: int = 1) -> None:
    """SUM all-reduce of the gradients of `params` over `group`, one flat
    buffer a dtype, divided by `divisor`."""
    import torch.distributed as dist

    by_dtype: dict = {}
    for p in params:
        g = _local(p.grad)
        by_dtype.setdefault(g.dtype, []).append(g)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        if divisor != 1:
            flat /= divisor
        torch._foreach_copy_(grads, [part.view_as(g) for part, g in
                                     zip(flat.split([g.numel() for g in grads]), grads)])


def make_train_step(model, optimizer: torch.optim.Optimizer, cfg: OptimizerConfig,
                    temperature: float = 0.05, apply_fn: Callable | None = None,
                    mesh=None) -> TrainStep:
    """One AdamW step with the gradient of the whole batch's loss: this
    process's batch, or with `mesh` the batches of every rank (module notes)."""
    return TrainStep(model, optimizer, cfg, temperature, apply_fn, mesh)


def make_sharded_train_step(model, optimizer: torch.optim.Optimizer, cfg: OptimizerConfig,
                            mesh, temperature: float = 0.05,
                            apply_fn: Callable | None = None) -> TrainStep:
    """The JAX explicit data-parallel step of this rank's batch: dp x fsdp x
    the whole batch's gradient (module notes)."""
    return TrainStep(model, optimizer, cfg, temperature, apply_fn, mesh, world_scale=True)


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
