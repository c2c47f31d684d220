"""Plain PyTorch pretraining step of TVTSv2 (reference trainer.py:463-499):
contrastive loss over the cosine similarities at temperature 0.05, plus twice
the sort head's cross-entropy on batches that carry sort labels, then AdamW
(torch's update, decoupled weight decay) over four groups.

Groups by the reference names: `pred_model.*` and the video tower's
`timeattn` and `ln_3` take `lr_new`, every other trainable leaf `lr_clip`;
names holding "bias", "ln_" or "norm" take no weight decay; text blocks below
`text_tune_from` are frozen. A trainable leaf that the loss does not reach
(the sort head on a batch without labels) takes a zero gradient, so its
moments decay and its weight decay applies.
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F

from benchmark.reference import model as ref

_TEXT_BLOCK = re.compile(r"^text_model\.resblocks\.(\d+)\.")
NO_DECAY = ("bias", "ln_", "norm")


def group(name: str, text_tune_from: int) -> str | None:
    """"new" / "clip" (with "_nodecay" where no decay applies), or None when frozen."""
    block = _TEXT_BLOCK.match(name)
    if block and int(block.group(1)) < text_tune_from:
        return None
    new = name.startswith("pred_model.") or (
        name.startswith("video_model.") and ("timeattn" in name or "ln_3" in name))
    decay = "_nodecay" if any(k in name for k in NO_DECAY) else ""
    return ("new" if new else "clip") + decay


def contrastive_loss(video_emb, text_emb, temperature: float = 0.05, altered: bool = False):
    """Symmetric InfoNCE over the cosine similarities; `altered` plants a
    fault: the first clip's answer (its positive similarity) replaced by its
    similarity to the second caption."""
    a = video_emb / video_emb.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    b = text_emb / text_emb.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    sim = a @ b.t()
    if altered:
        sim = torch.cat([torch.cat([sim[:1, 1:2], sim[:1, 1:]], 1), sim[1:]], 0)
    x = sim / temperature
    return -F.log_softmax(x, 1).diagonal().mean() - F.log_softmax(x.t(), 1).diagonal().mean()


def loss(num, P, cfg: dict, batch: dict, remat: bool = True, altered: bool = False):
    """(loss, (text_emb, video_emb)) of a batch."""
    text_emb, video_emb, order = ref.forward(num, P, cfg, batch, remat)
    total = contrastive_loss(video_emb.float(), text_emb.float(), altered=altered)
    if order is not None and "labels" in batch:
        n = order.shape[-1]
        total = total + 2.0 * F.cross_entropy(order.reshape(-1, n), batch["labels"].reshape(-1))
    return total, (text_emb, video_emb)


class AdamW:
    """torch.optim.AdamW's update over the groups above."""

    def __init__(self, names, opt: dict, text_tune_from: int):
        self.groups = {n: group(n, text_tune_from) for n in names}
        self.opt = opt
        self.t = 0
        self.m: dict = {}
        self.v: dict = {}

    def trainable(self) -> list[str]:
        return [n for n, g in self.groups.items() if g is not None]

    @torch.no_grad()
    def step(self, P: dict, grads: dict) -> None:
        b1, b2 = self.opt["betas"]
        eps, wd = self.opt["eps"], self.opt["weight_decay"]
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for n in self.trainable():
            g = grads.get(n)
            p = P[n]
            g = torch.zeros_like(p) if g is None else g
            lr = self.opt["lr_new"] if self.groups[n].startswith("new") else self.opt["lr_clip"]
            if not self.groups[n].endswith("_nodecay"):
                p.mul_(1 - lr * wd)
            m = self.m.setdefault(n, torch.zeros_like(p)).mul_(b1).add_(g, alpha=1 - b1)
            v = self.v.setdefault(n, torch.zeros_like(p)).mul_(b2).addcmul_(g, g, value=1 - b2)
            p.addcdiv_(m, (v.sqrt() / c2 ** 0.5).add_(eps), value=-lr / c1)


def half_batch(batch: dict) -> dict:
    """The first half of a batch's clips and of each clip's captions."""
    video = batch["video"]
    B, h = video.shape[0], video.shape[0] // 2
    ids = batch["text_ids"]
    n = ids.shape[0] // B
    out = {"video": video[:h], "keep_ind": batch["keep_ind"][:h],
           "text_ids": ids.view(n, B, -1)[:, :h].reshape(n * h, -1)}
    if "labels" in batch:
        out["labels"] = batch["labels"][:h]
    return out


FAULTS = ("half_batch", "altered_answer")


def run_steps(num, P: dict, cfg: dict, batches: list, opt: dict, text_tune_from: int,
              fault: str | None = None) -> dict:
    """Train the float32 leaves `P` (updated in place) for one step a batch.
    Returns the losses, the first step's gradient by trainable leaf and its
    (text, video) embeddings.
    `fault` plants one of FAULTS (the control's fault readings): "half_batch"
    leaves half of each batch out, the loss the mean over the rest;
    "altered_answer" alters the first clip's positive similarity where the
    loss reads it."""
    if fault not in (None, *FAULTS):
        raise ValueError(f"unknown fault {fault!r}")
    adam = AdamW(P.keys(), opt, text_tune_from)
    trainable = set(adam.trainable())
    losses, first = [], {}
    for i, batch in enumerate(batches):
        if fault == "half_batch":
            batch = half_batch(batch)
        for n, p in P.items():
            p.requires_grad_(n in trainable)
        value, embeddings = loss(num, P, cfg, batch, altered=fault == "altered_answer")
        value.backward()
        grads = {n: P[n].grad for n in trainable if P[n].grad is not None}
        if i == 0:
            first = {n: grads[n].detach().clone() if n in grads else torch.zeros_like(P[n])
                     for n in trainable}
            outputs = tuple(e.detach().float() for e in embeddings)
        losses.append(float(value.detach()))
        for p in P.values():
            p.grad = None
            p.requires_grad_(False)
        adam.step(P, grads)
        del grads, value
    return {"losses": losses, "first_grads": first, "outputs": outputs}
