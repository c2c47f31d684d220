"""Traffic kind "pretrain": the pretraining step of the port,
`make_train_step(model, make_optimizer(...), ocfg, apply_fn=train_apply with
the mix's kernel config)`, f32 masters computing in bf16, in a closed loop.

Mix parameters: `batch` clips a step; `rounds`, the loaders' round robin
(each: `captions` a clip, and `sort_labels`, which YT-Temporal batches carry
and WebVid ones do not); `pool` distinct device-resident clip batches used in
turn; `caption_tokens` and `truncated_share` (benchmark/feed.py); a fresh
tube keep set a step; `text_tune_layers` (the text blocks below the last
ones are frozen); `optimizer` (AdamW's rates, decay, betas, eps); `kernels`
(the config's `trainer.kernels` section); `checked_steps`; `subpaths`, the
sub-path entries (benchmark/spans.py) the step calls, each of which
`kernel_roofline` needs to have recorded.

Check (set-up builds the one train step and drives it through the first
`checked_steps` steps of the feed, the window's own call; the reference
follows them from the same seeded weights and batches):
- loss_gap: |loss - reference| / |reference| of the first step;
- emb_err: the first step's text and video embeddings, as the forward
  returned them: the widest relative row error against the reference's;
- grad_gap: the first step's gradient as the optimizer got it (its first
  moment after one step over 1 - beta1), by the worst leaf: the gap between
  the two norms over the larger of the reference leaf's norm and the median
  leaf's;
- change_gap: the same of each trainable leaf's change over the checked
  steps, leaving out the elements whose reference gradient is under a
  thousandth of the median leaf's root-mean-square element (they move under
  Adam by round-off alone, as the key third of a qkv bias does under
  softmax), and the leaves left with none;
- frozen_moved: frozen leaves not bit for bit what they were (limit 0).
Why the first step's loss and the embeddings, and not the widest loss gap
(which the check prints as a reading): PERF.md, §2.
The program's changes are kept on the host from set-up to the check.
`failed` counts window steps whose loss is not finite.
"""

from __future__ import annotations

import functools
import statistics
import sys

import torch

from benchmark import feed, flops, program, weights
from benchmark.harness import percentile
from benchmark.reference import model as ref
from benchmark.reference import train as ref_train

QUIET_GRADIENT = 1e-3  # elements under this share of the median leaf's RMS move by round-off


class Session:
    def __init__(self, cell, seed: int, dev):
        self.cell, self.seed, self.dev = cell, seed, dev
        self.mix, self.cfg = cell.traffic, cell.config
        v = self.cfg["vision"]
        self.batch = self.mix["batch"]
        self.patches = (v["input_resolution"] // v["patch_size"]) ** 2
        self.n_keep = int(self.patches * (1.0 - v["mask_ratio"]))
        self.tune_from = self.cfg["text"]["layers"] - self.mix["text_tune_layers"]
        self.step_flops = [self.batch * flops.train_flops_per_clip(
            self.cfg, self.n_keep, r["captions"], self.tune_from) for r in self.mix["rounds"]]
        self.calls = 0
        self.losses: list = []
        self.spans = None
        self.outputs = ()

    # -- inputs ---------------------------------------------------------------
    def inputs(self) -> None:
        device = self.dev.device
        self.gen = feed.generator(self.seed, device)
        self.pool = feed.clips(self.gen, self.mix["pool"], self.batch, self.cfg["vision"], device)
        n = self.cfg["num_clips"]
        self.labels = torch.arange(n, device=device).repeat(self.batch, 1)

    def next_batch(self) -> tuple[dict, int]:
        i = self.calls
        self.calls += 1
        rnd = i % len(self.mix["rounds"])
        r = self.mix["rounds"][rnd]
        device = self.dev.device
        batch = {"video": self.pool[i % self.mix["pool"]],
                 "text_ids": feed.caption_ids(self.gen, r["captions"] * self.batch,
                                              self.cfg["text"]["context_length"],
                                              tuple(self.mix["caption_tokens"]),
                                              self.mix["truncated_share"], device),
                 "keep_ind": feed.keep_sets(self.gen, self.batch, self.patches, self.n_keep,
                                            device)}
        if r["sort_labels"]:
            batch["labels"] = self.labels
        return batch, rnd

    # -- the program ------------------------------------------------------------
    def set_up(self) -> None:
        from tvts_torch.ops.fused_forward import train_apply
        from tvts_torch.ops.kernel_config import resolve_kernel_config, train_apply_kwargs
        from tvts_torch.train.optim import OptimizerConfig, make_optimizer
        from tvts_torch.train.step import make_train_step

        self.inputs()
        device = self.dev.device
        _, self.model = program.build(self.cfg, self.seed, device, extract=False)
        o = self.mix["optimizer"]
        ocfg = OptimizerConfig(lr_new=o["lr_new"], lr_clip=o["lr_clip"],
                               weight_decay=o["weight_decay"], betas=tuple(o["betas"]),
                               eps=o["eps"], text_layers=self.cfg["text"]["layers"],
                               text_tune_layers=self.mix["text_tune_layers"])
        self.optimizer = make_optimizer(self.model, ocfg)
        kcfg = resolve_kernel_config(self.cfg["arch"], self.mix["kernels"], env={})
        self._apply = functools.partial(train_apply, **train_apply_kwargs(kcfg, ocfg))
        self._optimizer_step = self.optimizer.step
        self.optimizer.step = self._spanned_optimizer_step
        self.train = make_train_step(self.model, self.optimizer, ocfg,
                                     apply_fn=self._spanned_apply)
        self.checked = []
        for k in range(self.mix["checked_steps"]):
            self.step()
            self.checked.append(self.last_batch)
            if k == 0:
                grads = self._first_gradient(o["betas"][0])
        self.readings = self._readings(grads)
        self.losses = []

    def _first_gradient(self, beta1: float) -> dict:
        out = {}
        for name, p in self.model.named_parameters():
            state = self.optimizer.state.get(p)
            if state:
                moment = state["exp_avg"] if "exp_avg" in state else state["mu"]
                out[name] = moment.float().norm() / (1 - beta1)
        return out

    @torch.no_grad()
    def _readings(self, grads: dict) -> dict:
        init = weights.make(self.cfg, self.seed, self.dev.device)
        delta, moved = {}, 0
        for name, p in self.model.named_parameters():
            if name in grads:
                delta[name] = (p - init[name]).cpu()
            elif not torch.equal(p, init[name]):
                moved += 1
        del init
        return {"losses": [float(x) for x in self.losses],
                "grad_norms": {n: float(g) for n, g in grads.items()},
                "delta": delta, "frozen_moved": moved, "outputs": self.outputs}

    def _spanned_apply(self, model, batch):
        if self.spans is None:
            out = self._apply(model, batch)
            if not self.outputs:  # the first checked step's (text, video) embeddings
                self.outputs = tuple(o.detach().float() for o in out[:2])
            return out
        start = self.dev.event()
        out = self._apply(model, batch)
        self._pending = (start, self.dev.event())
        return out

    def _spanned_optimizer_step(self, *args, **kwargs):
        if self.spans is None:
            return self._optimizer_step(*args, **kwargs)
        start = self.dev.event()
        out = self._optimizer_step(*args, **kwargs)
        self.spans.append((*self._pending, start, self.dev.event()))
        return out

    def begin_window(self) -> None:
        self.losses = []

    def step(self) -> dict:
        batch, rnd = self.next_batch()
        self.last_batch = batch
        self.losses.append(self.train(batch)["loss"])
        return {"clips": self.batch, "flops": self.step_flops[rnd]}

    def spans_on(self, on: bool) -> dict:
        """Start recording the events of each step's forward, backward and
        optimizer; on stopping (after a synchronise) their ms by name."""
        if on:
            self.spans = []
            return {}
        spans, self.spans = self.spans, None
        return {"fwd": [a.elapsed_time(b) for a, b, _, _ in spans],
                "bwd": [b.elapsed_time(c) for _, b, c, _ in spans],
                "opt": [c.elapsed_time(d) for _, _, c, d in spans]}

    def failures(self) -> int:
        return int((~torch.isfinite(torch.stack(self.losses))).sum())

    def release(self) -> None:
        del self.model, self.optimizer, self.train, self._apply, self._optimizer_step
        self.losses = []

    # -- the check ----------------------------------------------------------------
    def reference(self, numerics: str = "f32", fault: str | None = None) -> dict:
        """The plain reference's readings over the checked steps' batches
        (with a planted fault: reference/train.py's FAULTS)."""
        P = {n: t.clone() for n, t in weights.make(self.cfg, self.seed, self.dev.device).items()}
        with ref.no_tf32():
            out = ref_train.run_steps(ref.Numerics(numerics), P, self.cfg, self.checked,
                                      self.mix["optimizer"], self.tune_from, fault)
        init = weights.make(self.cfg, self.seed, self.dev.device)
        with torch.no_grad():
            out["delta"] = {n: (P[n] - init[n]).cpu() for n in out["first_grads"]}
            out["grad_norms"] = {n: float(g.norm()) for n, g in out["first_grads"].items()}
        out["frozen_moved"] = 0
        return out

    def check(self) -> list:
        return compare(self.readings, self.reference(), self.cell.limits, _report)

    def control(self, numerics: str, fault: str | None = None) -> list:
        """The check with the reference in `numerics` (or with a planted
        fault) in the program's place."""
        if not hasattr(self, "checked"):
            self.inputs()
            self.checked = [self.next_batch()[0] for _ in range(self.mix["checked_steps"])]
        return compare(self.reference(numerics, fault), self.reference(), self.cell.limits,
                       _report)


def leaf_gaps(got: dict, want: dict) -> tuple[list, list]:
    """Each trainable leaf's gap of first-gradient norms, and of change norms
    over its counted elements (module notes), against the reference's."""
    g_ref = want["grad_norms"]
    g_med = statistics.median(g_ref.values())
    grad = [abs(got["grad_norms"].get(n, 0.0) - g) / max(g, g_med) for n, g in g_ref.items()]
    grads = want["first_grads"]
    quiet = QUIET_GRADIENT * statistics.median(float(g.norm()) / g.numel() ** 0.5
                                               for g in grads.values())
    c_ref, c_got = {}, {}
    for n, g in grads.items():
        counted = g.abs() >= quiet
        if counted.any():
            c_ref[n] = float(want["delta"][n].to(g.device)[counted].norm())
            mine = got["delta"].get(n)
            c_got[n] = 0.0 if mine is None else float(mine.to(g.device)[counted].norm())
    c_med = statistics.median(c_ref.values())
    return grad, [abs(c_got[n] - c) / max(c, c_med) for n, c in c_ref.items()]


@torch.no_grad()
def compare(got: dict, want: dict, limits: dict, report=None) -> list:
    """The checked numbers (module notes). `report(name, value)` receives
    readings that are not compared: the widest loss gap over the checked
    steps, and the 90th-percentile and median leaves."""
    losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
    grad, change = leaf_gaps(got, want)
    if report is not None:
        report("loss_gap_widest", max(losses))
        for name, gaps in (("grad_gap", grad), ("change_gap", change)):
            report(f"{name}_p90", percentile(gaps, 90))
            report(f"{name}_median", statistics.median(gaps))
    emb_err = max(float(((g[:len(w)] - w[:len(g)]).norm(dim=-1) / w[:len(g)].norm(dim=-1)).max())
                  for g, w in zip(got["outputs"], want["outputs"]))
    return [("loss_gap", losses[0], limits["loss_gap"]),
            ("emb_err", emb_err, limits["emb_err"]),
            ("grad_gap", max(grad), limits["grad_gap"]),
            ("change_gap", max(change), limits["change_gap"]),
            ("frozen_moved", got["frozen_moved"], limits["frozen_moved"])]


def _report(name: str, value: float) -> None:
    print(f"reading {name} {value!r}", file=sys.stderr)
