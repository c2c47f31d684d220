"""Traffic kind "classify": video classification through the port's
`make_cls_eval_step(model, use_fused=True)` (downstream/engine.py: the joint
space-time blocks on the kernels, ops/fused_forward.finetune_vit_fused_forward),
bf16 weights with the LayerNorms float32, in a closed loop. The model is the
downstream FinetuneViT at the configuration's sizes, its weights drawn from
the seed under the published names (reference/videomae.py) and loaded
through the port's q/v-bias fold (utils/convert.convert_v1_state_dict).

Mix parameters: `batch` clips a call (the views of one test video); `pool`
distinct device-resident batches drawn from the seed, dispatched in turn;
`checked_batches` pool batches whose window outputs the check compares;
`reference_chunk` clips the reference computes at once; `subpaths`, the
benchmark/spans.py entries the path calls.

Set-up fails the run unless one call of the entry launches the attention
core and the MLP sub-path once a block each (`text_core.launches`,
`fused_mlp_block.launches`) and runs no eager attention.

Check: after the window, `checked_batches` of the pool slots it ran, drawn
from the seed; for each, one of its window outputs drawn from the seed,
against the plain reference's logits and fc_norm features of that slot in
float32 (TF32 off). The numbers compared are the widest relative row errors
||program - reference|| / ||reference||: `logit_err` over the logits,
`feature_err` over the features. `failed` counts window batches with a
non-finite output.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import feed, flops_joint
from benchmark.reference import model as ref
from benchmark.reference import videomae

CHECK_SEED_OFFSET = 2_000_003  # the check's sample draws are not the inputs' ones


def build(cfg: dict, seed: int, device):
    """The port's FinetuneViT on `device` at the configuration's sizes, in
    eval mode: built on the meta device (no storage, no initialisation), its
    parameters then the seeded served weights themselves after the q/v-bias
    fold (bf16 but the LayerNorms, as cast_tower_ leaves a tower), by a
    strict assigning load (no second copy), and its position table
    written."""
    from tvts_torch.downstream.model import FinetuneViT, sinusoid_table
    from tvts_torch.utils.convert import convert_v1_state_dict

    with torch.device("meta"):
        model = FinetuneViT(num_classes=cfg["num_classes"], img_size=cfg["img_size"],
                            patch_size=cfg["patch_size"], embed_dim=cfg["embed_dim"],
                            depth=cfg["depth"], heads=cfg["num_heads"],
                            num_frames=cfg["num_frames"], tubelet_size=cfg["tubelet_size"],
                            use_mean_pooling=True, mlp_ratio=cfg["mlp_ratio"])
    weights = convert_v1_state_dict(videomae.make_weights(cfg, seed, device, served=True))
    model.load_state_dict(weights, strict=True, assign=True)
    model.pos_table = torch.from_numpy(sinusoid_table(*model.pos_table.shape).copy()).to(device)
    return model.eval()


class Session:
    def __init__(self, cell, seed: int, dev):
        self.cell, self.seed, self.dev = cell, seed, dev
        self.mix, self.cfg = cell.traffic, cell.config
        self.batch = self.mix["batch"]
        self.flops_per_step = self.batch * flops_joint.classify_flops_per_clip(self.cfg)
        self.logits: list = []
        self.features: list = []
        self.slots: list = []
        self.calls = 0

    def inputs(self) -> None:
        vision = {"input_resolution": self.cfg["img_size"], "num_frames": self.cfg["num_frames"]}
        self.pool = feed.clips(feed.generator(self.seed, self.dev.device), self.mix["pool"],
                               self.batch, vision, self.dev.device)

    def set_up(self) -> None:
        from tvts_torch.downstream.engine import make_cls_eval_step

        self.inputs()
        self.model = build(self.cfg, self.seed, self.dev.device)
        self.model.fc_norm.register_forward_hook(lambda m, i, out: self.features.append(out))
        self.eval_step = make_cls_eval_step(self.model, use_fused=True)
        self.check_path()
        for _ in range(self.mix["pool"]):  # every shape, and every pool slot once
            self.step()

    def check_path(self) -> None:
        """One call of the entry on the kernels: each block's core and MLP
        sub-path launched once, and no eager attention (module notes)."""
        from tvts_torch.models import sort
        from tvts_torch.ops import block_kernels, text_attention

        def eager(*args, **kwargs):
            raise RuntimeError("the timed path ran the eager attention")

        counters = (text_attention.text_core, block_kernels.fused_mlp_block)
        before = [fn.launches for fn in counters]
        real, sort.self_attention = sort.self_attention, eager
        try:
            self.eval_step(self.pool[0])
        finally:
            sort.self_attention = real
        launched = [fn.launches - b for fn, b in zip(counters, before)]
        if self.dev.cuda and launched != [self.cfg["depth"]] * 2:
            raise RuntimeError(f"one call launched the attention core and the MLP sub-path "
                               f"{launched} times; the path takes each once a block "
                               f"({self.cfg['depth']})")

    def begin_window(self) -> None:
        self.logits, self.features, self.slots = [], [], []

    def step(self) -> dict:
        slot = self.calls % self.mix["pool"]
        self.calls += 1
        self.logits.append(self.eval_step(self.pool[slot]))
        self.slots.append(slot)
        return {"clips": self.batch, "flops": self.flops_per_step}

    def spans_on(self, on: bool) -> dict:
        """The program's spans on (their earlier records dropped) or off (their
        records of the window returned: utils/profiling.take_spans)."""
        from tvts_torch.utils import profiling

        if on:
            profiling.spans_on(True)
            profiling.take_spans()
            return {}
        profiling.spans_on(False)
        return profiling.take_spans()

    def failures(self) -> int:
        finite = torch.stack([torch.isfinite(o).all() for o in self.logits])
        return int((~finite).sum())

    def release(self) -> None:
        rng = np.random.default_rng(self.seed + CHECK_SEED_OFFSET)
        seen = sorted(set(self.slots))
        slots = rng.choice(seen, min(self.mix["checked_batches"], len(seen)), replace=False)
        self.checked = []
        for slot in slots.tolist():
            calls = [i for i, s in enumerate(self.slots) if s == slot]
            i = calls[rng.integers(len(calls))]
            self.checked.append((slot, self.logits[i].float(), self.features[i].float()))
        del self.model, self.eval_step, self.logits, self.features

    def reference(self, slots: list, numerics: str = "f32") -> list:
        """The plain reference's (logits, features) of the pool `slots`."""
        P = {n: t.float() for n, t in videomae.make_weights(self.cfg, self.seed, self.dev.device,
                                                              served=True).items()}
        num = ref.Numerics(numerics)
        chunk = self.mix["reference_chunk"]
        out = []
        with ref.no_tf32(), torch.no_grad():
            for slot in slots:
                rows = [videomae.forward(num, P, self.cfg, self.pool[slot][i:i + chunk])
                        for i in range(0, self.batch, chunk)]
                out.append(tuple(torch.cat(part) for part in zip(*rows)))
        return out

    def check(self) -> list:
        want = self.reference([slot for slot, _, _ in self.checked])
        got = [(logits, features) for _, logits, features in self.checked]
        return compare(got, want, self.cell.limits)

    def control(self, numerics: str) -> list:
        """The check with the reference in `numerics` in the program's place."""
        if not hasattr(self, "pool"):
            self.inputs()
        rng = np.random.default_rng(self.seed + CHECK_SEED_OFFSET)
        slots = rng.choice(self.mix["pool"], self.mix["checked_batches"], replace=False).tolist()
        return compare(self.reference(slots, numerics), self.reference(slots), self.cell.limits)


def _row_err(got: list, want: list) -> float:
    return max(float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max()) for g, w in zip(got, want))


def compare(got: list, want: list, limits: dict) -> list:
    """[(name, value, limit)] of (logits, features) pairs against the reference's."""
    return [(name, _row_err([g[i] for g in got], [w[i] for w in want]), limits[name])
            for i, name in enumerate(("logit_err", "feature_err"))]
