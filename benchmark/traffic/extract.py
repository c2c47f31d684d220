"""Traffic kind "extract": embedding extraction through the port's
`make_embed_fns(model, use_fused=True)` video entry (H1-H4, the CLS-only
last block), bf16 weights, in a closed loop.

Mix parameters: `batch` clips a call; `pool` distinct device-resident
batches drawn from the seed, dispatched in turn (one per step, so no host
copy sits in the window); `checked_batches` pool batches whose window outputs
the check compares; `subpaths`, the sub-path entries (benchmark/spans.py)
the path calls, each of which `kernel_roofline` needs to have recorded.

Check: after the window, `checked_batches` of the pool slots it ran, drawn
from the seed; for each, one of its window outputs drawn from the seed, against the plain
reference's pooled embeddings of that slot in float32 (TF32 off), computed in
chunks of `reference_chunk` clips. The number compared is the widest
relative row error ||program - reference|| / ||reference|| over those rows.
`failed` counts window batches with a non-finite output.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import feed, flops, program, weights
from benchmark.reference import model as ref

CHECK_SEED_OFFSET = 2_000_003  # the check's sample draws are not the inputs' ones


class Session:
    def __init__(self, cell, seed: int, dev):
        self.cell, self.seed, self.dev = cell, seed, dev
        self.mix, self.cfg = cell.traffic, cell.config
        self.batch = self.mix["batch"]
        self.flops_per_step = self.batch * flops.extract_flops_per_clip(self.cfg)
        self.outputs: list = []
        self.slots: list = []
        self.calls = 0

    def inputs(self) -> None:
        device = self.dev.device
        v = self.cfg["vision"]
        patches = (v["input_resolution"] // v["patch_size"]) ** 2
        self.pool = feed.clips(feed.generator(self.seed, device), self.mix["pool"], self.batch,
                               v, device)
        self.keep = torch.arange(patches, device=device)[None].expand(self.batch, -1)

    def set_up(self) -> None:
        from tvts_torch.eval.embed import make_embed_fns

        self.inputs()
        _, self.model = program.build(self.cfg, self.seed, self.dev.device, extract=True)
        _, self.embed_video = make_embed_fns(self.model, use_fused=True)
        for _ in range(self.mix["pool"]):  # every shape, and every pool slot once
            self.step()

    def begin_window(self) -> None:
        self.outputs, self.slots = [], []

    def step(self) -> dict:
        slot = self.calls % self.mix["pool"]
        self.calls += 1
        self.outputs.append(self.embed_video(self.pool[slot], self.keep))
        self.slots.append(slot)
        return {"clips": self.batch, "flops": self.flops_per_step}

    def spans_on(self, on: bool) -> dict:
        return {}

    def failures(self) -> int:
        finite = torch.stack([torch.isfinite(o).all() for o in self.outputs])
        return int((~finite).sum())

    def release(self) -> None:
        rng = np.random.default_rng(self.seed + CHECK_SEED_OFFSET)
        seen = sorted(set(self.slots))
        slots = rng.choice(seen, min(self.mix["checked_batches"], len(seen)), replace=False)
        self.checked = []
        for slot in slots.tolist():
            seen = [i for i, s in enumerate(self.slots) if s == slot]
            self.checked.append((slot, self.outputs[seen[rng.integers(len(seen))]].float()))
        del self.model, self.embed_video, self.outputs

    def reference(self, slots: list, numerics: str = "f32") -> list:
        """The plain reference's pooled embeddings of the pool `slots`."""
        P = {n: t.float() for n, t in weights.make(self.cfg, self.seed, self.dev.device,
                                                     served=True).items()}
        num = ref.Numerics(numerics)
        chunk = self.mix["reference_chunk"]
        out = []
        with ref.no_tf32(), torch.no_grad():
            for slot in slots:
                rows = [ref.video_tower(num, P, self.cfg["vision"], self.pool[slot][i:i + chunk],
                                        self.keep[i:i + chunk])[0]
                        for i in range(0, self.batch, chunk)]
                out.append(torch.cat(rows))
        return out

    def check(self) -> list:
        want = self.reference([slot for slot, _ in self.checked])
        got = [o for _, o in self.checked]
        return compare(got, want, self.cell.limits)

    def control(self, numerics: str) -> list:
        """The check with the reference in `numerics` in the program's place."""
        if not hasattr(self, "pool"):
            self.inputs()
        rng = np.random.default_rng(self.seed + CHECK_SEED_OFFSET)
        slots = rng.choice(self.mix["pool"], self.mix["checked_batches"], replace=False).tolist()
        return compare(self.reference(slots, numerics), self.reference(slots), self.cell.limits)


def compare(got: list, want: list, limits: dict) -> list:
    err = max(float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max()) for g, w in zip(got, want))
    return [("pooled_err", err, limits["pooled_err"])]
