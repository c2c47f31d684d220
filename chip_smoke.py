#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths -- TVTSv2 B/16 video feature
extraction, zero-shot eval (retrieval, prompt recognition, SSV2 multiple
choice) and the B/16 pretraining step (forward, backward, AdamW) through the
hand-written Hopper kernels -- on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero; they
run in the order 1-5, 7, 6):
1. refuse to run without CUDA; print the card's name and power limit;
2. build the kernels from tvts_torch/csrc with nvcc (sm_90a); print the build
   seconds and the -Xptxas -v register / shared-memory lines;
3. kernel parity, in bf16 on seeded inputs against the plain PyTorch versions
   on the card: H1-H4 at the B/16 shape (B=2), at N=49 (B/32) and at D=1280,
   H=16 (head dim 80); H7 (text attention) at the B/16 text shape (B=8, S=77,
   D=512, causal), the H/14 text shape (B=4, S=77, D=1024, H=16) and the sort
   head shape (B=2, S=1181, D=512, non-causal, LN eps 1e-6); the backwards of
   H6 (time) and H5 (space) at the B/16 train shape (B=2, N=98) and at D=1280,
   H=16 (N=76), and of H7 at the text shape (causal, frozen and not) and the
   sort shape, each gradient tensor within 0.06 * max|ref| of the plain
   backward;
4. extraction main path: build_model("TVTSv2_B_16") with seeded weights (noise
   on every leaf of both towers), extract_embeddings over 3 batches of 8
   synthetic clips (the last ragged) through the kernels; launch counts
   12/11/11/1 per forward; pooled cosine against the eager tower in bf16 and
   in f32; extract_video_feature;
5. zero-shot main path, kernels on both towers: run_retrieval over 21
   clip-caption pairs in batches of 8, run_recognition over a few class
   names, run_ssv2_mc with a few options per clip; 11 H7 launches per text
   forward; per-caption text cosine against the eager tower in bf16 and f32;
   t2v / v2t metrics of the kernel and eager paths and the max |diff| of
   their similarity matrices;
7. train main path: build_model("TVTSv2_B_16", eval_mode=False) with f32
   masters, bf16 compute and seeded noise on every leaf, the optimizer of
   tools/train_bench.py (blocks 0-8 of the text tower frozen), a B=8 batch of
   synthetic clips, 32 clip-major captions, random keep sets and labels; at
   step 0 the kernel path against the eager path (|dloss| < 2e-2, worst
   relative gradient error < 0.12 over tensors with max|g| > 1e-2 * global,
   the gate of tools/train_grad_check.py); three optimizer steps on the
   kernels with finite losses, frozen blocks unchanged bit for bit, every
   trainable tensor moved, and per step 12 H6 and 12 H5 forwards and
   backwards, 12 H7 forwards (11 text, 1 sort) and 12 H7 backwards (9 frozen);
   H1-H4 not called;
6. times with CUDA events after warm-up: clips/s at B=64 and captions/s at
   B=256 (kernels, eager), each kernel against its plain version; the train
   step at B=20 (ms, clips/s, peak memory; kernels, eager), each backward
   kernel against its plain backward at the B=20 shapes, and the device-time
   breakdown of one kernel-path train step from torch.profiler.
The line before the last is {"kernels": [...]}, each with its bound (the
larger of its bytes over 3.35 TB/s and its flops over 989 TFLOP/s, from the
shapes timed); the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# max|diff| band of the Pallas kernels against XLA in bf16 (0.031-0.047 at
# mean|out| ~0.8), scaled where the reference is larger
BAND = 0.05
COS_BF16, COS_F32 = 0.999, 0.995
REPLACES = {
    "fused_time_block": "tvts_tpu/ops/pallas_block_attention.py:2456",
    "fused_space_block": "tvts_tpu/ops/pallas_block_attention.py:2964",
    "fused_mlp_block": "tvts_tpu/ops/pallas_block_attention.py:2604",
    "fused_space_cls_only": "tvts_tpu/ops/pallas_block_attention.py:3339",
    "fused_text_attention_block": "tvts_tpu/ops/pallas_text_attention.py:102",
    "time_subpath_backward": "tvts_tpu/ops/pallas_block_backward.py:736",
    "space_subpath_backward": "tvts_tpu/ops/pallas_block_backward.py:3106",
    "text_subpath_backward": "tvts_tpu/ops/pallas_text_attention.py:264",
}
SOURCE = "tvts_torch/csrc/block_kernels.cu"
PEAK_FLOPS, HBM_BYTES_S = 989e12, 3.35e12  # H100 SXM: dense bf16, HBM3
# the TPU's measured real-shape gradient band (5.8e-2, PERF.md before the port)
GRAD_BAND = 0.06
# H5 / H6 backward parity shapes: (B, T, N, D, H)
BWD_SHAPES = {"B/16 train": (2, 12, 98, 768, 12), "D=1280 H=16": (1, 12, 76, 1280, 16)}
# H7 backward parity shapes: (B, S, D, H, causal, LN eps, frozen)
TEXT_BWD_SHAPES = {"text": (8, 77, 512, 8, True, 1e-5, False),
                   "text frozen": (8, 77, 512, 8, True, 1e-5, True),
                   "sort head": (2, 1181, 512, 8, False, 1e-6, False)}
# H7 parity shapes: (B, S, D, H, causal, LN eps)
TEXT_SHAPES = {"B/16 text": (8, 77, 512, 8, True, 1e-5),
               "H/14 text": (4, 77, 1024, 16, True, 1e-5),
               "sort head": (2, 1181, 512, 8, False, 1e-6)}
WORDS = ("a person is playing the guitar on stage while dog runs across green field "
         "under blue sky man cooks pasta in small kitchen woman rides bike through "
         "city street at night children swim pool dance read book").split()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def seeded_inputs(B, T, N, D, seed, device):
    """Activations with mean|x| ~0.8 and weights of std 1/sqrt(fan_in), from a
    numpy seed."""
    rng = np.random.default_rng(seed)

    def t(*shape, std=1.0, base=0.0, dtype=torch.bfloat16):
        return torch.tensor(base + std * rng.standard_normal(shape), dtype=dtype,
                            device=device)

    S, hidden = 1 + T * N, 4 * D
    return dict(
        x=t(B, S, D), base=t(B, S, D),
        ln_w=t(D, std=0.1, base=1.0, dtype=torch.float32),
        ln_b=t(D, std=0.1, dtype=torch.float32),
        wqkv=t(3 * D, D, std=D ** -0.5), bqkv=t(3 * D, std=0.1),
        wproj=t(D, D, std=D ** -0.5), bproj=t(D, std=0.1),
        wfc=t(hidden, D, std=D ** -0.5), bfc=t(hidden, std=0.1),
        wpr=t(D, hidden, std=hidden ** -0.5), bpr=t(D, std=0.1))


def kernel_calls(bk, a, T, H, act):
    """name -> (kernel call, plain call) on the inputs `a`."""
    attn_w = (a["ln_w"], a["ln_b"], a["wqkv"], a["bqkv"], a["wproj"], a["bproj"])
    mlp_w = (a["ln_w"], a["ln_b"], a["wfc"], a["bfc"], a["wpr"], a["bpr"])
    basecls = a["base"][:, :1].contiguous()
    return {
        "fused_time_block": (
            lambda: bk.fused_time_block(a["x"], *attn_w, num_frames=T, num_heads=H),
            lambda: bk.time_block_plain(a["x"], *attn_w, T, H)),
        "fused_space_block": (
            lambda: bk.fused_space_block(a["x"], a["base"], *attn_w, num_frames=T,
                                         num_heads=H),
            lambda: bk.space_block_plain(a["x"], a["base"], *attn_w, T, H)),
        "fused_mlp_block": (
            lambda: bk.fused_mlp_block(a["x"], *mlp_w, act=act),
            lambda: bk.mlp_block_plain(a["x"], *mlp_w, act)),
        "fused_space_cls_only": (
            lambda: bk.fused_space_cls_only(a["x"], basecls, *attn_w, num_frames=T,
                                            num_heads=H),
            lambda: bk.space_cls_only_plain(a["x"], basecls, *attn_w, T, H)),
    }


def text_calls(ta, a, H, causal, eps):
    """(kernel call, plain call) of H7 on the inputs `a` (x [B, S, D])."""
    w = (a["ln_w"], a["ln_b"], a["wqkv"], a["bqkv"], a["wproj"], a["bproj"])
    return (lambda: ta.fused_text_attention_block(a["x"], *w, num_heads=H, causal=causal,
                                                  eps=eps),
            lambda: ta.text_attention_block_plain(a["x"], *w, H, causal, eps))


def backward_calls(bb, a, g, T, H):
    """name -> (kernel backward, plain backward) of H6 and H5 on the inputs
    `a` and the output gradient g: tuples of gradients in argument order."""
    w = (a["ln_w"], a["ln_b"], a["wqkv"], a["bqkv"], a["wproj"], a["bproj"])
    return {
        "time_subpath_backward": (
            lambda: bb.vjp(lambda *t: bb.time_subpath(*t, T, H), g, (a["x"], *w)),
            lambda: bb.time_subpath_backward_plain(g, a["x"], *w, T, H)),
        "space_subpath_backward": (
            lambda: bb.vjp(lambda *t: bb.space_subpath(*t, T, H), g, (a["x"], a["base"], *w)),
            lambda: bb.space_subpath_backward_plain(g, a["x"], a["base"], *w, T, H)),
    }


def text_backward_calls(bb, ta, a, g, H, causal, eps, frozen):
    """(kernel backward, plain backward) of H7; with `frozen` dx only."""
    w = (a["ln_w"], a["ln_b"], a["wqkv"], a["bqkv"], a["wproj"], a["bproj"])
    wrt = (0,) if frozen else None
    return (lambda: bb.vjp(lambda *t: ta.text_subpath(*t, num_heads=H, causal=causal, eps=eps,
                                                      frozen=frozen), g, (a["x"], *w), wrt),
            lambda: ta.text_subpath_backward_plain(g, a["x"], *w, H, causal, eps, frozen))


GRAD_NAMES = {"time_subpath_backward": ("dx", "dln_w", "dln_b", "dwqkv", "dbqkv", "dwproj",
                                        "dbproj"),
              "space_subpath_backward": ("dx", "dbase", "dln_w", "dln_b", "dwqkv", "dbqkv",
                                         "dwproj", "dbproj")}
GRAD_NAMES["text_subpath_backward"] = GRAD_NAMES["time_subpath_backward"]


def grad_band_check(tag: str, names, got, want) -> float:
    """Each gradient tensor within GRAD_BAND * max|ref|; prints each; returns
    the largest max|diff|."""
    worst = 0.0
    for name, a, b in zip(names, got, want):
        if a.shape != b.shape or not torch.isfinite(a.float()).all():
            raise AssertionError(f"{tag} {name}: shape {tuple(a.shape)} or non-finite")
        diff = (a.float() - b.float()).abs().max().item()
        ref = b.float().abs().max().item()
        print(f"[3] {tag} {name:7s} max|diff| {diff:.3e} max|ref| {ref:.3e} "
              f"ratio {diff / ref:.4f} (<= {GRAD_BAND})")
        if diff > GRAD_BAND * ref:
            raise AssertionError(f"{tag} {name}: max|diff| {diff} > {GRAD_BAND} * {ref}")
        worst = max(worst, diff)
    return worst


def attention_work(kind: str, B: int, T: int, N: int, D: int, H: int, backward: bool):
    """(flops, bytes) of a video attention sub-path at [B, 1 + T*N, D]: the
    qkv and proj products, the core over its (query, key) pairs (the CLS row
    over every token), each input read once and each output written once."""
    S = 1 + T * N
    M = B * S
    keys = T + 1 if kind == "time" else N + 1
    pairs = B * (T * N * keys + S)
    weights = 2 * 4 * D * D
    if backward:  # g, x, qkv, attn, lse in; dx, dW out
        return 16 * M * D * D + 10 * D * pairs, 2 * M * D * 7 + 4 * B * H * S + 2 * weights
    extra = 2 * M * D if kind == "space" else 0  # base
    return 8 * M * D * D + 4 * D * pairs, 4 * M * D + extra + weights


def text_work(B: int, S: int, D: int, H: int, causal: bool, backward: bool,
              frozen: bool = False):
    """(flops, bytes) of the H7 sub-path (forward or backward) at [B, S, D]."""
    M = B * S
    pairs = B * (S * (S + 1) // 2 if causal else S * S)
    weights = 2 * 4 * D * D
    if backward:
        gemm = 8 if frozen else 16
        return (gemm * M * D * D + 10 * D * pairs,
                2 * M * D * 7 + 4 * B * H * S + (1 if frozen else 2) * weights)
    return 8 * M * D * D + 4 * D * pairs, 4 * M * D + weights


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: max(bytes / HBM rate, flops / peak)."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def train_batch(cfg, B: int, seed: int, device) -> dict:
    """Synthetic B/16 pretraining batch: normalised clips, n_trans * B
    clip-major tokenized captions, a random keep set of n_keep patches per
    clip, labels tile(arange(n_trans))."""
    from tvts_torch.text.tokenizer import tokenize_openclip

    rng = np.random.default_rng(seed)
    v, n = cfg.vision, cfg.num_clips
    video = rng.standard_normal((B, v.num_frames, 3, v.input_resolution, v.input_resolution))
    keep = np.stack([rng.permutation(v.patches_per_frame)[:v.n_keep] for _ in range(B)])
    ids = tokenize_openclip(synthetic_captions(n * B, seed))
    return {"video": torch.tensor(video, dtype=torch.float32, device=device),
            "text_ids": torch.from_numpy(ids).to(device),
            "keep_ind": torch.from_numpy(keep.astype(np.int64)).to(device),
            "labels": torch.from_numpy(np.tile(np.arange(n), (B, 1))).to(device)}


def text_inputs(B, S, D, seed, device):
    """seeded_inputs for a token sequence of length S (no frame structure)."""
    return seeded_inputs(B, 1, S - 1, D, seed, device)


def synthetic_captions(n: int, seed: int) -> list[str]:
    """Seeded word salads of 4-20 words; caption 0 overflows the 77-token
    context, so the truncation path runs."""
    rng = np.random.default_rng(seed)
    caps = [" ".join(rng.choice(WORDS, size=rng.integers(4, 21))) for _ in range(n)]
    caps[0] = " ".join(rng.choice(WORDS, size=120))
    return caps


def band_check(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float, float]:
    """(max|diff|, mean|ref|, tolerance); raises on a non-finite output."""
    if not torch.isfinite(got.float()).all():
        raise AssertionError("non-finite kernel output")
    diff = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().mean().item()
    return diff, ref, BAND * max(1.0, ref / 0.8)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class SyntheticLoader:
    """Normalised synthetic clips in fixed batches (the last one ragged), with
    optional captions, labels and option-major multiple-choice texts."""

    def __init__(self, videos: np.ndarray, n_patches: int, batch_size: int,
                 text=None, labels=None, options=None):
        self.videos, self.batch_size = videos, batch_size
        self.keep = np.tile(np.arange(n_patches, dtype=np.int32), (len(videos), 1))
        self.text, self.labels, self.options = text, labels, options

    def __iter__(self):
        for i in range(0, len(self.videos), self.batch_size):
            j = i + self.batch_size
            batch = {"video": self.videos[i:j], "keep_ind": self.keep[i:j]}
            if self.text is not None:
                batch["text"] = self.text[i:j]
            if self.options is not None:
                batch["text"] = [opts[i:j] for opts in self.options]
            if self.labels is not None:
                batch["label"] = self.labels[i:j]
            yield batch


def cos_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def counted(bk, bb, ta) -> list:
    """Every kernel wrapper that counts its launches."""
    return [*bk.KERNELS, ta.fused_text_attention_block, *bb.KERNELS, ta.text_subpath_backward]


def launch_counts(bk, bb, ta) -> dict[str, int]:
    counts = {fn.__name__: fn.launches for fn in counted(bk, bb, ta)}
    counts["text_subpath_backward (frozen)"] = ta.text_subpath_backward.frozen_launches
    return counts


def reset_launch_counts(bk, bb, ta) -> None:
    for fn in counted(bk, bb, ta):
        fn.launches = 0
    ta.text_subpath_backward.frozen_launches = 0


def grads_of(model, loss_fn, batch) -> tuple[float, dict]:
    """(loss, name -> f32 gradient) of the trainable parameters."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    loss, _ = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return loss.item(), {n: (torch.zeros_like(p) if g is None else g).float()
                         for (n, _), g in zip(named, grads)}


def train_phase(dev, bk, bb, ta) -> dict:
    """Phase 7 (module notes). Returns what phase 6 times."""
    from functools import partial

    from tvts_torch.models.factory import build_model
    from tvts_torch.ops.fused_forward import train_apply
    from tvts_torch.ops.kernel_config import resolve_kernel_config, train_apply_kwargs
    from tvts_torch.train.optim import OptimizerConfig, freeze_mask, make_optimizer
    from tvts_torch.train.step import make_loss_fn, make_train_step

    cfg, model = build_model("TVTSv2_B_16", eval_mode=False, device=dev, seed=0,
                             compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(11)
    with torch.no_grad():  # seeded noise on every leaf, the sort head's included
        for p in model.parameters():
            p.add_(torch.from_numpy(0.02 * rng.standard_normal(p.shape).astype(np.float32))
                   .to(dev))
    v = cfg.vision
    # the optimizer of tools/train_bench.py
    ocfg = OptimizerConfig(schedule=(6, 8), steps_per_epoch=1000, text_layers=cfg.text.layers,
                           text_tune_layers=3)
    kcfg = resolve_kernel_config(cfg.name, {"preset": "best"})
    kernel_apply = partial(train_apply, **train_apply_kwargs(kcfg, ocfg))
    optimizer = make_optimizer(model, ocfg)
    frozen = [n for n, f in freeze_mask(model, ocfg).items() if f]
    print(f"[7] {cfg.name} train: mask {v.mask_ratio}, n_keep {v.n_keep}, "
          f"S = {1 + v.num_frames * v.n_keep}; {sum(p.numel() for p in model.parameters())} "
          f"f32 master parameters, bf16 compute; {len(frozen)} frozen tensors "
          f"(text blocks 0-{ocfg.text_tune_from - 1}); kernel config {kcfg}")
    batch = train_batch(cfg, 8, seed=12, device=dev)

    # step-0 gate: kernel path against the eager path
    loss_k, gk = grads_of(model, make_loss_fn(apply_fn=kernel_apply), batch)
    loss_e, ge = grads_of(model, make_loss_fn(), batch)
    gscale = max(g.abs().max().item() for g in ge.values())
    rows = []
    for name, e in ge.items():
        amax = e.abs().max().item()
        err = (gk[name] - e).abs().max().item()
        rows.append((err / (amax + 1e-6), err, amax, name))
    sig = sorted((r for r in rows if r[2] > 1e-2 * gscale), reverse=True)
    print(f"[7] step-0 loss kernels {loss_k:.6f} eager {loss_e:.6f} |diff| "
          f"{abs(loss_k - loss_e):.3e} (< 2e-2); global max|g| {gscale:.3e}; top 5 by "
          f"relative error among {len(sig)} significant tensors (max|g| > 1e-2 * global):")
    for rel, err, amax, name in sig[:5]:
        print(f"[7]   rel {rel:.3e} abs {err:.3e} max|g| {amax:.3e} {name}")
    if abs(loss_k - loss_e) >= 2e-2 or (sig and sig[0][0] >= 0.12):
        raise AssertionError("train step 0: kernel path disagrees with the eager path")
    del gk, ge

    # three optimizer steps on the kernels
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(model, optimizer, ocfg, apply_fn=kernel_apply)
    n_steps = 3
    reset_launch_counts(bk, bb, ta)
    for i in range(n_steps):
        aux = {k: v.item() for k, v in step(batch).items()}
        print(f"[7] step {i}: " + ", ".join(f"{k} {v:.6f}" for k, v in aux.items()))
        if not all(np.isfinite(list(aux.values()))):
            raise AssertionError(f"train step {i}: non-finite {aux}")
    torch.cuda.synchronize()
    launches = launch_counts(bk, bb, ta)
    print(f"[7] launches over {n_steps} steps: {launches}")
    want = dict.fromkeys(launches, 0)
    want.update({name: 12 * n_steps for name in (
        "time_subpath", "time_subpath_backward", "space_subpath", "space_subpath_backward",
        "fused_text_attention_block", "text_subpath_backward")})
    want["text_subpath_backward (frozen)"] = 9 * n_steps
    if launches != want:
        raise AssertionError(f"train launches {launches}, expected {want}")
    moved, changed = [], []
    for n, p in model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        (changed if n in frozen and not same else moved if n not in frozen and same
         else []).append(n)
    if changed or moved:
        raise AssertionError(f"frozen tensors changed {changed}; trainable unmoved {moved}")
    print(f"[7] {len(frozen)} frozen tensors unchanged bit for bit; all "
          f"{len(before) - len(frozen)} trainable tensors moved")
    return dict(cfg=cfg, model=model, optimizer=optimizer, ocfg=ocfg,
                kernel_apply=kernel_apply, launches=launches)


def train_times(dev, card, bk, bb, ta, train: dict, times: dict) -> None:
    """Phase 6, train part: the step at B=20, each backward against its plain
    backward at the B=20 shapes, the profiler breakdown of one step."""
    from tvts_torch.train.step import make_train_step

    cfg, model = train["cfg"], train["model"]
    v, B = cfg.vision, 20
    batch = train_batch(cfg, B, seed=13, device=dev)
    for path, apply_fn in (("kernels", train["kernel_apply"]), ("eager", None)):
        step = make_train_step(model, train["optimizer"], train["ocfg"], apply_fn=apply_fn)
        step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / iters * 1e3
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[6] B/16 train step B={B} {path:7s}: {ms:.2f} ms/step, {B / ms * 1e3:.2f} "
              f"clips/s, peak memory {mem:.2f} GiB [{card}]")

    step = make_train_step(model, train["optimizer"], train["ocfg"],
                           apply_fn=train["kernel_apply"])
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    # device rows that are kernels (a host range such as the optimizer's step
    # also shows on the device timeline, over its kernels)
    rows = [(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0),
             e.key, e.count) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in host]
    busy = sum(r[0] for r in rows) / 1e3
    print(f"[6] profiled kernel-path step B={B}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"(idle share {max(0.0, 1 - busy / wall):.3f}) [{card}]")
    groups = {}
    for us, key, count in rows:
        group = ("hand-written (tvts::)" if "tvts::" in key
                 else "optimizer (multi_tensor_apply)" if "multi_tensor_apply" in key
                 else "library GEMM (cuBLAS / CUTLASS)"
                 if any(k in key for k in ("nvjet", "gemm", "cutlass", "sm90_xmma"))
                 else "other PyTorch kernels (elementwise, reductions, copies, conv)")
        groups[group] = groups.get(group, 0.0) + us / 1e3
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[6]   {ms:9.3f} ms ({ms / busy:.3f}) {group}")
    print("[6]   top device time by kernel:")
    for us, key, count in sorted(rows, reverse=True)[:24]:
        print(f"[6]   {us / 1e3:9.3f} ms {count:5d}x {key[:100]}")

    S = 1 + v.num_frames * v.n_keep
    T, N, D, H = v.num_frames, v.n_keep, v.width, v.heads
    a = seeded_inputs(1, 1, 1, D, seed=14, device=dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    for k in ("x", "base"):
        a[k] = torch.randn(B, S, D, generator=gen, device=dev, dtype=torch.bfloat16)
    g = torch.randn(B, S, D, generator=gen, device=dev, dtype=torch.bfloat16)
    w = (a["ln_w"], a["ln_b"], a["wqkv"], a["bqkv"], a["wproj"], a["bproj"])
    for name, core, kind in (("time_subpath_backward", "tvts_time_core", "time"),
                             ("space_subpath_backward", "tvts_space_core", "space")):
        res = a["x"] if kind == "time" else a["base"]
        _, *saves = bk._attention_sub_path(core, a["x"], res, *w, T, H, save=True)
        fn = getattr(bb, name)
        k_ms = cuda_ms(lambda: fn(g, a["x"], saves, a["ln_w"], a["ln_b"], a["wqkv"],
                                  a["wproj"], T, H), iters=5)
        plain = bb.time_subpath_backward_plain if kind == "time" \
            else bb.space_subpath_backward_plain
        extra = (a["base"],) if kind == "space" else ()
        p_ms = cuda_ms(lambda: plain(g, a["x"], *extra, *w, T, H), iters=3)
        times[name] = (k_ms, p_ms, bound_ms(*attention_work(kind, B, T, N, D, H, True)))
        print(f"[6] {name:22s} B={B} S={S}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
              f"(forward + backward), bound {times[name][2][0]:.3f} ms "
              f"({times[name][2][1]}) [{card}]")
        del saves
    tc = cfg.text
    for label, (TB, TS, TD, TH, causal, eps, frozen) in (
            ("text", (80, 77, tc.width, tc.heads, True, 1e-5, False)),
            ("text frozen", (80, 77, tc.width, tc.heads, True, 1e-5, True)),
            ("sort head", (B, S + cfg.num_clips, cfg.sort.embed_dim, cfg.sort.num_heads,
                           False, 1e-6, False))):
        t = text_inputs(TB, TS, TD, seed=16, device=dev)
        tg = text_inputs(TB, TS, TD, seed=17, device=dev)["x"]
        tw = (t["ln_w"], t["ln_b"], t["wqkv"], t["bqkv"], t["wproj"], t["bproj"])
        _, *saves = ta._text_sub_path(t["x"], *tw, TH, causal, eps, save=True)
        k_ms = cuda_ms(lambda: ta.text_subpath_backward(tg, t["x"], saves, t["ln_w"], t["ln_b"],
                                                        t["wqkv"], t["wproj"], TH, causal,
                                                        frozen), iters=5)
        p_ms = cuda_ms(lambda: ta.text_subpath_backward_plain(tg, t["x"], *tw, TH, causal, eps,
                                                              frozen), iters=3)
        bnd = bound_ms(*text_work(TB, TS, TD, TH, causal, True, frozen))
        if label == "text":
            times["text_subpath_backward"] = (k_ms, p_ms, bnd)
        print(f"[6] text_subpath_backward {label} B={TB} S={TS} D={TD}: kernel {k_ms:.3f} ms, "
              f"plain {p_ms:.3f} ms (forward + backward), bound {bnd[0]:.3f} ms ({bnd[1]}) "
              f"[{card}]")


def main() -> int:
    # ---- phase 1: the card --------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device -- this script runs only on the card",
              file=sys.stderr)
        return 1
    card = card_line()
    dev = torch.device("cuda")
    print(f"[1] card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    from tvts_torch.eval.embed import embed_texts, extract_embeddings, make_embed_fns
    from tvts_torch.eval.feature_extraction import extract_video_feature
    from tvts_torch.eval.zero_recognition import run_recognition
    from tvts_torch.eval.zero_ret import run_retrieval
    from tvts_torch.eval.zero_ssv2_mc import run_ssv2_mc
    from tvts_torch.models.factory import build_model
    from tvts_torch.ops import block_backward as bb
    from tvts_torch.ops import block_kernels as bk
    from tvts_torch.ops import text_attention as ta
    from tvts_torch.text.tokenizer import tokenize_openclip

    # ---- phase 2: build ------------------------------------------------------
    t0 = time.perf_counter()
    so, log = bk.build()
    bk.library()
    print(f"[2] built {so.name} in {time.perf_counter() - t0:.1f} s")
    entry = ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line:
            print(f"[2]   {entry}: {line.split(':', 1)[1].strip()}")
        elif "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill"):
            print(f"[2]   {entry}: {line.strip()}")

    # ---- phase 3: kernel parity ---------------------------------------------
    max_err = {}
    for label, (B, T, N, D, H, act) in {
            "B/16": (2, 12, 196, 768, 12, "quick_gelu"),
            "B/32 N=49": (2, 12, 49, 768, 12, "quick_gelu"),
            "D=1280 H=16": (1, 12, 256, 1280, 16, "gelu")}.items():
        a = seeded_inputs(B, T, N, D, seed=0, device=dev)
        for name, (kernel, plain) in kernel_calls(bk, a, T, H, act).items():
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            torch.cuda.synchronize()
            diff, ref, tol = band_check(got, want)
            print(f"[3] {name:22s} {label:12s} max|diff| {diff:.5f} mean|ref| {ref:.4f} "
                  f"(tol {tol:.4f})")
            if diff > tol:
                raise AssertionError(f"{name} {label}: max|diff| {diff} > {tol}")
            if label == "B/16":
                max_err[name] = diff
        del a
    for label, (B, S, D, H, causal, eps) in TEXT_SHAPES.items():
        kernel, plain = text_calls(ta, text_inputs(B, S, D, seed=0, device=dev), H, causal,
                                   eps)
        before = ta.fused_text_attention_block.launches
        got = kernel()
        torch.cuda.synchronize()
        if ta.fused_text_attention_block.launches != before + 1:
            raise AssertionError("fused_text_attention_block did not count its launch")
        want = plain()
        torch.cuda.synchronize()
        diff, ref, tol = band_check(got, want)
        print(f"[3] fused_text_attention_block {label:9s} B={B} S={S} D={D} H={H} "
              f"causal={causal} eps={eps:g}: max|diff| {diff:.5f} mean|ref| {ref:.4f} "
              f"(tol {tol:.4f})")
        if diff > tol:
            raise AssertionError(f"fused_text_attention_block {label}: max|diff| {diff} > {tol}")
        if label == "B/16 text":
            max_err["fused_text_attention_block"] = diff
    for label, (B, T, N, D, H) in BWD_SHAPES.items():
        a = seeded_inputs(B, T, N, D, seed=7, device=dev)
        g = seeded_inputs(B, T, N, D, seed=8, device=dev)["x"]
        for name, (kernel, plain) in backward_calls(bb, a, g, T, H).items():
            before = getattr(bb, name).launches
            got = kernel()
            torch.cuda.synchronize()
            if getattr(bb, name).launches != before + 1:
                raise AssertionError(f"{name} did not count its launch")
            worst = grad_band_check(f"{name} {label}", GRAD_NAMES[name], got, plain())
            if label == "B/16 train":
                max_err[name] = worst
        del a, g
    for label, (B, S, D, H, causal, eps, frozen) in TEXT_BWD_SHAPES.items():
        a = text_inputs(B, S, D, seed=9, device=dev)
        g = text_inputs(B, S, D, seed=10, device=dev)["x"]
        kernel, plain = text_backward_calls(bb, ta, a, g, H, causal, eps, frozen)
        before = ta.text_subpath_backward.launches
        got = kernel()
        torch.cuda.synchronize()
        if ta.text_subpath_backward.launches != before + 1:
            raise AssertionError("text_subpath_backward did not count its launch")
        worst = grad_band_check(f"text_subpath_backward {label}",
                                GRAD_NAMES["text_subpath_backward"], got, plain())
        if label == "text":
            max_err["text_subpath_backward"] = worst

    # ---- phase 4: main path -------------------------------------------------
    cfg, model = build_model("TVTSv2_B_16", dtype=torch.bfloat16, device=dev, seed=0)
    _, model32 = build_model("TVTSv2_B_16", dtype=torch.float32, device=dev, seed=0)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for p in model32.parameters():  # seeded noise on every leaf (time qkv is 0 at init)
            p.add_(torch.from_numpy(0.02 * rng.standard_normal(p.shape).astype(np.float32))
                   .to(dev))
    model.load_state_dict(model32.state_dict())
    zero = [n for n, p in model.named_parameters() if not p.any()]
    if zero:
        raise AssertionError(f"all-zero parameters: {zero}")
    v = cfg.vision
    tc = cfg.text
    print(f"[4] {cfg.name}: video width {v.width}, {v.layers} blocks, {v.num_frames} frames, "
          f"{v.patches_per_frame} patches/frame; text width {tc.width}, {tc.layers} blocks, "
          f"{tc.heads} heads, context {tc.context_length}; "
          f"{sum(p.numel() for p in model.parameters())} parameters, all non-zero")

    clips = np.random.default_rng(2).standard_normal(
        (21, v.num_frames, 3, v.input_resolution, v.input_resolution)).astype(np.float32)
    loader = SyntheticLoader(clips, v.patches_per_frame, batch_size=8)
    reset_launch_counts(bk, bb, ta)
    fused = extract_embeddings(model, loader, use_fused=True)["video"]
    launches = launch_counts(bk, bb, ta)
    per_forward = dict(zip(bk.launch_counts(), (12, 11, 11, 1)))
    n_forwards = 3
    print(f"[4] launches over {n_forwards} forwards: {launches}")
    want = dict.fromkeys(launches, 0)
    want.update({name: n * n_forwards for name, n in per_forward.items()})
    if launches != want:
        raise AssertionError(f"extraction launches {launches}, expected {want}")
    eager = extract_embeddings(model, loader, use_fused=False)["video"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    eager32 = extract_embeddings(model32, loader, use_fused=False)["video"]
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    if fused.shape != (21, v.output_dim) or not np.isfinite(fused).all():
        raise AssertionError(f"fused embeddings: shape {fused.shape} or non-finite")
    c16, c32 = cos_rows(fused, eager).min(), cos_rows(fused, eager32).min()
    unit = fused / np.linalg.norm(fused, axis=-1, keepdims=True)
    across = (unit @ unit.T)[~np.eye(len(unit), dtype=bool)].mean()
    print(f"[4] pooled cosine, kernel path vs eager: min {c16:.6f} (bf16, >= {COS_BF16}), "
          f"min {c32:.6f} (f32, >= {COS_F32}); mean cosine across clips {across:.4f}")
    if c16 < COS_BF16 or c32 < COS_F32:
        raise AssertionError("kernel path disagrees with the eager tower")
    feat = extract_video_feature(model, clips[:1], use_fused=True)
    if feat.shape != (1, v.output_dim) or not np.isfinite(feat).all():
        raise AssertionError(f"extract_video_feature: shape {feat.shape}")
    print(f"[4] extract_video_feature -> {feat.shape}, cosine to batch row "
          f"{cos_rows(feat, fused[:1])[0]:.6f}")

    # ---- phase 5: zero-shot main path ---------------------------------------
    captions = synthetic_captions(len(clips), seed=4)
    classnames = ["playing guitar", "riding a bike", "cooking pasta", "swimming",
                  "dancing", "reading a book"]
    rng = np.random.default_rng(5)
    labels = rng.integers(0, len(classnames), len(clips))
    n_opt = 5
    options = [[f"a person {classnames[(k + o) % len(classnames)]}" for k in range(len(clips))]
               for o in range(n_opt)]
    mc_labels = rng.integers(0, n_opt, len(clips))
    ret_loader = SyntheticLoader(clips, v.patches_per_frame, 8, text=captions)
    rec_loader = SyntheticLoader(clips, v.patches_per_frame, 8, labels=labels)
    mc_loader = SyntheticLoader(clips, v.patches_per_frame, 8, options=options,
                                labels=mc_labels)
    reset_launch_counts(bk, bb, ta)
    ret, sims = run_retrieval(model, ret_loader, use_fused=True)
    rec = run_recognition(model, rec_loader, classnames, use_fused=True)
    mc = run_ssv2_mc(model, mc_loader, use_fused=True)
    zs_launches = launch_counts(bk, bb, ta)
    text_forwards = n_forwards + len(classnames) + len(clips)
    video_forwards = 3 * n_forwards
    print(f"[5] launches over {text_forwards} text and {video_forwards} video forwards: "
          f"{zs_launches}")
    want = dict.fromkeys(zs_launches, 0)
    want.update({name: n * video_forwards for name, n in per_forward.items()})
    want["fused_text_attention_block"] = (tc.layers - 1) * text_forwards
    if zs_launches != want:
        raise AssertionError(f"zero-shot launches {zs_launches}, expected {want}")
    launches["fused_text_attention_block"] = zs_launches["fused_text_attention_block"]
    ret_eager, sims_eager = run_retrieval(model, ret_loader, use_fused=False)
    for path, res in (("kernels", ret), ("eager", ret_eager)):
        print(f"[5] retrieval {path:7s}: " + json.dumps(res))
    sims_diff = float(np.abs(sims - sims_eager).max())
    print(f"[5] retrieval sims {sims.shape}, max|diff| kernels vs eager {sims_diff:.6f}")
    if sims.shape != (len(clips), len(clips)) or not np.isfinite(sims).all():
        raise AssertionError("retrieval similarity matrix: wrong shape or non-finite")
    if rec["logits"].shape != (len(clips), len(classnames)) \
            or not np.isfinite(rec["logits"]).all():
        raise AssertionError("recognition logits: wrong shape or non-finite")
    print(f"[5] recognition over {len(classnames)} classes: top1 {rec['top1']:.4f} "
          f"top5 {rec['top5']:.4f}; SSV2-MC over {n_opt} options: accuracy "
          f"{mc['accuracy']:.4f} ({mc['correct']}/{mc['total']})")
    if mc["total"] != len(clips):
        raise AssertionError(f"SSV2-MC scored {mc['total']} clips of {len(clips)}")

    texts = {}
    for path, m, use_fused in (("kernels", model, True), ("eager", model, False),
                               ("eager32", model32, False)):
        embed_text, _ = make_embed_fns(m, use_fused=use_fused)
        if path == "eager32":
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        texts[path] = np.concatenate([embed_texts(embed_text, captions[i:i + 8], dev,
                                                  batch_size=8)
                                      for i in range(0, len(captions), 8)])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if texts["kernels"].shape != (len(captions), tc.output_dim) \
            or not np.isfinite(texts["kernels"]).all():
        raise AssertionError(f"text embeddings: shape {texts['kernels'].shape} or non-finite")
    t16 = cos_rows(texts["kernels"], texts["eager"]).min()
    t32 = cos_rows(texts["kernels"], texts["eager32"]).min()
    print(f"[5] text cosine, kernel path vs eager: min {t16:.6f} (bf16, >= {COS_BF16}), "
          f"min {t32:.6f} (f32, >= {COS_F32})")
    if t16 < COS_BF16 or t32 < COS_F32:
        raise AssertionError("text kernel path disagrees with the eager tower")
    del model32

    # ---- phase 7: train main path -------------------------------------------
    train = train_phase(dev, bk, bb, ta)
    launches.update({name: train["launches"][name] for name in (
        "time_subpath_backward", "space_subpath_backward", "text_subpath_backward")})

    # ---- phase 6: times -----------------------------------------------------
    B = 64
    gen = torch.Generator(device=dev).manual_seed(3)
    video = torch.randn(B, v.num_frames, 3, v.input_resolution, v.input_resolution,
                        generator=gen, device=dev)
    keep = torch.arange(v.patches_per_frame, device=dev)[None].expand(B, -1)
    rates = {}
    for path, use_fused in (("kernels", True), ("eager", False)):
        _, embed_video = make_embed_fns(model, use_fused=use_fused)
        ms = cuda_ms(lambda: embed_video(video, keep), iters=5)
        rates[path] = B / (ms / 1e3)
        print(f"[6] B/16 extraction B={B} {path:7s}: {ms:.2f} ms/batch, "
              f"{rates[path]:.2f} clips/s [{card}]")
    print(f"[6] extraction kernels / eager: {rates['kernels'] / rates['eager']:.3f} [{card}]")
    del video

    a = seeded_inputs(1, 1, 1, v.width, seed=0, device=dev)  # weights; x, base below
    S = 1 + v.num_frames * v.patches_per_frame
    a["x"] = torch.randn(B, S, v.width, generator=gen, device=dev, dtype=torch.bfloat16)
    a["base"] = torch.randn(B, S, v.width, generator=gen, device=dev, dtype=torch.bfloat16)
    times = {}
    with torch.inference_mode():
        for name, (kernel, plain) in kernel_calls(bk, a, v.num_frames, v.heads,
                                                  v.act).items():
            k_ms = cuda_ms(kernel, iters=10)
            p_ms = cuda_ms(plain, iters=10)
            if name == "fused_mlp_block":
                work = (16 * a["x"].numel() * v.width, 4 * a["x"].numel() + 16 * v.width ** 2)
            elif name == "fused_space_cls_only":
                M, D = a["x"].shape[0] * S, v.width
                work = (4 * M * D * D + 4 * B * D * D + 4 * D * M,
                        2 * M * D + 4 * B * D + 8 * D * D)
            else:
                work = attention_work("time" if name == "fused_time_block" else "space", B,
                                      v.num_frames, v.patches_per_frame, v.width, v.heads,
                                      backward=False)
            times[name] = (k_ms, p_ms, bound_ms(*work))
            print(f"[6] {name:22s} B={B}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
                  f"{times[name][2][0]:.3f} ms ({times[name][2][1]}) [{card}]")

    TB = 256
    ids = torch.from_numpy(tokenize_openclip(
        [captions[i % len(captions)] for i in range(TB)])).to(dev)
    text_rates = {}
    for path, use_fused in (("kernels", True), ("eager", False)):
        embed_text, _ = make_embed_fns(model, use_fused=use_fused)
        ms = cuda_ms(lambda: embed_text(ids), iters=10)
        text_rates[path] = TB / (ms / 1e3)
        print(f"[6] B/16 embed_text B={TB} {path:7s}: {ms:.3f} ms/batch, "
              f"{text_rates[path]:.2f} captions/s [{card}]")
    print(f"[6] embed_text kernels / eager: {text_rates['kernels'] / text_rates['eager']:.3f} "
          f"[{card}]")
    with torch.inference_mode():
        for label, (B, S, D, H, causal, eps) in (
                ("text", (TB, 77, tc.width, tc.heads, True, 1e-5)),
                ("sort", (20, 1181, 512, 8, False, 1e-6))):
            kernel, plain = text_calls(ta, text_inputs(B, S, D, seed=6, device=dev), H,
                                       causal, eps)
            k_ms = cuda_ms(kernel, iters=10)
            p_ms = cuda_ms(plain, iters=10)
            bnd = bound_ms(*text_work(B, S, D, H, causal, backward=False))
            if label == "text":
                times["fused_text_attention_block"] = (k_ms, p_ms, bnd)
            print(f"[6] fused_text_attention_block {label} B={B} S={S} D={D}: kernel "
                  f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]}) "
                  f"[{card}]")
    del model
    train_times(dev, card, bk, bb, ta, train, times)

    print(card)
    # library_ms: no single PyTorch call computes a whole sub-path (LayerNorm,
    # qkv product, divided or causal attention, proj product and residual)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": times[name][0], "plain_ms": times[name][1], "bound_ms": times[name][2][0],
         "bound_by": times[name][2][1], "library_ms": None} for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
