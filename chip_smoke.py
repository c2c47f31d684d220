#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths -- TVTSv2 B/16 video feature
extraction and zero-shot eval (retrieval, prompt recognition, SSV2 multiple
choice) through the hand-written Hopper kernels -- on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
1. refuse to run without CUDA; print the card's name and power limit;
2. build the kernels from tvts_torch/csrc with nvcc (sm_90a); print the build
   seconds and the -Xptxas -v register / shared-memory lines;
3. kernel parity, in bf16 on seeded inputs against the plain PyTorch versions
   on the card: H1-H4 at the B/16 shape (B=2), at N=49 (B/32) and at D=1280,
   H=16 (head dim 80); H7 (text attention) at the B/16 text shape (B=8, S=77,
   D=512, causal), the H/14 text shape (B=4, S=77, D=1024, H=16) and the sort
   head shape (B=2, S=1181, D=512, non-causal, LN eps 1e-6);
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
6. times with CUDA events after warm-up: clips/s at B=64 and captions/s at
   B=256 (kernels, eager), each kernel against its plain version.
The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
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
}
SOURCE = "tvts_torch/csrc/block_kernels.cu"
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


def launch_counts(bk, ta) -> dict[str, int]:
    return {**bk.launch_counts(), "fused_text_attention_block":
            ta.fused_text_attention_block.launches}


def reset_launch_counts(bk, ta) -> None:
    bk.reset_launch_counts()
    ta.fused_text_attention_block.launches = 0


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
    reset_launch_counts(bk, ta)
    fused = extract_embeddings(model, loader, use_fused=True)["video"]
    launches = launch_counts(bk, ta)
    per_forward = dict(zip(bk.launch_counts(), (12, 11, 11, 1)))
    n_forwards = 3
    print(f"[4] launches over {n_forwards} forwards: {launches}")
    for name, n in per_forward.items():
        if launches[name] != n * n_forwards:
            raise AssertionError(f"{name}: {launches[name]} launches, "
                                 f"expected {n} per forward")
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
    reset_launch_counts(bk, ta)
    ret, sims = run_retrieval(model, ret_loader, use_fused=True)
    rec = run_recognition(model, rec_loader, classnames, use_fused=True)
    mc = run_ssv2_mc(model, mc_loader, use_fused=True)
    zs_launches = launch_counts(bk, ta)
    text_forwards = n_forwards + len(classnames) + len(clips)
    video_forwards = 3 * n_forwards
    print(f"[5] launches over {text_forwards} text and {video_forwards} video forwards: "
          f"{zs_launches}")
    want = {name: n * video_forwards for name, n in per_forward.items()}
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
            times[name] = (k_ms, p_ms)
            print(f"[6] {name:22s} B={B}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
                  f"[{card}]")

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
            if label == "text":
                times["fused_text_attention_block"] = (k_ms, p_ms)
            print(f"[6] fused_text_attention_block {label} B={B} S={S} D={D}: kernel "
                  f"{k_ms:.3f} ms, plain {p_ms:.3f} ms [{card}]")

    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": times[name][0], "plain_ms": times[name][1]} for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
